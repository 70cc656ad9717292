"""pyannote-face CLI on PyTorch: the ``track``, ``extract`` and ``demo``
commands.

Port of ``pyannote_video_tpu/cli/face_cli.py`` with the same USAGE, flags,
defaults and file schemas (tracking: one line per (t, track-id, normalized
bbox, status); landmarks and embeddings: one line per tracked face).

Both commands run the streaming engines of ``pipeline/streaming.py`` by
default, as the JAX CLI does: one sequential decode, frames packed to YUV
4:2:0 and copied to the device on threads of their own, gray and chips
taken from the planes.  ``PYV_NO_STREAM=1`` selects the older engines: the
per-shot tracker of ``pipeline/tracking.py`` (also taken for a custom
``detect_func``) and the chunked extract (64 faces per batch, RGB frames
read by timestamp).  ``track --rank r --world W`` shards the shots over W
workers in either engine; rank 0 merges the part files
(``parallel/multihost.py``).  ``demo`` draws boxes, track ids, labels and
nose lines over the video and encodes it with OpenCV: host work over
``tracking.txt`` with no tensor, so it runs without a card.

Run as ``python -m pyannote_video_tpu_torch.cli.face_cli track <video>
<shot.json> <tracking>`` or ``... extract <video> <tracking> "" ""
<landmarks> <embeddings>``; it runs on the CUDA device (``main(argv,
device="cpu")`` from Python runs it on the CPU).  ``... demo <video>
<tracking> <output>`` needs OpenCV, imported when it runs.
"""

from __future__ import annotations

import colorsys
import os
import sys
from typing import Dict, List

import numpy as np

from ..utils.device import DeviceLike

USAGE = """Face detection and tracking

The standard pipeline is the following

      face tracking => feature extraction => face clustering

Usage:
  pyannote-face track [options] <video> <shot.json> <tracking>
  pyannote-face extract [options] <video> <tracking> <landmark_model> <embedding_model> <landmarks> <embeddings>
  pyannote-face demo [options] <video> <tracking> <output>
  pyannote-face (-h | --help)
  pyannote-face --version

General options:

  --ffmpeg=<ffmpeg>         Specify which `ffmpeg` to use.
  -h --help                 Show this screen.
  --version                 Show version.
  --verbose                 Show processing progress.

Face tracking options (track):

  <video>                   Path to video file.
  <shot.json>               Path to shot segmentation result file.
  <tracking>                Path to tracking result file.

  --min-size=<ratio>        Approximate size (in video height ratio) of the
                            smallest face that should be detected. Default is
                            to try and detect any object [default: 0.0].
  --every=<seconds>         Only apply detection every <seconds> seconds.
                            Default is to process every frame [default: 0.0].
  --min-overlap=<ratio>     Associates face with tracker if overlap is greater
                            than <ratio> [default: 0.5].
  --min-confidence=<float>  Reset trackers with confidence lower than <float>
                            [default: 10.].
  --max-gap=<float>         Bridge gaps with duration shorter than <float>
                            [default: 1.].
  --resume                  Resume an interrupted run from the last fully
                            tracked shot in <tracking> (extension; shots are
                            independent work units so per-shot restart is
                            exact).
  --rank=<r>                Multi-worker mode (extension): this worker's
                            rank; processes shots where index mod world ==
                            rank and writes <tracking>.part<r> [default: 0].
  --world=<w>               Total number of workers; rank 0 merges the
                            part files into <tracking> once all workers
                            have finished [default: 1].
  --coordinator=<addr>      host:port of the jax.distributed coordinator
                            (only needed on multi-host TPU slices).

Feature extraction options (extract):

  <video>                   Path to video file.
  <tracking>                Path to tracking result file.
  <landmark_model>          Path to facial landmark detection model (.npz).
  <embedding_model>         Path to feature extraction model (.npz).
  <landmarks>               Path to facial landmarks detection result file.
  <embeddings>              Path to feature extraction result file.
  --exact-chips             Use exact rotated chip sampling (dlib
                            get_face_chip parity, including face roll) for
                            the embedding alignment instead of the fast
                            axis-aligned path (extension).

Visualization options (demo):

  <video>                   Path to video file.
  <tracking>                Path to tracking result file.
  <output>                  Path to demo video file.

  --height=<pixels>         Height of demo video file [default: 400].
  --from=<sec>              Encode demo from <sec> seconds [default: 0].
  --until=<sec>             Encode demo until <sec> seconds.
  --shift=<sec>             Shift result files by <sec> seconds [default: 0].
  --landmark=<path>         Path to facial landmarks detection result file.
  --label=<path>            Path to track identification result file.
"""

MIN_OVERLAP_RATIO = 0.5
MIN_CONFIDENCE = 10.0
MAX_GAP = 1.0

def _streaming() -> bool:
    return os.environ.get("PYV_NO_STREAM") != "1"


def track(video, shot_path, output,
          detect_min_size=0.0, detect_every=0.0,
          track_min_overlap_ratio=MIN_OVERLAP_RATIO,
          track_min_confidence=MIN_CONFIDENCE,
          track_max_gap=MAX_GAP, resume=False, verbose=False,
          rank=0, world=1, coordinator=None, legs=None,
          device: DeviceLike = None):
    """Tracking by detection (reference `pyannote-face.py:239-269`).

    The streaming engine (``pipeline/streaming.py:stream_tracks``:
    overlapped decode → YUV420 transfer → device compute, gray from the
    luma plane) unless ``PYV_NO_STREAM=1`` or a custom ``detect_func``
    asks for the per-shot one; both give the same track semantics.
    ``legs``, a ``StreamLegs``, receives the streaming engine's seconds.

    With ``resume=True``, restarts from the shot containing the last
    written timestamp: shots are independent work units, so completed
    shots are kept verbatim and the interrupted shot is re-tracked.

    With ``world > 1`` (extension), this process is worker ``rank`` of a
    shot-sharded multi-worker run: it tracks shots ``rank, rank+world, …``
    into ``<output>.part<rank>``; rank 0 then waits for the other parts
    and merges them deterministically (``parallel/multihost.py``).
    """
    from ..core import Annotation, formats, load
    from ..parallel.multihost import (init_distributed, merge_tracking_parts,
                                      part_path)
    from ..pipeline.face_tracking import FaceTracking
    from ..utils.profiling import StageStats

    tracking = FaceTracking(detect_min_size=detect_min_size,
                            detect_every=detect_every,
                            track_min_overlap_ratio=track_min_overlap_ratio,
                            track_min_confidence=track_min_confidence,
                            track_max_gap=track_max_gap, device=device)
    init_distributed(coordinator, rank, world)

    with open(shot_path, "r") as fp:
        shot = load(fp)
    if isinstance(shot, Annotation):
        shot = shot.get_timeline()
    shots = list(shot)

    next_id = 0
    if resume and os.path.exists(output):
        points = formats.read_tracking(output)
        if points:
            t_last = max(p.t for p in points)
            start_idx = len(shots)
            for i, seg in enumerate(shots):
                if seg.start <= t_last < seg.end:
                    start_idx = i
                    break
            restart_t = (shots[start_idx].start
                         if start_idx < len(shots) else float("inf"))
            keep = [p for p in points if p.t < restart_t]
            with open(output, "w") as fp:
                for p in keep:
                    formats.write_track_point(fp, p)
            next_id = max((p.identifier for p in keep), default=-1) + 1
            shots = shots[start_idx:]
            if shots:
                video.start = max(video.start, shots[0].start)

    use_stream = _streaming() and tracking.detect_func is None
    if use_stream:
        from ..pipeline.streaming import StreamLegs, stream_tracks

        legs = StreamLegs() if legs is None else legs

    def my_tracks():
        """This worker's tracks: every shot, or those with index mod world
        == rank.  The streaming engine plans over the FULL frame grid
        (decode is sequential anyway and overlaps compute) and drops
        unassigned shots before any device work, so every worker's frame
        partition, detections and scans are those of the single-worker
        run; the per-shot engine seeks to each of its shots."""
        mine = (lambda i: i % world == rank) if world > 1 else None
        if use_stream:
            return stream_tracks(tracking, video, shots, legs=legs,
                                 segment_filter=mine)
        if mine is None:
            return tracking(video, shots)
        return _per_shot_tracks(tracking, video,
                                [s for i, s in enumerate(shots) if mine(i)])

    def write(foutput, first_id):
        for offset, trk in enumerate(my_tracks()):
            for t, (left, top, right, bottom), status in trk:
                foutput.write(formats.FACE_TEMPLATE.format(
                    t=t, identifier=first_id + offset, status=status,
                    left=left, right=right, top=top, bottom=bottom))
            stats.add(n=len(trk), tracks=1)
            foutput.flush()

    stats = StageStats("track")
    if world > 1:
        with open(part_path(output, rank), "w") as foutput:
            write(foutput, 0)
        if rank == 0:
            # include_existing folds the pre-restart tracks kept by
            # --resume into the merge (the merge rewrites `output`)
            merge_tracking_parts(output, world, wait_s=3600.0,
                                 include_existing=resume)
    else:
        with open(output, "a" if resume else "w") as foutput:
            write(foutput, next_id)
    if verbose and use_stream:
        print("stream legs:", legs.as_dict(), file=sys.stderr)
    if verbose:
        print(stats.finish(), file=sys.stderr)


def _per_shot_tracks(tracking, video, my_shots):
    """The per-shot engine over a subset of shots, each sought on its own."""
    old_start, old_end = video.start, video.end
    try:
        for seg in my_shots:
            video.start, video.end = seg.start, seg.end
            yield from tracking(video, [seg])
    finally:
        video.start, video.end = old_start, old_end


EXTRACT_FACES_PER_BATCH = 64  # faces per device dispatch


def extract_batch(video, chunk, predictor, embedder, chip_fn,
                  lap=lambda part, since: since):
    """One batch of ``extract``: ``chunk`` is a list of (T, track point).

    The chunk's unique frames are stacked once and sent to the device once;
    the cascade, the chip cut and the embedder are enqueued without a wait,
    and landmarks [n, 68, 2] (pixels) and embeddings [n, 128] come back in
    one read.  ``lap(part, since)`` is told when each part was enqueued.
    """
    import time

    import torch

    device = predictor.device
    frame_width, frame_height = video.frame_size
    tick = time.perf_counter()
    times = sorted({T for T, _ in chunk})
    t_index = {T: i for i, T in enumerate(times)}
    frames = torch.from_numpy(np.stack([video(T) for T in times])).to(device)
    fidx = torch.from_numpy(np.asarray(
        [t_index[T] for T, _ in chunk], dtype=np.int64)).to(device)
    boxes = torch.from_numpy(np.asarray(
        [[p.left * frame_width, p.top * frame_height,
          p.right * frame_width, p.bottom * frame_height]
         for _, p in chunk], dtype=np.float32)).to(device)
    tick = lap("frames", tick)

    landmarks = predictor.predict_device(frames, fidx, boxes)
    tick = lap("cascade", tick)
    chips = chip_fn(frames, fidx, landmarks)
    tick = lap("chips", tick)
    embeddings = embedder.embed_device(chips)
    # one read per batch: landmarks and embeddings together
    packed = torch.cat([landmarks.reshape(len(chunk), -1), embeddings],
                       dim=1).cpu().numpy()
    lap("embedder", tick)
    n_lm = landmarks.shape[1] * 2
    return packed[:, :n_lm].reshape(len(chunk), -1, 2), packed[:, n_lm:]


def extract(video, landmark_model, embedding_model, tracking_path,
            landmark_output, embedding_output, exact_chips=False,
            verbose=False, legs=None, device: DeviceLike = None,
            compute_dtype=None, stats=None):
    """Landmarks + embeddings for tracked faces (reference
    `pyannote-face.py:271-314`).

    By default the streaming engine
    (``pipeline/streaming.py:stream_extract``): ONE sequential decode pass
    pipelined against the YUV420 transfer and the device's work; the
    cascade, the chip cut (straight from the YUV planes) and the embedder
    are enqueued per batch, and landmarks and embeddings come back in one
    read per 64 faces.  ``legs``, a ``StreamLegs``, receives its seconds.
    ``PYV_NO_STREAM=1`` selects the chunked engine (``_extract_chunked``).

    ``compute_dtype`` (default bfloat16) is the embedder's conv dtype.
    ``stats``, a dict, receives the seconds spent loading the tracking
    file and the two models (``load``) and, from the chunked engine, per
    part; timing them synchronises the device after each part.
    """
    import time

    import torch

    from ..core import formats
    from ..models.embedder import FaceEmbedder
    from ..models.landmarks import LandmarkPredictor
    from ..utils.device import resolve_device

    device = resolve_device(device)

    def lap(part, since):
        if stats is None:
            return since
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        now = time.perf_counter()
        stats[part] = stats.get(part, 0.0) + (now - since)
        return now

    tick = time.perf_counter()
    points = formats.read_tracking(tracking_path)
    predictor = LandmarkPredictor(landmark_model or None, device=device)
    embedder = FaceEmbedder(
        embedding_model or None, device=device,
        compute_dtype=torch.bfloat16 if compute_dtype is None else compute_dtype)
    lap("load", tick)

    if not _streaming():
        _extract_chunked(video, predictor, embedder, points, landmark_output,
                         embedding_output, exact_chips, lap)
    else:
        from ..pipeline.streaming import StreamLegs, stream_extract

        legs = StreamLegs() if legs is None else legs
        size = np.asarray(video.frame_size)
        with open(landmark_output, "w") as flandmark, \
             open(embedding_output, "w") as fembedding:
            for T, p, lm, emb in stream_extract(
                    video, points, predictor, embedder,
                    exact_chips=exact_chips, legs=legs):
                formats.write_landmarks_line(flandmark, T, p.identifier,
                                             lm / size)
                formats.write_embedding_line(fembedding, T, p.identifier, emb)
                flandmark.flush()
                fembedding.flush()
        if verbose:
            print("stream legs:", legs.as_dict(), file=sys.stderr)
    if verbose:
        print(f"extract: {len(points)} faces", file=sys.stderr)


def _extract_chunked(video, predictor, embedder, points, landmark_output,
                     embedding_output, exact_chips, lap):
    """The chunked engine: the tracked faces are grouped by time and taken
    64 at a time.  A batch's unique frames are read by timestamp, stacked
    once and sent to the device once; the cascade, the chip cut (from the
    RGB frames) and the embedder run there, and landmarks and embeddings
    come back in one read per batch.  The JAX engine pads the frame axis
    to a power of two and the face axis to 64 to bound its compilations;
    nothing is compiled per shape here and a face's result does not depend
    on its batch, so the last batch is simply shorter.  ``lap`` receives
    the parts ``frames`` (stacking and copy), ``cascade``, ``chips``,
    ``embedder`` and ``write``."""
    import time

    from ..core import formats
    from ..models.chip import extract_chips, extract_chips_exact

    chip_fn = extract_chips_exact if exact_chips else extract_chips
    # flatten to (T, point) preserving group order
    flat = [(T, p) for T, group in formats.iter_tracking_by_time(points)
            for p in group]
    size = np.asarray(video.frame_size)

    with open(landmark_output, "w") as flandmark, \
         open(embedding_output, "w") as fembedding:
        for start in range(0, len(flat), EXTRACT_FACES_PER_BATCH):
            chunk = flat[start: start + EXTRACT_FACES_PER_BATCH]
            landmarks, embeddings = extract_batch(
                video, chunk, predictor, embedder, chip_fn, lap)
            tick = time.perf_counter()
            for (T, p), lm, emb in zip(chunk, landmarks, embeddings):
                formats.write_landmarks_line(flandmark, T, p.identifier,
                                             lm / size)
                formats.write_embedding_line(fembedding, T, p.identifier, emb)
            flandmark.flush()
            fembedding.flush()
            lap("write", tick)


# The reference's fixed track-color table (behavioral constant, same
# category as its ffmpeg flags: `pyannote-face.py:320-328` — itself the
# public Green-Armytage 26-color alphabet), so demo frames are
# pixel-comparable with reference output.
REFERENCE_COLORS: List[tuple] = [
    (240, 163, 255), (0, 117, 220), (153, 63, 0), (76, 0, 92),
    (25, 25, 25), (0, 92, 49), (43, 206, 72), (255, 204, 153),
    (128, 128, 128), (148, 255, 181), (143, 124, 0), (157, 204, 0),
    (194, 0, 136), (0, 51, 128), (255, 164, 5), (255, 168, 187),
    (66, 102, 0), (255, 0, 16), (94, 241, 242), (0, 153, 143),
    (224, 255, 102), (116, 10, 255), (153, 0, 0), (255, 255, 128),
    (255, 255, 0), (255, 80, 5),
]


def _palette(n: int = 26) -> List[tuple]:
    """Track colors: the reference's fixed 26-color table, extended with
    golden-ratio HSV colors when more are requested."""
    colors = list(REFERENCE_COLORS[:n])
    for i in range(len(colors), n):
        h = (i * 0.618033988749895) % 1.0
        v = 0.85 if i % 2 == 0 else 0.6
        r, g, b = colorsys.hsv_to_rgb(h, 0.85, v)
        colors.append((int(r * 255), int(g * 255), int(b * 255)))
    return colors


def demo(filename, tracking_path, output, t_start=0.0, t_end=None, shift=0.0,
         labels_path=None, landmark_path=None, height=200, ffmpeg=None):
    """Overlay video (reference `pyannote-face.py:317-413`): colored face
    boxes, #track-id, optional labels and nose lines, timestamp."""
    import cv2

    from ..core import formats
    from ..io.video import Video

    labels: Dict[int, str] = (
        formats.read_labels(labels_path) if labels_path else {}
    )

    video = Video(filename, ffmpeg=ffmpeg)
    video_width, video_height = video.size
    ratio = height / video_height
    width = int(ratio * video_width)
    video.frame_size = (width, height)

    points = formats.read_tracking(tracking_path)
    by_time = list(formats.iter_tracking_by_time(points))
    landmark_rows = (
        formats.read_landmarks(landmark_path) if landmark_path else []
    )
    lm_by_time: Dict[float, List] = {}
    for (t, identifier, pts) in landmark_rows:
        lm_by_time.setdefault(t, []).append((identifier, pts))

    colors = _palette()
    t_end = video.duration if t_end is None else t_end

    writer = cv2.VideoWriter(
        output, cv2.VideoWriter_fourcc(*"MJPG"), video.frame_rate,
        (width, height),
    )
    if not writer.isOpened():
        raise IOError(f"could not open video writer for {output}")

    face_idx = 0
    for t in np.arange(t_start, t_end, 1.0 / video.frame_rate):
        frame = np.ascontiguousarray(video(t))
        t_query = t - shift
        # reference timing semantics (`pyannote-face.py:159-172`): each
        # frame query consumes AT MOST ONE timestamp group, and a group is
        # drawn only on the first frame at/after its timestamp — faces are
        # not held over later frames.  (Deviation: the reference's
        # generator drops the final group entirely when its for-loop ends,
        # `pyannote-face.py:174-175`; we display it.)
        current_faces: List = []
        if face_idx < len(by_time) and by_time[face_idx][0] <= t_query:
            current_faces = by_time[face_idx][1]
            face_idx += 1

        cv2.putText(frame, f"{t:.3f}", (10, height - 10),
                    cv2.FONT_HERSHEY_DUPLEX, 0.5, (255, 0, 0), 1, 8, False)

        for p in current_faces:
            color = colors[p.identifier % len(colors)]
            pt1 = (int(p.left * width), int(p.top * height))
            pt2 = (int(p.right * width), int(p.bottom * height))
            cv2.rectangle(frame, pt1, pt2, color, 2)
            cv2.putText(frame, f"#{p.identifier:d}", (pt1[0], pt2[1] + 15),
                        cv2.FONT_HERSHEY_SIMPLEX, 0.5, (255, 0, 0), 1, 8,
                        False)
            label = labels.get(p.identifier, "")
            cv2.putText(frame, f"{label:s}", (pt1[0], pt1[1] - 7),
                        cv2.FONT_HERSHEY_SIMPLEX, 0.5, (255, 0, 0), 1, 8,
                        False)
            # nose line (landmarks 27 -> 33) when landmarks are available
            for identifier, pts in lm_by_time.get(p.t, []):
                if identifier != p.identifier:
                    continue
                # reference rounds landmark pixels (`pyannote-face.py:206`)
                n1 = (int(round(pts[27, 0] * width)),
                      int(round(pts[27, 1] * height)))
                n2 = (int(round(pts[33, 0] * width)),
                      int(round(pts[33, 1] * height)))
                cv2.line(frame, n1, n2, color, 1)

        writer.write(frame[:, :, ::-1])  # RGB -> BGR
    writer.release()
    _mux_audio(filename, output, t_start, t_end, ffmpeg=ffmpeg)


def _mux_audio(source, output, t_start, t_end, ffmpeg=None):
    """Copy the source's audio track into the rendered demo.

    The reference gets audio passthrough for free from moviepy's ffmpeg
    writer (`pyannote-face.py:408-413`); cv2.VideoWriter is video-only, so
    when an ffmpeg binary is available the demo is re-muxed in place.
    Without one the demo stays silent with a warning — same pixels either
    way.
    """
    import shutil
    import subprocess
    import tempfile
    import warnings

    ffmpeg_bin = ffmpeg or shutil.which("ffmpeg")
    if not ffmpeg_bin or not shutil.which(ffmpeg_bin):
        warnings.warn("no ffmpeg binary found - demo has no audio track")
        return
    dot = output.rfind(".")
    suffix = output[dot:] if dot > 0 else ".avi"
    fd, tmp = tempfile.mkstemp(suffix=suffix)
    os.close(fd)
    cmd = [ffmpeg_bin, "-y", "-i", output, "-ss", f"{t_start:.3f}",
           "-to", f"{t_end:.3f}", "-i", source,
           "-map", "0:v", "-map", "1:a?", "-c:v", "copy", "-c:a", "aac",
           "-shortest", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
        shutil.move(tmp, output)
    except (subprocess.CalledProcessError, OSError) as exc:
        warnings.warn(f"audio mux failed ({exc}); demo has no audio track")
        try:
            os.remove(tmp)
        except OSError:
            pass


def main(argv=None, device: DeviceLike = None):
    from .. import __version__
    from ..io.video import Video
    from ..utils.device import resolve_device
    from .args import parse

    arguments = parse(
        USAGE,
        version=f"pyannote-face {__version__}",
        argv=argv,
        commands=["track", "extract", "demo"],
        positionals={
            "track": ["<video>", "<shot.json>", "<tracking>"],
            "extract": ["<video>", "<tracking>", "<landmark_model>",
                        "<embedding_model>", "<landmarks>", "<embeddings>"],
            "demo": ["<video>", "<tracking>", "<output>"],
        },
        defaults={
            "--ffmpeg": "",
            "--verbose": None,
            "--min-size": "0.0",
            "--every": "0.0",
            "--min-overlap": "0.5",
            "--min-confidence": "10.",
            "--max-gap": "1.",
            "--resume": None,
            "--exact-chips": None,
            "--rank": "0",
            "--world": "1",
            "--coordinator": "",
            "--height": "400",
            "--from": "0",
            "--until": "",
            "--shift": "0",
            "--landmark": "",
            "--label": "",
        },
    )

    if arguments["demo"]:
        t_end = arguments["--until"]
        demo(arguments["<video>"], arguments["<tracking>"],
             arguments["<output>"],
             t_start=float(arguments["--from"]),
             t_end=float(t_end) if t_end else None,
             shift=float(arguments["--shift"]),
             labels_path=arguments["--label"] or None,
             landmark_path=arguments["--landmark"] or None,
             height=int(arguments["--height"]),
             ffmpeg=arguments["--ffmpeg"] or None)
        return

    device = resolve_device(device)
    verbose = bool(arguments["--verbose"])
    video = Video(arguments["<video>"], ffmpeg=arguments["--ffmpeg"] or None,
                  verbose=verbose)
    if arguments["extract"]:
        extract(video, arguments["<landmark_model>"],
                arguments["<embedding_model>"], arguments["<tracking>"],
                arguments["<landmarks>"], arguments["<embeddings>"],
                exact_chips=bool(arguments["--exact-chips"]),
                verbose=verbose, device=device)
        return
    track(video, arguments["<shot.json>"], arguments["<tracking>"],
          detect_min_size=float(arguments["--min-size"]),
          detect_every=float(arguments["--every"]),
          track_min_overlap_ratio=float(arguments["--min-overlap"]),
          track_min_confidence=float(arguments["--min-confidence"]),
          track_max_gap=float(arguments["--max-gap"]),
          resume=bool(arguments["--resume"]), verbose=verbose,
          rank=int(arguments["--rank"]), world=int(arguments["--world"]),
          coordinator=arguments["--coordinator"] or None, device=device)


if __name__ == "__main__":
    main()
