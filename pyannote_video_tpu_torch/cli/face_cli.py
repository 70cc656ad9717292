"""pyannote-face CLI on PyTorch: the ``track`` command.

Port of ``pyannote_video_tpu/cli/face_cli.py`` with the same USAGE, flags,
defaults and tracking-file schema (one line per (t, track-id, normalized
bbox, status)).  ``track`` runs the per-shot engine
(``pipeline/tracking.py``) as a single worker; ``extract``, ``demo`` and
``--world`` > 1 are not ported yet and exit with a message saying so.

Run as ``python -m pyannote_video_tpu_torch.cli.face_cli track <video>
<shot.json> <tracking>``; it runs on the CUDA device (``main(argv,
device="cpu")`` from Python runs it on the CPU).
"""

from __future__ import annotations

import sys

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

_NOT_PORTED = {
    "extract": "ROADMAP: 'Extract'",
    "demo": "ROADMAP: 'Fused program and demo'",
    "--world": "ROADMAP: 'Streaming and the face CLI'",
}


def _not_ported(what: str) -> SystemExit:
    return SystemExit(
        f"pyannote-face {what}: not ported to PyTorch yet "
        f"({_NOT_PORTED[what]}); use pyannote_video_tpu's CLI")


def track(video, shot_path, output,
          detect_min_size=0.0, detect_every=0.0,
          track_min_overlap_ratio=MIN_OVERLAP_RATIO,
          track_min_confidence=MIN_CONFIDENCE,
          track_max_gap=MAX_GAP, resume=False, verbose=False,
          rank=0, world=1, coordinator=None, device: DeviceLike = None):
    """Tracking by detection (reference `pyannote-face.py:239-269`).

    With ``resume=True``, restarts from the shot containing the last
    written timestamp: shots are independent work units, so completed
    shots are kept verbatim and the interrupted shot is re-tracked.
    """
    import os

    from ..core import Annotation, formats, load
    from ..pipeline.face_tracking import FaceTracking
    from ..utils.profiling import StageStats

    if world > 1:
        raise _not_ported("--world")

    tracking = FaceTracking(detect_min_size=detect_min_size,
                            detect_every=detect_every,
                            track_min_overlap_ratio=track_min_overlap_ratio,
                            track_min_confidence=track_min_confidence,
                            track_max_gap=track_max_gap, device=device)

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

    stats = StageStats("track")
    with open(output, "a" if resume else "w") as foutput:
        for offset, trk in enumerate(tracking(video, shots)):
            identifier = next_id + offset
            for t, (left, top, right, bottom), status in trk:
                foutput.write(formats.FACE_TEMPLATE.format(
                    t=t, identifier=identifier, status=status,
                    left=left, right=right, top=top, bottom=bottom))
            stats.add(n=len(trk), tracks=1)
            foutput.flush()
    if verbose:
        print(stats.finish(), file=sys.stderr)


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

    for command in ("extract", "demo"):
        if arguments[command]:
            raise _not_ported(command)
    if int(arguments["--world"]) > 1:
        raise _not_ported("--world")

    device = resolve_device(device)
    verbose = bool(arguments["--verbose"])
    video = Video(arguments["<video>"], ffmpeg=arguments["--ffmpeg"] or None,
                  verbose=verbose)
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
