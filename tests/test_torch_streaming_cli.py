"""The port's streaming ``track`` and ``extract`` against the JAX package's
default (streaming) paths, and against the port's older engines, on the CPU.

Across the packages the JAX module's ``pack_yuv420`` is replaced at run
time by the JAX package's own NumPy ``rgb_to_yuv420`` (the port's one
convention), so that both see the same planes.  Tolerances:

* the plan and the assembler: equal;
* the same detections (a detector stub in each package): the same tracks,
  timestamps and statuses, pixel boxes equal or 1 px apart where ``_fix``
  rounded a mean that sat on .5 (the bar of ``tests/test_torch_tracking.py``);
* each package's own bfloat16 detector: the same structure; boxes within
  2.5/120 of the frame, the bar of ``tests/test_streaming_cli.py``, on 79%
  of the points where this was written; that share moves with the
  convolutions' rounding, so the test holds the median to 10/120 and every
  point to 21/120.  The
  detector puts several candidates of nearly equal score on a face, up to
  20 px apart at 160×120, and which of them wins NMS differs between two
  bfloat16 detectors, or between the RGB frame and its YUV 4:2:0 round
  trip, on about one detection frame in six; the tracker carries that box
  to the next detection.  The same holds for the port's streaming engine
  against its per-shot one (a third within 2.5/120, median 3/120);
  with the detections held equal every box is within 2.5/120;
* landmarks within 5e-3 px on ≥ 90% of the faces and float32 embeddings
  within 1e-3 where the landmarks agree (the bars of
  ``tests/test_torch_extract.py``); streaming against chunked landmarks
  within 0.02 (normalised).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pyannote_video_tpu import Video as JVideo
from pyannote_video_tpu.cli import face_cli as jface_cli
from pyannote_video_tpu.core import Segment as JSegment
from pyannote_video_tpu.core import formats as jformats
from pyannote_video_tpu.models import embedder as jembedder
from pyannote_video_tpu.models.weights import DETECTOR_FILE
from pyannote_video_tpu.ops.color import rgb_to_yuv420 as j_rgb_to_yuv420
from pyannote_video_tpu.pipeline import streaming as jstreaming
from pyannote_video_tpu.pipeline.face_tracking import FaceTracking as JFaceTracking
from pyannote_video_tpu.utils.synthetic import synthetic_episode

from pyannote_video_tpu_torch.cli import face_cli
from pyannote_video_tpu_torch.core import Segment, Timeline, dump, formats
from pyannote_video_tpu_torch.io.video import Video
from pyannote_video_tpu_torch.models.detector import FaceDetector
from pyannote_video_tpu_torch.ops.color import rgb_to_yuv420, yuv420_to_rgb
from pyannote_video_tpu_torch.pipeline import streaming
from pyannote_video_tpu_torch.pipeline.face_tracking import FaceTracking

pytestmark = pytest.mark.skipif(
    not DETECTOR_FILE.exists(), reason="no trained weights")

W, H = 160, 120
BOX_TOL = 2.5 / 120.0
LANDMARK_TOL = 5e-3


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The test runner's workers share the cores: with every worker's torch
    pool at full width the many small CPU operations of a scan mostly wait
    for each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    # the JAX package's refiner trainer leaves this set in its pytest worker
    monkeypatch.delenv("PYV_NO_REFINE", raising=False)
    monkeypatch.delenv("PYV_NO_STREAM", raising=False)
    # both packages see the planes of the one (NumPy) convention
    monkeypatch.setattr(jstreaming, "pack_yuv420", j_rgb_to_yuv420)


@pytest.fixture(scope="module")
def episode():
    return synthetic_episode(n_shots=2, shot_frames=12, width=W, height=H,
                             seed=61, face_height_ratio=0.45)


@pytest.fixture(scope="module")
def shot_json(episode, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("torch_streaming") / "shot.json")
    with open(path, "w") as fp:
        dump(Timeline([Segment(s, e) for s, e in episode.shots]), fp)
    return path


# -- the plan and the assembler ------------------------------------------------


class _FakeVideo:
    def __init__(self, n=100, fps=25.0):
        self._grid = np.arange(n) / fps

    def timestamps(self):
        return self._grid


PLAN_CASES = {
    "memory splits": ([(0.0, 1.0), (1.0, 2.2), (2.2, 4.0)], 17, 3),
    "no split": ([(0.0, 1.0), (1.0, 2.2), (2.2, 4.0)], 2000, 5),
    "every frame": ([(0.0, 2.0), (2.0, 4.0)], 30, 1),
    "empty segments": ([(0.0, 1.0), (1.0, 1.01), (1.01, 1.02), (1.02, 3.0),
                        (3.0, 4.0)], 40, 4),
    "short and long shots": ([(0.0, 0.5), (0.5, 1.5), (1.5, 4.0)], 10, 2),
    "split lands on a boundary": ([(0.0, 1.0), (1.0, 4.0)], 25, 5),
}


@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_shot_plan_matches_the_jax_plan(case):
    segs, max_shot, every = PLAN_CASES[case]
    ref = jstreaming._shot_plan(_FakeVideo(), [JSegment(s, e) for s, e in segs],
                                max_shot, every)
    out = streaming._shot_plan(_FakeVideo(), [Segment(s, e) for s, e in segs],
                               max_shot, every)
    for a, b in zip(out, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    shot_id, _, segment = out
    for s in np.unique(shot_id):
        assert len(np.unique(segment[shot_id == s])) == 1


def test_shot_plan_matches_generator():
    """The up-front replay partitions frames exactly like the per-shot
    engine's online generator, ``max_shot_frames`` splits included."""
    from pyannote_video_tpu_torch.pipeline.tracking import get_segment_generator

    segs = [Segment(0.0, 1.0), Segment(1.0, 2.2), Segment(2.2, 4.0)]
    max_shot, every = 17, 3
    shot_id, detect, segment = streaming._shot_plan(_FakeVideo(), segs,
                                                    max_shot, every)
    gen = get_segment_generator(segs)
    gen.send(None)
    want_sid, want_rel, want_seg = [], [], []
    sid, shot_len, seg = 0, 0, 0
    for t in _FakeVideo().timestamps():
        if gen.send(float(t)):
            seg += 1
            if shot_len:
                sid += 1
                shot_len = 0
        want_sid.append(sid)
        want_rel.append(shot_len)
        want_seg.append(seg)
        shot_len += 1
        if shot_len >= max_shot:
            sid += 1
            shot_len = 0
    np.testing.assert_array_equal(shot_id, np.asarray(want_sid))
    np.testing.assert_array_equal(detect, np.asarray(want_rel) % every == 0)
    np.testing.assert_array_equal(segment, np.asarray(want_seg))


@pytest.mark.parametrize("keep", [None, "even", "odd", "none"])
@pytest.mark.parametrize("case", ["memory splits", "empty segments",
                                  "split lands on a boundary"])
@pytest.mark.parametrize("batch", [7, 64])
def test_shot_assembler_gives_the_jax_shots(case, keep, batch):
    segs, max_shot, every = PLAN_CASES[case]
    video = _FakeVideo()
    shot_id, detect, _ = streaming._shot_plan(
        video, [Segment(s, e) for s, e in segs], max_shot, every)
    keep_sid = {None: None, "none": set(),
                "even": {int(s) for s in np.unique(shot_id) if s % 2 == 0},
                "odd": {int(s) for s in np.unique(shot_id) if s % 2 == 1}}[keep]
    grays = np.random.default_rng(0).uniform(
        0, 255, (len(shot_id), 4, 6)).astype(np.float32)
    ts = video.timestamps()
    ours = streaming._ShotAssembler(shot_id, keep_sid)
    theirs = jstreaming._ShotAssembler(shot_id, keep_sid)
    out, ref = [], []
    for base in range(0, len(ts), batch):
        n = min(batch, len(ts) - base)
        dets = {int(i): [(float(base + i), 1.0, 2.0, 3.0)]
                for i in np.nonzero(detect[base:base + n])[0]}
        out += ours.add_batch(base, ts[base:base + n], n,
                              torch.from_numpy(grays[base:base + n]), dets)
        # the JAX assembler is fed padded batches; n_valid bounds its walk
        ref += theirs.add_batch(base, ts[base:base + n], n,
                                jnp.asarray(grays[base:base + n]), dict(dets))
    out += ours.finish()
    ref += theirs.finish()
    assert len(out) == len(ref)
    kept = (len(np.unique(shot_id)) if keep_sid is None else len(keep_sid))
    assert len(out) == kept
    for (g, t, d), (g_r, t_r, d_r) in zip(out, ref):
        assert isinstance(g, torch.Tensor)
        np.testing.assert_array_equal(g.numpy(), np.asarray(g_r))
        np.testing.assert_array_equal(t, t_r)
        assert d == d_r and len(t) == len(g) <= max_shot
    assert ours.finish() == []


def test_a_kept_gray_chunk_is_never_the_plane_it_came_from():
    y = torch.randint(0, 255, (5, 4, 6), dtype=torch.uint8)
    gray = streaming._gray_prog(y)
    assert gray.dtype == torch.float32 and gray.data_ptr() != y.data_ptr()


# -- the detector's tail -------------------------------------------------------


def test_streaming_detections_are_detect_batch_of_the_same_rgb(episode):
    """The streaming path feeds float RGB to ``candidates`` and shares
    ``select`` with ``detect_batch``: the same RGB gives the same boxes."""
    det = FaceDetector(device="cpu")
    y, u, v = (torch.from_numpy(p) for p in rgb_to_yuv420(episode.frames[:24:5]))
    idx = torch.tensor([0, 2, 4])
    rgb = streaming._det_rgb_prog(y, u, v, idx)
    np.testing.assert_array_equal(
        rgb.numpy(), yuv420_to_rgb(y, u, v).numpy()[[0, 2, 4]])
    scores, boxes = det.candidates(rgb)
    streamed = [det.select(s, b) for s, b in zip(scores.numpy(), boxes.numpy())]
    # detect_batch takes uint8: give it the same values, rounded, on both sides
    rounded = rgb.round().to(torch.uint8)
    scores, boxes = det.candidates(rounded.to(torch.float32))
    assert ([det.select(s, b) for s, b in zip(scores.numpy(), boxes.numpy())]
            == det.detect_batch(rounded.numpy()))
    assert all(len(b) == 1 for b in streamed)
    for found, f in zip(streamed, (0, 10, 20)):
        gt = episode.faces_at(f)[0].box
        assert np.abs(np.asarray(found[0]) - np.asarray(gt)).max() < 12.0


# -- track: the slice against the JAX package ----------------------------------


def _per_batch_detection_frames(episode, batch, every=5):
    video = Video(episode.frames, fps=episode.fps)
    _, detect, _ = streaming._shot_plan(
        video, [Segment(s, e) for s, e in episode.shots], 2000, every)
    return [list(base + np.nonzero(detect[base:base + batch])[0])
            for base in range(0, len(detect), batch)]


def _canned(episode, frames, rows):
    """Two candidates per frame: the true box, and a copy 3 px off with a
    lower score, which NMS must drop; rows beyond ``frames`` score below
    any threshold."""
    scores = np.full((rows, 2), -1e9, np.float32)
    boxes = np.zeros((rows, 2, 4), np.float32)
    for k, f in enumerate(frames):
        box = np.asarray(episode.faces_at(int(f))[0].box, np.float32)
        scores[k] = (10.0, 9.0)
        boxes[k] = (box, box + 3.0)
    return scores, boxes


def _stub_detectors(episode, batch):
    """A detector of each package whose candidates are the episode's true
    boxes, batch after batch in the order the streaming paths ask."""
    from pyannote_video_tpu.models.detector import FaceDetector as JFaceDetector

    plan = _per_batch_detection_frames(episode, batch)
    plan = [frames for frames in plan if frames]

    ours, calls = FaceDetector(device="cpu"), iter(plan)

    def candidates(det_rgb):
        scores, boxes = _canned(episode, next(calls), det_rgb.shape[0])
        return torch.from_numpy(scores), torch.from_numpy(boxes)

    ours.candidates = candidates

    theirs, jcalls = JFaceDetector(), iter(plan)

    def pyramid(params, det_rgb):
        scores, boxes = _canned(episode, next(jcalls), det_rgb.shape[0])
        return jnp.asarray(scores), jnp.asarray(boxes)

    theirs._pyramid_fn = lambda fh, fw: pyramid
    return ours, theirs


def _both_stream_tracks(episode, ours=None, theirs=None, **kwargs):
    engine = FaceTracking(detect_every=0.2, track_max_gap=1.0, device="cpu",
                          **kwargs)
    engine._batch_detector = ours
    legs = streaming.StreamLegs()
    out = list(streaming.stream_tracks(
        engine, Video(episode.frames, fps=episode.fps),
        [Segment(s, e) for s, e in episode.shots], legs=legs))
    jengine = JFaceTracking(detect_every=0.2, track_max_gap=1.0, **kwargs)
    jengine._batch_detector = theirs
    jlegs = jstreaming.StreamLegs()
    ref = list(jstreaming.stream_tracks(
        jengine, JVideo(episode.frames, fps=episode.fps),
        [JSegment(s, e) for s, e in episode.shots], legs=jlegs))
    return out, ref, legs, jlegs


@pytest.mark.parametrize("batch", [64, 8])
def test_same_detections_give_the_jax_tracks(episode, monkeypatch, batch):
    """Batches of 8 put both cuts inside a batch and let every shot span
    two or three of them."""
    monkeypatch.setattr(streaming, "TRACK_BATCH", batch)
    monkeypatch.setattr(jstreaming, "TRACK_BATCH", batch)
    out, ref, legs, jlegs = _both_stream_tracks(
        episode, *_stub_detectors(episode, batch))
    assert len(out) == len(ref) == 2
    scale = np.asarray([W, H, W, H])
    for trk_o, trk_r in zip(out, ref):
        assert [(t, s) for t, _, s in trk_o] == [(t, s) for t, _, s in trk_r]
        box_o = np.asarray([b for _, b, _ in trk_o]) * scale
        box_r = np.asarray([b for _, b, _ in trk_r]) * scale
        assert np.abs(box_o - box_r).max() <= 1.0 + 1e-6
        assert (np.abs(box_o - box_r) < 1e-6).mean() >= 0.9
    assert legs.frames == jlegs.frames == 24
    assert legs.batches == jlegs.batches == -(-24 // batch)
    # the JAX path pads its last batch to the batch size; the port ships
    # what there is
    assert legs.bytes_shipped == 24 * W * H * 3 // 2 <= jlegs.bytes_shipped
    assert set(legs.as_dict()) == set(jlegs.as_dict())


def test_each_packaged_detector_gives_the_jax_structure(episode):
    out, ref, _, _ = _both_stream_tracks(episode)
    assert len(out) == len(ref) > 0
    box_o, box_r = [], []
    for trk_o, trk_r in zip(out, ref):
        assert [(round(t, 3), s) for t, _, s in trk_o] == [
            (round(t, 3), s) for t, _, s in trk_r]
        box_o += [b for _, b, _ in trk_o]
        box_r += [b for _, b, _ in trk_r]
    err = np.abs(np.asarray(box_o) - np.asarray(box_r)).max(axis=1)
    assert np.median(err) <= 4 * BOX_TOL, err * 120
    assert err.max() <= 21.0 / 120.0, err * 120
    cut = episode.cuts[0]
    for trk in out:
        ts = [t for t, _, _ in trk]
        assert max(ts) < cut or min(ts) >= cut


def test_stream_tracks_needs_the_batched_detector(episode):
    engine = FaceTracking(detect_every=0.2, device="cpu")
    engine.detect_func = lambda frame: []
    with pytest.raises(ValueError, match="per-shot"):
        streaming.stream_tracks(engine, Video(episode.frames[:4]), [])


def test_even_working_size_and_frame_size_restored(episode, monkeypatch):
    """``detect_min_size`` scales the working frames; the streaming path
    rounds them down to even sizes and puts ``frame_size`` back."""
    video = Video(episode.frames[:10], fps=episode.fps)
    engine = FaceTracking(detect_min_size=0.3876, detect_every=0.2,
                          device="cpu")
    ratio = engine.detect_smallest / (engine.detect_min_size * H)
    assert (int(W * ratio), int(H * ratio)) == (137, 103)
    seen = []
    real = streaming.pack_yuv420
    monkeypatch.setattr(streaming, "pack_yuv420",
                        lambda f: (seen.append(f.shape), real(f))[1])
    tracks = list(streaming.stream_tracks(engine, video,
                                          [Segment(0, 10 / 25.0)]))
    assert video.frame_size == [W, H]
    assert seen == [(10, 102, 136, 3)]
    assert tracks and all(0.0 <= v <= 1.0 for trk in tracks
                          for _, box, _ in trk for v in box)
    # restored after an error on the way, too
    monkeypatch.setattr(streaming, "pack_yuv420",
                        lambda f: (_ for _ in ()).throw(RuntimeError("packer")))
    with pytest.raises(RuntimeError, match="packer"):
        list(streaming.stream_tracks(engine, video, [Segment(0, 10 / 25.0)]))
    assert video.frame_size == [W, H]


# -- track and extract: the port's two engines, and the CLI --------------------


@pytest.fixture(scope="module")
def tracked(episode, shot_json, tmp_path_factory):
    """``track`` by both engines of the port, with the legs of the first."""
    import os

    d = tmp_path_factory.mktemp("torch_streaming_track")
    legs = streaming.StreamLegs()
    saved = os.environ.pop("PYV_NO_STREAM", None)
    try:
        face_cli.track(Video(episode.frames, fps=episode.fps), shot_json,
                       str(d / "stream.txt"), detect_every=0.2, legs=legs,
                       device="cpu")
        os.environ["PYV_NO_STREAM"] = "1"
        face_cli.track(Video(episode.frames, fps=episode.fps), shot_json,
                       str(d / "per_shot.txt"), detect_every=0.2, device="cpu")
    finally:
        os.environ.pop("PYV_NO_STREAM", None)
        if saved is not None:
            os.environ["PYV_NO_STREAM"] = saved
    return str(d / "stream.txt"), str(d / "per_shot.txt"), legs, d


def test_track_parity(tracked):
    stream_txt, per_shot_txt, _, _ = tracked
    a = formats.read_tracking(stream_txt)
    b = formats.read_tracking(per_shot_txt)
    assert len(a) == len(b) > 0
    assert ([(round(p.t, 3), p.identifier, p.status) for p in a]
            == [(round(p.t, 3), p.identifier, p.status) for p in b])
    ba = np.asarray([[p.left, p.top, p.right, p.bottom] for p in a])
    bb = np.asarray([[p.left, p.top, p.right, p.bottom] for p in b])
    err = np.abs(ba - bb).max(axis=1)
    # gray from the quantised luma moves a DSST peak by ~1 px; a detection
    # on the YUV round trip may be another candidate of the same face
    assert np.median(err) <= 4 * BOX_TOL, err * 120
    assert err.max() <= 21.0 / 120.0, err * 120


def test_track_parity_from_the_same_detections(episode, monkeypatch):
    """With the detections held equal the two engines differ only in their
    gray (decoded luma against float BT.601): boxes within 2.5/120."""
    ours, _ = _stub_detectors(episode, 64)
    engine = FaceTracking(detect_every=0.2, track_max_gap=1.0, device="cpu")
    engine._batch_detector = ours
    segs = [Segment(s, e) for s, e in episode.shots]
    streamed = list(streaming.stream_tracks(
        engine, Video(episode.frames, fps=episode.fps), segs))
    truth = {f.tobytes(): [tuple(float(v) for v in episode.faces_at(i)[0].box)]
             for i, f in enumerate(episode.frames)}
    per_shot_engine = FaceTracking(detect_every=0.2, track_max_gap=1.0,
                                   device="cpu")
    per_shot_engine.detect_func = lambda frame: truth[frame.tobytes()]
    per_shot = list(per_shot_engine(
        Video(episode.frames, fps=episode.fps), segs))
    assert len(streamed) == len(per_shot) == 2
    for trk_s, trk_p in zip(streamed, per_shot):
        assert [(t, s) for t, _, s in trk_s] == [(t, s) for t, _, s in trk_p]
        np.testing.assert_allclose(
            np.asarray([b for _, b, _ in trk_s]),
            np.asarray([b for _, b, _ in trk_p]), atol=BOX_TOL)


def test_stream_legs_add_up(tracked):
    """Main-thread legs (feed_wait + dispatch + sync + scan + host) ≈ wall."""
    _, _, legs, _ = tracked
    d = legs.as_dict()
    assert d["frames"] == 24 and d["batches"] == 1
    main = (d["feed_wait_s"] + d["dispatch_s"] + d["sync_s"]
            + d["scan_s"] + d["host_s"])
    assert abs(main - d["wall_s"]) < 0.15 * d["wall_s"] + 0.25
    assert d["main_thread_s"] == pytest.approx(main, abs=5e-3)
    assert d["pack_s"] > 0 and d["shipped_gb"] == round(24 * W * H * 1.5 / 1e9, 3)


def test_track_file_is_the_jax_streaming_file_in_structure(tracked, episode,
                                                           shot_json, tmp_path):
    """The CLI functions of both packages on their default paths."""
    stream_txt, _, _, _ = tracked
    jout = str(tmp_path / "jax.txt")
    jface_cli.track(JVideo(episode.frames, fps=episode.fps), shot_json, jout,
                    detect_every=0.2)
    a, b = formats.read_tracking(stream_txt), jformats.read_tracking(jout)
    assert ([(round(p.t, 3), p.identifier, p.status) for p in a]
            == [(round(p.t, 3), p.identifier, p.status) for p in b])


class _F32Forward:
    """``jembedder.forward`` with float32 convs, as the port is asked to run."""

    def __init__(self):
        self._real = jembedder.forward

    def __call__(self, params, chips, **kwargs):
        kwargs["compute_dtype"] = jnp.float32
        return self._real(params, chips, **kwargs)


@pytest.fixture(scope="module")
def extracted(tracked, episode):
    """``extract`` on the streamed tracking file: the port's two engines and
    the JAX package's default (streaming) one, float32 embedders."""
    import os

    stream_txt, _, _, d = tracked
    paths = {k: str(d / k) for k in ("lm", "emb", "clm", "cemb", "jlm", "jemb",
                                     "xlm", "xemb")}
    legs = streaming.StreamLegs()
    video = lambda: Video(episode.frames, fps=episode.fps)
    saved = os.environ.pop("PYV_NO_STREAM", None)
    patch = pytest.MonkeyPatch()
    try:
        face_cli.extract(video(), "", "", stream_txt, paths["lm"], paths["emb"],
                         legs=legs, device="cpu", compute_dtype=torch.float32)
        face_cli.extract(video(), "", "", stream_txt, paths["xlm"],
                         paths["xemb"], exact_chips=True, device="cpu",
                         compute_dtype=torch.float32)
        patch.setattr(jstreaming, "pack_yuv420", j_rgb_to_yuv420)
        patch.setattr(jembedder, "forward", _F32Forward())
        jface_cli.extract(JVideo(episode.frames, fps=episode.fps), "", "",
                          stream_txt, paths["jlm"], paths["jemb"])
        os.environ["PYV_NO_STREAM"] = "1"
        face_cli.extract(video(), "", "", stream_txt, paths["clm"],
                         paths["cemb"], device="cpu",
                         compute_dtype=torch.float32)
    finally:
        patch.undo()
        os.environ.pop("PYV_NO_STREAM", None)
        if saved is not None:
            os.environ["PYV_NO_STREAM"] = saved
    return paths, legs, stream_txt


def _landmarks(path):
    rows = formats.read_landmarks(path)
    return [(t, i) for t, i, _ in rows], np.stack([lm for _, _, lm in rows])


def test_extract_lines_in_file_order(extracted):
    paths, legs, stream_txt = extracted
    points = formats.read_tracking(stream_txt)
    want = [(round(p.t, 3), p.identifier) for _, group in
            formats.iter_tracking_by_time(points) for p in group]
    for key in ("lm", "clm", "jlm", "xlm"):
        assert _landmarks(paths[key])[0] == want
    for key in ("emb", "cemb", "jemb", "xemb"):
        t, i, X = formats.read_embeddings(paths[key])
        assert list(zip(t.tolist(), i.tolist())) == want
        assert X.shape == (len(points), 128)
        np.testing.assert_allclose(np.linalg.norm(X, axis=1), 1.0, atol=1e-3)
    assert legs.frames == 24 and legs.wall_s > 0 and legs.dispatch_s > 0


def test_extract_matches_the_jax_streaming_extract(extracted):
    paths, _, _ = extracted
    _, ref_lm = _landmarks(paths["jlm"])
    _, out_lm = _landmarks(paths["lm"])
    err = (np.abs(out_lm - ref_lm) * [W, H]).max(axis=(1, 2))
    same = err <= LANDMARK_TOL + 1e-5 * W     # the files hold 5 decimals
    assert same.mean() >= 0.9, err
    assert err.max() <= 1.0, err
    _, _, ref = formats.read_embeddings(paths["jemb"])
    _, _, out = formats.read_embeddings(paths["emb"])
    # chips cut from the YUV planes: where the landmarks agree so do they
    assert np.abs(out - ref)[same].max() <= 1e-3
    assert np.linalg.norm(out - ref, axis=1).max() <= 0.05


def test_extract_parity(extracted):
    """Streaming against chunked: crops from the luma's gray against crops
    from the RGB frame's, chips from subsampled chroma against RGB chips."""
    paths, _, _ = extracted
    _, lm_s = _landmarks(paths["lm"])
    _, lm_c = _landmarks(paths["clm"])
    np.testing.assert_allclose(lm_s, lm_c, atol=0.02)
    _, _, X_s = formats.read_embeddings(paths["emb"])
    _, _, X_c = formats.read_embeddings(paths["cemb"])
    cos = (X_s * X_c).sum(1) / (
        np.linalg.norm(X_s, axis=1) * np.linalg.norm(X_c, axis=1) + 1e-9)
    assert cos.min() > 0.97, cos


def test_exact_chips_come_from_the_planes_too(extracted):
    paths, _, _ = extracted
    _, _, a = formats.read_embeddings(paths["emb"])
    _, _, b = formats.read_embeddings(paths["xemb"])
    assert a.shape == b.shape and np.abs(a - b).max() > 1e-4
    np.testing.assert_array_equal(_landmarks(paths["xlm"])[1],
                                  _landmarks(paths["lm"])[1])


def test_extract_prog_packs_landmarks_then_embeddings(episode):
    from pyannote_video_tpu_torch.models.embedder import FaceEmbedder
    from pyannote_video_tpu_torch.models.landmarks import LandmarkPredictor

    predictor = LandmarkPredictor(device="cpu")
    embedder = FaceEmbedder(device="cpu", compute_dtype=torch.float32)
    y, u, v = (torch.from_numpy(p) for p in rgb_to_yuv420(episode.frames[:4]))
    fidx = torch.tensor([0, 3, 3])
    boxes = torch.tensor([episode.faces_at(f)[0].box for f in (0, 3, 3)],
                         dtype=torch.float32)
    packed = streaming.extract_prog(predictor, embedder, y, u, v, fidx, boxes)
    assert packed.shape == (3, 68 * 2 + 128)
    np.testing.assert_array_equal(packed[1].numpy(), packed[2].numpy())
    # a face's result does not depend on its batch: nothing is padded
    alone = streaming.extract_prog(predictor, embedder, y, u, v, fidx[:1],
                                   boxes[:1])
    np.testing.assert_allclose(alone.numpy(), packed[:1].numpy(), atol=1e-5)


@pytest.mark.parametrize("no_stream,engine", [("0", "stream_extract"),
                                              ("1", "_extract_chunked")])
def test_extract_takes_its_engine_from_the_environment(
        monkeypatch, tmp_path, episode, tracked, no_stream, engine):
    monkeypatch.setenv("PYV_NO_STREAM", no_stream)
    called = []
    monkeypatch.setattr(streaming, "stream_extract",
                        lambda *a, **k: called.append("stream_extract") or iter(()))
    monkeypatch.setattr(face_cli, "_extract_chunked",
                        lambda *a, **k: called.append("_extract_chunked"))
    face_cli.extract(Video(episode.frames, fps=episode.fps), "", "", tracked[0],
                     str(tmp_path / "l"), str(tmp_path / "e"), device="cpu")
    assert called == [engine]


@pytest.mark.parametrize("argv", [
    ["demo", "clip.avi", "tracking.txt", "out.avi"],
    ["demo", "--world=2", "--height=200", "clip.avi", "tracking.txt", "out.avi"]])
def test_only_demo_still_exits_nonzero(argv, monkeypatch):
    """``demo`` is ported: no command exits non-zero for being unported,
    and ``demo`` takes its own flags (``--world`` belongs to ``track``)."""
    calls = {}
    monkeypatch.setattr(face_cli, "demo",
                        lambda *a, **k: calls.update(args=a, kwargs=k))
    face_cli.main(argv, device="cpu")
    assert calls["args"] == ("clip.avi", "tracking.txt", "out.avi")
    assert calls["kwargs"]["height"] == (200 if "--height=200" in argv else 400)
