"""The port's tracking stage against the JAX package, on the CPU.

``TrackingByDetection`` of both packages on the episodes of
``tests/test_pipeline.py`` with the same injected detections: the same
tracks, timestamps and statuses.  Boxes are integers after ``_fix``'s
rounding and must be equal, except where a mean lands within 0.05 px of
.5 and the two packages' FFT rounding puts it on either side: there 1 px.
The CLI's tracking file is read back by the JAX package's parser.
"""

import warnings

import numpy as np
import pytest

from pyannote_video_tpu import Video as JVideo
from pyannote_video_tpu.core import Segment as JSegment
from pyannote_video_tpu.core import formats as jformats
from pyannote_video_tpu.models.weights import DETECTOR_FILE
from pyannote_video_tpu.pipeline.tracking import (
    TrackingByDetection as JTracking,
)
from pyannote_video_tpu.utils.synthetic import synthetic_episode

from pyannote_video_tpu_torch.core import Segment, Timeline, dump, formats
from pyannote_video_tpu_torch.io.video import Video
from pyannote_video_tpu_torch.ops import dsst
from pyannote_video_tpu_torch.pipeline.tracking import TrackingByDetection

needs_weights = pytest.mark.skipif(
    not DETECTOR_FILE.exists(), reason="no trained detector weights")


def _iou(a, b):
    ix0, iy0 = max(a[0], b[0]), max(a[1], b[1])
    ix1, iy1 = min(a[2], b[2]), min(a[3], b[3])
    inter = max(0, ix1 - ix0) * max(0, iy1 - iy0)
    union = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter
    return inter / union if union > 0 else 0.0


def _run_both(frames, fps, detect_func, n_frames=None, **kwargs):
    """Tracks of both packages' engines from the same frames and detections."""
    T = len(frames) if n_frames is None else n_frames
    ref = list(JTracking(detect_func=detect_func, **kwargs)(
        JVideo(frames, fps=fps), [JSegment(0, T / fps)]))
    out = list(TrackingByDetection(detect_func=detect_func, device="cpu",
                                   **kwargs)(
        Video(frames, fps=fps), [Segment(0, T / fps)]))
    return out, ref


def _assert_same_tracks(out, ref, width, height):
    """Same tracks, timestamps and statuses; pixel boxes equal, or within
    1 px where ``_fix`` rounded a mean that sat on .5."""
    assert len(out) == len(ref)
    scale = np.asarray([width, height, width, height])
    for trk_o, trk_r in zip(out, ref):
        assert [(t, s) for t, _, s in trk_o] == [(t, s) for t, _, s in trk_r]
        box_o = np.asarray([b for _, b, _ in trk_o]) * scale
        box_r = np.asarray([b for _, b, _ in trk_r]) * scale
        assert np.abs(box_o - box_r).max() <= 1.0 + 1e-6
        # a 1 px difference is a rounding that fell on either side of .5,
        # never a moved box: almost every coordinate is equal
        assert (np.abs(box_o - box_r) < 1e-6).mean() >= 0.9


class TestAgainstJax:
    def test_custom_detect_func_compat(self):
        ep = synthetic_episode(n_shots=1, shot_frames=8, width=120, height=96,
                               seed=9, face_height_ratio=0.5)

        def oracle_detect(frame):
            for f in range(len(ep.frames)):
                if np.array_equal(frame, ep.frames[f]):
                    return [ep.faces_at(f)[0].box]
            return []

        out, ref = _run_both(ep.frames, ep.fps, oracle_detect,
                             detect_every=0.2)
        assert len(out) == 1 and len(out[0]) >= 6
        _assert_same_tracks(out, ref, 120, 96)

    def test_crossing_objects_no_identity_swap(self):
        rng = np.random.default_rng(12)
        H, W, T, S = 120, 240, 28, 40
        bg = rng.integers(0, 60, (H, W, 3), dtype=np.uint8)
        tex_a = rng.integers(120, 255, (S, S, 3), dtype=np.uint8)
        tex_a[:, ::4] = (255, 40, 40)
        tex_b = rng.integers(120, 255, (S, S, 3), dtype=np.uint8)
        tex_b[::4, :] = (40, 40, 255)
        frames = np.empty((T, H, W, 3), dtype=np.uint8)
        gt = []
        for f in range(T):
            img = bg.copy()
            ax, bx = 20 + 4 * f, 180 - 4 * f      # cross at f = 20
            img[20:20 + S, ax:ax + S] = tex_a
            img[44:44 + S, bx:bx + S] = tex_b
            frames[f] = img
            gt.append(((ax, 20, ax + S, 20 + S), (bx, 44, bx + S, 44 + S)))
        fmap = {frames[f].tobytes(): f for f in range(T)}

        def oracle_detect(frame):
            return list(gt[fmap[np.asarray(frame).tobytes()]])

        out, ref = _run_both(frames, 25.0, oracle_detect, detect_every=0.2,
                             track_max_gap=0.0, track_min_confidence=5.0)
        _assert_same_tracks(out, ref, W, H)
        assert len(out) == 2
        for trk in out:
            assert len(trk) >= T - 2
            xs = {round(t, 5): (box[0] + box[2]) / 2 * W for t, box, _ in trk}
            # no swap: the track that starts left ends right & vice versa
            assert (xs[min(xs)] < W / 2) == (xs[max(xs)] > W / 2)

    def test_two_concurrent_faces_with_injected_boxes(self):
        ep = synthetic_episode(n_shots=1, shot_frames=16, width=240,
                               height=160, seed=88, faces_per_shot=2,
                               n_identities=2, face_height_ratio=0.35)
        fmap = {ep.frames[f].tobytes(): f for f in range(len(ep.frames))}

        def oracle_detect(frame):
            f = fmap[np.asarray(frame).tobytes()]
            return [o.box for o in ep.faces_at(f)]

        out, ref = _run_both(ep.frames, ep.fps, oracle_detect,
                             detect_every=0.2, track_max_gap=1.0)
        assert len(out) == 2
        _assert_same_tracks(out, ref, 240, 160)
        statuses = {s for trk in out for _, _, s in trk}
        assert "detection" in statuses
        assert statuses <= {"detection", "forward", "backward",
                            "forward+backward", "forward+detection+backward",
                            "forward+detection", "detection+backward"}

    def test_detection_miss_bridged_by_tracking(self):
        T, W, H = 24, 240, 160
        ep = synthetic_episode(n_shots=1, shot_frames=T, width=W, height=H,
                               seed=77, face_height_ratio=0.4)
        fmap = {ep.frames[f].tobytes(): f for f in range(T)}

        def flaky_detect(frame):
            f = fmap[np.asarray(frame).tobytes()]
            return [] if f in (10, 15) else [o.box for o in ep.faces_at(f)]

        out, ref = _run_both(ep.frames, ep.fps, flaky_detect,
                             detect_every=0.2, track_max_gap=1.0)
        assert len(out) == 1 and len(out[0]) == T
        _assert_same_tracks(out, ref, W, H)

    def test_duplicate_detection_suppressed(self):
        rng = np.random.default_rng(5)
        H, W, T = 240, 320, 10
        frames = np.repeat(
            rng.integers(0, 255, (1, H, W, 3), dtype=np.uint8), T, axis=0)
        big = (100.0, 60.0, 200.0, 160.0)
        small = (125.0, 85.0, 175.0, 135.0)    # inside `big`, gate-failing

        def make_detect():
            calls = []

            def detect(_frame):
                calls.append(1)
                return [big] if len(calls) == 1 else [small]
            return detect

        kwargs = dict(detect_every=0.2, track_min_overlap_ratio=0.5)
        ref = list(JTracking(detect_func=make_detect(), **kwargs)(
            JVideo(frames, fps=25.0), [JSegment(0, T / 25.0)]))
        out = list(TrackingByDetection(detect_func=make_detect(),
                                       device="cpu", **kwargs)(
            Video(frames, fps=25.0), [Segment(0, T / 25.0)]))
        assert len(out) == 1
        _assert_same_tracks(out, ref, W, H)


class TestEngine:
    def test_crowd_scene_grows_slot_bucket(self):
        """>16 simultaneous objects: the 16→32 slot-bucket retry keeps every
        detection (20 detections per frame also take the wide matcher)."""
        rng = np.random.default_rng(4)
        H, W, T = 480, 640, 6
        frames = np.repeat(
            rng.integers(0, 255, (1, H, W, 3), dtype=np.uint8), T, axis=0)
        boxes = [(float(20 + c * 124), float(20 + r * 115),
                  float(110 + c * 124), float(100 + r * 115))
                 for r in range(4) for c in range(5)]
        tracking = TrackingByDetection(detect_func=lambda f: boxes,
                                       detect_every=0.2, max_tracks=16,
                                       device="cpu")
        slot_counts = []
        scan = dsst.shot_scan

        def counting_scan(state, *args, **kwargs):
            slot_counts.append(state.alive.shape[0])
            return scan(state, *args, **kwargs)

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr("pyannote_video_tpu_torch.ops.dsst.shot_scan",
                       counting_scan)
            with warnings.catch_warnings():
                warnings.simplefilter("error")   # no drop warning allowed
                tracks = list(tracking(Video(frames, fps=25.0),
                                       [Segment(0, T / 25.0)]))
        assert slot_counts == [16, 16, 32, 32]
        assert len(tracks) == 20
        t0_boxes = [tuple(np.asarray(p[1]) * (W, H, W, H))
                    for trk in tracks for p in trk if p[0] == 0.0]
        for b in boxes:
            assert any(_iou(b, tb) > 0.8 for tb in t0_boxes)

    def test_max_shot_frames_splits_with_a_warning(self):
        ep = synthetic_episode(n_shots=1, shot_frames=12, width=120,
                               height=96, seed=9, face_height_ratio=0.5)
        fmap = {ep.frames[f].tobytes(): f for f in range(12)}
        tracking = TrackingByDetection(
            detect_func=lambda fr: [ep.faces_at(fmap[fr.tobytes()])[0].box],
            detect_every=0.2, max_shot_frames=6, device="cpu")
        with pytest.warns(UserWarning, match="splitting for memory"):
            tracks = list(tracking(Video(ep.frames, fps=ep.fps),
                                   [Segment(0, 12 / ep.fps)]))
        assert len(tracks) == 2            # tracks break at the split
        assert max(t for t, _, _ in tracks[0]) < min(t for t, _, _ in tracks[1])

    def test_empty_video_segment(self):
        tracking = TrackingByDetection(detect_func=lambda f: [], device="cpu")
        frames = np.zeros((3, 48, 64, 3), np.uint8)
        assert list(tracking(Video(frames, fps=25.0), [Segment(0, 1)])) == []

    def test_lazy_names(self):
        import pyannote_video_tpu_torch as port
        from pyannote_video_tpu_torch.pipeline.face_tracking import FaceTracking

        assert port.TrackingByDetection is TrackingByDetection
        assert port.FaceTracking is FaceTracking
        assert issubclass(FaceTracking, TrackingByDetection)


@pytest.fixture(autouse=True)
def _refine_on(monkeypatch):
    # the JAX package's refiner trainer leaves this set in its pytest worker
    monkeypatch.delenv("PYV_NO_REFINE", raising=False)


@pytest.fixture(scope="module")
def face_episode():
    return synthetic_episode(n_shots=2, shot_frames=12, width=160, height=120,
                             seed=61, face_height_ratio=0.45)


@needs_weights
class TestFaceTracking:
    def test_structure_matches_jax_with_each_packaged_detector(self, face_episode):
        from pyannote_video_tpu.pipeline.face_tracking import (
            FaceTracking as JFaceTracking,
        )
        from pyannote_video_tpu_torch.pipeline.face_tracking import FaceTracking

        ep = face_episode
        ref = list(JFaceTracking(detect_every=0.2, track_max_gap=1.0)(
            JVideo(ep.frames, fps=ep.fps),
            [JSegment(s, e) for s, e in ep.shots]))
        out = list(FaceTracking(detect_every=0.2, track_max_gap=1.0,
                                device="cpu")(
            Video(ep.frames, fps=ep.fps), [Segment(s, e) for s, e in ep.shots]))
        assert len(out) == len(ref) > 0
        for trk_o, trk_r in zip(out, ref):
            assert [(round(t, 3), s) for t, _, s in trk_o] == [
                (round(t, 3), s) for t, _, s in trk_r]
            # each package's own bf16 detector: boxes agree, not bit for bit
            np.testing.assert_allclose(
                np.asarray([b for _, b, _ in trk_o]),
                np.asarray([b for _, b, _ in trk_r]), atol=2.5 / 120.0)
        # no track crosses the cut
        cut = ep.cuts[0]
        for trk in out:
            ts = [t for t, _, _ in trk]
            assert max(ts) < cut or min(ts) >= cut

    def test_detect_min_size_restores_frame_size(self, face_episode):
        from pyannote_video_tpu_torch.pipeline.face_tracking import FaceTracking

        ep = face_episode
        video = Video(ep.frames[:10], fps=ep.fps)
        tracking = FaceTracking(detect_min_size=0.45, detect_every=0.2,
                                device="cpu")
        tracks = list(tracking(video, [Segment(0, 10 / 25.0)]))
        assert video.frame_size == [160, 120]
        assert tracks
        gt = ep.faces_at(4)[0].box
        gtn = (gt[0] / 160, gt[1] / 120, gt[2] / 160, gt[3] / 120)
        best = max(_iou(box, gtn) for trk in tracks for (t, box, s) in trk
                   if abs(t - 4 / 25.0) < 1e-6)
        assert best > 0.4


@needs_weights
class TestFaceCLI:
    @pytest.fixture(scope="class")
    def clip(self, tmp_path_factory, face_episode):
        pytest.importorskip("cv2")
        from pyannote_video_tpu.utils.synthetic import write_synthetic_video

        d = tmp_path_factory.mktemp("torch_face_cli")
        path = str(d / "ep.avi")
        write_synthetic_video(path, face_episode)
        shot_json = str(d / "shot.json")
        with open(shot_json, "w") as fp:
            dump(Timeline([Segment(s, e) for s, e in face_episode.shots]), fp)
        return path, shot_json, d

    @pytest.fixture(scope="class")
    def tracked(self, clip):
        from pyannote_video_tpu_torch.cli.face_cli import main

        path, shot_json, d = clip
        out = str(d / "tracking.txt")
        main(["track", "--every=0.2", path, shot_json, out], device="cpu")
        return out

    def test_tracking_file_is_read_by_the_jax_parser(self, tracked, face_episode):
        points = jformats.read_tracking(tracked)
        assert points
        own = formats.read_tracking(tracked)
        assert [tuple(vars(p).values()) for p in own] == [
            tuple(vars(p).values()) for p in points]
        assert {p.identifier for p in points} == set(
            range(max(p.identifier for p in points) + 1))
        for p in points:
            assert set(p.status.replace("error(", "").replace(")", "")
                       .split("+")) <= {"forward", "detection", "backward"}
        # the face of every frame is covered by a track point
        n = len(face_episode.frames)
        hits = 0
        for f in range(n):
            gt = face_episode.faces_at(f)[0].box
            gtn = (gt[0] / 160, gt[1] / 120, gt[2] / 160, gt[3] / 120)
            hits += any(abs(p.t - f / face_episode.fps) < 1e-3 and _iou(
                (p.left, p.top, p.right, p.bottom), gtn) > 0.4 for p in points)
        assert hits >= n - 3

    def test_resume_keeps_finished_shots_verbatim(self, clip, tracked, tmp_path):
        from pyannote_video_tpu_torch.cli.face_cli import track

        path, shot_json, _ = clip
        lines = open(tracked).read().splitlines(keepends=True)
        cut = 12 / 25.0
        first = [ln for ln in lines if float(ln.split()[0]) < cut]
        second = [ln for ln in lines if float(ln.split()[0]) >= cut]
        assert first and second
        # interrupted in the second shot: its first few points were written
        partial = tmp_path / "partial.txt"
        partial.write_text("".join(first + second[:3]))
        track(Video(path), shot_json, str(partial), detect_every=0.2,
              resume=True, device="cpu")
        resumed = partial.read_text().splitlines(keepends=True)
        assert resumed[:len(first)] == first
        assert resumed == lines

    def test_shot_then_track_chained_through_files(self, clip, tmp_path):
        from pyannote_video_tpu_torch.cli.face_cli import main as face_main
        from pyannote_video_tpu_torch.cli.structure_cli import main as shot_main

        path, _, _ = clip
        shot_json = str(tmp_path / "shot.json")
        tracking = str(tmp_path / "tracking.txt")
        shot_main(["shot", "--threshold=2.0", path, shot_json], device="cpu")
        face_main(["track", "--every=0.2", path, shot_json, tracking],
                  device="cpu")
        points = jformats.read_tracking(tracking)
        assert points
        by_track = {}
        for p in points:
            by_track.setdefault(p.identifier, []).append(p.t)
        cut = 12 / 25.0
        assert all(max(ts) < cut or min(ts) >= cut for ts in by_track.values())
        assert any(max(ts) < cut for ts in by_track.values())
        assert any(min(ts) >= cut for ts in by_track.values())


class TestUnported:
    @pytest.mark.parametrize("argv,item", [
        (["demo", "v.avi", "t.txt", "o.avi"], "demo"),
        (["demo", "--world=2", "v.avi", "t.txt", "o.avi"], "demo"),
        (["demo", "--height=200", "--from=1", "v.avi", "t.txt", "o.avi"],
         "demo"),
    ])
    def test_unported_commands_exit_nonzero(self, argv, item, monkeypatch):
        """Every command is ported now: ``demo`` dispatches to its function
        with the JAX CLI's flags and returns (exit status 0)."""
        from pyannote_video_tpu_torch.cli import face_cli

        calls = []
        monkeypatch.setattr(face_cli, item,
                            lambda *a, **k: calls.append((a, k)))
        assert face_cli.main(argv, device="cpu") is None
        (args, kwargs), = calls
        assert args == ("v.avi", "t.txt", "o.avi")
        assert kwargs["t_start"] == (1.0 if "--from=1" in argv else 0.0)
        assert kwargs["t_end"] is None and kwargs["shift"] == 0.0

    def test_track_function_takes_world(self, tmp_path):
        """``world`` > 1 is ported: a worker writes its part file, and only
        rank 0 merges."""
        from pyannote_video_tpu_torch.cli.face_cli import track

        shot_json = tmp_path / "s.json"
        with open(shot_json, "w") as fp:
            dump(Timeline([Segment(0.0, 0.04), Segment(0.04, 0.08)]), fp)
        track(Video(np.zeros((2, 48, 64, 3), np.uint8)), str(shot_json),
              str(tmp_path / "t.txt"), rank=1, world=2, device="cpu")
        assert (tmp_path / "t.txt.part1").exists()
        assert not (tmp_path / "t.txt").exists()

    def test_usage_is_the_reference_text(self):
        from pyannote_video_tpu.cli import face_cli as jcli
        from pyannote_video_tpu_torch.cli import face_cli

        assert face_cli.USAGE == jcli.USAGE
