"""``pyannote-face demo`` of the port against the JAX CLI's, on the CPU.

``demo`` is host drawing over ``tracking.txt`` with OpenCV (no tensor), so
both CLIs must write the same video: on a small written synthetic clip with
tracking, landmarks and labels, every decoded frame is byte-equal.
"""

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from pyannote_video_tpu.cli import face_cli as jface_cli

from pyannote_video_tpu_torch.cli import face_cli
from pyannote_video_tpu_torch.core import formats
from pyannote_video_tpu_torch.utils.synthetic import (synthetic_episode,
                                                      write_synthetic_video)

W, H = 160, 120


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    """A 2-shot clip, its true faces as a tracking file (one track per
    shot, a point every other frame), their landmarks and labels."""
    tmp = tmp_path_factory.mktemp("demo")
    ep = synthetic_episode(n_shots=2, shot_frames=6, width=W, height=H,
                           seed=5, n_identities=2)
    video = str(tmp / "clip.avi")
    write_synthetic_video(video, ep)
    tracking, lms, labels = (str(tmp / n) for n in
                             ("tracking.txt", "landmarks.txt", "labels.txt"))
    scale = np.asarray([W, H], np.float32)
    with open(tracking, "w") as ft, open(lms, "w") as fl:
        for f in ep.faces:
            if f.frame % 2:
                continue
            t = f.frame / ep.fps
            track = f.frame // 6
            l, u, r, b = f.box
            formats.write_track_point(ft, formats.TrackPoint(
                t, track, l / W, u / H, r / W, b / H, "detection"))
            formats.write_landmarks_line(fl, t, track, f.landmarks / scale)
    formats.write_labels(labels, {0: "alice", 1: "bob"})
    return tmp, video, tracking, lms, labels


def _frames(path):
    cap = cv2.VideoCapture(path)
    out = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        out.append(frame)
    cap.release()
    return out


@pytest.mark.parametrize("flags", [
    [],
    ["--landmark={lms}", "--label={labels}", "--height=96"],
    ["--from=0.12", "--until=0.4", "--shift=0.04", "--landmark={lms}"],
])
def test_demo_writes_the_jax_clis_frames(clip, flags):
    tmp, video, tracking, lms, labels = clip
    flags = [f.format(lms=lms, labels=labels) for f in flags]
    ours, ref = str(tmp / "ours.avi"), str(tmp / "ref.avi")
    with pytest.warns(UserWarning, match="no ffmpeg"):
        assert face_cli.main(["demo", *flags, video, tracking, ours]) is None
    with pytest.warns(UserWarning, match="no ffmpeg"):
        jface_cli.main(["demo", *flags, video, tracking, ref])
    a, b = _frames(ours), _frames(ref)
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert x.shape == y.shape and np.array_equal(x, y)
    height = int(next((f.split("=")[1] for f in flags if f.startswith("--height")),
                      400))
    assert a[0].shape[0] == height
    # boxes were drawn: the demo differs from the clip itself
    assert any(not np.array_equal(x, y) for x, y in zip(a, _frames(video)))


def test_demo_function_matches_jax(clip):
    tmp, video, tracking, lms, labels = clip
    kw = dict(t_start=0.0, t_end=0.3, labels_path=labels, landmark_path=lms,
              height=120)
    with pytest.warns(UserWarning):
        face_cli.demo(video, tracking, str(tmp / "f_ours.avi"), **kw)
    with pytest.warns(UserWarning):
        jface_cli.demo(video, tracking, str(tmp / "f_ref.avi"), **kw)
    a, b = _frames(str(tmp / "f_ours.avi")), _frames(str(tmp / "f_ref.avi"))
    assert len(a) == len(b) == 8
    assert all(np.array_equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("n", [1, 26, 40])
def test_palette_matches_jax(n):
    assert face_cli._palette(n) == jface_cli._palette(n)
    assert face_cli.REFERENCE_COLORS == jface_cli.REFERENCE_COLORS
