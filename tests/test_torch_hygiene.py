"""Rules of the PyTorch port that no parity test would catch.

* No module of ``pyannote_video_tpu_torch``, not ``chip_smoke.py`` and not
  the scripts that run on the card imports ``jax`` or ``pyannote_video_tpu``.
* Entry points called without ``device`` on a machine without CUDA raise;
  they never run on the CPU unasked.
* The tracking scan's bodies, the extract stage's device functions and the
  streaming path's device functions hold no call that waits for the device.
* No module of the port imports ``cv2`` when it is imported.
"""

import ast
import inspect
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "pyannote_video_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "scripts" / "torch_profile.py",
    ROOT / "scripts" / "dfd_probe.py", ROOT / "scripts" / "stream_ab.py"]
FORBIDDEN = ("jax", "jaxlib", "pyannote_video_tpu")


def _imported(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = [m for m in _imported(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


@pytest.mark.parametrize(
    "path", sorted((ROOT / "pyannote_video_tpu_torch").rglob("*.py")),
    ids=lambda p: str(p.relative_to(ROOT)))
def test_no_cv2_import_at_module_level(path):
    """The machine with the card has no OpenCV: it is imported inside the
    functions that need it, never when a module is imported."""
    top = [node for node in ast.parse(path.read_text(), str(path)).body
           if isinstance(node, (ast.Import, ast.ImportFrom))]
    bad = [n for node in top for n in (
        [a.name for a in node.names] if isinstance(node, ast.Import)
        else [node.module or ""]) if n.split(".")[0] == "cv2"]
    assert not bad, f"{path.name} imports cv2 at module level"


def _frames():
    return np.zeros((4, 48, 64, 3), np.uint8)


def _shot():
    from pyannote_video_tpu_torch.io.video import Video
    from pyannote_video_tpu_torch.pipeline.shot import Shot

    Shot(Video(_frames()))


def _detector():
    from pyannote_video_tpu_torch.models.detector import FaceDetector

    FaceDetector()


def _do_shot(tmp_path):
    from pyannote_video_tpu_torch.cli.structure_cli import do_shot
    from pyannote_video_tpu_torch.io.video import Video

    do_shot(Video(_frames()), str(tmp_path / "out.json"))


def _main(tmp_path):
    from pyannote_video_tpu_torch.cli.structure_cli import main

    main(["shot", str(tmp_path / "missing.avi"), str(tmp_path / "out.json")])


def _tracking_by_detection():
    from pyannote_video_tpu_torch.pipeline.tracking import TrackingByDetection

    TrackingByDetection(detect_func=lambda frame: [])


def _face_tracking():
    from pyannote_video_tpu_torch.pipeline.face_tracking import FaceTracking

    FaceTracking()


def _face_track(tmp_path):
    from pyannote_video_tpu_torch.cli.face_cli import track
    from pyannote_video_tpu_torch.io.video import Video

    track(Video(_frames()), str(tmp_path / "missing.json"),
          str(tmp_path / "out.json"))


def _face_main(tmp_path):
    from pyannote_video_tpu_torch.cli.face_cli import main

    main(["track", str(tmp_path / "missing.avi"),
          str(tmp_path / "missing.json"), str(tmp_path / "out.json")])


def _landmark_predictor():
    from pyannote_video_tpu_torch.models.landmarks import LandmarkPredictor

    LandmarkPredictor()


def _face_embedder():
    from pyannote_video_tpu_torch.models.embedder import FaceEmbedder

    FaceEmbedder()


def _face_extract(tmp_path):
    from pyannote_video_tpu_torch.cli.face_cli import extract
    from pyannote_video_tpu_torch.io.video import Video

    extract(Video(_frames()), "", "", str(tmp_path / "missing.txt"),
            str(tmp_path / "out.json"), str(tmp_path / "out2.json"))


def _face_main_extract(tmp_path):
    from pyannote_video_tpu_torch.cli.face_cli import main

    main(["extract", str(tmp_path / "missing.avi"),
          str(tmp_path / "missing.txt"), "", "", str(tmp_path / "out.json"),
          str(tmp_path / "out2.json")])


def _face_clustering():
    from pyannote_video_tpu_torch.pipeline.clustering import FaceClustering

    FaceClustering()


def _face():
    from pyannote_video_tpu_torch.pipeline.face import Face

    Face()


def _run_stream():
    from pyannote_video_tpu_torch.io.stream import run_stream

    run_stream([(np.arange(4.0), _frames())], lambda c, ts, y, u, v: (c, y), None)


def _isolate_legs():
    from pyannote_video_tpu_torch.io.stream import isolate_legs

    isolate_legs([(np.arange(4.0), _frames())], lambda c, ts, y, u, v: (c, y),
                 None)


def _device_batches():
    from pyannote_video_tpu_torch.io.batch import device_batches
    from pyannote_video_tpu_torch.io.video import Video

    device_batches(Video(_frames()), 2)


def _prefetch_to_device():
    from pyannote_video_tpu_torch.io.batch import prefetch_to_device

    prefetch_to_device([_frames()])


def _stream_tracks(monkeypatch):
    """An engine made when there was a card, used when there is none."""
    from pyannote_video_tpu_torch.io.video import Video
    from pyannote_video_tpu_torch.pipeline.face_tracking import FaceTracking
    from pyannote_video_tpu_torch.pipeline.streaming import stream_tracks

    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: True)
        engine = FaceTracking()
    stream_tracks(engine, Video(_frames()), [])


def _stream_extract():
    from types import SimpleNamespace

    from pyannote_video_tpu_torch.io.video import Video
    from pyannote_video_tpu_torch.pipeline.streaming import stream_extract

    on_card = SimpleNamespace(device=torch.device("cuda"))
    stream_extract(Video(_frames()), [], on_card, on_card)


@pytest.mark.parametrize("entry", ["Shot", "FaceDetector", "do_shot", "main",
                                   "TrackingByDetection", "FaceTracking",
                                   "face_cli.track", "face_cli.main",
                                   "LandmarkPredictor", "FaceEmbedder",
                                   "face_cli.extract", "face_cli.main extract",
                                   "FaceClustering", "Face", "run_stream",
                                   "isolate_legs", "device_batches",
                                   "prefetch_to_device", "stream_tracks",
                                   "stream_extract"])
def test_entry_points_need_cuda_unless_asked_for_cpu(entry, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    call = {"Shot": _shot, "FaceDetector": _detector,
            "do_shot": lambda: _do_shot(tmp_path),
            "main": lambda: _main(tmp_path),
            "TrackingByDetection": _tracking_by_detection,
            "FaceTracking": _face_tracking,
            "face_cli.track": lambda: _face_track(tmp_path),
            "face_cli.main": lambda: _face_main(tmp_path),
            "LandmarkPredictor": _landmark_predictor,
            "FaceEmbedder": _face_embedder,
            "face_cli.extract": lambda: _face_extract(tmp_path),
            "face_cli.main extract": lambda: _face_main_extract(tmp_path),
            "FaceClustering": _face_clustering, "Face": _face,
            "run_stream": _run_stream, "isolate_legs": _isolate_legs,
            "device_batches": _device_batches,
            "prefetch_to_device": _prefetch_to_device,
            "stream_tracks": lambda: _stream_tracks(monkeypatch),
            "stream_extract": _stream_extract}[entry]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()
    assert not (tmp_path / "out.json").exists()
    assert not (tmp_path / "out2.json").exists()


SYNCING_CALLS = (".item(", ".cpu(", ".tolist(", ".nonzero(", "bool(",
                 ".numpy(", "torch.tensor(")


@pytest.mark.parametrize("name", ["shot_scan", "_det_branch", "_step_core",
                                  "_psr", "_optimal_match", "_jv_match",
                                  "restart_slots", "_filter_init_from_boxes"])
def test_scan_bodies_never_wait_for_the_device(name):
    """A pass is enqueued whole: nothing in the scan reads a device value
    on the host or builds a tensor from host data per frame."""
    from pyannote_video_tpu_torch.ops import dsst

    source = inspect.getsource(getattr(dsst, name))
    code = "\n".join(line.split("#")[0] for line in source.splitlines())
    found = [call for call in SYNCING_CALLS if call in code]
    assert not found, f"dsst.{name} calls {found}"


def _extract_bodies():
    from pyannote_video_tpu_torch.models import chip, embedder, landmarks, nn
    from pyannote_video_tpu_torch.ops import distance, warp

    return {
        "landmarks.predict_cascade": landmarks.predict_cascade,
        "landmarks.predict_crops": landmarks.predict_crops,
        "landmarks._stage_features": landmarks._stage_features,
        "landmarks._similarity_to_current": landmarks._similarity_to_current,
        "embedder.forward": embedder.forward,
        "nn.resblock": nn.resblock,
        "chip.chip_transforms": chip.chip_transforms,
        "chip._axis_aligned": chip._axis_aligned,
        "chip.extract_chips": chip.extract_chips,
        "chip.extract_chips_exact": chip.extract_chips_exact,
        "chip.extract_chips_yuv": chip.extract_chips_yuv,
        "chip.box_to_landmarks": chip.box_to_landmarks,
        "warp.bilinear_sample": warp.bilinear_sample,
        "warp.gather_affine_warp": warp.gather_affine_warp,
        "warp.similarity_from_points": warp.similarity_from_points,
        "warp.invert_affine": warp.invert_affine,
        "distance.pairwise_sqdist": distance.pairwise_sqdist,
    }


@pytest.mark.parametrize("name", [
    "landmarks.predict_cascade", "landmarks.predict_crops",
    "landmarks._stage_features", "landmarks._similarity_to_current",
    "embedder.forward", "nn.resblock", "chip.chip_transforms",
    "chip._axis_aligned", "chip.extract_chips", "chip.extract_chips_exact",
    "chip.extract_chips_yuv", "chip.box_to_landmarks", "warp.bilinear_sample",
    "warp.gather_affine_warp", "warp.similarity_from_points",
    "warp.invert_affine", "distance.pairwise_sqdist"])
def test_extract_bodies_never_wait_for_the_device(name):
    """One batch of the extract stage is enqueued whole; its one read is in
    ``face_cli.extract``."""
    source = inspect.getsource(_extract_bodies()[name])
    code = "\n".join(line.split("#")[0] for line in source.splitlines())
    found = [call for call in SYNCING_CALLS if call in code]
    assert not found, f"{name} calls {found}"


def _streaming_bodies():
    from pyannote_video_tpu_torch.ops import color
    from pyannote_video_tpu_torch.pipeline import streaming

    return {
        "streaming._gray_prog": streaming._gray_prog,
        "streaming._det_rgb_prog": streaming._det_rgb_prog,
        "streaming.extract_prog": streaming.extract_prog,
        "color.yuv_luma_to_gray": color.yuv_luma_to_gray,
        "color.yuv420_to_rgb": color.yuv420_to_rgb,
    }


@pytest.mark.parametrize("name", [
    "streaming._gray_prog", "streaming._det_rgb_prog", "streaming.extract_prog",
    "color.yuv_luma_to_gray", "color.yuv420_to_rgb"])
def test_streaming_bodies_never_wait_for_the_device(name):
    """A streamed batch's device work is enqueued whole; its one read is in
    ``stream_tracks`` / ``stream_extract``."""
    source = inspect.getsource(_streaming_bodies()[name])
    code = "\n".join(line.split("#")[0] for line in source.splitlines())
    found = [call for call in SYNCING_CALLS if call in code]
    assert not found, f"{name} calls {found}"


@pytest.mark.parametrize("name,reads", [("_stream_tracks", 1),
                                        ("_stream_extract", 1)])
def test_streaming_loops_read_the_device_once_per_batch(name, reads):
    from pyannote_video_tpu_torch.pipeline import streaming

    source = inspect.getsource(getattr(streaming, name))
    code = "\n".join(line.split("#")[0] for line in source.splitlines())
    assert code.count(".cpu(") == reads, name
    assert not [call for call in (".item(", "bool(", "float(t", "torch.tensor(")
                if call in code]
