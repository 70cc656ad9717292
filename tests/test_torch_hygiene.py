"""Rules of the PyTorch port that no parity test would catch.

* No module of ``pyannote_video_tpu_torch``, not ``chip_smoke.py`` and not
  the scripts that run on the card imports ``jax`` or ``pyannote_video_tpu``.
* Entry points called without ``device`` on a machine without CUDA raise;
  they never run on the CPU unasked.
* The tracking scan's bodies, the extract stage's device functions, the
  streaming path's device functions and the fused programs hold no call
  that waits for the device.
* No module of the port imports ``cv2`` when it is imported, and the
  trainers (``train/``) never import it: their data runs without OpenCV.
* The trainers' step functions hold no call that waits for the device; a
  mining refresh reads the device once (twice for the refiner's miner:
  candidates, then crops); no trainer's ``main`` writes into the JAX
  package.
* The host modules the port copies from the JAX package stay copies: the
  same code (docstrings aside), and the same answers on seeded inputs.
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
    ROOT / "scripts" / "dfd_probe.py", ROOT / "scripts" / "stream_ab.py",
    ROOT / "scripts" / "pyannote-face-torch.py",
    ROOT / "scripts" / "pyannote-structure-torch.py"]
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


def _thread():
    from pyannote_video_tpu_torch.io.video import Video
    from pyannote_video_tpu_torch.pipeline.thread import Thread

    Thread(Video(_frames()), shot=[])


def _do_thread(tmp_path):
    from pyannote_video_tpu_torch.cli.structure_cli import do_thread
    from pyannote_video_tpu_torch.io.video import Video

    do_thread(Video(_frames()), str(tmp_path / "missing.json"),
              str(tmp_path / "out.json"))


def _main_thread(tmp_path):
    from pyannote_video_tpu_torch.cli.structure_cli import main

    main(["thread", str(tmp_path / "missing.avi"),
          str(tmp_path / "missing.json"), str(tmp_path / "out.json")])


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


def _fused():
    from pyannote_video_tpu_torch.models.fused import FusedFacePipeline

    FusedFacePipeline()


def _entry():
    from pyannote_video_tpu_torch.entry import entry

    entry()


def _shot_scheduler():
    from pyannote_video_tpu_torch.parallel.scheduler import ShotScheduler

    ShotScheduler()


def _train_detector():
    from pyannote_video_tpu_torch.train.train_detector import train

    train(steps=1, mine=False)


def _train_embedder():
    from pyannote_video_tpu_torch.train.train_embedder import train

    train(steps=1, width=0.125)


def _train_refiner():
    from pyannote_video_tpu_torch.train.train_refiner import train

    train(steps=1)


def _hard_negative_miner():
    from pyannote_video_tpu_torch.train.mine import HardNegativeMiner

    HardNegativeMiner()


def _serve_miner():
    from pyannote_video_tpu_torch.train.train_refiner import ServeMiner

    ServeMiner()


def _train_main(module, tmp_path):
    import importlib

    importlib.import_module(f"pyannote_video_tpu_torch.train.{module}").main(
        ["1", str(tmp_path / "out.json")])


def _fresh_embedder():
    from pyannote_video_tpu_torch.models.embedder import FaceEmbedder

    FaceEmbedder(width=0.5)


def _dfd_pairs():
    from pyannote_video_tpu_torch.ops.dfd import dfd_pairs_reference_style

    dfd_pairs_reference_style(np.zeros((2, 10, 10)), np.zeros((2, 10, 10)))


def _make_mesh():
    from pyannote_video_tpu_torch.parallel.mesh import make_mesh

    make_mesh()


def _on_card_mesh():
    """A mesh made when there was a card, used when there is none."""
    from types import SimpleNamespace

    return SimpleNamespace(device_type="cuda")


def _sharded_embed_fn():
    from pyannote_video_tpu_torch.parallel.sharding import sharded_embed_fn

    sharded_embed_fn(_on_card_mesh())


def _make_train_step():
    from pyannote_video_tpu_torch.parallel.sharding import make_train_step
    from pyannote_video_tpu_torch.train.optim import Adam

    make_train_step(_on_card_mesh(), Adam([torch.zeros(2)], 1e-3))


def _run_dryrun():
    from pyannote_video_tpu_torch.parallel.dryrun import run_dryrun

    run_dryrun(1)


def _launch():
    from pyannote_video_tpu_torch.parallel.dryrun import launch

    launch(1, "pyannote_video_tpu_torch.parallel.dryrun:run_dryrun", (1,))


def _dryrun_multichip():
    from pyannote_video_tpu_torch.entry import dryrun_multichip

    dryrun_multichip(1)


def _evaluate():
    from pyannote_video_tpu_torch.evals.eval_synthetic import evaluate

    evaluate(n_shots=1, shot_frames=2, width=64, height=48)


def _probe():
    from pyannote_video_tpu_torch.evals.probe_detector import probe

    probe("A", seeds=(101,))


@pytest.mark.parametrize("entry", ["Shot", "FaceDetector", "do_shot", "main",
                                   "Thread", "do_thread", "main thread",
                                   "TrackingByDetection", "FaceTracking",
                                   "face_cli.track", "face_cli.main",
                                   "LandmarkPredictor", "FaceEmbedder",
                                   "face_cli.extract", "face_cli.main extract",
                                   "FaceClustering", "Face", "run_stream",
                                   "isolate_legs", "device_batches",
                                   "prefetch_to_device", "stream_tracks",
                                   "stream_extract", "FusedFacePipeline",
                                   "entry", "ShotScheduler",
                                   "dfd_pairs_reference_style",
                                   "train_detector.train",
                                   "train_embedder.train",
                                   "train_refiner.train", "HardNegativeMiner",
                                   "ServeMiner", "train_detector.main",
                                   "train_embedder.main", "train_refiner.main",
                                   "FaceEmbedder(width=0.5)", "make_mesh",
                                   "sharded_embed_fn", "make_train_step",
                                   "run_dryrun", "launch", "dryrun_multichip",
                                   "evaluate", "probe"])
def test_entry_points_need_cuda_unless_asked_for_cpu(entry, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    call = {"Shot": _shot, "FaceDetector": _detector,
            "do_shot": lambda: _do_shot(tmp_path),
            "main": lambda: _main(tmp_path),
            "Thread": _thread, "do_thread": lambda: _do_thread(tmp_path),
            "main thread": lambda: _main_thread(tmp_path),
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
            "stream_extract": _stream_extract, "FusedFacePipeline": _fused,
            "entry": _entry, "ShotScheduler": _shot_scheduler,
            "dfd_pairs_reference_style": _dfd_pairs,
            "train_detector.train": _train_detector,
            "train_embedder.train": _train_embedder,
            "train_refiner.train": _train_refiner,
            "HardNegativeMiner": _hard_negative_miner,
            "ServeMiner": _serve_miner,
            "train_detector.main": lambda: _train_main("train_detector", tmp_path),
            "train_embedder.main": lambda: _train_main("train_embedder", tmp_path),
            "train_refiner.main": lambda: _train_main("train_refiner", tmp_path),
            "FaceEmbedder(width=0.5)": _fresh_embedder,
            "make_mesh": _make_mesh, "sharded_embed_fn": _sharded_embed_fn,
            "make_train_step": _make_train_step, "run_dryrun": _run_dryrun,
            "launch": _launch,
            "dryrun_multichip": _dryrun_multichip, "evaluate": _evaluate,
            "probe": _probe}[entry]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()
    assert not torch.distributed.is_initialized()
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


def _structure_bodies():
    from pyannote_video_tpu_torch.ops import flow, orb

    return {
        "orb.detect_and_describe": orb.detect_and_describe,
        "orb.hamming_2nn": orb.hamming_2nn,
        "orb.batched_ratio_matches": orb.batched_ratio_matches,
        "flow.poly_expansion": flow.poly_expansion,
        "flow._flow_level": flow._flow_level,
        "flow.farneback_flow": flow.farneback_flow,
        "flow.warped_residual": flow.warped_residual,
    }


@pytest.mark.parametrize("name", [
    "orb.detect_and_describe", "orb.hamming_2nn", "orb.batched_ratio_matches",
    "flow.poly_expansion", "flow._flow_level", "flow.farneback_flow",
    "flow.warped_residual"])
def test_structure_bodies_never_wait_for_the_device(name):
    """ORB over a feature batch, a 64-pair Hamming product and the flow of a
    shot chunk are enqueued whole; the reads are in ``Thread`` (once per
    feature batch and per 64 pairs) and in ``Shot``."""
    source = inspect.getsource(_structure_bodies()[name])
    code = "\n".join(line.split("#")[0] for line in source.splitlines())
    found = [call for call in SYNCING_CALLS if call in code]
    assert not found, f"{name} calls {found}"


def test_thread_reads_the_device_once_per_batch():
    from pyannote_video_tpu_torch.pipeline.thread import Thread

    for name in ("_compute_features", "_pair_counts"):
        source = inspect.getsource(getattr(Thread, name))
        code = "\n".join(line.split("#")[0] for line in source.splitlines())
        assert code.count(".cpu(") == 1, name
        assert not [call for call in (".item(", "bool(", ".numpy(")
                    if call in code], name


def _fused_bodies():
    from pyannote_video_tpu_torch.models import fused

    return {
        "fused._device_nms": fused._device_nms,
        "FusedFacePipeline._candidates": fused.FusedFacePipeline._candidates,
        "FusedFacePipeline._build": fused.FusedFacePipeline._build,
        "FusedFacePipeline.build_detect_only":
            fused.FusedFacePipeline.build_detect_only,
    }


@pytest.mark.parametrize("name", [
    "fused._device_nms", "FusedFacePipeline._candidates",
    "FusedFacePipeline._build", "FusedFacePipeline.build_detect_only"])
def test_fused_bodies_never_wait_for_the_device(name):
    """The fused and detect-only programs (and the NMS rounds in them) are
    enqueued whole; the caller reads their output once."""
    source = inspect.getsource(_fused_bodies()[name])
    code = "\n".join(line.split("#")[0] for line in source.splitlines())
    found = [call for call in SYNCING_CALLS if call in code]
    assert not found, f"{name} calls {found}"


def _parallel_bodies():
    from pyannote_video_tpu_torch.parallel import sharding

    return {
        "sharding._AllReduce.forward": sharding._AllReduce.forward,
        "sharding._AllReduce.backward": sharding._AllReduce.backward,
        "sharding._AllGather.forward": sharding._AllGather.forward,
        "sharding._AllGather.backward": sharding._AllGather.backward,
        "sharding.psum": sharding.psum,
        "sharding.all_gather": sharding.all_gather,
        "sharding._full": sharding._full,
        "sharding.sharded_embed_fn": sharding.sharded_embed_fn,
        "sharding.metric_loss": sharding.metric_loss,
        "sharding.loss_fn": sharding.loss_fn,
        "sharding.make_train_step": sharding.make_train_step,
    }


@pytest.mark.parametrize("name", [
    "sharding._AllReduce.forward", "sharding._AllReduce.backward",
    "sharding._AllGather.forward", "sharding._AllGather.backward",
    "sharding.psum", "sharding.all_gather", "sharding._full",
    "sharding.sharded_embed_fn", "sharding.metric_loss", "sharding.loss_fn",
    "sharding.make_train_step"])
def test_sharded_steps_never_wait_for_the_device(name):
    """The sharded forward and train step (its ``step`` closure included)
    and their collectives are enqueued whole: the loss stays on the
    device."""
    source = inspect.getsource(_parallel_bodies()[name])
    code = "\n".join(line.split("#")[0] for line in source.splitlines())
    found = [call for call in SYNCING_CALLS if call in code]
    assert not found, f"{name} calls {found}"


TRAIN_FILES = sorted((ROOT / "pyannote_video_tpu_torch" / "train").glob("*.py"))


@pytest.mark.parametrize("path", TRAIN_FILES, ids=lambda p: p.name)
def test_trainers_never_import_cv2(path):
    """Not at module level and not inside a function: the machine with the
    card has no OpenCV."""
    bad = [m for m in _imported(path) if (m or "").split(".")[0] == "cv2"]
    assert not bad, f"{path.name} imports {bad}"


def test_training_data_runs_without_cv2():
    """Every generator of the trainers, in a process where ``import cv2``
    fails: nothing they reach at any depth needs OpenCV."""
    import subprocess
    import sys

    code = """
import sys
sys.modules["cv2"] = None
import numpy as np
from pyannote_video_tpu_torch.train import data, mine, train_landmarks, train_refiner
rng = np.random.default_rng(0)
data.detection_batch(rng, batch=2)
data.embedding_batch(rng, data.identity_bank(4), n_ident=2, per_ident=1)
mine.negative_frame(rng, 120, 160)
mine.positive_frame(rng, 120, 160)
train_refiner.scene(rng)
train_landmarks.make_dataset(n_images=2)
"""
    done = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert done.returncode == 0, done.stderr[-2000:]


def _train_bodies():
    from pyannote_video_tpu_torch.models import detector, embedder, nn, refiner
    from pyannote_video_tpu_torch.train import (mine, optim, train_detector,
                                                train_embedder, train_refiner)

    return {
        "optim.train_step": optim.train_step,
        "optim.Adam.step": optim.Adam.step,
        "optim.clip_by_global_norm": optim.clip_by_global_norm,
        "train_detector.loss_fn": train_detector.loss_fn,
        "train_embedder.loss_fn": train_embedder.loss_fn,
        "train_refiner.loss_fn": train_refiner.loss_fn,
        "nn.batch_norm": nn.batch_norm,
        "nn.hinge": nn.hinge,
        "nn.sigmoid_binary_cross_entropy": nn.sigmoid_binary_cross_entropy,
        "detector.forward_maps": detector.forward_maps,
        "refiner.forward": refiner.forward,
        "embedder.forward": embedder.forward,
        "mine._pyramid_maps": mine._pyramid_maps,
    }


@pytest.mark.parametrize("name", [
    "optim.train_step", "optim.Adam.step", "optim.clip_by_global_norm",
    "train_detector.loss_fn", "train_embedder.loss_fn",
    "train_refiner.loss_fn", "nn.batch_norm", "nn.hinge",
    "nn.sigmoid_binary_cross_entropy", "detector.forward_maps",
    "refiner.forward", "embedder.forward", "mine._pyramid_maps"])
def test_train_steps_never_wait_for_the_device(name):
    """A training step is enqueued whole; the host reads its loss only when
    it logs it."""
    source = inspect.getsource(_train_bodies()[name])
    code = "\n".join(line.split("#")[0] for line in source.splitlines())
    found = [call for call in SYNCING_CALLS if call in code]
    assert not found, f"{name} calls {found}"


@pytest.mark.parametrize("name,reads", [("mine._read_levels", 1),
                                        ("mine.HardNegativeMiner.refresh", 0),
                                        ("mine.HardNegativeMiner.refresh_positives", 0),
                                        ("train_refiner.ServeMiner.refresh", 1),
                                        ("train_refiner._extract_grouped", 1)])
def test_mining_reads_the_device_once_per_refresh(name, reads):
    """``refresh`` and ``refresh_positives`` each make one ``_levels`` call,
    whose ``_read_levels`` copies every level in one read; the refiner's
    miner reads its candidates, then all crops in one extraction."""
    from pyannote_video_tpu_torch.train import mine, train_refiner

    obj = {"mine": mine, "train_refiner": train_refiner}
    owner, *attrs = name.split(".")
    fn = obj[owner]
    for attr in attrs:
        fn = getattr(fn, attr)
    code = "\n".join(line.split("#")[0]
                     for line in inspect.getsource(fn).splitlines())
    assert code.count(".cpu(") == reads, name
    if name.startswith("mine.HardNegativeMiner"):
        assert code.count("self._levels(") == 1, name
    if name == "train_refiner.ServeMiner.refresh":
        assert code.count("_extract_grouped(") == 1, name
    assert not [c for c in (".item(", "bool(", ".tolist(") if c in code], name


@pytest.mark.parametrize("module", ["train_detector", "train_embedder",
                                    "train_refiner", "train_landmarks"])
def test_train_mains_refuse_to_write_into_the_jax_package(module, tmp_path):
    import importlib

    main = importlib.import_module(f"pyannote_video_tpu_torch.train.{module}").main
    target = ROOT / "pyannote_video_tpu" / "models" / "weights" / "trained.npz"
    args = [str(target)] if module == "train_landmarks" else ["1", str(target)]
    kwargs = {} if module == "train_landmarks" else {"device": "cpu"}
    with pytest.raises(ValueError, match="JAX package"):
        main(args, **kwargs)
    with pytest.raises(SystemExit):
        main([] if module == "train_landmarks" else ["1"], **kwargs)
    assert not target.exists()


# host modules copied from the JAX package: (port module, JAX module)
HOST_COPIES = [
    ("core/assignment.py", "core/assignment.py"),
    ("core/graph.py", "core/graph.py"),
    ("core/segment.py", "core/segment.py"),
    ("utils/metrics.py", "utils/metrics.py"),
    ("utils/synthetic_shift.py", "utils/synthetic_shift.py"),
    ("models/dlib_convert.py", "models/dlib_convert.py"),
]


def _without_docstring(path: Path) -> str:
    """The module's code: its AST with every docstring taken out (the
    module's, and those of its classes and functions, which a copy may word
    for its own package)."""
    tree = ast.parse(path.read_text(), str(path))
    for node in [tree] + [n for n in ast.walk(tree) if isinstance(
            n, (ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef))]:
        if node.body and isinstance(node.body[0], ast.Expr) and isinstance(
                getattr(node.body[0], "value", None), ast.Constant):
            node.body = node.body[1:]
    return ast.dump(tree)


@pytest.mark.parametrize("port,jax", HOST_COPIES, ids=[p for p, _ in HOST_COPIES])
def test_host_copies_hold_the_same_code(port, jax):
    assert _without_docstring(ROOT / "pyannote_video_tpu_torch" / port) == (
        _without_docstring(ROOT / "pyannote_video_tpu" / jax))


@pytest.mark.parametrize("n", [1, 2, 5, 9, 12])
def test_assignment_copy_matches_jax(n):
    from pyannote_video_tpu.core import assignment as jassignment
    from pyannote_video_tpu_torch.core import associate_by_overlap, hungarian

    rng = np.random.default_rng(n)
    cost = rng.uniform(0, 1, (n, n))
    cost[rng.uniform(size=(n, n)) < 0.3] = 0.0
    assert hungarian(cost) == jassignment.hungarian(cost)
    rows, cols = max(n - 1, 0), n
    assert (associate_by_overlap(cost, rows, cols)
            == jassignment.associate_by_overlap(cost, rows, cols))


@pytest.mark.parametrize("seed", range(3))
def test_metrics_copy_matches_jax(seed):
    from pyannote_video_tpu.utils import metrics as jmetrics
    from pyannote_video_tpu_torch.utils import metrics

    rng = np.random.default_rng(seed)
    truth = sorted(rng.uniform(0, 60, 8).tolist())
    pred = sorted((np.asarray(truth[:6]) + rng.normal(0, 0.05, 6)).tolist()
                  + rng.uniform(0, 60, 2).tolist())
    assert metrics.boundary_f1(pred, truth, 0.1) == jmetrics.boundary_f1(pred, truth, 0.1)

    def boxes(k):
        xy = rng.uniform(0, 100, (k, 2))
        return [tuple(map(float, (x, y, x + 30, y + 40))) for x, y in xy]

    gt = {t: boxes(2) for t in range(6)}
    found = {t: [(l + 3, u - 2, r + 3, b - 2) for l, u, r, b in gt[t][:1]]
             + boxes(1) for t in range(1, 6)}
    found[6] = boxes(1)
    assert metrics.track_frame_f1(found, gt) == jmetrics.track_frame_f1(found, gt)
    a, b = gt[0][0], found[1][0]
    assert metrics.iou_xyxy(a, b) == jmetrics.iou_xyxy(a, b)
    assignment = {i: int(rng.integers(4)) for i in range(12)}
    identity = {i: int(rng.integers(3)) for i in range(12)}
    assert (metrics.cluster_purity(assignment, identity)
            == jmetrics.cluster_purity(assignment, identity))
    assert (metrics.pairwise_prf(assignment, identity)
            == jmetrics.pairwise_prf(assignment, identity))
