"""Rules of the PyTorch port that no parity test would catch.

* No module of ``pyannote_video_tpu_torch`` and not ``chip_smoke.py``
  imports ``jax`` or ``pyannote_video_tpu``.
* Entry points called without ``device`` on a machine without CUDA raise;
  they never run on the CPU unasked.
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "pyannote_video_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
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


@pytest.mark.parametrize("entry", ["Shot", "FaceDetector", "do_shot", "main"])
def test_entry_points_need_cuda_unless_asked_for_cpu(entry, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    call = {"Shot": _shot, "FaceDetector": _detector,
            "do_shot": lambda: _do_shot(tmp_path),
            "main": lambda: _main(tmp_path)}[entry]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()
    assert not (tmp_path / "out.json").exists()
