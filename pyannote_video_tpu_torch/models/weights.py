"""Packaged model parameters, read by path from the JAX package's files.

The ``.npz`` weights live once, under ``pyannote_video_tpu/models/weights/``;
this module only finds them (it imports nothing of that package) and
``models/nn.py:load_params`` converts them to the port's layout.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

from .nn import State, load_params

WEIGHTS_DIR = (Path(__file__).resolve().parent.parent.parent
               / "pyannote_video_tpu" / "models" / "weights")

DETECTOR_FILE = WEIGHTS_DIR / "detector_synthetic.npz"
REFINER_FILE = WEIGHTS_DIR / "refiner_synthetic.npz"
EMBEDDER_FILE = WEIGHTS_DIR / "embedder_synthetic.npz"
LANDMARKS_FILE = WEIGHTS_DIR / "landmarks_synthetic.npz"

# width multiplier of the packaged embedder: the full dlib ResNet-29
EMBEDDER_WIDTH = 1.0


def checked_output(path) -> Path:
    """A trainer's output path, refused when it lies inside the JAX package
    (whose packaged files are the reference and are never rewritten)."""
    out = Path(path).resolve()
    if out.is_relative_to(WEIGHTS_DIR.parent.parent):
        raise ValueError(f"{path}: the trainers never write into the JAX "
                         "package; give an output path outside it")
    out.parent.mkdir(parents=True, exist_ok=True)
    return out


def default_detector_params() -> State:
    """The packaged stage-1 pyramid detector (raises if it is missing)."""
    if not DETECTOR_FILE.exists():
        raise FileNotFoundError(f"no packaged detector weights at {DETECTOR_FILE}")
    return load_params(DETECTOR_FILE)


def default_refiner_params() -> Optional[State]:
    """Packaged refine-cascade weights (`models/refiner.py`), or None.

    No random fallback: with no trained refiner the detector serves the
    plain single-stage pyramid (a random second stage would destroy recall).
    """
    if REFINER_FILE.exists():
        return load_params(REFINER_FILE)
    return None


def default_embedder_params() -> State:
    """The packaged ResNet-29 embedder (raises if it is missing: a fresh
    model is asked for by width, ``FaceEmbedder(width=...)``)."""
    if not EMBEDDER_FILE.exists():
        raise FileNotFoundError(f"no packaged embedder weights at {EMBEDDER_FILE}")
    return load_params(EMBEDDER_FILE)
