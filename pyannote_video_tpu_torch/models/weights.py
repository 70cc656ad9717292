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
