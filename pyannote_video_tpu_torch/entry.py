"""The fused detect → align → embed program as one forward step.

Counterpart of the JAX package's ``entry()`` (``__graft_entry__.py``):
``fn, args = entry(); out = fn(*args)`` runs pyramid detection, the
refiner, device NMS, the landmark cascade, the chip cut and the ResNet-29
embedder over two seeded random 120×160 frames with 4 face slots each, on
the CUDA device unless ``device="cpu"`` is asked for.
"""

from __future__ import annotations

import numpy as np
import torch

from .utils.device import DeviceLike


def entry(device: DeviceLike = None):
    """(fn, args) of the fused program (``models/fused.py``):
    ``fn(*args)`` is a ``FusedOutput`` of [2, 4, ...] tensors."""
    from .models.fused import FusedFacePipeline

    pipe = FusedFacePipeline(max_faces=4, device=device)
    fused = pipe._build(120, 160)
    frames = torch.from_numpy(
        np.random.default_rng(0).integers(0, 255, (2, 120, 160, 3))
        .astype(np.uint8)).to(pipe.device)
    return fused, (pipe.detector_params, pipe.embedder_params,
                   pipe.landmark_arrays, frames)


if __name__ == "__main__":
    fn, args = entry()
    out = fn(*args)
    print("entry OK:", {k: tuple(v.shape) for k, v in out._asdict().items()})
