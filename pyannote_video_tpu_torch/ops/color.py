"""Batched device color conversion + resize (the shot stage's ingest).

Port of ``pyannote_video_tpu/ops/color.py`` (``to_gray``,
``resize_bilinear``, ``ingest_gray``): whole frame batches are converted
and resized on the device as a few tensor ops.  The YUV 4:2:0 functions
of that module belong to the tracking stage and are not ported yet.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

# ITU-R BT.601 luma — matches cv2.COLOR_RGB2GRAY (see utils/imops.py).
_LUMA = (0.299, 0.587, 0.114)


def to_gray(frames: torch.Tensor) -> torch.Tensor:
    """RGB ``[..., 3]`` (uint8 or float) → float32 grayscale ``[...]``.

    Elementwise weighted sum with the fixed association order of the JAX
    version, ``(r·0.299 + g·0.587) + b·0.114``: a different order (or a
    reduced-precision dot) moves the gray level by up to one step, which
    once flipped ORB match counts between backends.
    """
    x = frames.to(torch.float32)
    return (x[..., 0] * _LUMA[0] + x[..., 1] * _LUMA[1]) + x[..., 2] * _LUMA[2]


@lru_cache(maxsize=256)
def _interp_taps(n_in: int, n_out: int):
    """2-tap bilinear resampling plan: (idx0 [n_out], idx1 [n_out],
    w [n_out]) with OpenCV pixel-center convention, edge-clamped."""
    xs = (np.arange(n_out, dtype=np.float64) + 0.5) * (n_in / n_out) - 0.5
    xs = np.clip(xs, 0.0, n_in - 1.0)
    x0 = np.floor(xs).astype(np.int32)
    x1 = np.minimum(x0 + 1, n_in - 1).astype(np.int32)
    w = (xs - x0).astype(np.float32)
    return x0, x1, w


def _resample_axis(x: torch.Tensor, axis: int, n_out: int) -> torch.Tensor:
    i0, i1, w = _interp_taps(x.shape[axis], n_out)
    shape = [1] * x.ndim
    shape[axis] = n_out
    wt = torch.from_numpy(w).to(device=x.device, dtype=x.dtype).reshape(shape)
    a = x.index_select(axis, torch.from_numpy(i0).to(x.device, torch.long))
    b = x.index_select(axis, torch.from_numpy(i1).to(x.device, torch.long))
    return a * (1 - wt) + b * wt


def resize_bilinear(frames: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear resize of ``[B, H, W]`` or ``[B, H, W, C]`` batches.

    Separable 2-tap row/column resampling, no antialiasing (OpenCV
    INTER_LINEAR).  Float inputs keep their dtype (the detector resizes
    its pyramid in bfloat16, tap weights included); integer inputs are
    promoted to float32.
    """
    if frames.ndim not in (3, 4):
        raise ValueError(f"expected [B,H,W] or [B,H,W,C], got {tuple(frames.shape)}")
    x = frames if frames.is_floating_point() else frames.to(torch.float32)
    x = _resample_axis(x, 1, out_h)
    return _resample_axis(x, 2, out_w)


def ingest_gray(frames_u8: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """uint8 RGB batch → resized float32 grayscale batch.

    Gray-then-resize order matches the shot stage (`structure/shot.py:71-73`).
    """
    return resize_bilinear(to_gray(frames_u8), out_h, out_w)
