"""Batched box crop-and-resize for the detector's refine cascade.

Port of ``pyannote_video_tpu/ops/crop.py``: for every candidate box,
resample a fixed-size patch from its frame.  Each crop is two small
products with bilinear "hat" matrices (rows, then columns), the same
formulation as the JAX package, so both give the same numbers.

Coordinates follow the half-pixel-center convention of
``ops/color.py:_interp_taps`` (src = (dst+0.5)·scale − 0.5); samples
falling outside the frame contribute zero (black padding), as the
refiner's trainer saw them.
"""

from __future__ import annotations

import torch


def _hat_weights(starts: torch.Tensor, sizes: torch.Tensor, n_src: int,
                 n_dst: int, dtype) -> torch.Tensor:
    """Bilinear interpolation matrices ``[..., n_dst, n_src]`` for 1-D crop
    windows; rows sum to ≤ 1 (partial or zero at the borders = zero padding).
    """
    dst = (torch.arange(n_dst, dtype=torch.float32, device=starts.device) + 0.5) / n_dst
    src = starts[..., None] + dst * sizes[..., None] - 0.5
    grid = torch.arange(n_src, dtype=torch.float32, device=starts.device)
    w = (1.0 - (src[..., None] - grid).abs()).clamp(min=0.0)
    return w.to(dtype)


def crop_resize(frames: torch.Tensor, boxes: torch.Tensor,
                out_size: int = 64) -> torch.Tensor:
    """Resample one ``out_size``² patch per box from its frame.

    frames: [B, H, W, C] float; boxes: [B, K, 4] (l, t, r, b) pixel
    coordinates (may extend past the frame — outside reads as zero).
    Returns [B, K, out_size, out_size, C] in the frames' dtype.
    """
    if frames.ndim != 4 or boxes.ndim != 3 or boxes.shape[-1] != 4:
        raise ValueError(f"crop_resize: frames [B,H,W,C] + boxes [B,K,4], "
                         f"got {tuple(frames.shape)} / {tuple(boxes.shape)}")
    H, W = frames.shape[1], frames.shape[2]
    dt = frames.dtype
    l, t, r, b = boxes.to(torch.float32).unbind(-1)
    ry = _hat_weights(t, b - t, H, out_size, dt)        # [B, K, out, H]
    rx = _hat_weights(l, r - l, W, out_size, dt)        # [B, K, out, W]
    rows = torch.einsum("bkah,bhwc->bkawc", ry, frames)
    return torch.einsum("bkawc,bkow->bkaoc", rows, rx)
