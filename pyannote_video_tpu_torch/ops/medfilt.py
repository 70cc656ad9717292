"""1-D median filter (DFD series normalisation).

Port of ``pyannote_video_tpu/ops/medfilt.py``.  ``mode="zero"`` matches
``scipy.signal.medfilt`` (what pyannote-video calls, `structure/shot.py:124`);
``mode="reflect"`` mirrors the series at its ends, which keeps the local
median from sagging near the start and end of a video.
"""

from __future__ import annotations

import torch


def medfilt1d(y: torch.Tensor, kernel_size: int, mode: str = "zero") -> torch.Tensor:
    """Median filter of odd size over a 1-D series, on ``y``'s device.

    If the kernel exceeds what the series length supports for reflect
    padding, it is clamped to the largest valid odd size.
    """
    if kernel_size % 2 != 1:
        raise ValueError("kernel_size must be odd")
    n = y.shape[0]
    if mode == "reflect":
        # reflect padding needs pad <= n - 1
        kernel_size = min(kernel_size, 2 * n - 1)
    half = kernel_size // 2
    if mode == "zero":
        edge = y.new_zeros(half)
        padded = torch.cat([edge, y, edge])
    elif mode == "reflect":
        # numpy/jnp "reflect": the edge sample itself is not repeated
        padded = torch.cat([y[1:half + 1].flip(0), y, y[n - 1 - half:n - 1].flip(0)])
    else:
        raise ValueError(f"unknown pad mode: {mode}")
    # [n, k] sliding windows; odd k, so the median is the middle value
    return padded.unfold(0, kernel_size, 1).median(dim=1).values
