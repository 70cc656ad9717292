"""Batched device color conversion + resize (the shot stage's ingest).

Port of ``pyannote_video_tpu/ops/color.py``: whole frame batches are
converted and resized on the device as a few tensor ops, and the YUV 4:2:0
functions at the end are the streaming path's wire format.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

# ITU-R BT.601 luma — matches cv2.COLOR_RGB2GRAY (see utils/imops.py).
_LUMA = (0.299, 0.587, 0.114)
_PACK_FRAMES = 4     # frames per pass of `rgb_to_yuv420`


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


def ingest_gray_resize_first(frames_u8: torch.Tensor, out_h: int,
                             out_w: int) -> torch.Tensor:
    """Resize-then-gray (the thread stage order,
    `structure/thread.py:142-143`)."""
    return to_gray(resize_bilinear(frames_u8.to(torch.float32), out_h, out_w))


# ---------------------------------------------------------------------------
# YUV 4:2:0 ingest — the streaming pipeline's wire format
# ---------------------------------------------------------------------------
# Video codecs emit YUV 4:2:0 natively; shipping it to the device instead
# of RGB halves the host→device bytes (1.5 B/px vs 3 B/px), and the Y plane
# is (up to the fixed studio-swing affine) the BT.601 gray the tracking
# stage consumes, so gray conversion disappears from the ingest path.  The
# wire convention is LIMITED-range BT.601 (Y in [16, 235]), what typical
# codec output (ffmpeg yuv420p) uses.


def yuv_luma_to_gray(y: torch.Tensor) -> torch.Tensor:
    """Limited-range luma plane → full-range float32 gray (= `to_gray`).

    gray = (Y − 16) · 255/219, clipped, so that thresholds calibrated on
    0-255 gray hold unchanged on the streaming path.  The result is a new
    tensor, never a view of ``y``.
    """
    return ((y.to(torch.float32) - 16.0) * (255.0 / 219.0)).clamp(0.0, 255.0)


def yuv420_to_rgb(y: torch.Tensor, u: torch.Tensor,
                  v: torch.Tensor) -> torch.Tensor:
    """YUV 4:2:0 (limited range) → float32 RGB in [0, 255], on ``y``'s device.

    y [B, H, W] uint8, u/v [B, ceil(H/2), ceil(W/2)] uint8 → rgb [B, H, W, 3].
    Chroma is upsampled by nearest-neighbour 2× (I420 co-siting) and cut to
    the luma's size (odd sizes), then the fixed BT.601 inverse is applied
    elementwise, in the JAX version's association order.
    """
    H, W = y.shape[1], y.shape[2]
    yf = (y.to(torch.float32) - 16.0) * 1.164

    def up(c):
        c = c.to(torch.float32)
        c = c.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
        return c[:, :H, :W] - 128.0

    uf, vf = up(u), up(v)
    r = yf + 1.596 * vf
    g = yf - 0.392 * uf - 0.813 * vf
    b = yf + 2.017 * uf
    return torch.stack([r, g, b], dim=-1).clamp(0.0, 255.0)


def rgb_to_yuv420(frames_u8: np.ndarray) -> tuple:
    """Host-side RGB uint8 batch [B, H, W, 3] → (Y [B, H, W], U, V
    [B, H/2, W/2]) I420 planes, uint8 numpy arrays; H and W even.

    Stand-in for a decoder's native YUV output.  Limited-range BT.601,
    chroma as the 2×2 box average, rounded half to even: byte for byte the
    planes of the JAX package's NumPy ``rgb_to_yuv420``.  Each float32
    operation is the NumPy one in the same order (no fused multiply-add;
    the four chroma samples are summed as (a00 + a01) + (a10 + a11), the
    order NumPy's mean over the two 2-axes takes), but it runs as torch CPU
    operations on whole planes: they use every core and release the
    interpreter lock, so a packer thread overlaps the other threads.
    """
    x = torch.from_numpy(np.ascontiguousarray(frames_u8))
    B, H, W, _ = x.shape
    out = (np.empty((B, H, W), np.uint8),
           np.empty((B, H // 2, W // 2), np.uint8),
           np.empty((B, H // 2, W // 2), np.uint8))

    def plane(r, g, b, offset, cr, cg, cb):
        # ((offset + cr·r) + cg·g) + cb·b, one rounding per operation
        p = r * cr
        p += offset
        p += g * cg
        p += b * cb
        return p

    def box(p):
        s = p[:, 0::2, 0::2] + p[:, 0::2, 1::2]
        s += p[:, 1::2, 0::2] + p[:, 1::2, 1::2]
        s /= 4.0
        return s

    # a few frames at a time: the float32 planes then stay in the cache
    for i in range(0, B, _PACK_FRAMES):
        r, g, b = (x[i:i + _PACK_FRAMES, ..., c].to(torch.float32)
                   for c in range(3))
        planes = (plane(r, g, b, 16.0, 0.257, 0.504, 0.098),
                  box(plane(r, g, b, 128.0, -0.148, -0.291, 0.439)),
                  box(plane(r, g, b, 128.0, 0.439, -0.368, -0.071)))
        for dst, p in zip(out, planes):
            torch.from_numpy(dst[i:i + _PACK_FRAMES]).copy_(
                p.round_().clamp_(0, 255))
    return out
