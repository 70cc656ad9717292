"""Displaced-frame-difference (DFD) for shot boundary detection.

Port of ``pyannote_video_tpu/ops/dfd.py`` (the contract) and of its Pallas
TPU kernel ``ops/dfd_pallas.py:_dfd_kernel`` (``pl.pallas_call`` at
``dfd_pallas.py:134``), which becomes the hand-written CUDA kernel
``csrc/dfd.cu``.

For every consecutive frame pair and every ``block``×``block`` block, find
the displacement within ``radius`` that minimises the block's mean absolute
residual, then average the minima over the frame: small within a shot
(some displacement aligns the content), large across a cut.  With
``subpixel`` the residual surface is V-interpolated per axis,
``r(d) − |r(d−1) − r(d+1)|/2``, so slow sub-pixel pans do not inflate it.

Bound on an H100 at the shot stage's shape (T=257, 50×89): ~4.6 MB read
(~1.4 µs at 3.35 TB/s) and ~0.18 G f32 operations (~2.7 µs at 67 TFLOP/s
without tensor cores), so operations bound it; see ``csrc/dfd.cu`` for the
kernel's design.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

_MAX_SMEM = 232448  # bytes of shared memory one CTA may use on Hopper


def dfd_series_plain(gray: torch.Tensor, radius: int = 3, block: int = 5,
                     subpixel: bool = True) -> torch.Tensor:
    """Plain PyTorch DFD: gray ``[T, H, W]`` float32 → ``[T-1]`` float32.

    Same arithmetic as the JAX formulation: the residual surface
    ``[P, n_by, n_bx, R, R]`` is built one displacement at a time and the
    V-correction uses edge-clamped neighbours along each displacement axis.
    """
    T, H, W = gray.shape
    hc, wc = (H // block) * block, (W // block) * block
    n_by, n_bx = hc // block, wc // block
    R = 2 * radius + 1
    prev = gray[:-1, :hc, :wc]
    # edge padding replicates pyannote-video's coordinate clamping
    # (`structure/shot.py:95-96`)
    cur_pad = torch.nn.functional.pad(
        gray[1:, None], (radius, radius, radius, radius), mode="replicate")[:, 0]

    def block_mean(x: torch.Tensor) -> torch.Tensor:
        return x.reshape(T - 1, n_by, block, n_bx, block).mean(dim=(2, 4))

    resid = torch.stack([
        block_mean((prev - cur_pad[:, dy:dy + hc, dx:dx + wc]).abs())
        for dy in range(R) for dx in range(R)
    ], dim=-1).reshape(T - 1, n_by, n_bx, R, R)
    if subpixel:
        # neighbours along each displacement axis, edge-clamped (border
        # displacements get a one-sided, conservative correction)
        lo = torch.arange(R, device=gray.device).sub(1).clamp(min=0)
        hi = torch.arange(R, device=gray.device).add(1).clamp(max=R - 1)
        corr_y = (resid[..., lo, :] - resid[..., hi, :]).abs() * 0.5
        corr_x = (resid[..., lo] - resid[..., hi]).abs() * 0.5
        resid = (resid - corr_y - corr_x).clamp(min=0.0)
    return resid.amin(dim=(3, 4)).mean(dim=(1, 2))


@lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """``csrc/dfd.cu``, built at first use, with its C signatures declared."""
    from ..utils import cuda_build

    lib = cuda_build.load("dfd")
    lib.dfd_smem_bytes.argtypes = [ctypes.c_int] * 4
    lib.dfd_smem_bytes.restype = ctypes.c_size_t
    lib.dfd_series_launch.argtypes = (
        [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    lib.dfd_series_launch.restype = ctypes.c_int
    lib.dfd_error_string.argtypes = [ctypes.c_int]
    lib.dfd_error_string.restype = ctypes.c_char_p
    return lib


def _launch(gray: torch.Tensor, out: torch.Tensor, radius: int, block: int,
            subpixel: bool) -> None:
    lib = _library()
    T, H, W = gray.shape
    smem = lib.dfd_smem_bytes(H, W, radius, block)
    if smem > _MAX_SMEM:
        raise ValueError(f"dfd_series: frames {H}x{W} need {smem} B of shared "
                         f"memory per pair, more than the {_MAX_SMEM} B a CTA has")
    with torch.cuda.device(gray.device):
        stream = torch.cuda.current_stream(gray.device).cuda_stream
        err = lib.dfd_series_launch(gray.data_ptr(), out.data_ptr(), T, H, W,
                                    radius, block, int(subpixel), stream)
    if err != 0:
        raise RuntimeError(f"dfd kernel launch failed: "
                           f"{lib.dfd_error_string(err).decode()}")


def dfd_series(gray: torch.Tensor, radius: int = 3, block: int = 5,
               subpixel: bool = True) -> torch.Tensor:
    """DFD for all consecutive frame pairs: ``[T, H, W]`` f32 → ``[T-1]`` f32.

    ``dfd[i]`` compares frames ``i`` and ``i+1``.  A CUDA tensor goes
    through the hand-written kernel (``csrc/dfd.cu``) or raises; a CPU
    tensor goes through ``dfd_series_plain``.  ``dfd_series.launches``
    counts kernel launches.
    """
    if gray.ndim != 3 or gray.dtype != torch.float32:
        raise ValueError(f"dfd_series: expected [T, H, W] float32, got "
                         f"{tuple(gray.shape)} {gray.dtype}")
    T, H, W = gray.shape
    if T < 2 or H < block or W < block:
        raise ValueError(f"dfd_series: need T >= 2 and H, W >= block={block}, "
                         f"got {tuple(gray.shape)}")
    if gray.device.type == "cpu":
        return dfd_series_plain(gray, radius=radius, block=block, subpixel=subpixel)
    if gray.device.type != "cuda":
        raise ValueError(f"dfd_series: unsupported device {gray.device}")
    if not gray.is_contiguous():
        raise ValueError("dfd_series: gray must be contiguous")
    out = torch.empty(T - 1, dtype=torch.float32, device=gray.device)
    _launch(gray, out, radius, block, subpixel)
    dfd_series.launches += 1
    return out


dfd_series.launches = 0
