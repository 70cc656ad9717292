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
kernel's design.  ``_plan`` cuts each launch into tiles whose staged frames
fit a CTA's shared memory at any frame size.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from functools import lru_cache
from typing import List, Tuple

import torch

from ..utils.device import DeviceLike, resolve_device


def dfd_series_plain(gray: torch.Tensor, radius: int = 3, block: int = 5,
                     subpixel: bool = True) -> torch.Tensor:
    """Plain PyTorch DFD: gray ``[T, H, W]`` float32 → ``[T-1]`` float32.

    Same arithmetic as the JAX formulation: the residual surface
    ``[P, n_by, n_bx, R, R]`` is built one displacement at a time and the
    V-correction uses edge-clamped neighbours along each displacement axis.
    """
    T, H, W = gray.shape
    hc, wc = (H // block) * block, (W // block) * block
    # edge padding replicates pyannote-video's coordinate clamping
    # (`structure/shot.py:95-96`)
    cur_pad = torch.nn.functional.pad(
        gray[1:, None], (radius, radius, radius, radius), mode="replicate")[:, 0]
    return block_minima(gray[:-1, :hc, :wc], cur_pad[:, :hc + 2 * radius,
                                                     :wc + 2 * radius],
                        radius, block, subpixel).mean(dim=(1, 2))


def block_minima(prev: torch.Tensor, cur_pad: torch.Tensor, radius: int,
                 block: int, subpixel: bool) -> torch.Tensor:
    """Per-block minimum over displacements of the (V-corrected) block mean
    of ``|prev − shifted cur|``: prev ``[P, h, w]`` (multiples of ``block``)
    and cur ``[P, h + 2r, w + 2r]``, already edge-padded → ``[P, h/block,
    w/block]``."""
    P, hc, wc = prev.shape
    n_by, n_bx = hc // block, wc // block
    R = 2 * radius + 1

    def block_mean(x: torch.Tensor) -> torch.Tensor:
        return x.reshape(P, n_by, block, n_bx, block).mean(dim=(2, 4))

    resid = torch.stack([
        block_mean((prev - cur_pad[:, dy:dy + hc, dx:dx + wc]).abs())
        for dy in range(R) for dx in range(R)
    ], dim=-1).reshape(P, n_by, n_bx, R, R)
    if subpixel:
        # neighbours along each displacement axis, edge-clamped (border
        # displacements get a one-sided, conservative correction)
        lo = torch.arange(R, device=prev.device).sub(1).clamp(min=0)
        hi = torch.arange(R, device=prev.device).add(1).clamp(max=R - 1)
        corr_y = (resid[..., lo, :] - resid[..., hi, :]).abs() * 0.5
        corr_x = (resid[..., lo] - resid[..., hi]).abs() * 0.5
        resid = (resid - corr_y - corr_x).clamp(min=0.0)
    return resid.amin(dim=(3, 4))


# Launch limits, mirrored from csrc/dfd.cu.
_MAX_THREADS = 256                # kMaxThreads: one thread per (pair, block)
_STATIC_SMEM = 1152               # s_best and s_ready, to a 128-byte boundary
_PAD = 4                          # kPad: floats before each staged frame
_SMEM_BUDGET = 100 * 1024         # per CTA, far under the 227 KB a CTA may use
_MAX_RUNTIME_RADIUS, _MAX_RUNTIME_BLOCK = 7, 16   # kMaxRadius, kMaxBlock
_H100_SMS = 132


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclass(frozen=True)
class Plan:
    """How ``csrc/dfd.cu`` cuts one launch: a CTA takes a tile of ``band``
    block rows by ``tile_bx`` block columns of ``pairs`` consecutive pairs,
    and stages the frame rows and columns its windows reach (``rows`` rows
    with the halo) of ``pairs + 1`` frames, ``fstride`` floats each: one
    bulk copy per frame when the tile is as wide as the frame (``full``,
    rows ``W`` floats apart), else one per row (``pitch`` floats apart)."""

    T: int
    H: int
    W: int
    radius: int
    block: int
    band: int
    tile_bx: int
    pairs: int
    n_tx: int
    n_ty: int
    n_groups: int
    rows: int
    pitch: int
    fstride: int
    full: int
    threads: int
    smem: int

    @property
    def n_tiles(self) -> int:
        return self.n_tx * self.n_ty

    @property
    def grid(self) -> int:
        return self.n_groups * self.n_tiles

    def tile(self, t: int) -> Tuple[int, int]:
        """Block row and column where tile ``t`` starts (kernel order)."""
        return (t // self.n_tx) * self.band, (t % self.n_tx) * self.tile_bx

    def window_rows(self, t: int) -> List[int]:
        """Frame row that each row of tile ``t``'s windows reads: the tile's
        block rows and an r-row halo, edge-clamped."""
        y_org = self.tile(t)[0] * self.block - self.radius
        return [min(max(y_org + a, 0), self.H - 1) for a in range(self.rows)]

    def staged_rows(self, t: int) -> List[int]:
        """Frame rows that tile ``t`` stages."""
        y_org = self.tile(t)[0] * self.block - self.radius
        return list(range(max(y_org, 0), min(y_org + self.rows, self.H)))

    def window_cols(self, t: int) -> List[int]:
        """Frame column that each column of tile ``t``'s windows reads."""
        x_org = self.tile(t)[1] * self.block - self.radius
        cols = self.tile_bx * self.block + 2 * self.radius
        return [min(max(x_org + c, 0), self.W - 1) for c in range(cols)]

    def staged_cols(self, t: int) -> List[int]:
        """Frame columns that tile ``t`` stages: whole rows, or the span its
        windows reach."""
        if self.full:
            return list(range(self.W))
        x_org = self.tile(t)[1] * self.block - self.radius
        cols = self.tile_bx * self.block + 2 * self.radius
        return list(range(max(x_org, 0), min(x_org + cols, self.W)))


@lru_cache(maxsize=64)
def _plan(T: int, H: int, W: int, radius: int = 3, block: int = 5,
          n_sm: int = _H100_SMS) -> Plan:
    """The launch plan for ``[T, H, W]``: tiles of at most ``_MAX_THREADS``
    blocks, as wide as the frame where it has that few block columns (one
    bulk copy then stages a frame), split evenly over the frame and shrunk
    until their staged frames fit ``_SMEM_BUDGET``; then as many pairs per
    CTA as keep the grid at two CTAs per SM or more."""
    if radius < 0 or block < 1 or H < block or W < block or T < 2:
        raise ValueError(f"dfd: no plan for [{T}, {H}, {W}], radius={radius}, "
                         f"block={block}")
    if (radius, block) != (3, 5) and (radius > _MAX_RUNTIME_RADIUS
                                      or block > _MAX_RUNTIME_BLOCK):
        raise ValueError(f"dfd kernel: radius={radius}, block={block} beyond "
                         f"the run-time instance's {_MAX_RUNTIME_RADIUS}, "
                         f"{_MAX_RUNTIME_BLOCK}")
    if T * H * W + 3 >= 2 ** 31:
        raise ValueError(f"dfd kernel: [{T}, {H}, {W}] has more elements than "
                         f"its 32-bit indices reach")
    n_by, n_bx, n_pairs = H // block, W // block, T - 1
    tile_bx = _cdiv(n_bx, _cdiv(n_bx, _MAX_THREADS))
    band = _cdiv(n_by, _cdiv(n_by, _MAX_THREADS // tile_bx))

    def geometry(band: int, tile_bx: int) -> Tuple[int, int, int]:
        """Window rows, row pitch and frame stride (floats) of a tile.  A
        copy runs from the 16-byte boundary at or before its first float to
        the one at or after its last: up to 6 floats more than its span."""
        rows = band * block + 2 * radius
        if tile_bx >= n_bx:
            return rows, W, 4 * _cdiv(_PAD + 3 + min(rows, H) * W + 3, 4)
        # a row's copy may start 3 floats before its span and end 3 after;
        # pitch = W (mod 4) keeps every row's copy on a 16-byte boundary
        span = min(tile_bx * block + 2 * radius, W) + 6
        pitch = span + (W - span) % 4
        return rows, pitch, 4 * _cdiv(_PAD + 3 + min(rows, H) * pitch, 4)

    def smem(band: int, tile_bx: int, pairs: int) -> int:
        return 4 * (pairs + 1) * geometry(band, tile_bx)[2]

    while smem(band, tile_bx, 1) > _SMEM_BUDGET:
        if band >= tile_bx and band > 1:
            band = _cdiv(band, 2)
        elif tile_bx > 1:
            tile_bx = _cdiv(tile_bx, 2)
        else:
            raise ValueError(f"dfd kernel: block={block}, radius={radius} "
                             f"needs more shared memory than a CTA has")
    rows, pitch, fstride = geometry(band, tile_bx)
    n_tx, n_ty = _cdiv(n_bx, tile_bx), _cdiv(n_by, band)
    pairs = 1
    for k in range(2, _MAX_THREADS // (band * tile_bx) + 1):
        if (_cdiv(n_pairs, k) * n_tx * n_ty < 2 * n_sm
                or smem(band, tile_bx, k) > _SMEM_BUDGET):
            break
        pairs = k
    return Plan(T=T, H=H, W=W, radius=radius, block=block, band=band,
                tile_bx=tile_bx, pairs=pairs, n_tx=n_tx, n_ty=n_ty,
                n_groups=_cdiv(n_pairs, pairs), rows=rows, pitch=pitch,
                fstride=fstride, full=int(n_tx == 1),
                threads=32 * _cdiv(pairs * band * tile_bx, 32),
                smem=smem(band, tile_bx, pairs))


class _CPlan(ctypes.Structure):
    """``DfdPlan`` of ``csrc/dfd.cu``."""

    _fields_ = [(name, ctypes.c_int) for name in (
        "T", "H", "W", "radius", "block", "band", "tile_bx", "pairs", "n_tx",
        "n_tiles", "n_groups", "rows", "pitch", "fstride", "full", "threads",
        "smem")]


@lru_cache(maxsize=64)
def _c_plan(plan: Plan) -> _CPlan:
    return _CPlan(**{name: getattr(plan, name) for name, _ in _CPlan._fields_})


@lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """``csrc/dfd.cu``, built at first use, with its C signatures declared."""
    from ..utils import cuda_build

    lib = cuda_build.load("dfd")
    lib.dfd_prepare.argtypes = []
    lib.dfd_prepare.restype = ctypes.c_int
    lib.dfd_series_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.POINTER(_CPlan), ctypes.c_int, ctypes.c_void_p]
    lib.dfd_series_launch.restype = ctypes.c_int
    lib.dfd_error_string.argtypes = [ctypes.c_int]
    lib.dfd_error_string.restype = ctypes.c_char_p
    return lib


@lru_cache(maxsize=None)
def _prepared(index: int) -> int:
    """Set the kernels' shared-memory attribute on device ``index``, once
    (never inside a CUDA-graph capture); its SM count."""
    lib = _library()
    with torch.cuda.device(index):
        static = lib.dfd_prepare()
    if static < 0:
        raise RuntimeError(f"dfd kernel setup failed: "
                           f"{lib.dfd_error_string(-static).decode()}")
    if static > _STATIC_SMEM:
        raise RuntimeError(f"dfd kernel: {static} B of static shared memory, "
                           f"the plan counts {_STATIC_SMEM} B")
    return torch.cuda.get_device_properties(index).multi_processor_count


def _launch(gray: torch.Tensor, out: torch.Tensor, radius: int, block: int,
            subpixel: bool) -> None:
    index = gray.device.index
    plan = _plan(*gray.shape, radius, block, _prepared(index))
    partial = (torch.empty((plan.T - 1) * plan.n_tiles, dtype=torch.float32,
                           device=gray.device) if plan.n_tiles > 1 else None)
    lib = _library()
    with torch.cuda.device(index):
        stream = torch.cuda.current_stream(index).cuda_stream
        err = lib.dfd_series_launch(
            gray.data_ptr(), out.data_ptr(),
            None if partial is None else partial.data_ptr(),
            ctypes.byref(_c_plan(plan)), int(subpixel), stream)
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


def dfd_pairs_reference_style(prev, cur, radius: int = 3, block: int = 5,
                              device: DeviceLike = None) -> torch.Tensor:
    """DFD for explicit (prev, cur) batches: ``[P, H, W]`` each → ``[P]``.

    Tensors are used on the device they lie on; arrays are sent to
    ``device`` (``cuda`` unless ``"cpu"`` is asked for).  The pairs go
    through ``dfd_series`` as one interleaved series ``prev₀, cur₀, prev₁,
    cur₁, ...`` (one kernel launch on the card, the plain version on the
    CPU), of which every other entry is a requested pair."""
    if not isinstance(prev, torch.Tensor):
        dev = resolve_device(device)
        prev = torch.as_tensor(prev, dtype=torch.float32, device=dev)
        cur = torch.as_tensor(cur, dtype=torch.float32, device=dev)
    P, H, W = prev.shape
    series = torch.stack([prev, cur], dim=1).reshape(2 * P, H, W)
    return dfd_series(series.to(torch.float32).contiguous(), radius=radius,
                      block=block)[0::2]
