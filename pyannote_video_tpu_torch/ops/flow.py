"""Dense optical flow (Farneback) over frame-pair batches.

Port of ``pyannote_video_tpu/ops/flow.py`` (an XLA program there, tensor
code here), the shot stage's ``method="farneback"``: polynomial expansion,
iterative displacement refinement over an image pyramid, and the
motion-compensated residual, each over a whole batch of pairs.

Algorithm (Farnebäck 2003): each neighbourhood is approximated by a
quadratic ``f(x) ≈ xᵀAx + bᵀx + c`` fitted under a Gaussian applicability;
for two frames the displacement satisfies ``A·d = −½(b₂ − b₁)`` with
``A = (A₁+A₂)/2``; the solve is stabilised by averaging ``AᵀA`` and
``AᵀΔb`` over a window before the 2×2 inverse.

Every correlation tap is a shifted multiply and add, and every 2×2
product, sum and solve is elementwise: no convolution or matrix product
reaches cuDNN or cuBLAS, so the result is full float32 whatever the
caller's TF32 flags, and the card runs the CPU's operations in the CPU's
order.  Internally the symmetric ``A`` is kept as three planes
(a11, a12, a22) and vectors as two; the public functions return the JAX
layouts.
"""

from __future__ import annotations

from functools import lru_cache
from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .color import resize_bilinear

POLY_N = 5          # expansion window half-size (cv2 poly_n=5)
POLY_SIGMA = 1.1    # applicability sigma (cv2's default companion to n=5)
WIN_SIZE = 15       # displacement averaging window (reference winsize=15)
N_ITERS = 3         # iterations per level (reference)
N_LEVELS = 3        # pyramid levels (reference)
PYR_SCALE = 0.5     # pyramid scale (reference)
DET_GUARD = 1e-9    # |det| below this is replaced by it


@lru_cache(maxsize=8)
def _poly_expansion_weights(n: int, sigma: float):
    """Precompute the separable correlation weights + normal-equation
    inverse for polynomial expansion (Farnebäck §4, OpenCV's
    FarnebackPrepareGaussian)."""
    x = np.arange(-n, n + 1, dtype=np.float64)
    w = np.exp(-(x**2) / (2.0 * sigma**2))
    w /= w.sum()
    # separable 1-D kernels: w, w·x, w·x²
    k0 = w
    k1 = w * x
    k2 = w * x * x
    # Gram matrix of basis [1, x, y, x², y², xy] under applicability
    s0 = w.sum()                # = 1
    s2 = (w * x * x).sum()
    s4 = (w * x * x * x * x).sum()
    # 2-D moments are products of 1-D ones (separable gaussian)
    # basis ordering: [1, x, y, x², y², xy]
    G = np.zeros((6, 6))
    G[0, 0] = s0 * s0
    G[0, 3] = G[3, 0] = s2 * s0
    G[0, 4] = G[4, 0] = s2 * s0
    G[1, 1] = s2 * s0
    G[2, 2] = s2 * s0
    G[3, 3] = s4 * s0
    G[4, 4] = s4 * s0
    G[3, 4] = G[4, 3] = s2 * s2
    G[5, 5] = s2 * s2
    Ginv = np.linalg.inv(G)
    return (k0.astype(np.float32), k1.astype(np.float32),
            k2.astype(np.float32), Ginv.astype(np.float32))


def _corr_axis(x: torch.Tensor, k: np.ndarray, axis: int) -> torch.Tensor:
    """1-D correlation of [B, H, W] along ``axis`` (1 rows, 2 columns) with
    edge padding, as shifted multiply-adds (taps that are exactly 0 are
    skipped: they add 0)."""
    n = (len(k) - 1) // 2
    size = x.shape[axis]
    pad = (0, 0, n, n) if axis == 1 else (n, n, 0, 0)
    xp = F.pad(x[:, None], pad, mode="replicate")[:, 0]
    out = None
    for i, tap in enumerate(k.tolist()):
        if tap == 0.0:
            continue
        term = xp.narrow(axis, i, size) * tap
        out = term if out is None else out + term
    return out


def _sep_corr(img: torch.Tensor, ky: np.ndarray, kx: np.ndarray) -> torch.Tensor:
    """Separable 2-D correlation over [B, H, W] with edge padding: ``ky``
    down the columns, then ``kx`` along the rows."""
    return _corr_axis(_corr_axis(img, ky, 1), kx, 2)


def _poly_planes(img: torch.Tensor, n: int = POLY_N, sigma: float = POLY_SIGMA):
    """Quadratic expansion as planes: ((a11, a12, a22), (bx, by))."""
    k0, k1, k2, Ginv = _poly_expansion_weights(n, sigma)
    # moments m_{ij} = Σ w(x)w(y) x^i y^j f   (x → columns, y → rows); the
    # column passes are shared by the moments of equal y order
    c0, c1, c2 = (_corr_axis(img, k, 1) for k in (k0, k1, k2))
    moments = [_corr_axis(c0, k0, 2),   # m00
               _corr_axis(c0, k1, 2),   # m10, x moment
               _corr_axis(c1, k0, 2),   # m01, y moment
               _corr_axis(c0, k2, 2),   # m20
               _corr_axis(c2, k0, 2),   # m02
               _corr_axis(c1, k1, 2)]   # m11

    # solve G·coef = moments for basis [1, x, y, x², y², xy], row by row
    def coef(i: int) -> torch.Tensor:
        out = None
        for j, g in enumerate(Ginv[i].tolist()):
            if g == 0.0:
                continue
            term = moments[j] * g
            out = term if out is None else out + term
        return out

    cx, cy, cxx, cyy, cxy = (coef(i) for i in range(1, 6))
    half = cxy / 2.0
    return (cxx, half, cyy), (cx, cy)


def poly_expansion(img: torch.Tensor, n: int = POLY_N,
                   sigma: float = POLY_SIGMA):
    """Quadratic expansion coefficients per pixel.

    img: [B, H, W] float32 → (A [B,H,W,2,2], b [B,H,W,2]).
    """
    (a11, a12, a22), (bx, by) = _poly_planes(img, n, sigma)
    A = torch.stack([torch.stack([a11, a12], dim=-1),
                     torch.stack([a12, a22], dim=-1)], dim=-2)
    return A, torch.stack([bx, by], dim=-1)


def _warp_planes(planes: Sequence[torch.Tensor], fx: torch.Tensor,
                 fy: torch.Tensor) -> List[torch.Tensor]:
    """Sample each [B, H, W] plane at (x + fx, y + fy): bilinear, edge
    clamp, four gathers over the flat index ``b·H·W + y·W + x``."""
    B, H, W = fx.shape
    dev = fx.device
    xx = torch.arange(W, device=dev, dtype=torch.float32)
    yy = torch.arange(H, device=dev, dtype=torch.float32)[:, None]
    sx = (xx + fx).clamp(0.0, W - 1.0)
    sy = (yy + fy).clamp(0.0, H - 1.0)
    x0f, y0f = sx.floor(), sy.floor()
    x0, y0 = x0f.long(), y0f.long()
    x1 = (x0 + 1).clamp_max(W - 1)
    y1 = (y0 + 1).clamp_max(H - 1)
    wx, wy = sx - x0f, sy - y0f
    base = (torch.arange(B, device=dev) * (H * W))[:, None, None]
    corners = [base + y * W + x for y, x in ((y0, x0), (y0, x1), (y1, x0), (y1, x1))]
    out = []
    for plane in planes:
        flat = plane.reshape(-1)
        v00, v01, v10, v11 = (flat[i] for i in corners)
        out.append((v00 * (1 - wx) + v01 * wx) * (1 - wy)
                   + (v10 * (1 - wx) + v11 * wx) * wy)
    return out


def _warp_field(field: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Sample ``field`` [B, H, W, C] at x + flow (bilinear, edge clamp)."""
    planes = _warp_planes(field.unbind(-1), flow[..., 0], flow[..., 1])
    return torch.stack(planes, dim=-1)


def _box_planes(planes: Sequence[torch.Tensor], size: int) -> List[torch.Tensor]:
    k = np.ones(size, dtype=np.float32) / size
    return [_sep_corr(p, k, k) for p in planes]


def _box_blur(x: torch.Tensor, size: int) -> torch.Tensor:
    """[B, H, W, C] box filter (the displacement averaging window)."""
    return torch.stack(_box_planes(x.unbind(-1), size), dim=-1)


def _flow_level(prev: torch.Tensor, cur: torch.Tensor, flow: torch.Tensor,
                win_size: int, n_iters: int) -> torch.Tensor:
    """Refine ``flow`` [B, H, W, 2] at one pyramid level."""
    A1, b1 = _poly_planes(prev)
    A2, b2 = _poly_planes(cur)
    fx, fy = flow[..., 0], flow[..., 1]
    for _ in range(n_iters):
        w11, w12, w22, wbx, wby = _warp_planes((*A2, *b2), fx, fy)
        a11 = 0.5 * (A1[0] + w11)
        a12 = 0.5 * (A1[1] + w12)
        a22 = 0.5 * (A1[2] + w22)
        # Δb = −½(b₂(x+d) − b₁(x)) + A·d  (Farnebäck eq. 7 with prior d)
        db0 = -0.5 * (wbx - b1[0]) + (a11 * fx + a12 * fy)
        db1 = -0.5 * (wby - b1[1]) + (a12 * fx + a22 * fy)
        # normal equations AᵀA, AᵀΔb, averaged over the window
        g00, g01, g11, h0, h1 = _box_planes(
            (a11 * a11 + a12 * a12, a11 * a12 + a12 * a22,
             a12 * a12 + a22 * a22, a11 * db0 + a12 * db1,
             a12 * db0 + a22 * db1), win_size)
        det = g00 * g11 - g01 * g01
        det = torch.where(det.abs() < DET_GUARD, DET_GUARD, det)
        fx = (g11 * h0 - g01 * h1) / det
        fy = (-g01 * h0 + g00 * h1) / det
    return torch.stack([fx, fy], dim=-1)


def _pyramid(H: int, W: int, levels: int) -> List[Tuple[int, int]]:
    """Level sizes, coarse → fine (Python's round: half to even)."""
    dims = []
    h, w = H, W
    for _ in range(levels):
        dims.append((h, w))
        h = max(8, int(round(h * PYR_SCALE)))
        w = max(8, int(round(w * PYR_SCALE)))
    return dims[::-1]


def farneback_flow(prev: torch.Tensor, cur: torch.Tensor,
                   levels: int = N_LEVELS, win_size: int = WIN_SIZE,
                   iters: int = N_ITERS) -> torch.Tensor:
    """Dense flow for frame-pair batches: [B, H, W] × 2 → [B, H, W, 2].

    flow[..., 0] is the x displacement, flow[..., 1] the y displacement.
    """
    B, H, W = prev.shape
    dims = _pyramid(H, W, levels)
    flow = torch.zeros((B, dims[0][0], dims[0][1], 2), dtype=torch.float32,
                       device=prev.device)
    for i, (lh, lw) in enumerate(dims):
        p = resize_bilinear(prev, lh, lw)
        c = resize_bilinear(cur, lh, lw)
        if i > 0:
            prev_h, prev_w = dims[i - 1]
            flow = resize_bilinear(flow, lh, lw)
            fx = flow[..., 0] * float(np.float32(lw / prev_w))
            fy = flow[..., 1] * float(np.float32(lh / prev_h))
            flow = torch.stack([fx, fy], dim=-1)
        flow = _flow_level(p, c, flow, win_size, iters)
    return flow


def warped_residual(prev: torch.Tensor, cur: torch.Tensor,
                    flow: torch.Tensor) -> torch.Tensor:
    """Motion-compensated mean absolute residual per pair — the reference's
    DFD statistic computed from a flow field (`shot.py:93-99`)."""
    (recon,) = _warp_planes((cur,), flow[..., 0], flow[..., 1])
    return (prev - recon).abs().mean(dim=(1, 2))


def dfd_series_farneback(gray: torch.Tensor) -> torch.Tensor:
    """Farneback-based DFD series over consecutive frames ([T, H, W])."""
    prev, cur = gray[:-1], gray[1:]
    return warped_residual(prev, cur, farneback_flow(prev, cur))
