"""Bilinear sampling, affine warps and chip extraction.

Port of ``pyannote_video_tpu/ops/warp.py``: the DSST tracker's patch sampler
(``separable_resize_chips``), and the point sampler, gathered affine warp
and similarity fit that landmarks and face chips use (ORB will too).

``separable_resize_chips`` keeps the JAX function's contract: chips are cut with an axis-aligned 2×3 matrix
(chip → image; any rotation component is ignored), coordinates are clipped
to the frame, the right/bottom tap is ``min(x0 + 1, W - 1)``, and the two
horizontal taps are blended before the two vertical ones.

The JAX function gathers whole source *columns* from a transposed
``[T·W, H·C]`` copy of the frame stack, because per-pixel gathers run as
scalar loops on the TPU.  A GPU gathers single elements at full rate, so
this port reads only the four taps each output pixel needs, straight from
the ``[T, H, W, C]`` stack, and applies the same arithmetic in the same
order (``a·(1−wx) + b·wx`` per row, then ``top·(1−wy) + bot·wy``).
``transpose_for_chips`` and ``separable_resize_chips_t`` therefore have no
counterpart here: there is no transposed stack to build or to pass.

``bilinear_sample`` and ``gather_affine_warp`` read four taps per point
through one flat index and blend them in the JAX order.  The JAX package's
``optimization_barrier``s around the indices are lowering hints for its
compiler and have no counterpart.  ``similarity_from_points`` is batched
over a leading axis (the JAX package ``vmap``s it); ``invert_affine`` is
the closed-form 2×2 inverse, so neither launches a solver per face.
"""

from __future__ import annotations

import torch


def separable_resize_chips(images: torch.Tensor, frame_idx: torch.Tensor,
                           matrices: torch.Tensor, out_h: int,
                           out_w: int) -> torch.Tensor:
    """Cut N axis-aligned chips from a frame stack.

    images [T, H, W, C] (uint8 ok), frame_idx [N] integer, matrices
    [N, 2, 3] float32 (chip → image: ``x = m00·px + m02``,
    ``y = m11·py + m12``) → [N, out_h, out_w, C] float32.  Explicit integer
    indexing: no call whose shape or control flow depends on the data.
    """
    T, H, W, C = images.shape
    dev = images.device
    flat = images.reshape(T * H * W, C)

    sx = matrices[:, 0, 0]
    sy = matrices[:, 1, 1]
    ox = matrices[:, 0, 2]
    oy = matrices[:, 1, 2]
    px = torch.arange(out_w, dtype=torch.float32, device=dev)
    py = torch.arange(out_h, dtype=torch.float32, device=dev)
    in_x = (ox[:, None] + sx[:, None] * px[None]).clamp(0.0, W - 1.0)
    in_y = (oy[:, None] + sy[:, None] * py[None]).clamp(0.0, H - 1.0)

    x0f = in_x.floor()
    y0f = in_y.floor()
    wx = (in_x - x0f)[:, None, :, None]                 # [N, 1, out_w, 1]
    wy = (in_y - y0f)[:, :, None, None]                 # [N, out_h, 1, 1]
    x0 = x0f.to(torch.long)[:, None, :]
    y0 = y0f.to(torch.long)
    x1 = (x0 + 1).clamp_max(W - 1)
    y1 = (y0 + 1).clamp_max(H - 1)

    base = frame_idx.to(torch.long)[:, None] * (H * W)  # [N, 1]
    row0 = (base + y0 * W)[:, :, None]                  # [N, out_h, 1]
    row1 = (base + y1 * W)[:, :, None]

    def take(idx):
        return flat[idx].to(torch.float32)              # [N, out_h, out_w, C]

    top = take(row0 + x0) * (1.0 - wx) + take(row0 + x1) * wx
    bot = take(row1 + x0) * (1.0 - wx) + take(row1 + x1) * wx
    return top * (1.0 - wy) + bot * wy


def bilinear_sample(image: torch.Tensor, ys: torch.Tensor,
                    xs: torch.Tensor) -> torch.Tensor:
    """Sample ``image`` [H, W, C] (or [H, W]) at float coordinates
    (ys, xs) of any common shape; out-of-bounds coordinates clamp to the
    edge.  Returns ``ys.shape`` (+ ``[C]``) float32."""
    H, W = image.shape[0], image.shape[1]
    squeeze = image.dim() == 2
    flat = image.reshape(H * W, -1)
    out_shape = ys.shape

    ys = ys.reshape(-1).clamp(0.0, H - 1.0)
    xs = xs.reshape(-1).clamp(0.0, W - 1.0)
    y0f = ys.floor()
    x0f = xs.floor()
    y0 = y0f.to(torch.long)
    x0 = x0f.to(torch.long)
    y1 = (y0 + 1).clamp_max(H - 1)
    x1 = (x0 + 1).clamp_max(W - 1)
    wy = (ys - y0f)[:, None]
    wx = (xs - x0f)[:, None]

    def take(yy, xx):
        return flat[yy * W + xx].to(torch.float32)

    top = take(y0, x0) * (1 - wx) + take(y0, x1) * wx
    bot = take(y1, x0) * (1 - wx) + take(y1, x1) * wx
    out = top * (1 - wy) + bot * wy                     # [P, C]
    if squeeze:
        return out.reshape(out_shape)
    return out.reshape(*out_shape, image.shape[2])


def gather_affine_warp(images: torch.Tensor, frame_idx: torch.Tensor,
                       matrices: torch.Tensor, out_h: int,
                       out_w: int) -> torch.Tensor:
    """Extract N chips from a frame batch: chip i warps frame frame_idx[i].

    images [T, H, W, C], frame_idx [N] integer, matrices [N, 2, 3]
    (OUTPUT → INPUT: ``in_xy = matrix @ [out_x, out_y, 1]``)
    → [N, out_h, out_w, C] float32.  One flat index
    ``fi·H·W + y·W + x`` over the whole stack: no [N, H, W, C] copy of
    frames is ever made.
    """
    T, H, W, C = images.shape
    dev = images.device
    flat = images.reshape(T * H * W, C)

    ys_o, xs_o = torch.meshgrid(
        torch.arange(out_h, dtype=torch.float32, device=dev),
        torch.arange(out_w, dtype=torch.float32, device=dev), indexing="ij")
    ys_o = ys_o.reshape(-1)
    xs_o = xs_o.reshape(-1)

    in_x = (matrices[:, 0, 0, None] * xs_o[None]
            + matrices[:, 0, 1, None] * ys_o[None]
            + matrices[:, 0, 2, None]).clamp(0.0, W - 1.0)       # [N, P]
    in_y = (matrices[:, 1, 0, None] * xs_o[None]
            + matrices[:, 1, 1, None] * ys_o[None]
            + matrices[:, 1, 2, None]).clamp(0.0, H - 1.0)

    x0f = in_x.floor()
    y0f = in_y.floor()
    x0 = x0f.to(torch.long)
    y0 = y0f.to(torch.long)
    x1 = (x0 + 1).clamp_max(W - 1)
    y1 = (y0 + 1).clamp_max(H - 1)
    wx = (in_x - x0f)[..., None]
    wy = (in_y - y0f)[..., None]
    base = frame_idx.to(torch.long)[:, None] * (H * W)           # [N, 1]

    def take(yy, xx):
        return flat[base + yy * W + xx].to(torch.float32)        # [N, P, C]

    top = take(y0, x0) * (1 - wx) + take(y0, x1) * wx
    bot = take(y1, x0) * (1 - wx) + take(y1, x1) * wx
    out = top * (1 - wy) + bot * wy
    return out.reshape(frame_idx.shape[0], out_h, out_w, C)


def batched_affine_warp(images: torch.Tensor, matrices: torch.Tensor,
                        out_h: int, out_w: int) -> torch.Tensor:
    """images [B, H, W, C] × matrices [B, 2, 3] → [B, out_h, out_w, C]:
    image i warped by matrix i."""
    idx = torch.arange(images.shape[0], device=images.device)
    return gather_affine_warp(images, idx, matrices, out_h, out_w)


def affine_warp(image: torch.Tensor, matrix: torch.Tensor, out_h: int,
                out_w: int) -> torch.Tensor:
    """Warp one image [H, W, C] with a 2×3 matrix mapping OUTPUT → INPUT
    coordinates.  Returns [out_h, out_w, C]."""
    return batched_affine_warp(image[None], matrix[None], out_h, out_w)[0]


def similarity_from_points(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Least-squares similarity transform (rotation + scale + translation).

    Finds s·R, t minimising ‖(s·R·src + t) − dst‖² (Umeyama without
    reflection handling).  src, dst: [..., P, 2] point sets (x, y), either
    may lack the leading axes of the other; returns [..., 2, 3] matrices
    mapping src → dst.
    """
    src = src.to(torch.float32)
    dst = dst.to(torch.float32)
    mu_s = src.mean(dim=-2)
    mu_d = dst.mean(dim=-2)
    s_c = src - mu_s[..., None, :]
    d_c = dst - mu_d[..., None, :]
    var_s = (s_c * s_c).sum(dim=(-2, -1)).clamp_min(1e-12)
    # complex-number form of the 2-D similarity fit:
    # a + ib = Σ conj(s)·d / Σ |s|²
    a = (s_c[..., 0] * d_c[..., 0] + s_c[..., 1] * d_c[..., 1]).sum(-1) / var_s
    b = (s_c[..., 0] * d_c[..., 1] - s_c[..., 1] * d_c[..., 0]).sum(-1) / var_s
    tx = mu_d[..., 0] - (a * mu_s[..., 0] - b * mu_s[..., 1])
    ty = mu_d[..., 1] - (b * mu_s[..., 0] + a * mu_s[..., 1])
    return torch.stack([torch.stack([a, -b, tx], dim=-1),
                        torch.stack([b, a, ty], dim=-1)], dim=-2)


def invert_affine(matrix: torch.Tensor) -> torch.Tensor:
    """Invert 2×3 affine matrices [..., 2, 3] (closed-form 2×2 inverse)."""
    a, b, tx = matrix[..., 0, 0], matrix[..., 0, 1], matrix[..., 0, 2]
    c, d, ty = matrix[..., 1, 0], matrix[..., 1, 1], matrix[..., 1, 2]
    det = a * d - b * c
    ia, ib, ic, id_ = d / det, -b / det, -c / det, a / det
    return torch.stack(
        [torch.stack([ia, ib, -(ia * tx + ib * ty)], dim=-1),
         torch.stack([ic, id_, -(ic * tx + id_ * ty)], dim=-1)], dim=-2)
