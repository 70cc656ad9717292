"""Axis-aligned bilinear chip extraction (the DSST tracker's patch sampler).

Port of ``separable_resize_chips`` from ``pyannote_video_tpu/ops/warp.py``,
with the same contract: chips are cut with an axis-aligned 2×3 matrix
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

``bilinear_sample``, ``gather_affine_warp``, ``similarity_from_points`` and
``invert_affine`` serve landmarks, face chips and ORB; they are ported with
the extract stage.
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
