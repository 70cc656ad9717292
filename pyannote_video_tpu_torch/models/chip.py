"""Face-chip alignment: landmarks → similarity transform → 150×150 chip.

Port of ``pyannote_video_tpu/models/chip.py``, the counterpart of dlib's
``get_face_chip_details(shape, 150, 0.25)`` + ``extract_image_chip``: a
least-squares similarity transform is fitted from the detected landmarks
to a canonical landmark layout, then the chip is cut by bilinear sampling
(``ops/warp.py``), all faces of a frame batch at once.  Nothing here waits
for the device.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..ops.warp import (gather_affine_warp, separable_resize_chips,
                        similarity_from_points)
from ..utils.synthetic import CANONICAL_LANDMARKS

CHIP_SIZE = 150
PADDING = 0.25


def canonical_chip_landmarks(chip_size: int = CHIP_SIZE,
                             padding: float = PADDING) -> np.ndarray:
    """The canonical 68 landmarks in chip pixel coordinates.

    The unit face frame ([-1, 1]²) is centered in the chip with a margin of
    ``padding`` of the face size on each side — the dlib padding convention
    (0.25 → the face occupies the middle 2/3 of the chip).
    """
    scale = chip_size / (2.0 * (1.0 + 2.0 * padding))
    center = chip_size / 2.0
    return (CANONICAL_LANDMARKS * scale + center).astype(np.float32)


@lru_cache(maxsize=None)
def _chip_target(device: torch.device) -> torch.Tensor:
    """The canonical chip landmarks on ``device``, built once per device."""
    return torch.from_numpy(canonical_chip_landmarks()).to(device)


@lru_cache(maxsize=None)
def _canonical(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(
        np.asarray(CANONICAL_LANDMARKS, dtype=np.float32)).to(device)


def chip_transforms(landmarks: torch.Tensor) -> torch.Tensor:
    """Per-face CHIP → IMAGE affine matrices from detected landmarks.

    landmarks [N, 68, 2] in image coordinates → [N, 2, 3] matrices mapping
    chip pixels to image pixels, the direction the warps consume
    (output → input).
    """
    return similarity_from_points(_chip_target(landmarks.device), landmarks)


def _axis_aligned(matrices: torch.Tensor, chip_size: float) -> torch.Tensor:
    """Drop the rotation component of chip → image similarity matrices.

    Keeps the isotropic scale (|a + bi|) and re-anchors the translation so
    that the chip's center maps to the same image point.  Face roll in
    video is small; the axis-aligned form is what
    ``ops/warp.py:separable_resize_chips`` takes.
    """
    a = matrices[:, 0, 0]
    b = matrices[:, 1, 0]
    scale = torch.sqrt(a * a + b * b)
    c = chip_size / 2.0
    cx_img = matrices[:, 0, 0] * c + matrices[:, 0, 1] * c + matrices[:, 0, 2]
    cy_img = matrices[:, 1, 0] * c + matrices[:, 1, 1] * c + matrices[:, 1, 2]
    zeros = torch.zeros_like(scale)
    row0 = torch.stack([scale, zeros, cx_img - scale * c], dim=1)
    row1 = torch.stack([zeros, scale, cy_img - scale * c], dim=1)
    return torch.stack([row0, row1], dim=1)


def extract_chips(frames: torch.Tensor, frame_idx: torch.Tensor,
                  landmarks: torch.Tensor,
                  chip_size: int = CHIP_SIZE) -> torch.Tensor:
    """Cut aligned face chips out of a frame batch (axis-aligned: the
    rotation is dropped; ``extract_chips_exact`` keeps it).

    frames [T, H, W, 3], frame_idx [N], landmarks [N, 68, 2]
    → chips [N, chip_size, chip_size, 3] float32.
    """
    matrices = _axis_aligned(chip_transforms(landmarks), float(chip_size))
    return separable_resize_chips(frames, frame_idx, matrices,
                                  chip_size, chip_size)


def extract_chips_yuv(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                      frame_idx: torch.Tensor, landmarks: torch.Tensor,
                      chip_size: int = CHIP_SIZE) -> torch.Tensor:
    """Aligned RGB chips straight from planar YUV 4:2:0 frames.

    y [T, H, W] uint8, u/v [T, H/2, W/2] uint8, frame_idx [N],
    landmarks [N, 68, 2] → chips [N, chip_size, chip_size, 3] float32.

    The luma plane and the half-resolution chroma planes are sampled
    separately with the same chip transform (chroma through the I420 half
    grid: chroma sample (r, c) is centered at full-resolution
    (2r + 0.5, 2c + 0.5)), and the BT.601 limited-range inverse is applied
    to the chip's pixels only: no full-resolution RGB frame is made.
    """
    matrices = _axis_aligned(chip_transforms(landmarks), float(chip_size))
    chip_y = separable_resize_chips(y[..., None], frame_idx, matrices,
                                    chip_size, chip_size)[..., 0]
    # chip → image through the half-resolution chroma grid:
    #   x_chroma = (x_full − 0.5) / 2  →  scale/2, (offset − 0.5)/2
    mc = torch.cat([matrices[:, :, :2] * 0.5,
                    (matrices[:, :, 2:] - 0.5) * 0.5], dim=2)
    chip_u = separable_resize_chips(u[..., None], frame_idx, mc,
                                    chip_size, chip_size)[..., 0]
    chip_v = separable_resize_chips(v[..., None], frame_idx, mc,
                                    chip_size, chip_size)[..., 0]
    yf = (chip_y - 16.0) * 1.164
    uf = chip_u - 128.0
    vf = chip_v - 128.0
    r = yf + 1.596 * vf
    g = yf - 0.392 * uf - 0.813 * vf
    b = yf + 2.017 * uf
    return torch.stack([r, g, b], dim=-1).clamp(0.0, 255.0)


def extract_chips_exact(frames: torch.Tensor, frame_idx: torch.Tensor,
                        landmarks: torch.Tensor,
                        chip_size: int = CHIP_SIZE) -> torch.Tensor:
    """Exact (rotation-preserving) chip extraction, four taps per pixel."""
    return gather_affine_warp(frames, frame_idx, chip_transforms(landmarks),
                              chip_size, chip_size)


def box_to_landmarks(boxes: torch.Tensor) -> torch.Tensor:
    """Mean-shape landmarks placed inside detection boxes.

    boxes [N, 4] (left, top, right, bottom) → [N, 68, 2].  This is the ERT
    cascade's shape initialisation, and what the ``Face`` facade returns
    when it was given no landmark model.
    """
    boxes = boxes.to(torch.float32)
    cx = (boxes[:, 0] + boxes[:, 2]) / 2.0
    cy = (boxes[:, 1] + boxes[:, 3]) / 2.0
    half_w = (boxes[:, 2] - boxes[:, 0]) / 2.0
    half_h = (boxes[:, 3] - boxes[:, 1]) / 2.0
    canon = _canonical(boxes.device)
    x = cx[:, None] + canon[None, :, 0] * half_w[:, None]
    y = cy[:, None] + canon[None, :, 1] * half_h[:, None]
    return torch.stack([x, y], dim=-1)
