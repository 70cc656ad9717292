"""Host-side NumPy image ops (resize, grayscale).

Used only on the ingest path (`io/video.py` frame_size downscaling, synthetic
fixtures).  The batched device versions of these ops live in ``ops/color.py``;
hot pipeline stages never call these per-frame host versions.

Semantics match the OpenCV calls the reference makes:
``cv2.resize(..., INTER_LINEAR)`` (`video.py:403`) and
``cv2.cvtColor(rgb, COLOR_RGB2GRAY)`` (`structure/shot.py:72`).
"""

from __future__ import annotations

import numpy as np

# ITU-R BT.601 luma weights — what cv2.COLOR_RGB2GRAY uses.
LUMA_R, LUMA_G, LUMA_B = 0.299, 0.587, 0.114


def rgb_to_gray(rgb: np.ndarray) -> np.ndarray:
    """RGB (..., 3) uint8/float -> grayscale (...), same dtype family as cv2.

    uint8 input returns uint8 (rounded), float returns float32.
    """
    rgb = np.asarray(rgb)
    gray = (
        LUMA_R * rgb[..., 0].astype(np.float32)
        + LUMA_G * rgb[..., 1].astype(np.float32)
        + LUMA_B * rgb[..., 2].astype(np.float32)
    )
    if rgb.dtype == np.uint8:
        return np.clip(np.round(gray), 0, 255).astype(np.uint8)
    return gray.astype(np.float32)


def bilinear_resize(image: np.ndarray, width: int, height: int) -> np.ndarray:
    """Bilinear resize to (height, width); pixel-center aligned like OpenCV.

    Supports (H, W) and (H, W, C) inputs; preserves uint8 via rounding.
    """
    image = np.asarray(image)
    in_h, in_w = image.shape[:2]
    if (in_w, in_h) == (width, height):
        return image.copy()

    src = image.astype(np.float32)
    if src.ndim == 2:
        src = src[:, :, None]
        squeeze = True
    else:
        squeeze = False

    # OpenCV pixel-center mapping: src_x = (dst_x + 0.5) * scale - 0.5
    sx = in_w / width
    sy = in_h / height
    xs = (np.arange(width, dtype=np.float32) + 0.5) * sx - 0.5
    ys = (np.arange(height, dtype=np.float32) + 0.5) * sy - 0.5
    xs = np.clip(xs, 0, in_w - 1)
    ys = np.clip(ys, 0, in_h - 1)

    x0 = np.floor(xs).astype(np.int64)
    y0 = np.floor(ys).astype(np.int64)
    x1 = np.minimum(x0 + 1, in_w - 1)
    y1 = np.minimum(y0 + 1, in_h - 1)
    wx = (xs - x0)[None, :, None]
    wy = (ys - y0)[:, None, None]

    top = src[y0][:, x0] * (1 - wx) + src[y0][:, x1] * wx
    bot = src[y1][:, x0] * (1 - wx) + src[y1][:, x1] * wx
    out = top * (1 - wy) + bot * wy

    if squeeze:
        out = out[:, :, 0]
    if image.dtype == np.uint8:
        return np.clip(np.round(out), 0, 255).astype(np.uint8)
    return out.astype(image.dtype)
