"""Host-side NumPy image ops (resize, grayscale, affine warp, filter).

Used on the ingest path (`io/video.py` frame_size downscaling), by the
synthetic fixtures and by the trainers' data generators
(``train/data.py``, ``train/train_landmarks.py``), which run where OpenCV
is not installed.  The batched device versions of resize and grayscale live
in ``ops/color.py``; hot pipeline stages never call these per-frame host
versions.

Semantics follow the OpenCV calls the reference and the JAX trainers make:
``cv2.resize(..., INTER_LINEAR)`` (`video.py:403`),
``cv2.cvtColor(rgb, COLOR_RGB2GRAY)`` (`structure/shot.py:72`),
``cv2.warpAffine(..., INTER_LINEAR, BORDER_REFLECT)`` and ``cv2.filter2D``
(default border, REFLECT_101).  They agree with OpenCV to float32 rounding,
not bit for bit (``tests/test_torch_train_data.py`` states the tolerance).
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


def _reflect(index: np.ndarray, n: int) -> np.ndarray:
    """OpenCV's BORDER_REFLECT (``fedcba|abcdefgh|hgfedcb``) at any
    distance from the edge."""
    index = np.mod(index, 2 * n)
    return np.where(index >= n, 2 * n - 1 - index, index)


def warp_affine(image: np.ndarray, M: np.ndarray, size) -> np.ndarray:
    """``cv2.warpAffine(image, M, size, flags=INTER_LINEAR,
    borderMode=BORDER_REFLECT)``: dst(x, y) = image(M⁻¹·(x, y, 1)), sampled
    bilinearly; source taps outside the image reflect at its edge.

    image: (H, W) or (H, W, C); M: 2×3 forward map; size: (width,
    height) of the output.  Returns float32.
    """
    w, h = size
    m = np.asarray(M, dtype=np.float64).reshape(2, 3)
    # OpenCV's invertAffineTransform, in double
    det = m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]
    det = 1.0 / det if det != 0 else 0.0
    a11, a12 = m[1, 1] * det, -m[0, 1] * det
    a21, a22 = -m[1, 0] * det, m[0, 0] * det
    b1 = -a11 * m[0, 2] - a12 * m[1, 2]
    b2 = -a21 * m[0, 2] - a22 * m[1, 2]
    xs = np.arange(w, dtype=np.float64)[None, :]
    ys = np.arange(h, dtype=np.float64)[:, None]
    sx = a11 * xs + a12 * ys + b1
    sy = a21 * xs + a22 * ys + b2
    x0, y0 = np.floor(sx).astype(np.int64), np.floor(sy).astype(np.int64)
    fx, fy = (sx - x0).astype(np.float32), (sy - y0).astype(np.float32)
    in_h, in_w = image.shape[:2]
    xa, xb = _reflect(x0, in_w), _reflect(x0 + 1, in_w)
    ya, yb = _reflect(y0, in_h), _reflect(y0 + 1, in_h)
    src = image.astype(np.float32)
    if src.ndim == 3:
        fx, fy = fx[..., None], fy[..., None]
    one = np.float32(1.0)
    return (src[ya, xa] * ((one - fy) * (one - fx))
            + src[ya, xb] * ((one - fy) * fx)
            + src[yb, xa] * (fy * (one - fx))
            + src[yb, xb] * (fy * fx))


def filter2d(image: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """``cv2.filter2D(image, -1, kernel)`` on a float32 image: correlation
    with the kernel anchored at its centre (``k // 2``), borders by
    REFLECT_101 (``gfedcb|abcdefgh|gfedcba``, NumPy's ``"reflect"``)."""
    kernel = np.asarray(kernel, dtype=np.float32)
    kh, kw = kernel.shape
    h, w = image.shape[:2]
    pad = [(kh // 2, kh - 1 - kh // 2), (kw // 2, kw - 1 - kw // 2)]
    padded = np.pad(image.astype(np.float32),
                    pad + [(0, 0)] * (image.ndim - 2), mode="reflect")
    out = np.zeros(image.shape, dtype=np.float32)
    for i in range(kh):
        for j in range(kw):
            out += kernel[i, j] * padded[i:i + h, j:j + w]
    return out
