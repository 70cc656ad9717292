"""Batched ORB features: FAST corners + steered-BRIEF binary descriptors.

Port of ``pyannote_video_tpu/ops/orb.py`` (an XLA program there, tensor
code here): detection, orientation and description run over a *batch* of
frames with fixed keypoint slots, and matching is an exact 2-NN Hamming
search written as one matrix product (`hamming_2nn`).

The JAX version is built so that match counts cannot flap between
backends, and every step of that design is kept: integer gray levels; an
exact 5×5 box *sum* (shifted adds of integers below 2^24, whatever the
caller's TF32 or cuDNN flags), then one IEEE division by 25; FAST
strengths, moments and the top-K key in integers; the angle quantised to
1,024 bins.  What can still differ by an ulp between XLA and torch, or
between the CPU and the card, is ``atan2``/``cos``/``sin``: an angle on a
bin edge moves one bin, a rotated sample point at exactly .5 rounds the
other way.  So keypoints and ``valid`` are exact; a few descriptor bits
may differ (the tests bound their share).

The per-keypoint ``vmap``s of the JAX version are gathers over one flat
index ``b·H·W + y·W + x`` into the whole batch.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

N_BITS = 256
PATCH = 31          # descriptor patch diameter
FAST_T = 20.0       # FAST threshold
MAX_KP = 500        # keypoint slots per frame (cv2.ORB default nfeatures)

# Bresenham circle of radius 3 — the FAST-9/16 test ring, clockwise from
# 12 o'clock, as (dx, dy).
_CIRCLE = np.asarray(
    [(0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
     (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3)],
    dtype=np.int32,
)


def _brief_pattern(seed: int = 7) -> np.ndarray:
    """[N_BITS, 4] sampling pairs (x1, y1, x2, y2), Gaussian σ = PATCH/5."""
    rng = np.random.default_rng(seed)
    sigma = PATCH / 5.0
    pts = np.clip(rng.normal(0.0, sigma, size=(N_BITS, 4)),
                  -(PATCH // 2), PATCH // 2)
    return pts.astype(np.float32)


_PATTERN = _brief_pattern()
_BIN_W = float(np.float32(2.0 * np.pi / 1024.0))

# the radius-15 disc of the intensity centroid, as integer offsets
_R = PATCH // 2
_DISC_Y, _DISC_X = [a.astype(np.int64) for a in np.nonzero(
    (np.arange(-_R, _R + 1)[:, None] ** 2
     + np.arange(-_R, _R + 1)[None, :] ** 2) <= _R * _R)]
_DISC_Y -= _R
_DISC_X -= _R


def _shift2d(img: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """out[y, x] = img[y+dy, x+dx], wrapping around (``jnp.roll``)."""
    return torch.roll(img, shifts=(-dy, -dx), dims=(-2, -1))


def _divide(x: torch.Tensor, value: float) -> torch.Tensor:
    """IEEE ``x / value``: a divisor on the device, since CUDA turns a
    division by a host scalar into a product with its reciprocal."""
    return x / torch.full((), value, dtype=x.dtype, device=x.device)


def _box_sum5(x: torch.Tensor) -> torch.Tensor:
    """5×5 zero-padded box sum of [B, H, W] integer values by shifted adds
    (exact below 2^24 in any order)."""
    H, W = x.shape[-2:]
    p = F.pad(x, (2, 2, 2, 2))
    rows = p[:, 0:H] + p[:, 1:H + 1] + p[:, 2:H + 2] + p[:, 3:H + 3] + p[:, 4:H + 4]
    return (rows[..., 0:W] + rows[..., 1:W + 1] + rows[..., 2:W + 2]
            + rows[..., 3:W + 3] + rows[..., 4:W + 4])


def _arc9_strength(diffs: torch.Tensor) -> torch.Tensor:
    """cv2's FAST score over [B, 16, H, W] ring differences: the max over
    the 16 arcs of 9 contiguous ring pixels of the arc's minimum.  Minima
    by doubling along the ring (2, 4, 8, then the 9th); min and max are
    exact, so this equals the arc-by-arc loop."""
    m2 = torch.minimum(diffs, torch.roll(diffs, -1, dims=1))
    m4 = torch.minimum(m2, torch.roll(m2, -2, dims=1))
    m8 = torch.minimum(m4, torch.roll(m4, -4, dims=1))
    return torch.minimum(m8, torch.roll(diffs, -8, dims=1)).amax(dim=1)


def detect_and_describe(grays: torch.Tensor, max_kp: int = MAX_KP,
                        threshold: float = FAST_T):
    """FAST-9 keypoints + oriented BRIEF descriptors for a frame batch.

    grays: [B, H, W] float32, on the device where the work runs.
    Returns (keypoints [B, K, 3] (x, y, angle), valid [B, K] bool,
             descriptors [B, K, N_BITS] float32 in {0, 1}).
    """
    B, H, W = grays.shape
    dev = grays.device
    grays = torch.round(grays)

    # light 5×5 box smoothing: an exact integer sum, then one division
    smooth = _divide(_box_sum5(grays), 25.0)

    # --- FAST-9 corner test, vectorised over the ring ----------------------
    ring = torch.stack(
        [_shift2d(grays, int(dy), int(dx)) for dx, dy in _CIRCLE], dim=1)
    center = grays[:, None]
    strength = torch.maximum(_arc9_strength(ring - center),   # bright arcs
                             _arc9_strength(center - ring))   # dark arcs
    del ring
    response = torch.where(strength > threshold, strength, 0.0)

    # 3×3 non-maximum suppression (max_pool2d pads with -inf)
    local_max = F.max_pool2d(response[:, None], 3, 1, 1)[:, 0]
    response = torch.where(response >= local_max, response, 0.0)

    # keep a safe border (descriptor patch + FAST ring)
    border = PATCH // 2 + 4
    yy = torch.arange(H, device=dev)[:, None]
    xx = torch.arange(W, device=dev)[None, :]
    inside = ((yy >= border) & (yy < H - border)
              & (xx >= border) & (xx < W - border))
    response = response * inside[None]

    # --- top-K keypoint slots on an int32 key, pixel index as tie-break ---
    hw = H * W
    idx = torch.arange(hw, dtype=torch.int32, device=dev)
    key = response.reshape(B, hw).to(torch.int32) * hw + (hw - 1 - idx)
    top_key = torch.topk(key, max_kp, dim=1).values
    top_resp = top_key // hw
    top_idx = (hw - 1) - top_key % hw
    kp_y = top_idx // W
    kp_x = top_idx % W
    valid = top_resp > 0

    # --- orientation: intensity centroid of the rounded radius-15 disc ----
    # (integer patch × integer offsets: the sums are exact, |sum| < 2^24)
    base = (torch.arange(B, device=dev) * hw)[:, None, None]
    flat = smooth.reshape(-1)
    dy = torch.from_numpy(_DISC_Y).to(dev)
    dx = torch.from_numpy(_DISC_X).to(dev)
    ys = (kp_y[..., None].long() + dy).clamp(0, H - 1)
    xs = (kp_x[..., None].long() + dx).clamp(0, W - 1)
    patch = torch.round(flat[base + ys * W + xs])              # [B, K, P]
    m10 = (patch * dx.to(torch.float32)).sum(-1)
    m01 = (patch * dy.to(torch.float32)).sum(-1)
    # quantise the angle so a ULP-level atan2 difference cannot rotate the
    # BRIEF pattern (save on a bin edge)
    angles = torch.round(_divide(torch.atan2(m01, m10), _BIN_W)) * _BIN_W

    # --- steered BRIEF at the nearest pixel of the smoothed image ---------
    pattern = torch.from_numpy(_PATTERN).to(dev)
    c = torch.cos(angles)[..., None]
    s = torch.sin(angles)[..., None]
    x0 = kp_x.to(torch.float32)[..., None]
    y0 = kp_y.to(torch.float32)[..., None]

    def sample(px, py):
        x = torch.round(c * px - s * py + x0).long().clamp(0, W - 1)
        y = torch.round(s * px + c * py + y0).long().clamp(0, H - 1)
        return flat[base + y * W + x]                          # [B, K, 256]

    v1 = sample(pattern[:, 0], pattern[:, 1])
    v2 = sample(pattern[:, 2], pattern[:, 3])
    descriptors = (v1 < v2).to(torch.float32)

    keypoints = torch.stack([x0[..., 0], y0[..., 0], angles], dim=-1)
    return keypoints, valid, descriptors


def hamming_2nn(desc1: torch.Tensor, valid1: torch.Tensor,
                desc2: torch.Tensor, valid2: torch.Tensor):
    """Exact 2-NN Hamming distances via one matrix product.

    desc ∈ {0,1}^[..., K, 256]; returns (best [..., K], second [..., K])
    distances for each row of desc1 against desc2 (invalid columns
    excluded; invalid rows get +inf).  Hamming(x, y) = |x| + |y| − 2·x·yᵀ
    for binary vectors; every product and sum is an integer ≤ 256, exact
    in float32 and under TF32 or bfloat16 inputs alike.
    """
    x1 = desc1.to(torch.float32)
    x2 = desc2.to(torch.float32)
    ones1 = x1.sum(-1)[..., :, None]
    ones2 = x2.sum(-1)[..., None, :]
    cross = x1 @ x2.transpose(-1, -2)
    dist = ones1 + ones2 - 2.0 * cross
    dist = torch.where(valid2[..., None, :], dist, torch.inf)
    top2 = torch.topk(dist, 2, dim=-1, largest=False).values
    best = torch.where(valid1, top2[..., 0], torch.inf)
    second = torch.where(valid1, top2[..., 1], torch.inf)
    return best, second


def _ratio_ok(best: torch.Tensor, second: torch.Tensor,
              ratio: float) -> torch.Tensor:
    return (best < ratio * second) & torch.isfinite(best)


def count_ratio_matches(desc1, valid1, desc2, valid2,
                        ratio: float = 0.7) -> int:
    """Lowe-ratio match count of one pair (reference `_match`,
    `thread.py:152-169`)."""
    return int(_ratio_ok(*hamming_2nn(desc1, valid1, desc2, valid2),
                         ratio).sum())


def batched_ratio_matches(desc1: torch.Tensor, valid1: torch.Tensor,
                          desc2: torch.Tensor, valid2: torch.Tensor,
                          ratio: float = 0.7) -> torch.Tensor:
    """Match counts for many descriptor pairs in one batched product.

    desc [Q, K, 256], valid [Q, K] → counts [Q] int32, left on the device.
    """
    ok = _ratio_ok(*hamming_2nn(desc1, valid1, desc2, valid2), ratio)
    return ok.sum(-1, dtype=torch.int32)
