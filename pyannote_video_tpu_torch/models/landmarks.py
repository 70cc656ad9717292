"""ERT 68-point landmark predictor (Kazemi–Sullivan ensemble of regression
trees), batched over faces.

Port of ``pyannote_video_tpu/models/landmarks.py``.  Per stage, the feature
pool (pixel intensities at mean-shape-anchored offsets, warped by the
current shape's similarity transform) is read for every (face, point) at
once; all trees of the stage walk in lockstep with heap-indexed arithmetic;
the leaf deltas are summed over the trees and added to the shape, which
lives in the normalized face frame ([-1, 1]² of the detection box).

**One form for every image size: the gather form.**  The JAX function
samples crops of up to 256² pixels with a dense hat-weight contraction,
evaluates every split as a one-hot matrix product and sums the leaves as
another, because point gathers run as scalar loops on the hardware it was
written for; it keeps a gather branch only for larger images.  A GPU
gathers single elements at full rate, so the switch between the two
branches has no counterpart here: every image size reads one tap (coarse
stages) or four taps (fine stages, ``ops/warp.py:bilinear_sample``'s
arithmetic in its order) per feature point through a flat index, walks the
trees with ``gather`` and sums the gathered leaf rows in float32.  No
matrix product lies on the way to a split decision, so neither cuBLAS nor
TF32 can touch one.  The forms agree to float32 rounding; a feature that
rounds differently by one ulp at a threshold can flip a split and move a
landmark by one leaf delta, which the tests bound.

Nothing in ``predict_cascade`` or ``predict_crops`` waits for the device:
shapes are fixed and selection is ``gather``/``where``.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from .nn import state_to
from ..ops.color import to_gray
from ..ops.warp import separable_resize_chips
from ..utils.device import DeviceLike, resolve_device
from ..utils.synthetic import CANONICAL_LANDMARKS

N_POINTS = 68

CROP = 128          # cascade sampling-domain resolution
CROP_SCALE = 2.0    # crop window covers CROP_SCALE × the detection box


def _similarity_to_current(mean_shape: torch.Tensor, shape: torch.Tensor):
    """Rotation + scale (no translation) aligning the mean shape [68, 2] to
    each current shape [N, 68, 2]: Kazemi–Sullivan re-index features
    through it.  Returns (a, b), each [N], of the matrices
    ``[[a, -b], [b, a]]``."""
    ms = mean_shape - mean_shape.mean(dim=0)
    s = shape - shape.mean(dim=1, keepdim=True)
    var = (ms * ms).sum().clamp_min(1e-9)
    a = (ms[:, 0] * s[..., 0] + ms[:, 1] * s[..., 1]).sum(dim=1) / var
    b = (ms[:, 0] * s[..., 1] - ms[:, 1] * s[..., 0]).sum(dim=1) / var
    return a, b


def _stage_features(grays: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                    fine: bool, dlib_oob: bool) -> torch.Tensor:
    """Pixel features [N, P] of face n's image ``grays[n]`` at float
    coordinates x, y [N, P]."""
    N, H, W = grays.shape
    flat = grays.reshape(-1)
    base = torch.arange(N, device=grays.device)[:, None] * (H * W)

    if dlib_oob:
        # dlib zeroes the feature of a point outside the image
        # (``area.contains(p) ? pixel : 0``); cascades imported from a
        # ``.dat`` file (bilinear_tail == 0) keep that, native ones clamp
        yi_r = torch.floor(y + 0.5)
        xi_r = torch.floor(x + 0.5)
        inb = ((yi_r >= 0.0) & (yi_r <= H - 1.0)
               & (xi_r >= 0.0) & (xi_r <= W - 1.0)).to(torch.float32)

    y = y.clamp(0.0, H - 1.0)
    x = x.clamp(0.0, W - 1.0)
    if fine:
        y0f = y.floor()
        x0f = x.floor()
        y0 = y0f.to(torch.long)
        x0 = x0f.to(torch.long)
        y1 = (y0 + 1).clamp_max(H - 1)
        x1 = (x0 + 1).clamp_max(W - 1)
        wy = y - y0f
        wx = x - x0f
        r0 = base + y0 * W
        r1 = base + y1 * W
        top = flat[r0 + x0] * (1 - wx) + flat[r0 + x1] * wx
        bot = flat[r1 + x0] * (1 - wx) + flat[r1 + x1] * wx
        feats = top * (1 - wy) + bot * wy
    else:
        # nearest pixel, half-to-even like the JAX package's ``jnp.round``
        yi = torch.round(y).to(torch.long)
        xi = torch.round(x).to(torch.long)
        feats = flat[base + yi * W + xi]
    if dlib_oob:
        feats = feats * inb
    return feats


def predict_cascade(params: Dict, grays: torch.Tensor, boxes: torch.Tensor,
                    return_leaves: bool = False):
    """Run the full cascade.

    params: dict with
        ``mean_shape`` [68, 2], ``n_stages``, ``depth`` (and optionally
        ``bilinear_tail``) as Python ints;
        per stage s: ``s{k}/anchor`` [P] long, ``s{k}/offset`` [P, 2],
        ``s{k}/i1`` [T, NODES] long, ``s{k}/i2``, ``s{k}/thresh``
        [T, NODES], ``s{k}/leaves`` [T, LEAVES, 136] float32.
    grays: [N, H, W] float32, one image per face.
    boxes: [N, 4] (left, top, right, bottom) in pixel coords of ``grays[i]``.

    Returns landmarks [N, 68, 2] in pixel coords; with ``return_leaves``
    also the list of each stage's leaf indices [N, T].
    """
    mean_shape = params["mean_shape"]
    n_stages = int(params["n_stages"])
    depth = int(params["depth"])
    # early stages read the nearest pixel, the last ``bilinear_tail`` stages
    # sample bilinearly; an absent field means every stage is bilinear
    bilinear_tail = int(params.get("bilinear_tail", n_stages))
    nodes = (1 << depth) - 1
    n_leaves = 1 << depth
    dlib_oob = bilinear_tail == 0

    cx = ((boxes[:, 0] + boxes[:, 2]) / 2.0)[:, None]
    cy = ((boxes[:, 1] + boxes[:, 3]) / 2.0)[:, None]
    half_w = ((boxes[:, 2] - boxes[:, 0]) / 2.0).clamp_min(1.0)[:, None]
    half_h = ((boxes[:, 3] - boxes[:, 1]) / 2.0).clamp_min(1.0)[:, None]

    N = grays.shape[0]
    shape = mean_shape.expand(N, N_POINTS, 2)
    stage_leaves: List[torch.Tensor] = []

    for s in range(n_stages):
        anchor = params[f"s{s}/anchor"]      # [P]
        offset = params[f"s{s}/offset"]      # [P, 2]
        i1 = params[f"s{s}/i1"]              # [T, NODES]
        i2 = params[f"s{s}/i2"]
        thresh = params[f"s{s}/thresh"]
        leaves = params[f"s{s}/leaves"]      # [T, LEAVES, 136]
        T_trees = i1.shape[0]
        fine = s >= n_stages - bilinear_tail

        # feature points: anchor + offset·rotᵀ, two multiply-adds per
        # coordinate (K = 2: not worth, and not safe as, a matrix product)
        a, b = _similarity_to_current(mean_shape, shape)
        a, b = a[:, None], b[:, None]
        anchored = shape[:, anchor, :]                        # [N, P, 2]
        pts_x = anchored[..., 0] + (offset[:, 0] * a - offset[:, 1] * b)
        pts_y = anchored[..., 1] + (offset[:, 0] * b + offset[:, 1] * a)
        x = cx + pts_x * half_w                               # [N, P]
        y = cy + pts_y * half_h
        feats = _stage_features(grays, x, y, fine, dlib_oob)

        # every split decided up front, then the lockstep walk
        d = (feats[:, i1.reshape(-1)] - feats[:, i2.reshape(-1)])
        bits = (d.reshape(N, T_trees, nodes) > thresh[None]).to(torch.long)
        node = torch.zeros((N, T_trees), dtype=torch.long, device=grays.device)
        for _ in range(depth):
            bit = torch.gather(bits, 2, node[..., None])[..., 0]
            node = 2 * node + 1 + bit
        leaf = node - nodes                                   # [N, T]
        if return_leaves:
            stage_leaves.append(leaf)

        # leaf deltas: one row per (face, tree), summed over the trees
        row = (torch.arange(T_trees, device=grays.device) * n_leaves)[None] + leaf
        delta_sum = leaves.reshape(T_trees * n_leaves, -1)[row].sum(dim=1)
        shape = shape + delta_sum.reshape(N, N_POINTS, 2)

    x = cx + shape[..., 0] * half_w
    y = cy + shape[..., 1] * half_h
    out = torch.stack([x, y], dim=-1)
    return (out, stage_leaves) if return_leaves else out


def predict_crops(params: Dict, grays: torch.Tensor, frame_idx: torch.Tensor,
                  boxes: torch.Tensor, return_leaves: bool = False):
    """Cascade over per-face crops instead of full frames.

    Cuts one CROP×CROP gray window covering ``CROP_SCALE ×`` each detection
    box (``ops/warp.py:separable_resize_chips``), runs the cascade in crop
    coordinates (the feature pool's offsets stay well inside the window)
    and maps the landmarks back to frame pixels.

    grays [T, H, W] float32, frame_idx [N] integer, boxes [N, 4] pixel
    coords → landmarks [N, 68, 2] pixel coords.
    """
    cx = (boxes[:, 0] + boxes[:, 2]) / 2.0
    cy = (boxes[:, 1] + boxes[:, 3]) / 2.0
    w = (boxes[:, 2] - boxes[:, 0]).clamp_min(2.0)
    h = (boxes[:, 3] - boxes[:, 1]).clamp_min(2.0)
    region_w = CROP_SCALE * w
    region_h = CROP_SCALE * h
    sx = region_w / CROP
    sy = region_h / CROP
    ox = cx - region_w / 2.0
    oy = cy - region_h / 2.0

    zeros = torch.zeros_like(sx)
    matrices = torch.stack(
        [torch.stack([sx, zeros, ox], dim=1),
         torch.stack([zeros, sy, oy], dim=1)], dim=1)         # chip → image
    crops = separable_resize_chips(grays[..., None], frame_idx, matrices,
                                   CROP, CROP)[..., 0]        # [N, CROP, CROP]

    # detection box in crop coordinates (identical for every face)
    q = CROP / (2.0 * CROP_SCALE)
    lo = torch.full_like(sx, CROP / 2 - q)
    hi = torch.full_like(sx, CROP / 2 + q)
    cbox = torch.stack([lo, lo, hi, hi], dim=1)
    out = predict_cascade(params, crops, cbox, return_leaves=return_leaves)
    lm, stage_leaves = out if return_leaves else (out, None)
    x = ox[:, None] + lm[..., 0] * sx[:, None]
    y = oy[:, None] + lm[..., 1] * sy[:, None]
    lm = torch.stack([x, y], dim=-1)
    return (lm, stage_leaves) if return_leaves else lm


class LandmarkPredictor:
    """Loads a trained cascade; mirrors ``dlib.shape_predictor(path)``.

    ``model_path``: a cascade ``.npz``; without it (and without ``params``)
    the packaged cascade, whose absence raises.  ``device``: ``cuda`` unless
    ``"cpu"`` is asked for.
    """

    def __init__(self, model_path: Optional[str] = None,
                 params: Optional[Dict] = None, device: DeviceLike = None):
        self.device = resolve_device(device)
        if params is not None:
            self.params = state_to(params, self.device)
        else:
            if model_path is None:
                from .weights import LANDMARKS_FILE

                if not LANDMARKS_FILE.exists():
                    raise FileNotFoundError(
                        f"no packaged landmark cascade at {LANDMARKS_FILE}")
                model_path = str(LANDMARKS_FILE)
            self.params = _load(model_path, self.device)

    @torch.no_grad()
    def predict_device(self, frames: torch.Tensor, frame_idx: torch.Tensor,
                       boxes: torch.Tensor) -> torch.Tensor:
        """As ``predict_batch`` on tensors that already lie on the
        predictor's device; the landmarks stay there."""
        grays = to_gray(frames) if frames.dim() == 4 else frames.to(torch.float32)
        return predict_crops(self.params, grays, frame_idx, boxes)

    def predict_batch(self, frames: np.ndarray, frame_idx: np.ndarray,
                      boxes: np.ndarray) -> np.ndarray:
        """frames [T, H, W(, 3)], frame_idx [N], boxes [N, 4] → [N, 68, 2]."""
        lm = self.predict_device(
            torch.from_numpy(np.asarray(frames)).to(self.device),
            torch.from_numpy(np.asarray(frame_idx, dtype=np.int64)).to(self.device),
            torch.from_numpy(np.asarray(boxes, dtype=np.float32)).to(self.device))
        return lm.cpu().numpy()


def mean_shape_only() -> Dict:
    """Degenerate 0-stage cascade: returns the mean shape in the box, as
    ``models/chip.py:box_to_landmarks`` does."""
    return {
        "mean_shape": torch.from_numpy(np.asarray(CANONICAL_LANDMARKS,
                                                  dtype=np.float32)),
        "n_stages": 0,
        "depth": 3,
    }


def cascade_from_jax(flat: Dict[str, np.ndarray],
                     device: DeviceLike = "cpu") -> Dict:
    """A cascade of the JAX package (flat ``"s{k}/name"`` keys, arrays of
    any array type) → the port's parameters on ``device``.

    Index arrays (``anchor``, ``i1``, ``i2``) become ``long``; leaves, which
    the packaged file stores as float16, become float32 (the sum over the
    trees runs in float32); ``n_stages``, ``depth`` and ``bilinear_tail``
    become Python ints; everything else float32.
    """
    out: Dict = {}
    for key, value in flat.items():
        value = np.asarray(value)
        if key in ("n_stages", "depth", "bilinear_tail"):
            out[key] = int(value)
        elif key.endswith(("anchor", "i1", "i2")):
            out[key] = torch.from_numpy(value.astype(np.int64)).to(device)
        else:
            out[key] = torch.from_numpy(value.astype(np.float32)).to(device)
    return out


def _load(path, device: DeviceLike = "cpu") -> Dict:
    with np.load(path) as data:
        return cascade_from_jax({k: data[k] for k in data.files}, device)


def save(path, params: Dict) -> None:
    """Write a cascade as the JAX package's ``.npz`` (`landmarks.py:350`):
    flat ``"s{k}/name"`` keys, which both packages' ``LandmarkPredictor``
    read.  Takes the trainer's numpy arrays (``train/train_landmarks.py``)
    or a port cascade (``cascade_from_jax``'s tensors and ints); index
    arrays are written as int32, everything else in its own dtype (the
    trainer's leaves are float16)."""
    flat = {}
    for key, value in params.items():
        if isinstance(value, torch.Tensor):
            value = value.detach().cpu().numpy()
        value = np.asarray(value)
        flat[key] = value.astype(np.int32) if key.endswith(
            ("anchor", "i1", "i2")) else value
    np.savez_compressed(path, **flat)
