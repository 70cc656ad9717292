"""Candidate-refining CNN — stage 2 of the face-detection cascade.

Port of ``pyannote_video_tpu/models/refiner.py`` (inference).  The pyramid
FCN (``models/detector.py``) proposes; this small classifier re-scores each
frame's top proposals on a 64² crop centred on the candidate with some
context around it.  The final score of a refined candidate is the refiner
logit; candidates below stage-1's top-K, or under ``PROPOSAL_GATE``, get
``UNREFINED``, far under any operating threshold.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .nn import State, batch_norm, conv, top_k
from ..ops.crop import crop_resize

# square crop window at CONTEXT × the candidate's larger side
CROP = 64
CONTEXT = 1.40
# proposals re-scored per frame
REFINE_K = 16
# score of candidates outside stage-1's top-K
UNREFINED = -12.0
# refined scores only replace stage-1 logits above this gate
PROPOSAL_GATE = 0.5


def forward(params: State, crops: torch.Tensor,
            compute_dtype=torch.bfloat16) -> torch.Tensor:
    """crops [N, CROP, CROP, 3] float (0-255, NHWC) → logits [N] float32.

    4× stride-2 3×3 conv+BN+ReLU (64² → 4²), then two dense layers.  The
    flattened map is NCHW; ``params_from_jax`` permuted ``d1``'s rows to
    match, so the logits equal the JAX package's NHWC flatten.
    """
    x = (crops.to(compute_dtype) / 256.0 - 0.5).permute(0, 3, 1, 2)
    i = 1
    while f"c{i}" in params:
        x = conv(params[f"c{i}"], x, stride=2, dlib_padding=False,
                 compute_dtype=compute_dtype)
        x = F.relu(batch_norm(params[f"bn{i}"], x))
        i += 1
    x = x.reshape(x.shape[0], -1)
    h = F.relu(F.linear(x, params["d1"]["w"], params["d1"]["b"]))
    return F.linear(h, params["d2"]["w"], params["d2"]["b"])[:, 0]


def crop_boxes(boxes: torch.Tensor, context: float = CONTEXT) -> torch.Tensor:
    """Candidate boxes [..., 4] → square context windows [..., 4]."""
    l, t, r, b = boxes.unbind(-1)
    cx, cy = (l + r) / 2.0, (t + b) / 2.0
    half = torch.maximum(r - l, b - t) * (context / 2.0)
    return torch.stack([cx - half, cy - half, cx + half, cy + half], dim=-1)


def refine_scores(ref_params: State, frames: torch.Tensor,
                  scores: torch.Tensor, boxes: torch.Tensor,
                  compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Re-score each frame's top stage-1 candidates with the refiner.

    frames [B, H, W, 3] float (the array the pyramid consumed); scores
    [B, K_total]; boxes [B, K_total, 4] in frame coordinates.  Returns new
    scores [B, K_total]: refiner logits on the refined top-K slots (where
    stage 1 cleared PROPOSAL_GATE), ``UNREFINED`` elsewhere.
    """
    B, K_total = scores.shape
    k = min(REFINE_K, K_total)
    top_s, top_i = top_k(scores, k)
    top_boxes = torch.gather(boxes, 1, top_i[..., None].expand(B, k, 4))
    crops = crop_resize(frames.to(compute_dtype), crop_boxes(top_boxes), CROP)
    logits = forward(ref_params, crops.reshape((B * k,) + crops.shape[2:]),
                     compute_dtype=compute_dtype).reshape(B, k)
    logits = torch.where(top_s > PROPOSAL_GATE, logits,
                         torch.full_like(logits, UNREFINED))
    out = torch.full((B, K_total), UNREFINED, dtype=scores.dtype,
                     device=scores.device)
    return out.scatter(1, top_i, logits.to(scores.dtype))
