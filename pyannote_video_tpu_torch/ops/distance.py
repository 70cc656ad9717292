"""Pairwise distances (clustering similarity).

Port of ``pyannote_video_tpu/ops/distance.py``: replaces
``scipy.spatial.distance.pdist`` over all face embeddings with the identity
``‖x−y‖² = ‖x‖² + ‖y‖² − 2·x·yᵀ``.  The product is a plain matrix product
(``torch.matmul``), computed in exact float32: TF32 is switched off around
it, since distances near zero are compared with a threshold.
"""

from __future__ import annotations

from typing import Optional

import torch


def pairwise_sqdist(x: torch.Tensor, y: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Squared Euclidean distances, x [N, D] × y [M, D] → [N, M] float32.

    Inputs are mean-centered first (distances are translation-invariant):
    this shrinks the magnitudes entering the identity and cuts float32
    cancellation error by orders of magnitude near zero distance.
    """
    x = x.to(torch.float32)
    symmetric = y is None
    y = x if symmetric else y.to(torch.float32)
    mean = x.mean(dim=0, keepdim=True)
    x = x - mean
    y = y - mean
    x2 = (x * x).sum(dim=1)[:, None]
    y2 = (y * y).sum(dim=1)[None, :]
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        xy = torch.matmul(x, y.T)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    # max(·, 0) with jnp.maximum's gradient at a tie, for the trainer
    out = x2 + y2 - 2.0 * xy
    out = torch.maximum(out, out.new_zeros(()))
    if symmetric:
        # self-distances are exactly zero; the product's different reduction
        # order would otherwise leave O(eps·‖x‖²) noise on the diagonal
        out = out * (1.0 - torch.eye(out.shape[0], dtype=out.dtype,
                                     device=out.device))
    return out


def pairwise_dist(x: torch.Tensor, y: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Euclidean distances (matches ``pdist(..., metric='euclidean')``)."""
    return torch.sqrt(pairwise_sqdist(x, y))
