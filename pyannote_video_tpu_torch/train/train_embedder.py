"""Embedder training: dlib-style metric learning on synthetic identities.

Port of ``pyannote_video_tpu/train/train_embedder.py``: trains the
ResNet-29 embedder (``models/embedder.py``) in float32 with dlib's
``loss_metric`` hinges around the 0.6 clustering threshold plus a
within-identity pull, behind a global-norm clip at 5 and Adam at 1e-3.

Usage:  python -m pyannote_video_tpu_torch.train.train_embedder <steps> <out.npz> [--resume]
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from ..models import embedder
from ..models.nn import hinge, load_params, save_params, state_to
from ..models.weights import EMBEDDER_FILE, EMBEDDER_WIDTH, checked_output
from ..ops.distance import pairwise_sqdist
from ..utils.device import DeviceLike, resolve_device
from . import data
from .optim import adam, train_step

THRESHOLD = 0.6   # dlib loss_metric distance threshold
# hinge targets around the clustering threshold (same < 0.35, diff > 1.0:
# the JAX trainer explains the widening from dlib's 0.56 / 0.64)
SAME_T = 0.35
DIFF_T = 1.0
PULL = 0.3        # within-identity variance regulariser weight


def loss_fn(params, chips, labels):
    """(loss, params with the batch norms' statistics moved), as
    `train_embedder.py:42-71`: chips [B, 150, 150, 3] float, labels [B]."""
    emb, params_new = embedder.forward(params, chips, train=True,
                                       compute_dtype=torch.float32)
    # epsilon inside the sqrt: the diagonal's exact zero would otherwise
    # give an infinite sqrt-gradient that the mask turns into NaN
    d = torch.sqrt(pairwise_sqdist(emb, emb) + 1e-9)
    same = (labels[:, None] == labels[None, :]).to(torch.float32)
    eye = torch.eye(labels.shape[0], dtype=torch.float32, device=d.device)
    same_mask = same * (1.0 - eye)
    diff_mask = 1.0 - same

    # dlib loss_metric hinges, each normalised by its violating pairs
    same_loss = hinge(d - SAME_T) * same_mask
    diff_loss = hinge(DIFF_T - d) * diff_mask
    n_same = torch.sum((same_loss > 0).to(torch.float32)).clamp_min(1.0)
    n_diff = torch.sum((diff_loss > 0).to(torch.float32)).clamp_min(1.0)
    n_same_all = torch.sum(same_mask).clamp_min(1.0)
    pull_loss = PULL * torch.sum(d * same_mask) / n_same_all
    return (torch.sum(same_loss) / n_same + torch.sum(diff_loss) / n_diff
            + pull_loss), params_new


def batch_tensors(chips, labels, device):
    """A host batch as the device tensors ``loss_fn`` takes."""
    return (torch.from_numpy(np.asarray(chips)).to(device, torch.float32),
            torch.from_numpy(np.asarray(labels, np.int64)).to(device))


def train(steps: int = 400, n_ident: int = 16, per_ident: int = 3,
          width: float = None, seed: int = 0, lr: float = 1e-3,
          log_every: int = 25, init_params: dict = None,
          device: DeviceLike = None):
    """Train for ``steps`` steps and return the state (on ``device``:
    ``cuda`` unless ``"cpu"`` is asked for).  Batches of ``n_ident`` ×
    ``per_ident`` chips from a bank of 512 identities; a fresh model at
    ``width`` (the packaged one's by default) is drawn from a
    ``torch.Generator`` seeded ``seed``."""
    device = resolve_device(device)
    width = EMBEDDER_WIDTH if width is None else width
    rng = np.random.default_rng(seed)
    # a large bank forces identity-generalisation (512 ≫ 128 dims)
    identities = data.identity_bank(512, seed=seed + 1)
    params = (init_params if init_params is not None
              else embedder.init_params(torch.Generator().manual_seed(seed),
                                        width=width))
    params = state_to(params, device)
    params, opt = adam(params, lr, max_norm=5.0)

    t0 = time.time()
    stream = data.batch_stream(lambda: data.embedding_batch(
        rng, identities, n_ident=n_ident, per_ident=per_ident))
    try:
        for step in range(steps):
            params, loss = train_step(loss_fn, params, opt,
                                      *batch_tensors(*next(stream), device))
            if step % log_every == 0 or step == steps - 1:
                print(f"step {step:5d}  loss {float(loss):.4f}  "
                      f"({time.time() - t0:.1f}s)", flush=True)
    finally:
        stream.close()
    return params


def main(argv=None, device: DeviceLike = None) -> int:
    """usage: train_embedder <steps> <out.npz> [--resume]

    ``--resume`` continues from the packaged checkpoint (fresh optimizer).
    The output path is required, and never lies inside the JAX package.
    """
    argv = sys.argv[1:] if argv is None else list(argv)
    device = resolve_device(device)
    args = [a for a in argv if a != "--resume"]
    if len(args) != 2:
        raise SystemExit(main.__doc__)
    steps, out = int(args[0]), checked_output(args[1])
    init = load_params(EMBEDDER_FILE) if "--resume" in argv else None
    params = train(steps=steps, init_params=init, device=device)
    save_params(out, params)
    print("saved", out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
