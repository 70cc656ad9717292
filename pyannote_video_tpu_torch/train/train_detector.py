"""Detector training on the synthetic face distribution.

Port of ``pyannote_video_tpu/train/train_detector.py``: trains the FCN
detector (``models/detector.py``) with a class-balanced BCE on the score
map, online hard-negative top-K, margin hinges and smooth-L1 on box deltas
at positive cells, in float32.  A producer thread renders batches while the
device steps; every ``MINE_EVERY`` steps the serve-scale miner
(``train/mine.py``) refreshes under the current weights and its crops
replace the batch's last slots.

Usage:  python -m pyannote_video_tpu_torch.train.train_detector <steps> <out.npz>
                [--resume] [--init=ckpt.npz] [--lr=3e-4] [--no-mine]
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from ..models import detector
from ..models.nn import (hinge, load_params, save_params,
                         sigmoid_binary_cross_entropy, state_to, top_k)
from ..models.weights import DETECTOR_FILE, checked_output
from ..utils.device import DeviceLike, resolve_device
from . import data
from .optim import adam, cosine_decay_schedule, train_step

# margin-hinge targets (logits); the reasons for each value are in the JAX
# package's trainer, which this one follows number for number
MARGIN_POS = 8.0
MARGIN_POS_HARD = 6.0   # hard-combo crops (data.AUG_HARD_P)
MARGIN_NEG = 0.0
MARGIN_W = 0.5
NEG_HINGE_W = 3.0       # extra pressure on the mined negatives
NEG_MINE_K = 32         # hard-negative cells per image
ANCHOR = MARGIN_POS + 4.0   # upper anchor on positive logits
MINE_EVERY = 25         # serve-scale mining refresh cadence (steps)
MINE_PER_BATCH = 4      # crops per batch replaced by mined negatives
MINE_POS_PER_BATCH = 2  # ... and by mined hard positives


def loss_fn(params, frames, labels, deltas, delta_mask, hard):
    """(loss, params with the batch norms' statistics moved), as
    `train_detector.py:73-118`: frames [B, H, W, 3] float, labels
    [B, h, w] in {1, 0, −1 = ignore}, deltas [B, h, w, 4], delta_mask
    [B, h, w], hard [B]."""
    maps, params_new = detector.forward_maps(params, frames, train=True,
                                             compute_dtype=torch.float32)
    logits = maps[..., 0]
    pred_deltas = maps[..., 1:]

    valid = labels >= 0.0  # -1 = ignore ring
    pos = labels == 1.0
    # class-balanced BCE: positives are rare
    bce = sigmoid_binary_cross_entropy(logits, labels.clamp_min(0.0))
    w = torch.where(pos, 20.0, 1.0) * valid
    cls_loss = torch.sum(bce * w) / torch.sum(w).clamp_min(1.0)

    # online hard-negative mining: the K highest-loss negative cells
    neg = pos | (labels < 0.0)
    neg_losses = torch.where(neg, 0.0, bce)
    B = neg_losses.shape[0]
    top_neg, _ = top_k(neg_losses.reshape(B, -1), NEG_MINE_K)
    cls_loss = cls_loss + 2.0 * torch.mean(top_neg)

    # margin hinges: positives into [target, ANCHOR], negatives ≤ MARGIN_NEG
    pos_target = torch.where(hard[:, None, None] > 0.5,
                             MARGIN_POS_HARD, MARGIN_POS)
    pos_hinge = hinge(pos_target - logits) + hinge(logits - ANCHOR)
    cls_loss = cls_loss + MARGIN_W * (
        torch.sum(pos_hinge * pos) / torch.sum(pos).clamp_min(1.0))
    neg_hinge = torch.where(neg, 0.0, hinge(logits - MARGIN_NEG))
    top_hinge, _ = top_k(neg_hinge.reshape(B, -1), NEG_MINE_K)
    cls_loss = cls_loss + NEG_HINGE_W * MARGIN_W * torch.mean(top_hinge)

    reg_err = pred_deltas - deltas
    huber = torch.where(reg_err.abs() < 1.0, 0.5 * reg_err ** 2,
                        reg_err.abs() - 0.5)
    reg_loss = torch.sum(huber * delta_mask[..., None]) / (
        torch.sum(delta_mask) * 4.0).clamp_min(1.0)
    return cls_loss + reg_loss, params_new


def batch_tensors(frames, labels, deltas, mask, hard, device):
    """A host batch as the device tensors ``loss_fn`` takes."""
    return (torch.from_numpy(np.asarray(frames)).to(device, torch.float32),
            *(torch.from_numpy(np.asarray(a, np.float32)).to(device)
              for a in (labels, deltas, mask, hard)))


def train(steps: int = 600, batch: int = 16, size: int = 128,
          seed: int = 0, lr: float = 3e-4, log_every: int = 50,
          init_params: dict = None, mine: bool = True,
          deep_width: int = 96, ckpt_path: str = None,
          ckpt_every: int = 400, device: DeviceLike = None):
    """Train for ``steps`` steps and return the state (on ``device``:
    ``cuda`` unless ``"cpu"`` is asked for).  A fresh model is drawn from a
    ``torch.Generator`` seeded ``seed``; the batches from a numpy
    generator seeded ``seed``, shared by the producer thread and the
    mining substitution, as in the JAX trainer."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    params = (init_params if init_params is not None
              else detector.init_params(torch.Generator().manual_seed(seed),
                                        deep_width=deep_width))
    params = state_to(params, device)
    miner = None
    if mine:
        from .mine import HardNegativeMiner

        miner = HardNegativeMiner(crop=size, seed=seed + 77, device=device)
    # cosine decay to lr/10
    params, opt = adam(params, cosine_decay_schedule(lr, steps, alpha=0.1))

    def make():
        frames, boxes, hard = data.detection_batch(
            rng, batch=batch, height=size, width=size, return_hard=True)
        return frames, data.detection_targets(boxes, size, size), hard

    t0 = time.time()
    stream = data.batch_stream(make)
    try:
        for step in range(steps):
            frames, (labels, deltas, mask), hard = next(stream)
            if miner is not None:
                if step % MINE_EVERY == 0:
                    miner.refresh(params)
                    miner.refresh_positives(params)
                crops = miner.sample(rng, MINE_PER_BATCH)
                # mined all-negative crops replace the last slots
                for j, patch in enumerate(crops):
                    i = batch - 1 - j
                    frames[i] = patch
                    labels[i], deltas[i], mask[i], hard[i] = 0.0, 0.0, 0.0, 0.0
                for j, (patch, box) in enumerate(
                        miner.sample_pos(rng, MINE_POS_PER_BATCH)):
                    i = batch - 1 - len(crops) - j
                    frames[i] = patch
                    lb, dl, mk = data.detection_targets([[box]], size, size)
                    labels[i], deltas[i], mask[i] = lb[0], dl[0], mk[0]
                    hard[i] = 1.0  # low-evidence face: HARD margin target
            params, loss = train_step(
                loss_fn, params, opt,
                *batch_tensors(frames, labels, deltas, mask, hard, device))
            if step % log_every == 0 or step == steps - 1:
                mined = ""
                if miner is not None:
                    mined = (f"  mined neg {len(miner)} "
                             f"(max {miner.last_max_logit:.1f}) "
                             f"pos {len(miner._pos_buf)} "
                             f"(min {miner.last_min_pos_logit:.1f})")
                print(f"step {step:5d}  loss {float(loss):.4f}  "
                      f"({time.time() - t0:.1f}s){mined}", flush=True)
            if ckpt_path and step and step % ckpt_every == 0:
                save_params(ckpt_path, params)
                print(f"ckpt @ {step} -> {ckpt_path}", flush=True)
    finally:
        stream.close()
    return params


def main(argv=None, device: DeviceLike = None) -> int:
    """usage: train_detector <steps> <out.npz> [--resume] [--init=ckpt.npz]
                             [--lr=3e-4] [--no-mine]

    ``--resume`` continues from the packaged checkpoint (fresh optimizer);
    ``--init=<path>`` from any checkpoint.  ``--no-mine`` turns the
    serve-scale mining off.  The output path is required, and never lies
    inside the JAX package.
    """
    argv = sys.argv[1:] if argv is None else list(argv)
    device = resolve_device(device)
    args = [a for a in argv if a not in ("--resume", "--no-mine")
            and not a.startswith(("--lr=", "--init="))]
    if len(args) != 2:
        raise SystemExit(main.__doc__)
    steps, out = int(args[0]), checked_output(args[1])
    init_path = next((a.split("=", 1)[1] for a in argv
                      if a.startswith("--init=")),
                     str(DETECTOR_FILE) if "--resume" in argv else None)
    lr = next((float(a.split("=", 1)[1]) for a in argv
               if a.startswith("--lr=")), 3e-4)
    init = load_params(init_path) if init_path else None
    params = train(steps=steps, init_params=init, lr=lr,
                   mine="--no-mine" not in argv,
                   ckpt_path=str(out) + ".ckpt", device=device)
    save_params(out, params)
    print("saved", out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
