"""Stage-2 refiner training — binary margin classification on crops.

Port of ``pyannote_video_tpu/train/train_refiner.py``.  The refiner
(``models/refiner.py``) re-scores the pyramid detector's top proposals at
canonical scale, so its crops are cut with the serving pair
``refiner.crop_boxes`` + ``ops/crop.py:crop_resize`` from frame-scale
scenes of the trainer's render families (``train/data.py``).

Window sources per class: positives are ground-truth boxes under a
stage-1-like jitter plus stage-1 detections on faces (IoU ≥ 0.5);
negatives are stage-1 candidates off every face, windows on the placed
decoys and clutter, and edge-straddling background windows.  The loss
mirrors the detector's margin objective.

``ServeMiner`` runs the FROZEN packaged stage 1 by calling
``models/detector.py:pyramid_candidates`` on ``default_detector_params()``
directly, with no refiner attached; the JAX miner reaches the same function
by setting ``PYV_NO_REFINE=1`` for the whole process, which this port
never does.

Usage:  python -m pyannote_video_tpu_torch.train.train_refiner <steps> <out.npz>
                [--init=ckpt.npz] [--lr=3e-4]
"""

from __future__ import annotations

import sys
import time
from dataclasses import replace
from typing import List, Tuple

import numpy as np
import torch

from ..models import refiner
from ..models.detector import level_dims, pyramid_candidates
from ..models.nn import (hinge, load_params, save_params,
                         sigmoid_binary_cross_entropy, state_to, top_k)
from ..models.weights import checked_output, default_detector_params
from ..ops.crop import crop_resize
from ..utils.device import DeviceLike, resolve_device
from ..utils.synthetic import FaceParams, _background, render_face
from . import data
from .data import (AUG_CUTOUT_P, AUG_HARD_P, AUG_P, AUG_SIDEBAR_P,
                   _draw_clutter, _photometric_aug, _random_affine,
                   _warp_frame_and_boxes, broad_identity)
from .optim import adam, cosine_decay_schedule, train_step

MARGIN_POS = 8.0
MARGIN_POS_HARD = 6.0   # low-evidence (hard-combo) faces, as in stage 1
ANCHOR = 12.0
MARGIN_NEG = 0.0
MARGIN_W = 0.5
NEG_TOPK = 16           # extra hinge pressure on the batch's hardest negs
SCENE_H, SCENE_W = 360, 480
MINE_EVERY = 20         # steps between stage-1 mining refreshes
MINE_FRAMES = 4
NEG_BUF = 1024          # mined hard-negative crop buffer
POS_BUF = 512           # serve-window positive crop buffer
PAD_BUCKET = 32         # batches padded to a multiple of this (see pad_to_bucket)


def _window(box) -> np.ndarray:
    """The CONTEXT window of one (l, t, r, b) box, in float32."""
    return refiner.crop_boxes(torch.as_tensor(box, dtype=torch.float32)).numpy()


def _jitter_box(rng, box, hard=False):
    """Stage-1 regression-noise model: centre shift up to ±12% of the
    side, independent x/y scale ×[0.72, 1.25].  The envelope is measured
    at serve time on hard posed faces (evals/probe_detector.py corners):
    stage-1 boxes on IoU-0.6 detections truncate the warped face's bound
    by up to ~27% in one axis — the refiner must score THOSE windows as
    positives, not just the GT bound."""
    l, t, r, b = box
    w, h = r - l, b - t
    sx = rng.uniform(0.72, 1.25)
    sy = rng.uniform(0.72, 1.25)
    cx = (l + r) / 2 + rng.uniform(-0.12, 0.12) * w
    cy = (t + b) / 2 + rng.uniform(-0.12, 0.12) * h
    return (cx - w * sx / 2, cy - h * sy / 2,
            cx + w * sx / 2, cy + h * sy / 2)


def _color_aug(rng: np.random.Generator, crops: np.ndarray) -> np.ndarray:
    """Per-crop channel-gain + desaturation augmentation (in place).

    Face-ness must not key on hue: the eval domains draw identities with
    skin tones OUTSIDE the training sampler's range (synthetic_shift's
    novel identities), and the decoy props differ from faces by geometry
    (no eyes/mouth), never by colour.  Random per-channel gains plus a
    grayscale mix make the refiner's decision colour-invariant without
    importing the eval-shift module."""
    n = crops.shape[0]
    apply = rng.random(n) < 0.5
    gains = rng.uniform(0.55, 1.45, size=(n, 1, 1, 3)).astype(np.float32)
    mixed = crops * np.where(apply[:, None, None, None], gains, 1.0)
    desat = rng.random(n) < 0.3
    a = rng.uniform(0.3, 0.9, size=(n, 1, 1, 1)).astype(np.float32)
    gray = mixed.mean(axis=-1, keepdims=True)
    mixed = np.where(desat[:, None, None, None],
                     mixed * (1 - a) + gray * a, mixed)
    return np.clip(mixed, 0.0, 255.0)


def scene(rng: np.random.Generator, p_face: float = 0.75
          ) -> Tuple[np.ndarray, List[tuple], List[tuple], np.ndarray]:
    """One frame-scale scene.

    Returns (frame u8 [H, W, 3], gt face boxes, distractor boxes
    (placed decoys/clutter — known-negative windows), hard mask per gt).
    """
    h, w = SCENE_H, SCENE_W
    bg = _background(w, h, rng).astype(np.float32)
    distract: List[tuple] = []
    # featureless skin-tone head (the canonical face-like prop)
    if rng.random() < 0.7:
        decoy = replace(FaceParams.random(rng),
                        eye_r=0.0, mouth_w=0.0, nose_len=0.2)
        dh = float(rng.uniform(0.12, 0.45) * h)
        # edge-straddling allowed: centre may sit within dh/2 of (or past)
        # the border — serve-time FPs live half off-frame too
        dcx = float(rng.uniform(-0.2 * dh, w + 0.2 * dh))
        dcy = float(rng.uniform(-0.1 * dh, h + 0.1 * dh))
        render_face(bg, dcx, dcy, dh, decoy)
        hw = dh / 2.0 / decoy.aspect
        distract.append((dcx - hw, dcy - dh / 2, dcx + hw, dcy + dh / 2))
    for _ in range(int(rng.integers(2, 6))):
        size = float(rng.uniform(0.10, 0.45) * h)
        # record where the clutter lands so its window is a known negative
        cx = float(rng.uniform(size / 2, w - size / 2))
        cy = float(rng.uniform(size / 2, h - size / 2))
        x0, y0 = int(cx - size / 2), int(cy - size / 2)
        _draw_clutter_at(bg, rng, size, cx, cy)
        distract.append((cx - size / 2, cy - size / 2,
                         cx + size / 2, cy + size / 2))
    gt: List[tuple] = []
    hard_flags: List[bool] = []
    n_faces = int(rng.integers(1, 4)) if rng.random() < p_face else 0
    for _ in range(n_faces):
        u = rng.random()
        # a quarter of faces draw from a WIDER identity stretch than the
        # stage-1 trainer's 0.35 — stage 2 sees each face centred at fixed
        # scale, so it can afford (and needs) broader appearance coverage
        params = (broad_identity(rng, stretch=0.75) if u < 0.25
                  else broad_identity(rng) if u < 0.6
                  else FaceParams.random(rng))
        face_h = float(rng.uniform(40.0, 0.55 * h))
        half_w = face_h / 2.0 / params.aspect
        cx = rng.uniform(half_w + 2, w - half_w - 2)
        cy = rng.uniform(face_h / 2 + 2, h - face_h / 2 - 2)
        if any(abs(cx - (g[0] + g[2]) / 2) < face_h * 0.9
               and abs(cy - (g[1] + g[3]) / 2) < face_h * 0.9 for g in gt):
            continue
        render_face(bg, cx, cy, face_h, params)
        gt.append((cx - half_w, cy - face_h / 2,
                   cx + half_w, cy + face_h / 2))
        hard_flags.append(False)
    # whole-frame pose affine (exactly-warped GT), as stage-1 training
    hard = bool(gt) and rng.random() < AUG_HARD_P
    if gt and (hard or rng.random() < AUG_P):
        A = _random_affine(rng, hard=hard)
        bg, gt = _warp_frame_and_boxes(bg, gt, A, w / 2, h / 2)
        hard_flags = [hard] * len(gt)
    # per-face cutouts / occlusion bars (data.py's generic occlusion)
    for gi, (l, t, r, btm) in enumerate(gt):
        if rng.random() < AUG_CUTOUT_P:
            fw, fh = r - l, btm - t
            cw = rng.uniform(0.1, 0.25) * fw
            chh = rng.uniform(0.1, 0.25) * fh
            ox = (l + r) / 2 + rng.uniform(-0.8, 0.8) * fw / 2
            oy = (t + btm) / 2 + rng.uniform(-0.8, 0.8) * fh / 2
            x0 = int(np.clip(ox - cw / 2, 0, w - 1))
            y0 = int(np.clip(oy - chh / 2, 0, h - 1))
            bg[y0:y0 + max(1, int(chh)), x0:x0 + max(1, int(cw))] = \
                rng.uniform(20, 230)
        if hard_flags[gi] or rng.random() < AUG_SIDEBAR_P:
            fw, fh = r - l, btm - t
            frac = rng.uniform(0.12, 0.28)
            side = rng.integers(0, 3)
            if side == 0:
                ol, ot, orr, ob = l, btm - fh * frac, r, btm
            elif side == 1:
                ol, ot, orr, ob = l, t + fh * 0.2, l + fw * frac, btm
            else:
                ol, ot, orr, ob = r - fw * frac, t + fh * 0.2, r, btm
            x0 = int(np.clip(ol, 0, w - 1)); y0 = int(np.clip(ot, 0, h - 1))
            x1 = int(np.clip(orr, x0 + 1, w)); y1 = int(np.clip(ob, y0 + 1, h))
            bg[y0:y1, x0:x1] = rng.uniform(20, 230, size=3)
    frame = np.clip(_photometric_aug(bg, rng), 0, 255).astype(np.uint8)
    return frame, gt, distract, np.asarray(hard_flags, dtype=np.float32)


def _draw_clutter_at(bg, rng, size, cx, cy):
    """`data._draw_clutter` at a CALLER-chosen position (so the window is
    known): temporarily re-centre by drawing into a view is not possible
    with its internal placement, so replicate the placement contract by
    seeding the draw into a crop around (cx, cy)."""
    h, w = bg.shape[:2]
    half = int(size / 2) + 2
    x0, x1 = max(0, int(cx) - half), min(w, int(cx) + half)
    y0, y1 = max(0, int(cy) - half), min(h, int(cy) + half)
    if x1 - x0 < 8 or y1 - y0 < 8:
        return
    view = bg[y0:y1, x0:x1]
    _draw_clutter(view, rng, size)


def _extract_grouped(frames_u8: np.ndarray, wins_per_frame,
                     device: torch.device) -> list:
    """Serve-exact crop extraction, one device copy per distinct frame and
    one read for all crops.

    frames_u8: [F, H, W, 3] u8; wins_per_frame: per-frame sequences of
    (l, t, r, b) windows.  Returns a list of [n_i, CROP, CROP, 3] f32 crop
    arrays (n_i = len(wins_per_frame[i])).  Frames with fewer windows are
    padded to the largest count with zero windows, whose crops are dropped
    (the JAX trainer also rounds the count up to a multiple of 8 to bound
    its compilations; nothing here compiles).
    """
    counts = [len(w) for w in wins_per_frame]
    m = max(counts, default=0)
    if m == 0:
        return [np.zeros((0, refiner.CROP, refiner.CROP, 3), np.float32)
                for _ in wins_per_frame]
    wins = np.zeros((len(wins_per_frame), m, 4), np.float32)
    for i, w in enumerate(wins_per_frame):
        if counts[i]:
            wins[i, :counts[i]] = np.asarray(w, np.float32)
    frames = torch.from_numpy(np.ascontiguousarray(frames_u8)).to(device)
    crops = crop_resize(frames.to(torch.float32),
                        torch.from_numpy(wins).to(device), refiner.CROP)
    crops = crops.cpu().numpy()
    return [crops[i, :counts[i]] for i in range(len(wins_per_frame))]


def _iou(a, b):
    ix = max(0.0, min(a[2], b[2]) - max(a[0], b[0]))
    iy = max(0.0, min(a[3], b[3]) - max(a[1], b[1]))
    inter = ix * iy
    ua = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter
    return inter / ua if ua > 0 else 0.0


def _clean_negative(box, gt) -> bool:
    """True when ``box``'s CONTEXT window shows no usable face: low IoU
    with every GT box and no GT centre inside the window."""
    win = tuple(float(v) for v in _window(box))
    for g in gt:
        if _iou(box, g) >= 0.25:
            return False
        gcx, gcy = (g[0] + g[2]) / 2, (g[1] + g[3]) / 2
        if win[0] <= gcx <= win[2] and win[1] <= gcy <= win[3]:
            return False
    return True


class ServeMiner:
    """Harvest serve-window crops through the FROZEN packaged stage-1
    pyramid (bfloat16, as served, no refiner).

    Negative crops: stage-1 top candidates with IoU < 0.25 to all GT.
    Positive crops: stage-1 candidates ON a face (IoU ≥ 0.5), with the
    face's hard flag.  A refresh reads the device twice: the candidates,
    then every crop of the refresh.  ``device``: ``cuda`` unless ``"cpu"``
    is asked for.  ``render_seconds`` adds up the host time spent
    rendering scenes.
    """

    def __init__(self, seed: int = 7, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.params = state_to(default_detector_params(), self.device)
        self.dims = level_dims(SCENE_H, SCENE_W)
        self.rng = np.random.default_rng(seed)
        self.neg: List[np.ndarray] = []
        self.pos: List[Tuple[np.ndarray, float]] = []  # (crop, hard)
        self.last_neg_score = float("nan")
        self.render_seconds = 0.0

    def refresh(self, n_frames: int = MINE_FRAMES):
        rng = self.rng
        t0 = time.perf_counter()
        scenes = [scene(rng) for _ in range(n_frames)]
        self.render_seconds += time.perf_counter() - t0
        frames = np.stack([s[0] for s in scenes])
        with torch.no_grad():
            scores_t, boxes_t = pyramid_candidates(
                self.params,
                torch.from_numpy(frames).to(self.device, torch.float32),
                self.dims)
            cand = torch.cat([scores_t[..., None], boxes_t], -1).cpu().numpy()
        scores, boxes = cand[..., 0], cand[..., 1:]
        new_neg, new_pos = [], []
        for i, (frame, gt, distract, hard) in enumerate(scenes):
            order = np.argsort(scores[i])[::-1][:refiner.REFINE_K]
            for j in order:
                if scores[i][j] <= refiner.PROPOSAL_GATE:
                    break
                box = tuple(float(v) for v in boxes[i][j])
                best = max((_iou(box, g) for g in gt), default=0.0)
                win = _window(box)
                if _clean_negative(box, gt):
                    new_neg.append((i, win, float(scores[i][j])))
                elif best >= 0.5:
                    gi = int(np.argmax([_iou(box, g) for g in gt]))
                    new_pos.append((i, win, float(hard[gi])))
            # distractor-centred windows are negatives even when stage 1
            # scored them low — cheap extra coverage of the prop families
            for dbox in distract:
                if _clean_negative(dbox, gt):
                    win = _window(_jitter_box(rng, dbox))
                    new_neg.append((i, win, 0.0))
        # one extraction for both classes: per frame its negative windows,
        # then its positive ones
        per_frame = [[n[1] for n in new_neg if n[0] == i]
                     + [p[1] for p in new_pos if p[0] == i]
                     for i in range(len(frames))]
        crops = _extract_grouped(frames, per_frame, self.device)
        n_neg = [sum(n[0] == i for n in new_neg) for i in range(len(frames))]
        if new_neg:
            self.neg.extend(c for i, lst in enumerate(crops)
                            for c in lst[:n_neg[i]])
            self.neg = self.neg[-NEG_BUF:]
            self.last_neg_score = max(n[2] for n in new_neg)
        if new_pos:
            hards = [p[2] for i in range(len(frames))
                     for p in new_pos if p[0] == i]
            self.pos.extend(zip((c for i, lst in enumerate(crops)
                                 for c in lst[n_neg[i]:]), hards))
            self.pos = self.pos[-POS_BUF:]

    def sample_neg(self, rng, k):
        if not self.neg:
            return np.zeros((0, refiner.CROP, refiner.CROP, 3), np.float32)
        idx = rng.integers(0, len(self.neg), size=k)
        return np.stack([self.neg[i] for i in idx])

    def sample_pos(self, rng, k):
        if not self.pos:
            return (np.zeros((0, refiner.CROP, refiner.CROP, 3), np.float32),
                    np.zeros((0,), np.float32))
        idx = rng.integers(0, len(self.pos), size=k)
        return (np.stack([self.pos[i][0] for i in idx]),
                np.asarray([self.pos[i][1] for i in idx], np.float32))


def crop_batch(rng: np.random.Generator, miner: ServeMiner,
               n_scenes: int = 4):
    """One training batch: fresh-scene crops + mined serve-window crops.

    Returns (crops [N, 64, 64, 3] f32, labels [N] in {0, 1},
    hard [N] — low-evidence positives get the soft margin target)."""
    crops, labels, hard = [], [], []
    scene_frames, scene_wins = [], []
    for _ in range(n_scenes):
        frame, gt, distract, hflags = scene(rng)
        wins, ls, hs = [], [], []
        for gi, g in enumerate(gt):
            wins.append(_window(_jitter_box(rng, g)))
            ls.append(1.0)
            hs.append(float(hflags[gi]))
        for d in distract:
            if _clean_negative(d, gt):
                wins.append(_window(_jitter_box(rng, d)))
                ls.append(0.0)
                hs.append(0.0)
        # edge-straddling + random background windows (always negative)
        for _ in range(3):
            side = rng.uniform(48, 160)
            ax = rng.random()
            if ax < 0.35:   # straddle a vertical border
                cx = rng.choice([rng.uniform(-0.3, 0.3) * side,
                                 SCENE_W + rng.uniform(-0.3, 0.3) * side])
                cy = rng.uniform(0, SCENE_H)
            elif ax < 0.7:  # straddle a horizontal border (top-biased)
                cx = rng.uniform(0, SCENE_W)
                cy = (rng.uniform(-0.3, 0.3) * side if rng.random() < 0.7
                      else SCENE_H + rng.uniform(-0.3, 0.3) * side)
            else:
                cx = rng.uniform(0, SCENE_W)
                cy = rng.uniform(0, SCENE_H)
            cand = (cx - side / 2, cy - side / 2,
                    cx + side / 2, cy + side / 2)
            if _clean_negative(cand, gt):
                wins.append(_window(cand))
                ls.append(0.0)
                hs.append(0.0)
        scene_frames.append(frame)
        scene_wins.append(wins)
        labels.extend(ls)
        hard.extend(hs)
    # one grouped device call for ALL scenes' windows (see _extract_grouped)
    for ex in _extract_grouped(np.stack(scene_frames), scene_wins,
                               miner.device):
        crops.extend(ex)
    mined = miner.sample_neg(rng, 12)
    crops.extend(mined)
    labels.extend([0.0] * len(mined))
    hard.extend([0.0] * len(mined))
    mpos, mhard = miner.sample_pos(rng, 6)
    crops.extend(mpos)
    labels.extend([1.0] * len(mpos))
    hard.extend(mhard)
    return (_color_aug(rng, np.stack(crops)), np.asarray(labels, np.float32),
            np.asarray(hard, np.float32))


def pad_to_bucket(crops, labels, hard, bucket: int = PAD_BUCKET):
    """Pad a batch to a multiple of ``bucket`` with black crops labelled 0
    (`train_refiner.py:462-474`).  The pad is part of the objective, not a
    compilation bound: the black crops enter the BCE, its weights and the
    negative top-K as easy negatives, so it is kept."""
    n = crops.shape[0]
    m = ((n + bucket - 1) // bucket) * bucket
    if m != n:
        pad = m - n
        crops = np.concatenate([crops, np.zeros((pad,) + crops.shape[1:],
                                                crops.dtype)])
        labels = np.concatenate([labels, np.zeros(pad, np.float32)])
        hard = np.concatenate([hard, np.zeros(pad, np.float32)])
    return crops, labels, hard


def loss_fn(params, crops, labels, hard):
    """(loss, params with the batch norms' statistics moved), as
    `train_refiner.py:424-440`: crops [N, 64, 64, 3] float, labels [N],
    hard [N]."""
    logits, params_new = refiner.forward(params, crops, train=True,
                                         compute_dtype=torch.float32)
    bce = sigmoid_binary_cross_entropy(logits, labels)
    pos = labels > 0.5
    w = torch.where(pos, 2.0, 1.0)
    loss = torch.sum(bce * w) / torch.sum(w).clamp_min(1.0)
    pos_target = torch.where(hard > 0.5, MARGIN_POS_HARD, MARGIN_POS)
    pos_hinge = hinge(pos_target - logits) + hinge(logits - ANCHOR)
    loss = loss + MARGIN_W * (torch.sum(pos_hinge * pos)
                              / torch.sum(pos).clamp_min(1.0))
    neg_hinge = torch.where(pos, 0.0, hinge(logits - MARGIN_NEG))
    top, _ = top_k(neg_hinge, min(NEG_TOPK, int(neg_hinge.shape[0])))
    loss = loss + 2.0 * MARGIN_W * torch.mean(top)
    return loss, params_new


def batch_tensors(crops, labels, hard, device):
    """A host batch as the device tensors ``loss_fn`` takes."""
    return tuple(torch.from_numpy(np.asarray(a, np.float32)).to(device)
                 for a in (crops, labels, hard))


def train(steps: int = 3000, seed: int = 0, lr: float = 3e-4,
          log_every: int = 50, init_params=None, ckpt_path: str = None,
          ckpt_every: int = 200, device: DeviceLike = None):
    """Train for ``steps`` steps and return the state (on ``device``:
    ``cuda`` unless ``"cpu"`` is asked for).  A producer thread renders the
    scenes, cuts the crops and refreshes the miner every ``MINE_EVERY``
    batches (stage 1 is frozen, so mining needs nothing from the step)."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    params = (init_params if init_params is not None
              else refiner.init_params(torch.Generator().manual_seed(seed)))
    params = state_to(params, device)
    miner = ServeMiner(seed=seed + 77, device=device)
    params, opt = adam(params, cosine_decay_schedule(lr, steps, alpha=0.1))
    batches = 0

    def make():
        nonlocal batches
        if batches % MINE_EVERY == 0:
            miner.refresh()
        batches += 1
        return pad_to_bucket(*crop_batch(rng, miner))

    t0 = time.time()
    stream = data.batch_stream(make)
    try:
        for step in range(steps):
            params, loss = train_step(loss_fn, params, opt,
                                      *batch_tensors(*next(stream), device))
            if step % log_every == 0 or step == steps - 1:
                print(f"step {step:5d}  loss {float(loss):.4f}  "
                      f"({time.time() - t0:.1f}s)  "
                      f"buf neg {len(miner.neg)} (last max "
                      f"{miner.last_neg_score:.1f}) pos {len(miner.pos)}",
                      flush=True)
            if ckpt_path and step and step % ckpt_every == 0:
                save_params(ckpt_path, params)
                print(f"ckpt @ {step} -> {ckpt_path}", flush=True)
    finally:
        stream.close()
    return params


def main(argv=None, device: DeviceLike = None) -> int:
    """usage: train_refiner <steps> <out.npz> [--init=ckpt.npz] [--lr=3e-4]

    The output path is required, and never lies inside the JAX package.
    """
    argv = sys.argv[1:] if argv is None else list(argv)
    device = resolve_device(device)
    args = [a for a in argv if not a.startswith("--")]
    if len(args) != 2:
        raise SystemExit(main.__doc__)
    steps, out = int(args[0]), checked_output(args[1])
    lr = next((float(a.split("=", 1)[1]) for a in argv
               if a.startswith("--lr=")), 3e-4)
    init_path = next((a.split("=", 1)[1] for a in argv
                      if a.startswith("--init=")), None)
    init = load_params(init_path) if init_path else None
    params = train(steps=steps, lr=lr, init_params=init,
                   ckpt_path=str(out) + ".ckpt", device=device)
    save_params(out, params)
    print("saved", out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
