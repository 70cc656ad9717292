"""Serve-scale bootstrapped hard-negative mining for the detector.

Port of ``pyannote_video_tpu/train/mine.py``.  The scenes are the JAX
package's draw for draw (``train/data.py``); the pyramid runs on the card
in the serving bfloat16 chain, and a refresh reads the device once: every
level's logits and level image in one copy.

dlib's MMOD trainer mines false positives from whole images through the
SAME pyramid it serves with (dlib/dnn/loss.h ``loss_mmod_``: every cell
of every pyramid level above the margin is a candidate loss term) — so
whatever configuration fires at serve time is, by construction, inside
the training distribution.  The 128 px crop trainer here historically
lacked that property: its clutter negatives are rendered AT crop scale,
while a serve-time distractor reaches the detector through 4-6 chained
3/4 downscales of a full frame, with accumulated resample blur and a
context window larger than the object.  Measured gap (r5, detector v5):
trainer crops' hardest negative cells score ≤ 3 logits while the SAME
generator families pushed through the serve pyramid reach 7.5, and the
wide-probe decoy tail sat at 9.9 — invisible to crop-scale training
pressure, however the clutter families are tuned.

This module closes the gap the way dlib does, bootstrapped: render
NEGATIVE frames (no faces) at frame scale from the trainer's own
generator families, run the CURRENT weights' chained pyramid exactly as
serving does (`models/detector.py:pyramid_candidates` semantics, bf16
resample chain included), and harvest 128 px crops AROUND the
highest-scoring cells — from the level image the detector actually saw,
not the original frame.  The trainer mixes these into every batch as
all-negative crops and refreshes the buffer as the weights move, so new
FP families surface as old ones are crushed.

Eval-shift hygiene: mining renders through `train.data`'s families only
(`_draw_clutter`, featureless heads, `_photometric_aug`); nothing here
imports `utils/synthetic_shift.py`.
"""

from __future__ import annotations

import time
from dataclasses import replace
from typing import List, Tuple

import numpy as np
import torch

from ..models.detector import STRIDE, WINDOW, forward_maps, pyramid_scales
from ..ops.color import resize_bilinear
from ..utils.device import DeviceLike, resolve_device
from ..utils.synthetic import FaceParams, _background, render_face
from .data import (AUG_HARD_P, AUG_SIDEBAR_P, _draw_clutter, _photometric_aug,
                   _random_affine, _warp_frame_and_boxes, broad_identity)

MINE_H, MINE_W = 360, 480   # frame scale: deep enough for a 5-level chain
MINE_MIN_LOGIT = 0.0        # harvest cells above the negative hinge target
MINE_PER_FRAME = 3          # top cells kept per frame per level
# positive mining: faces whose best serve-path cell scores below this are
# hard positives — harvest them WITH their level-mapped GT box.  Mining
# negatives alone over-suppresses low-evidence posed faces (measured, v6:
# wide-probe fp_n 240 → 51 but BC real_min 8.8 → 4.5 — the miner taught
# "blurry warped blob ⇒ not face" and the crop-scale positives, which
# never see the serve resample chain, could not push back).
HARD_POS_LOGIT = 6.0
# the regressed window band a face must land in at SOME pyramid level
# (models/detector.py: ±20% box head, pyramid ratio 3/4 — every height
# has at least one level inside [0.85, 0.85/0.75) ⊂ the band)
POS_BAND = (0.85, 1.2)


def negative_frame(rng: np.random.Generator,
                   h: int = MINE_H, w: int = MINE_W) -> np.ndarray:
    """One frame-scale NEGATIVE scene: background mosaic + the trainer's
    distractor families at a broad size band (clutter up to ~45% of the
    frame height — the serve pyramid, not the renderer, brings it into
    the detector's window band)."""
    bg = _background(w, h, rng).astype(np.float32)
    if rng.random() < 0.6:  # featureless skin-tone head
        decoy = replace(FaceParams.random(rng),
                        eye_r=0.0, mouth_w=0.0, nose_len=0.2)
        dh = float(rng.uniform(0.12, 0.45) * h)
        render_face(bg, float(rng.uniform(dh, w - dh)),
                    float(rng.uniform(dh / 2, h - dh / 2)), dh, decoy)
    for _ in range(int(rng.integers(2, 6))):
        _draw_clutter(bg, rng, float(rng.uniform(0.6, 4.0) * WINDOW))
    return np.clip(_photometric_aug(bg, rng), 0, 255).astype(np.uint8)


def positive_frame(rng: np.random.Generator,
                   h: int = MINE_H, w: int = MINE_W
                   ) -> Tuple[np.ndarray, list]:
    """One frame-scale scene with EXACTLY one augmented face (plus the
    negative families as context).  Single face by design: a mined crop
    must label every face it contains, and one face per frame keeps the
    level-mapped GT unambiguous.  Returns (frame uint8, [gt box])."""
    bg = _background(w, h, rng).astype(np.float32)
    for _ in range(int(rng.integers(1, 4))):
        _draw_clutter(bg, rng, float(rng.uniform(0.6, 3.0) * WINDOW))
    params = (broad_identity(rng) if rng.random() < 0.5
              else FaceParams.random(rng))
    fh = float(rng.uniform(WINDOW * 1.1, 0.45 * h))
    half_w = fh / 2.0 / params.aspect
    cx = float(rng.uniform(half_w + 2, w - half_w - 2))
    cy = float(rng.uniform(fh / 2 + 2, h - fh / 2 - 2))
    render_face(bg, cx, cy, fh, params)
    gt = [(cx - half_w, cy - fh / 2, cx + half_w, cy + fh / 2)]
    hard = rng.random() < 3 * AUG_HARD_P  # mining WANTS the joint tail
    if hard or rng.random() < 0.6:
        bg, gt = _warp_frame_and_boxes(
            bg, gt, _random_affine(rng, hard=hard), w / 2, h / 2)
    if gt and (hard or rng.random() < AUG_SIDEBAR_P):
        (l, t, r, b) = gt[0]
        frac = rng.uniform(0.12, 0.28)
        side = rng.integers(0, 3)
        if side == 0:
            box = (l, b - (b - t) * frac, r, b)
        elif side == 1:
            box = (l, t + (b - t) * 0.2, l + (r - l) * frac, b)
        else:
            box = (r - (r - l) * frac, t + (b - t) * 0.2, r, b)
        x0 = int(np.clip(box[0], 0, w - 1)); y0 = int(np.clip(box[1], 0, h - 1))
        x1 = int(np.clip(box[2], x0 + 1, w)); y1 = int(np.clip(box[3], y0 + 1, h))
        bg[y0:y1, x0:x1] = rng.uniform(20, 230, size=3)
    return np.clip(_photometric_aug(bg, rng), 0, 255).astype(np.uint8), gt


@torch.no_grad()
def _pyramid_maps(params, frames: torch.Tensor, dims):
    """Chained-downsample pyramid (serve semantics, bf16 chain) returning
    each level's (logits [B, mh, mw] float32, level image [B, lh, lw, 3]
    bfloat16) instead of decoded boxes."""
    outs = []
    cur = frames.to(torch.bfloat16)
    for (lh, lw) in dims:
        if (lh, lw) != (cur.shape[1], cur.shape[2]):
            cur = resize_bilinear(cur, lh, lw)
        outs.append((forward_maps(params, cur)[..., 0], cur))
    return outs


def _read_levels(levels):
    """Every level's (logits, image) as float32 host arrays, in one copy
    from the device."""
    parts = [t for pair in levels for t in pair]
    flat = torch.cat([t.reshape(-1).to(torch.float32) for t in parts]).cpu().numpy()
    out, at = [], 0
    for t in parts:
        out.append(flat[at:at + t.numel()].reshape(t.shape))
        at += t.numel()
    return list(zip(out[0::2], out[1::2]))


class HardNegativeMiner:
    """Ring buffer of serve-mined hard-negative crops.

    ``refresh(params)`` renders a few negative frames, runs the serve
    pyramid under the CURRENT params, and stores 128 px crops centered on
    every cell scoring above ``MINE_MIN_LOGIT`` (top ``MINE_PER_FRAME``
    per frame per level).  ``sample(rng, n)`` draws crops for the trainer
    to substitute into its batch (labels all-negative).

    ``device``: where the pyramid runs (``cuda`` unless ``"cpu"`` is asked
    for); the params handed to ``refresh`` live there.  ``render_seconds``
    adds up the host time spent rendering scenes.
    """

    def __init__(self, crop: int = 128, capacity: int = 512,
                 frames_per_refresh: int = 8, seed: int = 77,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.render_seconds = 0.0
        self.crop = crop
        self.capacity = capacity
        self.frames_per_refresh = frames_per_refresh
        self._rng = np.random.default_rng(seed)
        self._buf: List[np.ndarray] = []
        self._next = 0  # ring write cursor once full
        self._pos_buf: List[Tuple[np.ndarray, tuple]] = []  # (crop, gt box)
        self._pos_next = 0
        self.mined_total = 0
        self.last_max_logit = float("-inf")
        self.last_min_pos_logit = float("inf")
        self._scales = [s for s in pyramid_scales(MINE_H, MINE_W)
                        if s <= 1.0]
        self._dims = tuple(
            (max(STRIDE * 2, int(round(MINE_H * s))),
             max(STRIDE * 2, int(round(MINE_W * s)))) for s in self._scales)

    def __len__(self) -> int:
        return len(self._buf)

    def _store(self, patch: np.ndarray) -> None:
        if len(self._buf) < self.capacity:
            self._buf.append(patch)
        else:
            self._buf[self._next] = patch
            self._next = (self._next + 1) % self.capacity
        self.mined_total += 1

    def _levels(self, params, frames: np.ndarray):
        frames_t = torch.from_numpy(frames).to(self.device, torch.float32)
        return _read_levels(_pyramid_maps(params, frames_t, self._dims))

    def refresh(self, params) -> int:
        """Mine under ``params``; returns the number of crops harvested."""
        t0 = time.perf_counter()
        frames = np.stack([negative_frame(self._rng)
                           for _ in range(self.frames_per_refresh)])
        self.render_seconds += time.perf_counter() - t0
        c, found, mx = self.crop, 0, float("-inf")
        for logits, imgs in self._levels(params, frames):
            B, mh, mw = logits.shape
            flat = logits.reshape(B, -1)
            for b in range(B):
                top = np.argsort(flat[b])[::-1][:MINE_PER_FRAME]
                for i in top:
                    sc = float(flat[b, i])
                    mx = max(mx, sc)
                    if sc < MINE_MIN_LOGIT:
                        break  # sorted: the rest are lower
                    r, col = divmod(int(i), mw)
                    cy, cx = r * STRIDE + STRIDE // 2, \
                        col * STRIDE + STRIDE // 2
                    lh, lw = imgs.shape[1:3]
                    y0 = int(np.clip(cy - c // 2, 0, max(lh - c, 0)))
                    x0 = int(np.clip(cx - c // 2, 0, max(lw - c, 0)))
                    patch = imgs[b, y0:y0 + c, x0:x0 + c]
                    if patch.shape[0] < c or patch.shape[1] < c:
                        patch = np.pad(
                            patch, ((0, c - patch.shape[0]),
                                    (0, c - patch.shape[1]), (0, 0)),
                            mode="edge")
                    self._store(np.clip(patch, 0, 255).astype(np.uint8))
                    found += 1
        self.last_max_logit = mx
        return found

    def sample(self, rng: np.random.Generator, n: int) -> List[np.ndarray]:
        if not self._buf:
            return []
        idx = rng.integers(0, len(self._buf), size=min(n, len(self._buf)))
        return [self._buf[int(i)] for i in idx]

    # -- hard-positive side ------------------------------------------------

    def _store_pos(self, patch: np.ndarray, box: tuple) -> None:
        if len(self._pos_buf) < self.capacity:
            self._pos_buf.append((patch, box))
        else:
            self._pos_buf[self._pos_next] = (patch, box)
            self._pos_next = (self._pos_next + 1) % self.capacity

    def refresh_positives(self, params) -> int:
        """Mine faces the serve pyramid under-scores.

        For each rendered face, its serve score is the 3×3-neighborhood
        max logit at its center cell over every level whose scaled height
        lands in the regression band; faces below ``HARD_POS_LOGIT`` are
        harvested from their best level WITH the level-mapped GT box."""
        t0 = time.perf_counter()
        frames, gts = [], []
        for _ in range(self.frames_per_refresh):
            f, gt = positive_frame(self._rng)
            if gt:  # the affine can push the face out of frame
                frames.append(f)
                gts.append(gt[0])
        self.render_seconds += time.perf_counter() - t0
        if not frames:
            return 0
        levels = self._levels(params, np.stack(frames))
        logits = [lg for lg, _ in levels]
        imgs = [im for _, im in levels]
        c, found, mn = self.crop, 0, float("inf")
        for b, (l, t, r, btm) in enumerate(gts):
            fh = btm - t
            best = None  # (score, level, cell row, cell col)
            for li, s in enumerate(self._scales):
                if not (WINDOW * POS_BAND[0] <= fh * s <= WINDOW * POS_BAND[1]):
                    continue
                mh, mw = logits[li].shape[1:3]
                row = int((t + btm) / 2 * s / STRIDE)
                col = int((l + r) / 2 * s / STRIDE)
                r0, r1 = max(0, row - 1), min(mh, row + 2)
                c0, c1 = max(0, col - 1), min(mw, col + 2)
                if r0 >= r1 or c0 >= c1:
                    continue
                sc = float(logits[li][b, r0:r1, c0:c1].max())
                if best is None or sc > best[0]:
                    best = (sc, li, row, col)
            if best is None:
                continue
            sc, li, row, col = best
            mn = min(mn, sc)
            if sc >= HARD_POS_LOGIT:
                continue
            s = self._scales[li]
            lh, lw = imgs[li].shape[1:3]
            cy, cx = row * STRIDE + STRIDE // 2, col * STRIDE + STRIDE // 2
            y0 = int(np.clip(cy - c // 2, 0, max(lh - c, 0)))
            x0 = int(np.clip(cx - c // 2, 0, max(lw - c, 0)))
            patch = imgs[li][b, y0:y0 + c, x0:x0 + c]
            if patch.shape[0] < c or patch.shape[1] < c:
                patch = np.pad(patch, ((0, c - patch.shape[0]),
                                       (0, c - patch.shape[1]), (0, 0)),
                               mode="edge")
            box = (l * s - x0, t * s - y0, r * s - x0, btm * s - y0)
            self._store_pos(np.clip(patch, 0, 255).astype(np.uint8), box)
            found += 1
        self.last_min_pos_logit = mn
        return found

    def sample_pos(self, rng: np.random.Generator, n: int
                   ) -> List[Tuple[np.ndarray, tuple]]:
        if not self._pos_buf:
            return []
        idx = rng.integers(0, len(self._pos_buf),
                           size=min(n, len(self._pos_buf)))
        return [self._pos_buf[int(i)] for i in idx]
