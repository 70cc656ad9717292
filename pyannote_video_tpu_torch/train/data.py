"""Synthetic training data for detector / landmark / embedder models.

Port of ``pyannote_video_tpu/train/data.py``.  Samples from the same
parametric face distribution as the test fixtures (`utils/synthetic.py`),
so trained models and pipeline tests agree.  All generation is host-side
NumPy; batches are handed to the trainers' steps.

Every generator draws from its ``numpy.random.Generator`` in exactly the
JAX package's order, so a seed gives the same scenes, boxes, labels and
targets there and here.  The JAX generators call OpenCV (``warpAffine``,
``filter2D``, ``resize``); the machine with the card has no OpenCV, so
these call their NumPy counterparts in ``utils/imops.py``, which agree
with OpenCV to float32 rounding: the images match within the tolerance
``tests/test_torch_train_data.py`` states, the boxes and labels exactly
(no draw depends on a pixel value).
"""

from __future__ import annotations

import queue
import threading
from dataclasses import replace
from typing import Callable, Dict, Iterator, List, Tuple

import numpy as np

from ..models.detector import WINDOW
from ..utils.imops import bilinear_resize, filter2d, warp_affine
from ..utils.synthetic import FaceParams, _background, render_face


# geometric augmentation (generic image-space affine + cutout; trainers
# never sample the eval-shift renderer — see utils/synthetic_shift.py)
AUG_P = 0.7            # fraction of frames that get a random affine
AUG_MAX_ROLL = 30.0    # degrees
AUG_MIN_XSCALE = 0.76  # horizontal foreshortening (yaw proxy)
AUG_MAX_SHEAR = 0.11
AUG_YSCALE = (0.85, 1.18)  # vertical stretch (face aspect-ratio coverage)
AUG_CUTOUT_P = 0.25    # per-face probability of a cutout patch
AUG_SIDEBAR_P = 0.25   # per-face probability of a side occlusion bar
# joint-tail oversampling: with this probability a crop is a "hard combo" —
# strong roll AND strong foreshortening AND a forced occlusion bar at once.
# Independent sampling of each augmentation leaves the joint tail nearly
# empty (0.7 * tails of each range * 0.25 ≈ 1%), and the wide-seed probe
# showed exactly that gap: persistent-pose shots combining max roll, yaw
# squash and an occluder scored 0.8-3.6 logits while typical posed faces
# hold 7+ (evals/probe_detector.py --wide, domain B seed 707).
# Kept low, and paired with a LOWER positive-margin target in the loss
# (train_detector.MARGIN_POS_HARD): a measured run at 0.25 with the full
# +8 target taught the detector that low-evidence warped blobs are
# high-confidence faces, and background false positives rose with them
# (fp_n 13 → 110 on the unshifted probe domain).
AUG_HARD_P = 0.12


def broad_identity(rng: np.random.Generator,
                   stretch: float = 0.35) -> FaceParams:
    """Identity parameters from the training sampler's ranges stretched by
    ``stretch`` about each range's midpoint — generic appearance
    broadening (the synthetic analogue of training on a more diverse face
    corpus).  Values are clipped to renderable bounds.  Parameterised by
    one scalar applied uniformly to every field; NOT derived from the
    eval-shift module (`utils/synthetic_shift.py`), which trainers must
    never import.
    """
    s = 1.0 + stretch

    def u(lo, hi):
        lo, hi = np.asarray(lo, float), np.asarray(hi, float)
        mid, half = (lo + hi) / 2.0, (hi - lo) / 2.0 * s
        return rng.uniform(mid - half, mid + half)

    return FaceParams(
        skin=tuple(np.clip(u([150, 110, 80], [235, 205, 180]), 0, 255)),
        hair=tuple(np.clip(u([20, 10, 5], [120, 90, 60]), 0, 255)),
        eye_dx=float(np.clip(u(0.32, 0.48), 0.26, 0.54)),
        eye_y=float(np.clip(u(-0.24, -0.12), -0.30, -0.06)),
        eye_r=float(np.clip(u(0.07, 0.13), 0.04, 0.16)),
        iris=tuple(np.clip(u([10, 10, 10], [80, 60, 120]), 0, 255)),
        mouth_w=float(np.clip(u(0.20, 0.36), 0.12, 0.44)),
        mouth_y=float(np.clip(u(0.48, 0.62), 0.42, 0.68)),
        brow_y=float(np.clip(u(-0.52, -0.40), -0.60, -0.34)),
        aspect=float(np.clip(u(1.15, 1.45), 1.02, 1.60)),
        nose_len=float(np.clip(u(0.4, 0.6), 0.25, 0.75)),
    )


def _random_affine(rng: np.random.Generator, hard: bool = False) -> np.ndarray:
    if hard:
        # joint tail: strong roll AND strong foreshortening together
        # (sub-maximal: the extremes of BOTH at once leave too little
        # face evidence to be a useful positive)
        th = np.deg2rad(rng.uniform(18.0, 28.0) *
                        (1 if rng.random() < 0.5 else -1))
        xs = rng.uniform(0.78, 0.86)
    else:
        th = np.deg2rad(rng.uniform(-AUG_MAX_ROLL, AUG_MAX_ROLL))
        xs = rng.uniform(AUG_MIN_XSCALE, 1.0)
    ys = rng.uniform(*AUG_YSCALE)
    sh = rng.uniform(-AUG_MAX_SHEAR, AUG_MAX_SHEAR)
    rot = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
    return rot @ np.array([[xs, sh], [0.0, ys]])


def _warp_frame_and_boxes(img, gt, A, cx0, cy0):
    """Affine `A` about (cx0, cy0): warp image, map each GT box (treated
    as the face ellipse's bound) to the warped ellipse's bound."""
    h, w = img.shape[:2]
    M = np.concatenate([A, ([[cx0], [cy0]] - A @ [[cx0], [cy0]])], axis=1)
    out = warp_affine(img, M.astype(np.float32), (w, h))
    new_gt = []
    for (l, t, r, b) in gt:
        c = A @ [[(l + r) / 2 - cx0], [(t + b) / 2 - cy0]] + [[cx0], [cy0]]
        hw, hh = (r - l) / 2, (b - t) / 2
        bw = float(np.hypot(A[0, 0] * hw, A[0, 1] * hh))
        bh = float(np.hypot(A[1, 0] * hw, A[1, 1] * hh))
        # clip to the visible frame (the annotation of a face partially
        # warped out of view); drop faces left with no visible extent
        nl = max(float(c[0, 0]) - bw, 0.0)
        nt = max(float(c[1, 0]) - bh, 0.0)
        nr = min(float(c[0, 0]) + bw, float(w))
        nb = min(float(c[1, 0]) + bh, float(h))
        if nr > nl and nb > nt:
            new_gt.append((nl, nt, nr, nb))
    return out, new_gt


def _draw_clutter(bg: np.ndarray, rng: np.random.Generator,
                  size: float) -> None:
    """One generic high-contrast distractor: disc/ring/blob with optional
    dark spots, or a grating patch.

    A general clutter-negative family (standard detector training
    practice): object geometry, colors, spot counts/radii/positions are
    all drawn from broad random ranges — parameterised independently of
    any eval-domain decoy generator.  Teaches the detector that "compact
    shape containing a few dark dots" is not a face unless the actual
    eye/mouth configuration is present.
    """
    h, w = bg.shape[:2]
    half = min(size, min(h, w) - 4.0) / 2.0  # keep placement range valid
    cx = float(rng.uniform(half, w - half))
    cy = float(rng.uniform(half, h - half))
    x0, x1 = int(max(0, cx - half - 1)), int(min(w, cx + half + 2))
    y0, y1 = int(max(0, cy - half - 1)), int(min(h, cy + half + 2))
    if x1 <= x0 or y1 <= y0:
        return
    gy, gx = np.mgrid[y0:y1, x0:x1].astype(np.float32)
    rr = np.sqrt(((gx - cx) / half) ** 2 + ((gy - cy) / half) ** 2)
    region = bg[y0:y1, x0:x1]
    kind = int(rng.integers(0, 4))
    # bias toward pale low-saturation objects (p=0.4): bright dials,
    # plates, panels are the hardest real-world distractor palette —
    # v4's top wide-probe FPs were all near-white discs (r5, measured
    # +9.7 logits), and uniform-hue sampling makes that corner rare
    if rng.random() < 0.4:
        base = rng.uniform(170, 245)
        color = base + rng.uniform(-18, 18, size=3)
    else:
        color = rng.uniform(40, 245, size=3)
    if kind == 0:        # filled disc
        region[rr <= 1.0] = color
    elif kind == 1:      # ring / annulus
        inner = rng.uniform(0.5, 0.85)
        region[(rr <= 1.0) & (rr >= inner)] = color
    elif kind == 2:      # soft blob (squashed gaussian-ish falloff)
        sq = rng.uniform(0.6, 1.6)
        rr2 = np.sqrt(((gx - cx) / (half * sq)) ** 2
                      + ((gy - cy) / half) ** 2)
        m = rr2 <= 1.0
        a = np.clip(1.0 - rr2, 0.0, 1.0)[..., None]
        region[m] = (region * (1 - a) + color[None, None] * a)[m]
    else:                # grating patch
        theta = rng.uniform(0, np.pi)
        freq = rng.uniform(0.15, 0.7)
        wave = np.sin((gx * np.cos(theta) + gy * np.sin(theta)) * freq)
        m = rr <= 1.0
        region[m & (wave > 0)] = color
    # dark spots on the object: random scatter, or (p=0.3) a STRUCTURED
    # pattern — a symmetric pair plus optionally one below, the geometric
    # signature a face detector keys on.  Marks in an eyes(+mouth)
    # arrangement on a non-face object are the hardest negative family
    # (dial faces, speaker grilles, button panels); without them the
    # detector accepts "two dark dots over one" regardless of texture.
    def spot(sx, sy, sr):
        sm = (gx - sx) ** 2 + (gy - sy) ** 2 <= sr ** 2
        region[sm] = rng.uniform(0, 70, size=3)

    u = rng.random()
    if u < 0.3:
        dx = rng.uniform(0.25, 0.5) * half
        dy = rng.uniform(0.15, 0.45) * half
        sr = rng.uniform(0.05, 0.14) * size
        ang = rng.uniform(-0.35, 0.35)  # slight pattern roll
        ca, sa = np.cos(ang), np.sin(ang)
        spot(cx - dx * ca, cy - dy - dx * sa, sr)
        spot(cx + dx * ca, cy - dy + dx * sa, sr)
        if rng.random() < 0.7:  # the "mouth" mark
            spot(cx + rng.uniform(-0.1, 0.1) * half,
                 cy + rng.uniform(0.25, 0.55) * half,
                 sr * rng.uniform(0.8, 1.6))
    elif u < 0.65:
        # annular (dial/button-panel) placement: k marks on a random
        # ring — at certain angle draws two land "eyes"-high and one
        # low, the exact configuration the scatter mode under-samples
        # (v4's residual FP family)
        ring = rng.uniform(0.35, 0.85) * half
        for a in rng.uniform(0, 2 * np.pi, size=int(rng.integers(2, 7))):
            spot(cx + ring * np.cos(a), cy + ring * np.sin(a),
                 rng.uniform(0.04, 0.16) * size)
    else:
        for _ in range(int(rng.integers(0, 6))):
            spot(cx + rng.uniform(-0.7, 0.7) * half,
                 cy + rng.uniform(-0.7, 0.7) * half,
                 rng.uniform(0.04, 0.18) * size)


def _photometric_aug(bg: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Generic photometric augmentation: gain/bias, a linear illumination
    gradient across the frame, horizontal motion blur, and variable sensor
    noise.

    Standard detector-training practice, parameterised independently of the
    eval-shift renderer (`utils/synthetic_shift.py`) — the detector must
    keep firing when pose/occlusion shifts COMBINE with photometric ones
    (unlit/blurred rolled faces were the residual misses in the BC eval
    domain).
    """
    h, w = bg.shape[:2]
    out = bg.astype(np.float32)
    if rng.random() < 0.5:                      # global gain / bias
        out = out * rng.uniform(0.6, 1.25) + rng.uniform(-25.0, 25.0)
    if rng.random() < 0.4:                      # linear illumination gradient
        theta = rng.uniform(0, 2 * np.pi)
        gy, gx = np.mgrid[0:h, 0:w].astype(np.float32)
        ramp = ((gx / max(w - 1, 1)) * np.cos(theta)
                + (gy / max(h - 1, 1)) * np.sin(theta))
        ramp = (ramp - ramp.min()) / max(ramp.max() - ramp.min(), 1e-6)
        out = out * (rng.uniform(0.5, 0.9)
                     + ramp[..., None] * rng.uniform(0.2, 0.6))
    if rng.random() < 0.35:                     # motion blur (mostly horiz.)
        k = int(rng.integers(3, 11))
        kern = (np.full((1, k), 1.0 / k, np.float32) if rng.random() < 0.8
                else np.full((k, 1), 1.0 / k, np.float32))
        out = filter2d(out, kern)
    out += rng.normal(0, rng.uniform(1.0, 6.0), size=out.shape)
    return out


def detection_batch(rng: np.random.Generator, batch: int = 16,
                    height: int = 128, width: int = 128,
                    p_face: float = 0.8, return_hard: bool = False):
    """Frames with 0-2 faces whose heights sit in the detector's window band.

    Returns (frames [B, H, W, 3] uint8, per-frame GT box lists); with
    ``return_hard`` also a float [B] mask of the hard-combo crops so the
    loss can give their positives a lower margin target
    (train_detector.MARGIN_POS_HARD).
    """
    frames = np.empty((batch, height, width, 3), dtype=np.uint8)
    boxes: List[List[Tuple[float, float, float, float]]] = []
    hard_mask = np.zeros((batch,), dtype=np.float32)
    for b in range(batch):
        # super-scale augmentation: at inference, large faces reach the
        # detector through the pyramid's bilinear downscale
        # (`models/detector.py:pyramid_candidates`), which smooths edges
        # and aliases texture — crisply rendered window-scale faces never
        # look like that.  Render half the crops at a random super-scale
        # and downscale, covering the pyramid's appearance distribution up
        # to ~5.6x faces (220+ px at 480p, the big-closeup band).
        ss = float(rng.uniform(1.5, 5.6)) if rng.random() < 0.5 else 1.0
        ch, cw = int(round(height * ss)), int(round(width * ss))
        bg = _background(cw, ch, rng)
        gt: List[Tuple[float, float, float, float]] = []
        # face-like decoy negatives: skin-tone ellipses WITHOUT facial
        # structure, so the detector must key on eyes/mouth geometry
        # rather than "skin blob on texture"
        if rng.random() < 0.8:
            decoy = FaceParams.random(rng)
            decoy = replace(decoy, eye_r=0.0, mouth_w=0.0, nose_len=0.2)
            dh = min(WINDOW * ss * rng.uniform(0.8, 2.0),
                     min(cw, ch) / 2.0 - 2)
            dcx = rng.uniform(dh, cw - dh)
            dcy = rng.uniform(dh / 2, ch - dh / 2)
            render_face(bg, dcx, dcy, dh, decoy)
        # generic clutter negatives: discs/rings/blobs/gratings with
        # random dark spots — compact face-SIZED objects that are not
        # faces (see `_draw_clutter`)
        for _ in range(int(rng.integers(1, 5))):
            _draw_clutter(bg, rng, WINDOW * ss * rng.uniform(0.7, 2.0))
        n_faces = rng.integers(0, 3) if rng.random() < p_face else 0
        for _ in range(n_faces):
            # half from the generically stretched identity ranges
            # (`broad_identity`): detection must hold on face geometries
            # beyond the narrow training-sampler band
            params = (broad_identity(rng) if rng.random() < 0.5
                      else FaceParams.random(rng))
            face_h = WINDOW * ss * rng.uniform(0.85, 1.2)
            half_w = face_h / 2.0 / params.aspect
            cx = rng.uniform(half_w + 2, cw - half_w - 2)
            cy = rng.uniform(face_h / 2 + 2, ch - face_h / 2 - 2)
            # avoid heavy overlap with existing faces
            if any(abs(cx - (g[0] + g[2]) / 2) < face_h * 0.8
                   and abs(cy - (g[1] + g[3]) / 2) < face_h * 0.8 for g in gt):
                continue
            render_face(bg, cx, cy, face_h, params)
            gt.append((cx - half_w, cy - face_h / 2, cx + half_w, cy + face_h / 2))
        if ss != 1.0:
            # CHAINED 3/4-step downscale — the exact resample path a big
            # face takes through the serve-time pyramid
            # (`models/detector.py:pyramid_candidates`); a single direct
            # resize has a different alias/blur signature and leaves a
            # train/serve appearance gap on large faces (measured: chained
            # serving dropped scores of faces trained on direct downscale)
            cw2, ch2 = bg.shape[1], bg.shape[0]
            while round(cw2 * 0.75) > width:
                cw2, ch2 = round(cw2 * 0.75), round(ch2 * 0.75)
                bg = bilinear_resize(bg, cw2, ch2)
            bg = bilinear_resize(bg, width, height)
            gt = [tuple(v / ss for v in g) for g in gt]
        # pose augmentation: random affine of the whole frame (roll / yaw
        # foreshortening / shear) with exactly-warped GT, then cutouts —
        # the detector must keep firing on posed, partially occluded faces.
        # "hard" crops force the joint tail (see AUG_HARD_P).
        hard = bool(gt) and rng.random() < AUG_HARD_P
        hard_mask[b] = float(hard)
        if gt and (hard or rng.random() < AUG_P):
            A = _random_affine(rng, hard=hard)
            bg, gt = _warp_frame_and_boxes(bg, gt, A, width / 2, height / 2)
        for (l, t, r, btm2) in gt:
            if rng.random() < AUG_CUTOUT_P:
                fw, fh = r - l, btm2 - t
                cw = rng.uniform(0.1, 0.25) * fw
                chh = rng.uniform(0.1, 0.25) * fh
                ox = (l + r) / 2 + rng.uniform(-0.8, 0.8) * fw / 2
                oy = (t + btm2) / 2 + rng.uniform(-0.8, 0.8) * fh / 2
                x0 = int(np.clip(ox - cw / 2, 0, width - 1))
                y0 = int(np.clip(oy - chh / 2, 0, height - 1))
                x1 = int(np.clip(ox + cw / 2, x0 + 1, width))
                y1 = int(np.clip(oy + chh / 2, y0 + 1, height))
                bg[y0:y1, x0:x1] = rng.uniform(20, 230)
            if hard or rng.random() < AUG_SIDEBAR_P:
                # side occlusion bar: a solid rectangle covering up to a
                # quarter of the face from one edge (hands, foreground
                # props, frame edges — the generic partial-occlusion case)
                fw, fh = r - l, btm2 - t
                frac = rng.uniform(0.12, 0.28)
                side = rng.integers(0, 3)
                if side == 0:    # bottom
                    ol, ot, orr, ob = l, btm2 - fh * frac, r, btm2
                elif side == 1:  # left
                    ol, ot, orr, ob = l, t + fh * 0.2, l + fw * frac, btm2
                else:            # right
                    ol, ot, orr, ob = r - fw * frac, t + fh * 0.2, r, btm2
                x0 = int(np.clip(ol, 0, width - 1))
                y0 = int(np.clip(ot, 0, height - 1))
                x1 = int(np.clip(orr, x0 + 1, width))
                y1 = int(np.clip(ob, y0 + 1, height))
                bg[y0:y1, x0:x1] = rng.uniform(20, 230, size=3)
        frames[b] = np.clip(_photometric_aug(bg, rng), 0, 255
                            ).astype(np.uint8)
        boxes.append(gt)
    if return_hard:
        return frames, boxes, hard_mask
    return frames, boxes


def detection_targets(boxes: List[List[Tuple[float, float, float, float]]],
                      height: int, width: int, stride: int = 8,
                      window: float = WINDOW) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Dense target maps for the detector FCN.

    Returns (labels [B, mh, mw] in {1, 0, -1=ignore},
             deltas [B, mh, mw, 4], delta_mask [B, mh, mw]).
    """
    mh, mw = height // stride, width // stride
    B = len(boxes)
    labels = np.zeros((B, mh, mw), dtype=np.float32)
    deltas = np.zeros((B, mh, mw, 4), dtype=np.float32)
    for b, gts in enumerate(boxes):
        for (l, t, r, btm) in gts:
            cx, cy = (l + r) / 2, (t + btm) / 2
            w, h = r - l, btm - t
            col = int(cx / stride)
            row = int(cy / stride)
            if not (0 <= row < mh and 0 <= col < mw):
                continue
            # ignore ring around the positive cell
            for dr in (-1, 0, 1):
                for dc in (-1, 0, 1):
                    rr, cc = row + dr, col + dc
                    if 0 <= rr < mh and 0 <= cc < mw and labels[b, rr, cc] == 0:
                        labels[b, rr, cc] = -1.0
            labels[b, row, col] = 1.0
            cell_cx = (col + 0.5) * stride
            cell_cy = (row + 0.5) * stride
            deltas[b, row, col] = [
                (cx - cell_cx) / window,
                (cy - cell_cy) / window,
                np.log(max(w, 1.0) / window),
                np.log(max(h, 1.0) / window),
            ]
    mask = (labels == 1.0).astype(np.float32)
    return labels, deltas, mask


def embedding_batch(rng: np.random.Generator,
                    identities: Dict[int, FaceParams],
                    n_ident: int = 8, per_ident: int = 4,
                    chip_size: int = 150,
                    padding: float = 0.25) -> Tuple[np.ndarray, np.ndarray]:
    """Aligned face chips with identity labels for metric learning.

    Faces are rendered at (approximately) canonical chip alignment with
    small geometric jitter, varying background/lighting — the embedder must
    become invariant to everything except identity.
    """
    ids = rng.choice(list(identities), size=min(n_ident, len(identities)),
                     replace=False)
    chips = np.empty((len(ids) * per_ident, chip_size, chip_size, 3),
                     dtype=np.uint8)
    labels = np.empty((len(ids) * per_ident,), dtype=np.int32)
    face_h = chip_size / (1.0 + 2.0 * padding)
    i = 0
    for ident in ids:
        params = identities[int(ident)]
        for _ in range(per_ident):
            # resampling augmentation: pipeline chips are 2-tap-resampled
            # from frames where the face spans anywhere from ~0.5× (small
            # faces at 240p: the chip warp UPSCALES, blurring) to ~2× the
            # chip size (large faces: downscale smooths + aliases)
            # (`models/chip.py:extract_chips`) — a chip rendered directly
            # at 150 px has crisp edges the extracted chips never have,
            # and that train/serve gap showed up as cross-shot under-merge
            ss = float(rng.uniform(0.5, 2.2))
            cs = int(round(chip_size * ss))
            bg = _background(cs, cs, rng)
            # geometric jitter covers realistic landmark-alignment noise
            # (detector box offset + ERT residual) so downstream chips from
            # tracked boxes stay inside the invariance envelope
            cx = cs / 2 + rng.uniform(-12, 12) * ss
            cy = cs / 2 + rng.uniform(-12, 12) * ss
            h = face_h * ss * rng.uniform(0.8, 1.22)
            render_face(bg, cx, cy, h, params)
            if cs != chip_size:
                bg = bilinear_resize(bg, chip_size, chip_size)
            gain = rng.uniform(0.8, 1.2)
            bias = rng.uniform(-15, 15)
            noise = rng.normal(0, 3.0, size=bg.shape)
            chips[i] = np.clip(bg * gain + bias + noise, 0, 255).astype(np.uint8)
            labels[i] = int(ident)
            i += 1
    return chips, labels


def identity_bank(n: int = 64, seed: int = 1234) -> Dict[int, FaceParams]:
    rng = np.random.default_rng(seed)
    return {i: FaceParams.random(rng) for i in range(n)}


def batch_stream(make: Callable[[], object], depth: int = 4) -> Iterator:
    """Items of ``make()`` rendered in a background thread, so host-bound
    rendering overlaps the device step (the JAX trainers' producer
    threads).  A worker's exception is raised in the consumer; closing the
    generator stops the worker."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def worker():
        try:
            while not stop.is_set():
                item = make()
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.5)
                        break
                    except queue.Full:
                        pass
        except BaseException as exc:  # propagate instead of hanging q.get()
            q.put(exc)

    threading.Thread(target=worker, daemon=True).start()
    try:
        while True:
            item = q.get()
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
