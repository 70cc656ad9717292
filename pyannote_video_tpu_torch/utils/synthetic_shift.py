"""Held-out evaluation render domains: copy of
``pyannote_video_tpu/utils/synthetic_shift.py``.

The packaged models are trained on the upright domain-A renderer
(``utils/synthetic.py``).  The domains here shift the render distribution
along axes the trainers never sample, for evaluation only:

* **Domain B, pose and geometry**: in-plane roll up to ±25°, mild
  out-of-plane pose (horizontal foreshortening and shear as a yaw proxy),
  partial occlusion bars, identity parameters drawn outside the training
  sampler's ranges.
* **Domain C, photometric and scene**: lighting gradients across the
  frame, per-shot horizontal motion blur, extra sensor noise, and static
  face-like decoys (featureless heads, clock-like discs, textured balls).

NumPy only; the code under this docstring is the JAX package's, line for
line (``tests/test_torch_hygiene.py:HOST_COPIES``), so a seed renders the
same episode in both packages.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Dict, List, Optional, Tuple

import numpy as np

from .synthetic import FaceParams, face_landmarks, render_face

# ---------------------------------------------------------------------------
# Warped (rolled / posed / occluded) face rendering
# ---------------------------------------------------------------------------


def _render_patch(face_h: float, params: FaceParams
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, float]:
    """Rasterize an upright face into a standalone patch.

    Returns (color [S,S,3], alpha [S,S], landmarks-in-patch [68,2], center).
    Pixels never touched by the rasterizer stay at alpha 0; for clean
    bilinear edges the untouched color is backfilled with the skin tone.
    """
    half_h = face_h / 2.0
    S = int(2 * half_h) + 8
    sentinel = -1000.0
    patch = np.full((S, S, 3), sentinel, dtype=np.float32)
    c = S / 2.0
    lm = render_face(patch, c, c, face_h, params)
    alpha = (patch[..., 0] > sentinel / 2).astype(np.float32)
    patch[alpha == 0] = params.skin
    return patch, alpha, lm, c


def _bilinear_sample(img: np.ndarray, ys: np.ndarray, xs: np.ndarray
                     ) -> np.ndarray:
    """Sample img (H, W[, C]) at float coords with edge clamping."""
    h, w = img.shape[:2]
    x0 = np.clip(np.floor(xs).astype(np.int64), 0, w - 1)
    y0 = np.clip(np.floor(ys).astype(np.int64), 0, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    y1 = np.minimum(y0 + 1, h - 1)
    fx = np.clip(xs - x0, 0.0, 1.0)
    fy = np.clip(ys - y0, 0.0, 1.0)
    if img.ndim == 3:
        fx = fx[..., None]
        fy = fy[..., None]
    top = img[y0, x0] * (1 - fx) + img[y0, x1] * fx
    bot = img[y1, x0] * (1 - fx) + img[y1, x1] * fx
    return top * (1 - fy) + bot * fy


def render_face_warped(canvas: np.ndarray, cx: float, cy: float,
                       face_h: float, params: FaceParams,
                       roll_deg: float = 0.0, yaw_scale: float = 1.0,
                       shear: float = 0.0,
                       occlusion: Optional[Tuple[str, float, float]] = None,
                       ) -> Tuple[np.ndarray, Tuple[float, float, float, float]]:
    """Composite an affinely warped parametric face onto `canvas` in place.

    The upright face is rasterized into an offscreen patch, then mapped
    through ``A = R(roll) @ [[yaw_scale, shear], [0, 1]]`` about its
    center and alpha-composited at (cx, cy).  Landmarks and the GT box
    (axis-aligned bound of the warped face ellipse) go through the same
    affine, so ground truth stays exact under the warp.

    occlusion: optional ``(side, frac, shade)`` — after compositing, a
    rectangle covering ``frac`` of the warped face bound on the given side
    ('bottom' | 'left' | 'right') is painted over (partial-occlusion test).

    Returns (landmarks [68, 2] image coords, box (l, t, r, b)).
    """
    patch, alpha, lm_patch, pc = _render_patch(face_h, params)
    th = np.deg2rad(roll_deg)
    rot = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]],
                   dtype=np.float64)
    pose = np.array([[yaw_scale, shear], [0.0, 1.0]], dtype=np.float64)
    A = rot @ pose
    A_inv = np.linalg.inv(A)

    # target extent: patch corners through A
    half = pc
    corners = np.array([[-half, -half], [half, -half],
                        [-half, half], [half, half]])
    warped = corners @ A.T
    ex = float(np.abs(warped[:, 0]).max())
    ey = float(np.abs(warped[:, 1]).max())

    h_img, w_img = canvas.shape[:2]
    x0 = max(0, int(np.floor(cx - ex)))
    x1 = min(w_img, int(np.ceil(cx + ex)) + 1)
    y0 = max(0, int(np.floor(cy - ey)))
    y1 = min(h_img, int(np.ceil(cy + ey)) + 1)

    lm_img = (lm_patch - pc) @ A.T + np.array([cx, cy])
    half_w = face_h / 2.0 / params.aspect
    half_h = face_h / 2.0
    # axis-aligned bound of the warped face ellipse (radii half_w, half_h)
    bx = float(np.hypot(A[0, 0] * half_w, A[0, 1] * half_h))
    by = float(np.hypot(A[1, 0] * half_w, A[1, 1] * half_h))
    box = (cx - bx, cy - by, cx + bx, cy + by)

    if x1 > x0 and y1 > y0:
        yy, xx = np.mgrid[y0:y1, x0:x1].astype(np.float64)
        rel = np.stack([xx - cx, yy - cy], axis=-1)
        src = rel @ A_inv.T + pc
        sx, sy = src[..., 0], src[..., 1]
        inside = (sx >= 0) & (sx <= patch.shape[1] - 1) \
            & (sy >= 0) & (sy <= patch.shape[0] - 1)
        col = _bilinear_sample(patch, sy, sx)
        a = _bilinear_sample(alpha, sy, sx) * inside
        region = canvas[y0:y1, x0:x1]
        region[...] = region * (1 - a[..., None]) + col * a[..., None]

    if occlusion is not None:
        side, frac, shade = occlusion
        l, t, r, b = box
        if side == "bottom":
            ol, ot, orr, ob = l, b - (b - t) * frac, r, b
        elif side == "left":
            ol, ot, orr, ob = l, t + (b - t) * 0.2, l + (r - l) * frac, b
        else:  # right
            ol, ot, orr, ob = r - (r - l) * frac, t + (b - t) * 0.2, r, b
        ol = max(0, int(ol)); ot = max(0, int(ot))
        orr = min(w_img, int(orr)); ob = min(h_img, int(ob))
        if orr > ol and ob > ot:
            canvas[ot:ob, ol:orr] = shade

    return lm_img.astype(np.float32), box


# ---------------------------------------------------------------------------
# Domain B — pose/geometry shift
# ---------------------------------------------------------------------------


def novel_identity_sampler(rng: np.random.Generator) -> FaceParams:
    """Identity parameters from ranges extending outside the training
    sampler's (`FaceParams.random`: skin [150..235, 110..205, 80..180],
    aspect [1.15, 1.45], eye_dx [0.32, 0.48], ...)."""
    return FaceParams(
        skin=tuple(rng.uniform([125, 95, 65], [248, 220, 195])),
        hair=tuple(rng.uniform([10, 5, 0], [150, 120, 90])),
        eye_dx=float(rng.uniform(0.29, 0.51)),
        eye_y=float(rng.uniform(-0.27, -0.10)),
        eye_r=float(rng.uniform(0.06, 0.145)),
        iris=tuple(rng.uniform([5, 5, 5], [95, 75, 140])),
        mouth_w=float(rng.uniform(0.17, 0.39)),
        mouth_y=float(rng.uniform(0.45, 0.65)),
        brow_y=float(rng.uniform(-0.55, -0.38)),
        aspect=float(rng.uniform(1.08, 1.55)),
        nose_len=float(rng.uniform(0.35, 0.65)),
    )


class PoseShiftRenderer:
    """render_fn for domain B: per-(shot, identity) roll/yaw/shear pose,
    smooth within a shot, plus optional partial occlusion."""

    def __init__(self, max_roll: float = 25.0, min_yaw: float = 0.80,
                 max_shear: float = 0.08, occlude_p: float = 0.3,
                 max_occlude_frac: float = 0.22, seed: int = 9101):
        self.max_roll = max_roll
        self.min_yaw = min_yaw
        self.max_shear = max_shear
        self.occlude_p = occlude_p
        self.max_occlude_frac = max_occlude_frac
        # own stream: hooks must not perturb the episode's rng, so the
        # shot/face layout stays identical to the unshifted episode
        self._rng = np.random.default_rng(seed)
        self._pose: Dict[Tuple[int, int], tuple] = {}

    def _pose_for(self, shot_idx: int, params: FaceParams) -> tuple:
        key = (shot_idx, id(params))
        if key not in self._pose:
            rng = self._rng
            roll = float(rng.uniform(-self.max_roll, self.max_roll))
            yaw = float(rng.uniform(self.min_yaw, 1.0))
            shear = float(rng.uniform(-self.max_shear, self.max_shear))
            occ = None
            if rng.random() < self.occlude_p:
                side = rng.choice(["bottom", "left", "right"])
                frac = float(rng.uniform(0.12, self.max_occlude_frac))
                shade = rng.uniform(20, 230, size=3)
                occ = (str(side), frac, shade)
            self._pose[key] = (roll, yaw, shear, occ)
        return self._pose[key]

    def __call__(self, canvas, cx, cy, face_h, params, rng,
                 shot_idx, frame_idx):
        roll, yaw, shear, occ = self._pose_for(shot_idx, params)
        # smooth within-shot roll drift (faces are not rigid statues)
        roll_t = roll + 2.5 * np.sin(2 * np.pi * frame_idx / 30.0)
        return render_face_warped(canvas, cx, cy, face_h, params,
                                  roll_deg=roll_t, yaw_scale=yaw,
                                  shear=shear, occlusion=occ)


# ---------------------------------------------------------------------------
# Domain C — photometric/scene shift
# ---------------------------------------------------------------------------


class PhotometricShift:
    """frame_post for domain C: per-shot lighting gradient + motion blur
    + extra sensor noise (on top of the episode's baseline noise)."""

    def __init__(self, blur_p: float = 0.5, max_blur: int = 9,
                 gain_lo: float = 0.55, gain_hi: float = 1.35,
                 extra_noise: float = 3.0, seed: int = 9102):
        self.blur_p = blur_p
        self.max_blur = max_blur
        self.gain_lo = gain_lo
        self.gain_hi = gain_hi
        self.extra_noise = extra_noise
        self._rng = np.random.default_rng(seed)  # own stream, see above
        self._shot_cfg: Dict[int, tuple] = {}

    def _cfg(self, shot_idx: int) -> tuple:
        if shot_idx not in self._shot_cfg:
            rng = self._rng
            g0 = float(rng.uniform(self.gain_lo, 1.0))
            g1 = float(rng.uniform(1.0, self.gain_hi))
            if rng.random() < 0.5:
                g0, g1 = g1, g0
            axis = int(rng.integers(0, 2))  # 0 = horizontal, 1 = vertical
            blur = 0
            if rng.random() < self.blur_p:
                blur = int(rng.choice([5, 7, self.max_blur]))
            self._shot_cfg[shot_idx] = (g0, g1, axis, blur)
        return self._shot_cfg[shot_idx]

    def __call__(self, frame, rng, shot_idx, frame_idx):
        import cv2

        g0, g1, axis, blur = self._cfg(shot_idx)
        h, w = frame.shape[:2]
        if axis == 0:
            ramp = np.linspace(g0, g1, w, dtype=np.float32)[None, :, None]
        else:
            ramp = np.linspace(g0, g1, h, dtype=np.float32)[:, None, None]
        out = frame * ramp
        if blur:
            out = cv2.blur(out, (blur, 1))
        if self.extra_noise:
            out = out + self._rng.normal(0, self.extra_noise, size=out.shape)
        return out


class DecoyDrawer:
    """decoy_fn for domain C: static face-LIKE scene objects per shot.

    Types: featureless skin-tone head (the trainers' negative class,
    rendered OUT of the detector's expectation), clock-like disc with
    dark marks, textured ball.  Positions are fixed per shot and re-drawn
    each frame (they pan with nothing — static props), rejected if they
    overlap any GT face box that frame.
    """

    def __init__(self, per_shot: int = 2, size_frac: float = 0.30,
                 seed: int = 9103):
        self.per_shot = per_shot
        self.size_frac = size_frac
        self._rng = np.random.default_rng(seed)  # own stream, see above
        self._props: Dict[int, List[tuple]] = {}

    def _props_for(self, shot_idx, h, w):
        if shot_idx not in self._props:
            rng = self._rng
            props = []
            for _ in range(self.per_shot):
                kind = int(rng.integers(0, 3))
                size = float(rng.uniform(0.5, 1.0) * self.size_frac * h)
                px = float(rng.uniform(size, w - size))
                py = float(rng.uniform(size / 2, h - size / 2))
                params = replace(FaceParams.random(rng),
                                 eye_r=0.0, mouth_w=0.0, nose_len=0.2)
                marks = rng.uniform(0, 2 * np.pi, size=3)
                color = rng.uniform(60, 240, size=3)
                props.append((kind, px, py, size, params, marks, color))
            self._props[shot_idx] = props
        return self._props[shot_idx]

    def __call__(self, canvas, rng, shot_idx, frame_idx, face_boxes):
        h, w = canvas.shape[:2]
        yy, xx = None, None
        for kind, px, py, size, params, marks, color in self._props_for(
                shot_idx, h, w):
            half = size / 2.0
            clear = all(px + half < l or px - half > r
                        or py + half < t or py - half > b
                        for (l, t, r, b) in face_boxes) or not face_boxes
            if not clear:
                continue
            if kind == 0:      # featureless head
                render_face(canvas, px, py, size, params)
            else:
                x0 = max(0, int(px - half - 1)); x1 = min(w, int(px + half + 2))
                y0 = max(0, int(py - half - 1)); y1 = min(h, int(py + half + 2))
                if x1 <= x0 or y1 <= y0:
                    continue
                gy, gx = np.mgrid[y0:y1, x0:x1].astype(np.float32)
                disc = ((gx - px) / half) ** 2 + ((gy - py) / half) ** 2 <= 1.0
                region = canvas[y0:y1, x0:x1]
                if kind == 1:  # clock-like disc with dark marks
                    region[disc] = (235.0, 235.0, 225.0)
                    for a in marks:
                        mx = px + 0.55 * half * np.cos(a)
                        my = py + 0.55 * half * np.sin(a)
                        mark = ((gx - mx) ** 2 + (gy - my) ** 2) \
                            <= (0.12 * half) ** 2
                        region[mark] = (30.0, 30.0, 35.0)
                else:          # shaded textured ball
                    shade = np.clip(
                        1.0 - 0.6 * ((gx - px) ** 2 + (gy - py) ** 2)
                        / (half ** 2), 0.3, 1.0)
                    region[disc] = 0.0
                    region += disc[..., None] * color * shade[..., None]


# ---------------------------------------------------------------------------
# Domain registry
# ---------------------------------------------------------------------------


def domain_hooks(domain: str, **overrides) -> dict:
    """Episode hook-set for a named eval domain.

    'A' → {} (the training distribution — the upright default renderer);
    'B' → pose/geometry shift; 'C' → photometric/scene shift;
    'BC' → both shifts at once (hardest).
    """
    domain = domain.upper()
    if domain == "A":
        return {}
    hooks: dict = {}
    if "B" in domain:
        hooks["render_fn"] = PoseShiftRenderer(
            max_roll=overrides.get("max_roll", 25.0),
            occlude_p=overrides.get("occlude_p", 0.3))
        hooks["identity_sampler"] = novel_identity_sampler
    if "C" in domain:
        hooks["frame_post"] = PhotometricShift()
        hooks["decoy_fn"] = DecoyDrawer()
    if not hooks:
        raise ValueError(f"unknown eval domain: {domain!r}")
    return hooks
