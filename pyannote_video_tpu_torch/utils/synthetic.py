"""Synthetic video fixtures: procedural episodes with known ground truth.

The reference ships no tests and relies on a large sample episode
(`doc/getting_started.ipynb`, see SURVEY §4).  This environment has no media
files and no dlib models, so every test and trainer in this framework runs on
*procedurally generated* videos: per-shot textured backgrounds with smooth
camera pan (low displaced-frame-difference within a shot, high at cuts) and
rendered parametric faces with known boxes, identities and 68-point
landmarks.

The same face rasterizer feeds the detector / landmark / embedder trainers
(`train/data.py`), so models learned here are consistent with the fixtures
the pipeline tests run on.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# Canonical 68-point landmark template (iBUG-68 layout, normalized face frame)
# ---------------------------------------------------------------------------
# Coordinates in a unit face frame: x in [-1, 1] (left->right),
# y in [-1, 1] (top->bottom). Indices follow the dlib/iBUG convention:
# 0-16 jaw, 17-21 right brow (image-left), 22-26 left brow, 27-30 nose
# bridge, 31-35 nostrils, 36-41 image-left eye, 42-47 image-right eye,
# 48-59 outer mouth, 60-67 inner mouth.


def _build_canonical_landmarks() -> np.ndarray:
    pts: List[Tuple[float, float]] = []
    # jaw: 17 points along lower face ellipse, from image-left to image-right
    for i in range(17):
        a = np.pi * (1.0 - i / 16.0)  # pi -> 0
        pts.append((0.95 * np.cos(a + np.pi), 0.15 + 0.85 * np.sin(a)))
    # brows: 5 points each
    for i in range(5):
        pts.append((-0.65 + 0.5 * i / 4.0, -0.45 - 0.08 * np.sin(np.pi * i / 4)))
    for i in range(5):
        pts.append((0.15 + 0.5 * i / 4.0, -0.45 - 0.08 * np.sin(np.pi * i / 4)))
    # nose bridge: 4 points
    for i in range(4):
        pts.append((0.0, -0.35 + 0.55 * i / 3.0))
    # nostrils: 5 points
    for i in range(5):
        pts.append((-0.16 + 0.32 * i / 4.0, 0.28))
    # eyes: 6 points each (hexagon)
    for cx in (-0.4, 0.4):
        for i in range(6):
            a = np.pi / 3.0 * i + np.pi  # start at outer corner
            pts.append((cx + 0.16 * np.cos(a), -0.18 + 0.08 * np.sin(a)))
    # outer mouth: 12 points (ellipse)
    for i in range(12):
        a = 2 * np.pi * i / 12.0 + np.pi
        pts.append((0.28 * np.cos(a), 0.55 + 0.12 * np.sin(a)))
    # inner mouth: 8 points
    for i in range(8):
        a = 2 * np.pi * i / 8.0 + np.pi
        pts.append((0.18 * np.cos(a), 0.55 + 0.05 * np.sin(a)))
    return np.asarray(pts, dtype=np.float32)


CANONICAL_LANDMARKS = _build_canonical_landmarks()
assert CANONICAL_LANDMARKS.shape == (68, 2)


@dataclass
class FaceParams:
    """Identity-defining appearance parameters for the parametric face."""

    skin: Tuple[float, float, float] = (205.0, 170.0, 140.0)
    hair: Tuple[float, float, float] = (60.0, 40.0, 25.0)
    eye_dx: float = 0.40         # half eye distance (face units)
    eye_y: float = -0.18
    eye_r: float = 0.10
    iris: Tuple[float, float, float] = (40.0, 30.0, 25.0)
    mouth_w: float = 0.28
    mouth_y: float = 0.55
    brow_y: float = -0.45
    aspect: float = 1.3          # height / width of the face ellipse
    nose_len: float = 0.5

    @classmethod
    def random(cls, rng: np.random.Generator) -> "FaceParams":
        return cls(
            skin=tuple(rng.uniform([150, 110, 80], [235, 205, 180])),
            hair=tuple(rng.uniform([20, 10, 5], [120, 90, 60])),
            eye_dx=float(rng.uniform(0.32, 0.48)),
            eye_y=float(rng.uniform(-0.24, -0.12)),
            eye_r=float(rng.uniform(0.07, 0.13)),
            iris=tuple(rng.uniform([10, 10, 10], [80, 60, 120])),
            mouth_w=float(rng.uniform(0.20, 0.36)),
            mouth_y=float(rng.uniform(0.48, 0.62)),
            brow_y=float(rng.uniform(-0.52, -0.40)),
            aspect=float(rng.uniform(1.15, 1.45)),
            nose_len=float(rng.uniform(0.4, 0.6)),
        )


def face_landmarks(cx: float, cy: float, height: float,
                   params: FaceParams) -> np.ndarray:
    """68 landmark positions in image coords for a face at (cx, cy)."""
    half_h = height / 2.0
    half_w = half_h / params.aspect
    lm = CANONICAL_LANDMARKS.copy()
    # modulate template by identity parameters
    lm = lm.copy()
    eyes = slice(36, 48)
    lm[36:42, 0] = (lm[36:42, 0] + 0.4) / 0.4 * params.eye_dx - params.eye_dx
    lm[42:48, 0] = (lm[42:48, 0] - 0.4) / 0.4 * params.eye_dx + params.eye_dx
    lm[eyes, 1] += params.eye_y - (-0.18)
    lm[48:68, 0] *= params.mouth_w / 0.28
    lm[48:68, 1] += params.mouth_y - 0.55
    lm[17:27, 1] += params.brow_y - (-0.45)
    out = np.empty_like(lm)
    out[:, 0] = cx + lm[:, 0] * half_w
    out[:, 1] = cy + lm[:, 1] * half_h
    return out


def _fill_ellipse(img: np.ndarray, cx: float, cy: float, rx: float, ry: float,
                  color, yy: np.ndarray, xx: np.ndarray) -> None:
    if rx <= 0 or ry <= 0:
        return
    mask = ((xx - cx) / rx) ** 2 + ((yy - cy) / ry) ** 2 <= 1.0
    img[mask] = color


def render_face(img: np.ndarray, cx: float, cy: float, height: float,
                params: FaceParams) -> np.ndarray:
    """Rasterize a parametric face into `img` (H, W, 3) float32, in place.

    Returns the 68 landmarks in image coordinates.
    """
    h_img, w_img = img.shape[:2]
    half_h = height / 2.0
    half_w = half_h / params.aspect

    y0 = max(0, int(cy - half_h - 2))
    y1 = min(h_img, int(cy + half_h + 3))
    x0 = max(0, int(cx - half_w - 2))
    x1 = min(w_img, int(cx + half_w + 3))
    if y1 <= y0 or x1 <= x0:
        return face_landmarks(cx, cy, height, params)

    region = img[y0:y1, x0:x1]
    yy, xx = np.mgrid[y0:y1, x0:x1].astype(np.float32)

    # head: skin ellipse + hair cap
    _fill_ellipse(region, cx, cy, half_w, half_h, params.skin, yy, xx)
    hair_mask = (
        (((xx - cx) / half_w) ** 2 + ((yy - cy) / half_h) ** 2 <= 1.0)
        & (yy < cy - 0.55 * half_h)
    )
    region[hair_mask] = params.hair

    # eyes: white + iris
    for side in (-1.0, 1.0):
        ex = cx + side * params.eye_dx * half_w
        ey = cy + params.eye_y * half_h
        _fill_ellipse(region, ex, ey, 0.16 * half_w * (params.eye_r / 0.10),
                      0.08 * half_h, (245.0, 245.0, 245.0), yy, xx)
        _fill_ellipse(region, ex, ey, params.eye_r * half_w * 0.6,
                      params.eye_r * half_h * 0.6, params.iris, yy, xx)
        # brow
        bx0 = ex - 0.22 * half_w
        bx1 = ex + 0.22 * half_w
        by = cy + params.brow_y * half_h
        brow_mask = (xx >= bx0) & (xx <= bx1) & (np.abs(yy - by) <= 0.035 * half_h + 1)
        region[brow_mask] = params.hair

    # nose: thin vertical wedge
    nose_mask = (
        (np.abs(xx - cx) <= 0.05 * half_w + 0.5)
        & (yy >= cy - 0.35 * half_h)
        & (yy <= cy + (params.nose_len - 0.2) * half_h)
    )
    region[nose_mask] = tuple(c * 0.85 for c in params.skin)

    # mouth
    _fill_ellipse(region, cx, cy + params.mouth_y * half_h,
                  params.mouth_w * half_w, 0.12 * half_h,
                  (150.0, 60.0, 60.0), yy, xx)

    return face_landmarks(cx, cy, height, params)


# ---------------------------------------------------------------------------
# Episodes
# ---------------------------------------------------------------------------


@dataclass
class FaceObservation:
    """Ground-truth face instance in one frame."""

    frame: int
    face_id: int
    box: Tuple[float, float, float, float]  # (left, top, right, bottom) px
    landmarks: np.ndarray  # (68, 2) px


@dataclass
class SyntheticEpisode:
    frames: np.ndarray                  # [T, H, W, 3] uint8
    fps: float
    cuts: List[float]                   # cut timestamps (seconds)
    shots: List[Tuple[float, float]]    # (start, end) per shot
    faces: List[FaceObservation] = field(default_factory=list)
    identities: Dict[int, FaceParams] = field(default_factory=dict)

    def faces_at(self, frame: int) -> List[FaceObservation]:
        return [f for f in self.faces if f.frame == frame]


def _background(width: int, height: int, rng: np.random.Generator) -> np.ndarray:
    """A distinct, textured background for one shot (oversized for panning)."""
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    freq_x = rng.uniform(0.02, 0.1, size=3)
    freq_y = rng.uniform(0.02, 0.1, size=3)
    phase = rng.uniform(0, 2 * np.pi, size=3)
    base = rng.uniform(40, 200, size=3)
    amp = rng.uniform(20, 55, size=3)
    img = np.stack(
        [
            base[c] + amp[c] * np.sin(freq_x[c] * xx + freq_y[c] * yy + phase[c])
            for c in range(3)
        ],
        axis=-1,
    )
    # add some blocky texture for ORB keypoints to latch onto
    blocks = rng.uniform(-25, 25, size=(height // 8 + 1, width // 8 + 1, 3))
    img += np.kron(blocks, np.ones((8, 8, 1)))[:height, :width]
    # high-contrast rectangles: sharp corners that survive resizing, so
    # FAST/ORB (shot threading) has features to latch onto
    n_rects = max(12, (height * width) // 1200)
    for _ in range(n_rects):
        rw = int(rng.integers(6, max(8, width // 6)))
        rh = int(rng.integers(6, max(8, height // 6)))
        x0 = int(rng.integers(0, max(1, width - rw)))
        y0 = int(rng.integers(0, max(1, height - rh)))
        color = rng.uniform(0, 255, size=3)
        img[y0 : y0 + rh, x0 : x0 + rw] = (
            0.25 * img[y0 : y0 + rh, x0 : x0 + rw] + 0.75 * color
        )
    return np.clip(img, 0, 255).astype(np.float32)


def synthetic_episode(
    n_shots: int = 4,
    shot_frames: int = 30,
    fps: float = 25.0,
    width: int = 160,
    height: int = 120,
    n_identities: int = 2,
    faces_per_shot: int = 1,
    face_height_ratio: float = 0.45,
    seed: int = 0,
    thread_pattern: Optional[List[int]] = None,
    render_fn=None,
    frame_post=None,
    decoy_fn=None,
    identity_sampler=None,
) -> SyntheticEpisode:
    """Generate an episode with known cuts, faces and (optional) threading.

    Parameters
    ----------
    thread_pattern : list of int, optional
        Background-id per shot, e.g. ``[0, 1, 0, 1]`` creates an A/B
        alternating-camera pattern so shot threading has ground truth.
        Defaults to a distinct background per shot.
    render_fn : callable, optional
        ``(canvas, cx, cy, face_h, params, rng, shot_idx, frame_idx) ->
        (landmarks [68, 2], box (l, t, r, b))`` — face rasterizer hook.
        Defaults to the upright `render_face`.  The shifted eval domains
        (`utils/synthetic_shift.py`, VERDICT r2 missing #1) plug in
        rolled / posed / occluded variants here; the TRAINERS never call
        through this hook with a non-default value.
    frame_post : callable, optional
        ``(frame float32 [H, W, 3], rng, shot_idx, frame_idx) -> frame``
        applied before quantization (lighting gradients, motion blur).
    decoy_fn : callable, optional
        ``(canvas, rng, shot_idx, frame_idx, face_boxes) -> None`` — draws
        face-LIKE distractors that are NOT ground truth (detector precision
        test); ``face_boxes`` are this frame's GT boxes so decoys can stay
        clear of real faces.
    identity_sampler : callable, optional
        ``(rng) -> FaceParams`` — identity distribution override (novel
        geometry/texture families for held-out eval domains).
    """
    rng = np.random.default_rng(seed)
    if render_fn is None:
        def render_fn(canvas, cx, cy, face_h, params, _rng, _si, _fi):
            lm = render_face(canvas, cx, cy, face_h, params)
            half_w = face_h / 2.0 / params.aspect
            return lm, (cx - half_w, cy - face_h / 2.0,
                        cx + half_w, cy + face_h / 2.0)
    if identity_sampler is None:
        identity_sampler = FaceParams.random
    if thread_pattern is None:
        thread_pattern = list(range(n_shots))
    assert len(thread_pattern) == n_shots

    pad = 16  # oversize for panning
    backgrounds: Dict[int, np.ndarray] = {}
    for bg_id in set(thread_pattern):
        backgrounds[bg_id] = _background(width + 2 * pad, height + 2 * pad, rng)

    identities = {i: identity_sampler(rng) for i in range(n_identities)}

    total = n_shots * shot_frames
    frames = np.empty((total, height, width, 3), dtype=np.uint8)
    faces: List[FaceObservation] = []
    cuts: List[float] = []
    shots: List[Tuple[float, float]] = []

    t_frame = 0
    for shot_idx in range(n_shots):
        bg = backgrounds[thread_pattern[shot_idx]]
        pan = rng.uniform(-0.4, 0.4, size=2)  # px / frame
        pan_origin = rng.uniform(pad * 0.3, pad * 0.7, size=2)

        # face cast for this shot: assign identities round-robin
        cast = [(shot_idx * faces_per_shot + k) % n_identities
                for k in range(faces_per_shot)]
        face_h = face_height_ratio * height
        face_tracks = []
        for k, ident in enumerate(cast):
            cx0 = width * (0.25 + 0.5 * k / max(1, faces_per_shot - 1)
                           if faces_per_shot > 1 else 0.5) + rng.uniform(-8, 8)
            cy0 = height * 0.5 + rng.uniform(-6, 6)
            vx = rng.uniform(-0.6, 0.6)
            vy = rng.uniform(-0.3, 0.3)
            face_tracks.append((ident, cx0, cy0, vx, vy))

        for f in range(shot_frames):
            ox = int(round(pan_origin[0] + pan[0] * f))
            oy = int(round(pan_origin[1] + pan[1] * f))
            ox = np.clip(ox, 0, 2 * pad - 1)
            oy = np.clip(oy, 0, 2 * pad - 1)
            canvas = bg[oy : oy + height, ox : ox + width].copy()

            frame_boxes = []
            for ident, cx0, cy0, vx, vy in face_tracks:
                cx = cx0 + vx * f
                cy = cy0 + vy * f + 2.0 * np.sin(2 * np.pi * f / shot_frames)
                params = identities[ident]
                lm, box = render_fn(canvas, cx, cy, face_h, params,
                                    rng, shot_idx, f)
                faces.append(
                    FaceObservation(
                        frame=t_frame, face_id=ident, box=box, landmarks=lm,
                    )
                )
                frame_boxes.append(box)

            if decoy_fn is not None:
                decoy_fn(canvas, rng, shot_idx, f, frame_boxes)
            if frame_post is not None:
                canvas = frame_post(canvas, rng, shot_idx, f)

            # mild sensor noise so frames are never bit-identical
            noise = rng.normal(0, 2.0, size=canvas.shape)
            frames[t_frame] = np.clip(canvas + noise, 0, 255).astype(np.uint8)
            t_frame += 1

        shot_start = shot_idx * shot_frames / fps
        shot_end = (shot_idx + 1) * shot_frames / fps
        shots.append((shot_start, shot_end))
        if shot_idx > 0:
            cuts.append(shot_start)

    return SyntheticEpisode(
        frames=frames, fps=fps, cuts=cuts, shots=shots,
        faces=faces, identities=identities,
    )


def write_synthetic_video(path: str, episode: SyntheticEpisode) -> None:
    """Encode an episode to a video file (MJPG avi — works without ffmpeg).

    Imports cv2 here only: the rest of the module is numpy alone.
    """
    import cv2

    h, w = episode.frames.shape[1:3]
    writer = cv2.VideoWriter(
        path, cv2.VideoWriter_fourcc(*"MJPG"), episode.fps, (w, h)
    )
    if not writer.isOpened():
        raise IOError(f"could not open video writer for {path}")
    for frame in episode.frames:
        writer.write(frame[:, :, ::-1])  # RGB -> BGR
    writer.release()
