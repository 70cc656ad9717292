"""End-to-end quality evaluation on synthetic episodes with ground truth.

Port of ``evals/eval_synthetic.py``: runs the whole pipeline of the port
(shots → threads/scenes → tracking → landmarks/embeddings → clustering) on
a procedurally generated episode and reports

* shot-boundary F1;
* thread pairwise-F1 and scene pairwise-F1 against the episode's camera
  pattern;
* per-frame track F1, precision, recall;
* landmark mean error (inter-ocular-normalised, vs rendered GT points);
* cluster purity and pairwise recall and precision;

with the same keys, rounded the same way, as the JAX harness, plus the
``device`` it ran on and the wall seconds of each stage (``stage_s``).

Scale: 12 shots × 480p with 6 recurring identities (each appears in two
different shots, so same-identity cross-shot merging is exercised).

Usage:  python -m pyannote_video_tpu_torch.evals.eval_synthetic [seed] [--faces=N] [--domain=A|B|C|BC]

Domains B/C/BC are the held-out shifted render distributions
(``utils/synthetic_shift.py``).  Domain C's motion blur is computed here
without OpenCV (``box_blur_rows``), so the harness runs where OpenCV is
not installed.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from ..core import Segment, formats
from ..io.video import Video
from ..models.chip import extract_chips
from ..models.embedder import FaceEmbedder
from ..models.landmarks import LandmarkPredictor
from ..pipeline.clustering import FaceClustering
from ..pipeline.face_tracking import FaceTracking
from ..pipeline.shot import Shot
from ..pipeline.thread import Thread, scenes_from_threads
from ..utils import synthetic_shift
from ..utils.device import DeviceLike, resolve_device
from ..utils.metrics import (boundary_f1, cluster_purity, iou_xyxy,
                             pairwise_prf, track_frame_f1)
from ..utils.synthetic import synthetic_episode

# camera pattern: three A/B-alternating pairs → thread GT = pattern id,
# scene GT = [0]*4 + [1]*4 + [2]*4 (intertwined pairs merge into scenes)
THREAD_PATTERN = [0, 1, 0, 1, 2, 3, 2, 3, 4, 5, 4, 5]
SCENE_TRUTH = [0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2]


def box_blur_rows(image: np.ndarray, k: int) -> np.ndarray:
    """``cv2.blur(image, (k, 1))`` of a float32 image: the mean of ``k``
    neighbours along each row, borders by REFLECT_101; summed in float64
    and scaled by ``1/k`` before the cast, as OpenCV's box filter does."""
    pad = k // 2
    padded = np.pad(image, [(0, 0), (pad, k - 1 - pad)] + [(0, 0)] * (image.ndim - 2),
                    mode="reflect").astype(np.float64)
    width = image.shape[1]
    total = padded[:, :width].copy()
    for i in range(1, k):
        total += padded[:, i:i + width]
    return (total * (1.0 / k)).astype(np.float32)


class PhotometricShift(synthetic_shift.PhotometricShift):
    """Domain C's frame post-processing, the same draws and arithmetic,
    with ``box_blur_rows`` for OpenCV's blur."""

    def __call__(self, frame, rng, shot_idx, frame_idx):
        g0, g1, axis, blur = self._cfg(shot_idx)
        h, w = frame.shape[:2]
        if axis == 0:
            ramp = np.linspace(g0, g1, w, dtype=np.float32)[None, :, None]
        else:
            ramp = np.linspace(g0, g1, h, dtype=np.float32)[:, None, None]
        out = frame * ramp
        if blur:
            out = box_blur_rows(out, blur)
        if self.extra_noise:
            out = out + self._rng.normal(0, self.extra_noise, size=out.shape)
        return out


def domain_hooks(domain: str) -> dict:
    """``utils/synthetic_shift.py:domain_hooks`` with the OpenCV-free
    ``PhotometricShift``."""
    hooks = synthetic_shift.domain_hooks(domain)
    if "frame_post" in hooks:
        hooks["frame_post"] = PhotometricShift()
    return hooks


def _segment_label_map(annotation, shots):
    """Annotation → {shot_index: label} by segment identity."""
    seg_label = {}
    for segment, _, label in annotation.itertracks(yield_label=True):
        seg_label[(round(segment.start, 6), round(segment.end, 6))] = label
    out = {}
    for i, s in enumerate(shots):
        out[i] = seg_label.get((round(s.start, 6), round(s.end, 6)))
    return out


def evaluate(seed: int = 101, n_shots: int = 12, shot_frames: int = 20,
             width: int = 640, height: int = 480,
             n_identities: int = 6, faces_per_shot: int = 1,
             domain: str = "A", device: DeviceLike = None) -> dict:
    """Full-pipeline eval; `domain` selects the render distribution
    ('A' = training distribution; 'B'/'C'/'BC' = held-out shifted domains
    that no trainer ever samples).  ``device``: ``cuda`` unless ``"cpu"``
    is asked for."""
    device = resolve_device(device)
    ep = synthetic_episode(
        n_shots=n_shots, shot_frames=shot_frames, width=width, height=height,
        seed=seed, face_height_ratio=0.35 if faces_per_shot > 1 else 0.4,
        n_identities=n_identities, faces_per_shot=faces_per_shot,
        thread_pattern=THREAD_PATTERN[:n_shots],
        **domain_hooks(domain),
    )
    video = Video(ep.frames, fps=ep.fps)
    stage_s = {}
    t_start = t_stage = time.time()

    def lap(name):
        nonlocal t_stage
        now = time.time()
        stage_s[name] = round(now - t_stage, 3)
        t_stage = now

    # --- shots -----------------------------------------------------------
    shots = list(Shot(video, threshold=2.0, device=device))
    bf1 = boundary_f1([s.end for s in shots[:-1]], ep.cuts,
                      tolerance=1.5 / ep.fps)
    lap("shots")

    # --- threads & scenes (camera-pattern ground truth) --------------------
    gt_shots = [Segment(s, e) for s, e in ep.shots]
    threads = Thread(video, shot=gt_shots, lookahead=5, device=device)()
    thread_map = _segment_label_map(threads, gt_shots)
    thread_truth = {i: THREAD_PATTERN[i] for i in range(n_shots)}
    thread_prf = pairwise_prf(thread_map, thread_truth)

    scenes = scenes_from_threads(threads)
    # map scenes back onto shots by containment
    shot_scene = {}
    for i, s in enumerate(gt_shots):
        mid = (s.start + s.end) / 2
        for segment, _, label in scenes.itertracks(yield_label=True):
            if segment.start <= mid <= segment.end:
                shot_scene[i] = label
                break
    scene_truth = {i: SCENE_TRUTH[i] for i in range(n_shots)}
    scene_prf = pairwise_prf(shot_scene, scene_truth)
    lap("threads")

    # --- landmarks (inter-ocular-normalised mean error) --------------------
    predictor = LandmarkPredictor(device=device)
    lm_errors = []
    for shot_idx in range(n_shots):
        f = shot_idx * shot_frames + shot_frames // 2
        obs = ep.faces_at(f)[0]
        pred = predictor.predict_batch(
            ep.frames[f][None], np.zeros(1, dtype=np.int32),
            np.asarray([obs.box], dtype=np.float32))[0]
        gt = obs.landmarks
        eye_dist = np.linalg.norm(gt[36:42].mean(0) - gt[42:48].mean(0))
        lm_errors.append(
            float(np.linalg.norm(pred - gt, axis=1).mean() / eye_dist))
    landmark_err = float(np.mean(lm_errors))
    lap("landmarks")

    # --- tracking --------------------------------------------------------
    tracking = FaceTracking(detect_every=0.2, track_max_gap=1.0, device=device)
    tracks = list(tracking(video, shots))

    predicted = {}
    for tid, trk in enumerate(tracks):
        for t, (l, tp_, r, b), status in trk:
            predicted.setdefault(round(t, 5), []).append(
                (l * width, tp_ * height, r * width, b * height)
            )
    truth = {}
    for f in range(len(ep.frames)):
        t = round(f / ep.fps, 5)
        truth[t] = [o.box for o in ep.faces_at(f)]
    tf1 = track_frame_f1(predicted, truth)
    lap("tracking")

    # --- embeddings per track (landmark-aligned) ---------------------------
    embedder = FaceEmbedder(device=device)
    rows = []
    for tid, trk in enumerate(tracks):
        for t, (l, tp_, r, b), status in trk:
            rows.append(formats.TrackPoint(t, tid, l, tp_, r, b, status))
    emb_by_track = {}
    for t, group in formats.iter_tracking_by_time(rows):
        f = int(round(t * ep.fps))
        if f >= len(ep.frames):
            continue
        boxes = np.asarray(
            [[p.left * width, p.top * height, p.right * width,
              p.bottom * height] for p in group], dtype=np.float32)
        lms = predictor.predict_batch(
            ep.frames[f][None], np.zeros(len(group), dtype=np.int32), boxes)
        chips = extract_chips(
            torch.from_numpy(ep.frames[f][None]).to(device),
            torch.zeros((len(group),), dtype=torch.long, device=device),
            torch.from_numpy(lms).to(device))
        embs = embedder(chips)
        for p, e in zip(group, embs):
            emb_by_track.setdefault(p.identifier, []).append((t, e))
    lap("embeddings")

    # --- clustering --------------------------------------------------------
    fd, path = tempfile.mkstemp(suffix=".embedding.txt")
    try:
        with os.fdopen(fd, "w") as fp:
            for tid, entries in emb_by_track.items():
                for t, e in entries:
                    formats.write_embedding_line(fp, t, tid, e)
        clustering = FaceClustering(threshold=0.6, device=device)
        sp, feats = clustering.model.preprocess(path)
        result = clustering(sp, features=feats)
    finally:
        os.remove(path)
    assignment = {int(trk): lab
                  for _, trk, lab in result.itertracks(yield_label=True)}

    # ground-truth identity per track: majority of overlapping GT boxes
    truth_ident = {}
    for tid, trk in enumerate(tracks):
        votes = {}
        for t, (l, tp_, r, b), status in trk:
            f = int(round(t * ep.fps))
            if f >= len(ep.frames):
                continue
            box = (l * width, tp_ * height, r * width, b * height)
            for o in ep.faces_at(f):
                if iou_xyxy(box, o.box) > 0.3:
                    votes[o.face_id] = votes.get(o.face_id, 0) + 1
        truth_ident[tid] = max(votes, key=votes.get) if votes else -1
    purity = cluster_purity(assignment, truth_ident)
    cluster_prf = pairwise_prf(assignment, truth_ident)
    lap("clustering")

    wall = time.time() - t_start
    return {
        "seed": seed,
        "domain": domain,
        "config": f"{n_shots} shots x {shot_frames} frames @ "
                  f"{width}x{height}, {n_identities} identities, "
                  f"{faces_per_shot} face(s)/shot",
        "boundary_f1": round(bf1["f1"], 3),
        "thread_f1": round(thread_prf["f1"], 3),
        "scene_f1": round(scene_prf["f1"], 3),
        "landmark_err_interocular": round(landmark_err, 4),
        "track_f1": round(tf1["f1"], 3),
        "track_precision": round(tf1["precision"], 3),
        "track_recall": round(tf1["recall"], 3),
        "cluster_purity": round(purity, 3),
        "cluster_recall": round(cluster_prf["recall"], 3),
        "cluster_precision": round(cluster_prf["precision"], 3),
        "n_tracks": len(tracks),
        "n_clusters": len(set(assignment.values())),
        "wall_s": round(wall, 1),
        "stage_s": stage_s,
        "device": (torch.cuda.get_device_name(device) if device.type == "cuda"
                   else "cpu"),
    }


def main(argv=None, device: DeviceLike = None) -> dict:
    """``eval_synthetic [seed] [--faces=N] [--domain=A|B|C|BC]``: prints
    the row as one JSON line and returns it."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args = [a for a in argv if not a.startswith("--")]
    faces = 1
    domain = "A"
    for a in argv:
        if a.startswith("--faces="):
            faces = int(a.split("=", 1)[1])
        if a.startswith("--domain="):
            domain = a.split("=", 1)[1]
    seed = int(args[0]) if args else 101
    row = evaluate(seed=seed, faces_per_shot=faces, domain=domain, device=device)
    print(json.dumps(row), flush=True)
    return row


if __name__ == "__main__":
    main()
