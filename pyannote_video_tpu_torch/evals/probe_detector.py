"""Detector score calibration probe across the eval render domains.

Port of ``evals/probe_detector.py``.  For each domain (A = training
distribution, B/C/BC = held-out shifts, ``utils/synthetic_shift.py``) this
renders episodes, runs the raw pyramid detector (``FaceDetector.candidates``:
the stage-2 logits when the refine cascade is loaded) with a threshold of
0.5, far below the operating point, and reports the score distribution of
true faces vs false positives.  A face's score is its *best* overlapping
detection (the quantity the operating threshold gates on); detections
overlapping no face are false positives:

    <domain>: GT=<n> missed@0.5=<m> | real min/p5/p25 | fp n/max

Usage:  python -m pyannote_video_tpu_torch.evals.probe_detector [--weights=path.npz]
            [--domains=A,B,C,BC] [--refiner=path.npz] [--seeds=101,202,...]
            [--wide] [--json=out.jsonl] [--dump=N]

``PYV_NO_REFINE=1`` probes the raw stage-1 pyramid.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from ..models.detector import FaceDetector
from ..ops.boxes import nms
from ..utils.device import DeviceLike
from ..utils.synthetic import synthetic_episode
from .eval_synthetic import domain_hooks

SEEDS = (101, 202, 303)
WIDE_SEEDS = (101, 202, 303, 404, 505, 606, 707)


def probe(domain: str, weights: str | None = None, seeds=SEEDS,
          dump: int = 0, refiner: str | None = None,
          device: DeviceLike = None) -> dict:
    """One domain's row (the JAX probe's keys); ``device``: ``cuda``
    unless ``"cpu"`` is asked for."""
    det = FaceDetector(model_path=weights, refiner_path=refiner, device=device)
    real, fps_, miss, tot = [], [], 0, 0
    weak = []  # (score, seed, frame, face size) of the weakest real faces
    fp_top = []  # (score, seed, frame) of the strongest distractors
    for seed in seeds:
        ep = synthetic_episode(
            n_shots=6, shot_frames=10, width=640, height=480,
            n_identities=6, seed=seed, **domain_hooks(domain))
        idx = list(range(0, len(ep.frames), 3))
        frames = ep.frames[idx]
        scores_t, boxes_t = det.candidates(
            torch.from_numpy(frames).to(det.device, torch.float32))
        scores = scores_t.cpu().numpy()
        boxes = boxes_t.cpu().numpy()
        for k, i in enumerate(idx):
            gt = [f.box for f in ep.faces_at(i)]
            m = scores[k] > 0.5
            cb, cs = boxes[k][m], scores[k][m]
            keep = nms(cb, cs, iou_threshold=det.nms_iou) if len(cb) else []
            # per-face accounting: a face's score is its BEST detection, the
            # number the operating threshold gates on; a weak secondary
            # fragment NMS keeps on a detected face does not set the margin
            best = [0.0] * len(gt)
            for j in keep:
                b, s = cb[j], cs[j]
                bc = ((b[0] + b[2]) / 2, (b[1] + b[3]) / 2)
                hit = False
                for gi, g in enumerate(gt):
                    if g[0] <= bc[0] <= g[2] and g[1] <= bc[1] <= g[3]:
                        hit = True
                        best[gi] = max(best[gi], float(s))
                if not hit:
                    fps_.append(float(s))
                    fp_top.append((float(s), seed, i,
                                   tuple(round(float(v), 1) for v in b)))
            for gi, g in enumerate(gt):
                if best[gi] > 0.5:
                    real.append(best[gi])
                    weak.append((best[gi], seed, i,
                                 round(min(g[2] - g[0], g[3] - g[1]), 1)))
                else:
                    miss += 1
            tot += len(gt)
    r = np.asarray(real)
    f = np.asarray(sorted(fps_))
    out = {
        "domain": domain, "seeds": list(seeds), "gt": tot,
        "missed_at_0.5": miss,
        "real_min": round(float(r.min()), 2) if len(r) else None,
        "real_p5": round(float(np.percentile(r, 5)), 2) if len(r) else None,
        "real_p25": round(float(np.percentile(r, 25)), 2) if len(r) else None,
        "fp_n": int(len(f)),
        "fp_max": round(float(f[-1]), 2) if len(f) else 0.0,
    }
    if len(r):
        # worst real face (best-detection score) against worst distractor
        out["margin"] = round(float(r.min()) - out["fp_max"], 2)
    if dump:
        for s, seed, i, sz in sorted(weak)[:dump]:
            print(f"  weak face: score {s:6.2f}  seed {seed} frame {i:3d} "
                  f"min-side {sz}px", flush=True)
        for s, seed, i, box in sorted(fp_top, reverse=True)[:dump]:
            print(f"  top FP:    score {s:6.2f}  seed {seed} frame {i:3d} "
                  f"box {box}", flush=True)
    print(out, flush=True)
    return out


def main(argv=None, device: DeviceLike = None) -> list:
    """The JAX probe's flags; returns the rows and the summary."""
    argv = sys.argv[1:] if argv is None else list(argv)
    weights = None
    domains = ["A", "B", "C", "BC"]
    seeds = SEEDS
    json_out = None
    dump = 0
    refiner = None
    for a in argv:
        if a.startswith("--weights="):
            weights = a.split("=", 1)[1]
        elif a.startswith("--refiner="):
            refiner = a.split("=", 1)[1]
        elif a.startswith("--domains="):
            domains = a.split("=", 1)[1].split(",")
        elif a.startswith("--seeds="):
            seeds = tuple(int(s) for s in a.split("=", 1)[1].split(","))
        elif a == "--wide":
            seeds = WIDE_SEEDS
        elif a.startswith("--json="):
            json_out = a.split("=", 1)[1]
        elif a.startswith("--dump="):
            dump = int(a.split("=", 1)[1])
    rows = [probe(d, weights, seeds=seeds, dump=dump, refiner=refiner,
                  device=device) for d in domains]
    margins = [row["margin"] for row in rows if row.get("margin") is not None]
    summary = {"domain": "ALL",
               "min_margin": round(min(margins), 2) if margins else None}
    print(summary, flush=True)
    if json_out:
        with open(json_out, "w") as fp:
            for row in rows + [summary]:
                fp.write(json.dumps(row) + "\n")
    return rows + [summary]


if __name__ == "__main__":
    main()
