"""Where the port's tracks part from the JAX package's on an eval episode.

For each shot of ``evaluate``'s default episode (12 shots x 20 frames @
640x480) this runs both packages' detectors on the shot's detection frames
and both packages' trackers (``FaceTracking(detect_every=0.2)``, the
port's on the CPU) on each package's detections, and prints, for a shot
where the pairs' tracks differ in their frames or by more than
``BOX_TOL`` pixels in a box: the two packages' detection boxes, the frames of
each track for every (tracker, detections) pair and the largest
difference of its boxes from the JAX tracker's on JAX's detections
(``inf`` where the frames differ); with ``--psr`` also the
peak-to-sidelobe ratio of every tracker slot at every frame of each pass
(``/0`` dead, ``/1`` tracked, ``/2`` a detection point; the kill threshold
is 10).  It imports both packages, as the tests do, and runs on the CPU:

    JAX_PLATFORMS=cpu python evals/track_divergence.py A 101 [--psr] [--shots=5,6]
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

SHOT_FRAMES = 20
N_SHOTS = 12
BOX_TOL = 2.0


def _box_diff(a, b) -> float:
    """The largest coordinate difference of two shots' tracks, frame for
    frame (inf when their frames differ)."""
    if [[f for f, _ in t] for t in a] != [[f for f, _ in t] for t in b]:
        return float("inf")
    return max((float(np.abs(np.subtract(p, q)).max())
                for ta, tb in zip(a, b) for (_, p), (_, q) in zip(ta, tb)),
               default=0.0)


def _episode(domain: str, seed: int):
    from pyannote_video_tpu_torch.evals.eval_synthetic import (
        THREAD_PATTERN, domain_hooks)
    from pyannote_video_tpu_torch.utils.synthetic import synthetic_episode

    return synthetic_episode(
        n_shots=N_SHOTS, shot_frames=SHOT_FRAMES, width=640, height=480,
        seed=seed, face_height_ratio=0.4, n_identities=6, faces_per_shot=1,
        thread_pattern=THREAD_PATTERN[:N_SHOTS], **domain_hooks(domain))


def main(argv) -> int:
    import jax.numpy as jnp
    import torch

    from pyannote_video_tpu.ops import dsst as jdsst
    from pyannote_video_tpu.ops.color import to_gray as jgray
    from pyannote_video_tpu.pipeline.face_tracking import FaceTracking as JFT
    from pyannote_video_tpu_torch.ops import dsst as tdsst
    from pyannote_video_tpu_torch.ops.color import to_gray as tgray
    from pyannote_video_tpu_torch.pipeline.face_tracking import (
        FaceTracking as TFT)

    flags = [a for a in argv if a.startswith("--")]
    domain, seed = [a for a in argv if not a.startswith("--")][:2]
    shots = range(N_SHOTS)
    for flag in flags:
        if flag.startswith("--shots="):
            shots = [int(s) for s in flag[len("--shots="):].split(",")]
    ep = _episode(domain, int(seed))

    # each pass's packed [T, N, 8] output, recorded as the trackers run
    passes = []
    scan_t, scan_j = tdsst.shot_scan, jdsst.shot_scan_jit

    def record_t(*args, **kw):
        out = scan_t(*args, **kw)
        passes.append(out[1].cpu().numpy())
        return out

    def record_j(*args, **kw):
        out = scan_j(*args, **kw)
        passes.append(np.asarray(out[1]))
        return out

    tdsst.shot_scan, jdsst.shot_scan_jit = record_t, record_j
    trackers = {"jax": JFT(detect_every=0.2, track_max_gap=1.0),
                "port": TFT(detect_every=0.2, track_max_gap=1.0, device="cpu")}
    every = max(1, int(0.2 * ep.fps))
    for shot in shots:
        a = shot * SHOT_FRAMES
        frames = ep.frames[a:a + SHOT_FRAMES]
        ts = np.arange(a, a + SHOT_FRAMES) / ep.fps
        det_idx = np.arange(0, SHOT_FRAMES, every)
        dets = {k: t._detect_frames(frames, det_idx) for k, t in trackers.items()}
        grays = {"jax": jgray(jnp.asarray(frames)),
                 "port": tgray(torch.from_numpy(frames))}
        lines, outcomes = {}, {}
        for pkg, tracker in trackers.items():
            for src in trackers:
                passes.clear()
                tracks = list(tracker._process_shot_device(grays[pkg], ts, dets[src]))
                outcomes[pkg, src] = [
                    [(int(round(t * ep.fps)), box) for t, box, _ in trk]
                    for trk in tracks]
                lines[pkg, src] = []
                if "--psr" not in flags:
                    continue
                for direction, packed in zip(("forward", "backward"), passes):
                    order = (np.arange(SHOT_FRAMES) if direction == "forward"
                             else np.arange(SHOT_FRAMES - 1, -1, -1))
                    conf = packed[:SHOT_FRAMES, :, tdsst.PACK_CONF]
                    status = packed[:SHOT_FRAMES, :, tdsst.PACK_STATUS]
                    for slot in range(conf.shape[1]):
                        row = [f"{a + order[i]}:{conf[i, slot]:.3f}/"
                               f"{int(status[i, slot])}"
                               for i in range(SHOT_FRAMES)
                               if np.isfinite(conf[i, slot]) or status[i, slot] > 0.5]
                        if row:
                            lines[pkg, src].append(f"    {direction} slot "
                                                   f"{slot}: " + " ".join(row))
        diffs = {k: _box_diff(outcomes["jax", "jax"], v)
                 for k, v in outcomes.items()}
        if max(diffs.values()) <= BOX_TOL:
            continue
        print(f"shot {shot} (frames {a}-{a + SHOT_FRAMES - 1}):")
        for src, boxes in dets.items():
            print(f"  {src} detections:", {
                a + f: [tuple(round(v, 2) for v in b) for b in bs]
                for f, bs in boxes.items()})
        for (pkg, src), tracks in outcomes.items():
            print(f"  tracker {pkg}, {src} detections: "
                  f"{diffs[pkg, src]:.2f} px, frames",
                  [[f for f, _ in trk] for trk in tracks])
            for line in lines[pkg, src]:
                print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
