#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``pyannote_video_tpu_torch``) on one GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA device and exits non-zero without one.  Phases, each
printing one JSON line:

1. device: the card's name, and its name and power limit from nvidia-smi;
2. build: compiles every hand-written kernel of the path (``csrc/*.cu``)
   with nvcc, one process per source, all started together;
3. dfd: the DFD kernel against its plain PyTorch version on the card, at
   the shot stage's chunk shape [257, 50, 89] and at [12, 40, 60], with and
   without ``subpixel`` (max_abs_err <= 1e-3), and both timed;
4. shot: ``Shot`` on a 1280x720 synthetic episode (10 shots x 32 frames, so
   the 256-frame chunks carry a frame across their edge); the boundaries
   must sit at the true cuts, and match a CPU run of the port;
5. detect: ``FaceDetector`` with the packaged detector and refiner on those
   frames in batches of 32; recall >= 0.9 at IoU >= 0.5, and on 2 frames the
   card's float32 boxes match the CPU's (same count, IoU >= 0.9);
6. kernels: per kernel its launches on the main path (shot + detect, the
   counts reset just before), error, times and bound.

The last line is ``{"ok": true, "device": {...}}``.  Any failed check
raises, so the script exits non-zero without printing it.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

SEED = 7
DFD_SHAPES = [(257, 50, 89), (12, 40, 60)]
DFD_TOL = 1e-3
# one H100 SXM (NVIDIA data sheet): HBM bytes/s and f32 non-tensor-core FLOP/s
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: check failed: {what}")


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls (CUDA events, after
    a warm-up call)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def dfd_work(T: int, H: int, W: int, radius: int = 3, block: int = 5,
             subpixel: bool = True):
    """(bytes, f32 operations) the DFD of [T, H, W] needs: each input read
    once and each output written once; per (block, displacement) block²
    subtract/abs/add and a scale, the V-correction (10 operations) or a
    plain min, and the mean over blocks."""
    R = 2 * radius + 1
    n_blocks = (H // block) * (W // block)
    per_item = 3 * block * block + 1 + (10 if subpixel else 1)
    ops = (T - 1) * (n_blocks * R * R * per_item + n_blocks)
    return 4 * T * H * W + 4 * (T - 1), ops


def box_iou(a, b) -> float:
    ix0, iy0 = max(a[0], b[0]), max(a[1], b[1])
    ix1, iy1 = min(a[2], b[2]), min(a[3], b[3])
    inter = max(0.0, ix1 - ix0) * max(0.0, iy1 - iy0)
    union = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter
    return inter / union if union > 0 else 0.0


def boxes_agree(a, b, min_iou: float = 0.9) -> bool:
    return all(len(x) == len(y) and all(
        max((box_iou(p, q) for q in y), default=0.0) >= min_iou for p in x)
        for x, y in zip(a, b))


def phase_device():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, "nvidia-smi runs")
    smi_line = smi.stdout.strip().splitlines()[0]
    print(smi_line, flush=True)
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "kind": kind, "count": torch.cuda.device_count(),
          "nvidia_smi": smi_line, "torch": torch.__version__,
          "cuda": torch.version.cuda})
    return kind


def phase_build():
    from pyannote_video_tpu_torch.utils import cuda_build

    t0 = time.perf_counter()
    cuda_build.build(["dfd"])
    emit({"phase": "build", "kernels": ["dfd"],
          "seconds": time.perf_counter() - t0})


def phase_dfd():
    import torch

    from pyannote_video_tpu_torch.ops.dfd import dfd_series, dfd_series_plain

    rng = np.random.default_rng(SEED)
    max_err, timing = 0.0, {}
    for shape in DFD_SHAPES:
        gray = torch.from_numpy(
            rng.uniform(0, 255, shape).astype(np.float32)).cuda()
        for subpixel in (True, False):
            out = dfd_series(gray, subpixel=subpixel)
            ref = dfd_series_plain(gray, subpixel=subpixel)
            torch.cuda.synchronize()
            check(out.shape == ref.shape == (shape[0] - 1,), f"dfd shape {shape}")
            check(bool(torch.isfinite(out).all()), f"dfd finite {shape}")
            err = float((out - ref).abs().max())
            emit({"phase": "dfd", "shape": list(shape), "subpixel": subpixel,
                  "max_abs_err": err})
            check(err <= DFD_TOL, f"dfd {shape} subpixel={subpixel} err {err}")
            max_err = max(max_err, err)
        if shape == DFD_SHAPES[0]:
            timing = {
                "ms": cuda_ms(lambda: dfd_series(gray), 200),
                "plain_ms": cuda_ms(lambda: dfd_series_plain(gray), 10),
            }
    nbytes, ops = dfd_work(*DFD_SHAPES[0])
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    return {
        "name": "dfd", "route": "cuda",
        "source": "pyannote_video_tpu_torch/csrc/dfd.cu",
        "replaces": "pyannote_video_tpu/ops/dfd_pallas.py:48",
        "max_abs_err": max_err, **timing, "kernel_ms": timing["ms"],
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bound_shape": list(DFD_SHAPES[0]), "bytes": nbytes, "ops": ops,
        "library_ms": None,
    }


def make_episode():
    """A 1280x720 episode, rendered at 640x360 and upscaled 2x on the card
    (rendering at full size costs ~4x the host time); boxes scale with it."""
    import torch

    from pyannote_video_tpu_torch.ops.color import resize_bilinear
    from pyannote_video_tpu_torch.utils.synthetic import synthetic_episode

    ep = synthetic_episode(n_shots=10, shot_frames=32, width=640, height=360,
                           n_identities=6, faces_per_shot=1, seed=SEED)
    frames = np.empty((len(ep.frames), 720, 1280, 3), dtype=np.uint8)
    for i in range(0, len(ep.frames), 64):
        up = resize_bilinear(torch.from_numpy(ep.frames[i:i + 64]).cuda(), 720, 1280)
        frames[i:i + 64] = up.round().clamp(0, 255).to(torch.uint8).cpu().numpy()
    gt = [[tuple(2.0 * v for v in f.box) for f in ep.faces_at(i)]
          for i in range(len(frames))]
    return frames, ep.fps, ep.cuts, gt


def phase_shot(frames, fps, cuts):
    import torch

    from pyannote_video_tpu_torch.io.video import Video
    from pyannote_video_tpu_torch.pipeline.shot import Shot

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    shots = list(Shot(Video(frames, fps=fps), threshold=2.0, device="cuda"))
    seconds = time.perf_counter() - t0
    found = [s.end for s in shots[:-1]]
    check(shots[0].start == 0.0 and abs(shots[-1].end - len(frames) / fps) < 1e-6,
          "shots tile the video")
    check(len(found) == len(cuts), f"{len(found)} boundaries for {len(cuts)} cuts")
    check(all(abs(c - g) <= 1.5 / fps for c, g in zip(cuts, found)),
          f"boundaries {found} at cuts {cuts}")
    loose = [s.end for s in Shot(Video(frames, fps=fps), threshold=1.0,
                                 device="cuda")][:-1]
    check(all(any(abs(c - g) <= 1.5 / fps for g in loose) for c in cuts),
          "cuts within the threshold-1.0 boundaries")
    cpu = [s.end for s in Shot(Video(frames, fps=fps), threshold=2.0,
                               device="cpu")][:-1]
    check(cpu == found, f"CPU boundaries {cpu} == card boundaries {found}")
    emit({"phase": "shot", "frames": len(frames), "size": [1280, 720],
          "batch_size": 256, "boundaries": len(found), "cuts": len(cuts),
          "loose_boundaries": len(loose), "seconds": seconds,
          "frames_per_s": len(frames) / seconds})


def phase_detect(frames, gt):
    import torch

    from pyannote_video_tpu_torch.models.detector import FaceDetector

    det = FaceDetector(device="cuda")
    check("refiner" in det.params, "packaged refiner loaded")
    det.detect_batch(frames[:32])     # warm-up (cuDNN plans, allocator)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    found = []
    for i in range(0, len(frames), 32):
        found += det.detect_batch(frames[i:i + 32])
    seconds = time.perf_counter() - t0
    hits = sum(any(box_iou(g, d) >= 0.5 for d in dets)
               for boxes, dets in zip(gt, found) for g in boxes)
    total = sum(len(b) for b in gt)
    recall = hits / total
    check(recall >= 0.9, f"recall {recall}")

    pair = frames[:2]
    card32 = FaceDetector(device="cuda", compute_dtype=torch.float32).detect_batch(pair)
    cpu32 = FaceDetector(device="cpu", compute_dtype=torch.float32).detect_batch(pair)
    check(boxes_agree(card32, cpu32), f"card f32 {card32} vs CPU f32 {cpu32}")
    cpu16 = FaceDetector(device="cpu").detect_batch(pair)
    emit({"phase": "detect", "frames": len(frames), "batch": 32,
          "gt_faces": total, "recall_iou50": recall,
          "detections": sum(len(d) for d in found), "seconds": seconds,
          "frames_per_s": len(frames) / seconds,
          "card_vs_cpu_f32_agree": True,
          "card_bf16_vs_cpu_bf16_agree": boxes_agree(found[:2], cpu16)})


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    # float32 comparisons on the card run in full float32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    from pyannote_video_tpu_torch.ops.dfd import dfd_series

    kind = phase_device()
    phase_build()
    dfd_row = phase_dfd()
    frames, fps, cuts, gt = make_episode()

    # the main path: every launch count starts at 0 here
    dfd_series.launches = 0
    phase_shot(frames, fps, cuts)
    phase_detect(frames, gt)
    dfd_row["launches"] = dfd_series.launches
    check(dfd_row["launches"] > 0, "the shot path launched the dfd kernel")

    emit({"kernels": [dfd_row]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
