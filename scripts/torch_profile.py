#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's shot and detect paths, on one GPU.

Run from the repository root: ``python3 scripts/torch_profile.py [--out
FILE]``.  It uses the same 1280x720 synthetic episode as ``chip_smoke.py``
and ``torch.profiler`` (CUPTI) for device times:

* dfd: the DFD kernel alone at the shot chunk shape [257, 50, 89], its mean
  device time per launch beside the host wall time per call;
* shot: one ``Shot`` run over the 320 frames;
* detect: ``FaceDetector.detect_batch`` over 4 batches of 32 frames.

For each path: wall seconds, device-busy seconds (the sum of kernel and
copy times on the single stream), the idle share, and the top device
operations by time.  Prints one JSON object, and writes it to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def device_time_us(evt) -> float:
    """Device time of a kernel or copy row; 0 for host-side operator rows
    (they report their kernels' time again, which would count it twice)."""
    from torch.autograd import DeviceType

    if evt.device_type != DeviceType.CUDA:
        return 0.0
    return float(evt.self_device_time_total)


def profiled(fn, top: int = 8):
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [(evt.key, device_time_us(evt), evt.count)
            for evt in prof.key_averages() if device_time_us(evt) > 0]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows) * 1e-6
    return {
        "wall_s": wall, "device_busy_s": busy,
        "idle_share": max(0.0, 1.0 - busy / wall) if wall > 0 else None,
        "top": [{"op": k[:90], "device_ms": us * 1e-3, "count": n}
                for k, us, n in rows[:top]],
    }


def main() -> int:
    import numpy as np
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_profile: no CUDA device", file=sys.stderr)
        return 2

    import chip_smoke
    from pyannote_video_tpu_torch.io.video import Video
    from pyannote_video_tpu_torch.models.detector import FaceDetector
    from pyannote_video_tpu_torch.ops.dfd import dfd_series
    from pyannote_video_tpu_torch.pipeline.shot import Shot

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    result = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi}

    gray = torch.from_numpy(np.random.default_rng(chip_smoke.SEED).uniform(
        0, 255, (257, 50, 89)).astype(np.float32)).cuda()
    dfd_series(gray)
    n = 100
    dfd = profiled(lambda: [dfd_series(gray) for _ in range(n)], top=3)
    kernel = [r for r in dfd["top"] if "dfd_kernel" in r["op"]]
    result["dfd"] = {
        "shape": [257, 50, 89], "launches": n,
        "kernel_us_per_launch": kernel[0]["device_ms"] * 1e3 / n if kernel else None,
        "wall_us_per_call": dfd["wall_s"] * 1e6 / n, **dfd}

    frames, fps, _, _ = chip_smoke.make_episode()
    list(Shot(Video(frames[:64], fps=fps), device="cuda"))      # warm-up
    result["shot"] = {"frames": len(frames), **profiled(
        lambda: list(Shot(Video(frames, fps=fps), device="cuda")))}

    det = FaceDetector(device="cuda")
    det.detect_batch(frames[:32])                                # warm-up
    batches = [frames[i:i + 32] for i in range(0, 128, 32)]
    result["detect"] = {"frames": 128, **profiled(
        lambda: [det.detect_batch(b) for b in batches])}

    text = json.dumps(result)
    print(text)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
