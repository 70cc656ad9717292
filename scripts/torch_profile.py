#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's shot, detect, track, extract and streaming paths, on one GPU.

Run from the repository root: ``python3 scripts/torch_profile.py [--out
FILE]``.  It uses the same 1280x720 synthetic episode as ``chip_smoke.py``
and ``torch.profiler`` (CUPTI) for device times:

* dfd: the DFD kernel alone at the shot chunk shape [257, 50, 89], its mean
  device time per launch (every kernel named ``dfd_*``, the templated
  instances included) beside the host wall time per call;
* shot: one ``Shot`` run over the 320 frames, at the default height 50 and
  at height 144 (frames the kernel cuts into row bands);
* detect: ``FaceDetector.detect_batch`` over 4 batches of 32 frames;
* track: ``FaceTracking`` over one 32-frame shot (16 slots, detection every
  0.2 s): the whole stage, and its two scans alone (``_track_passes`` from
  ready detections), each with device launches per frame and per scan step
  and the largest gaps between consecutive device operations;
* extract: one 64-face batch of ``face_cli.extract`` (64 frames of 720p
  stacked and copied, the 15-stage cascade, the chip cut, the bfloat16
  ResNet-29, one read back), and the cascade and the embedder alone on
  inputs that already lie on the card;
* stream_track, stream_extract: the default (streaming) engines of
  ``face_cli.track`` and ``face_cli.extract`` over the first 64 frames (two
  shots): their ``StreamLegs``, and the device's operations by CUDA stream,
  so that the host→device copies show on the shipper's side stream beside
  the kernels on the main one.

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


def idle_gaps(prof, top: int = 5) -> dict:
    """Gaps between consecutive device operations of a profile, in
    microseconds: the largest, and the median."""
    from torch.autograd import DeviceType

    spans = sorted((evt.time_range.start, evt.time_range.end)
                   for evt in prof.events()
                   if evt.device_type == DeviceType.CUDA)
    gaps, busy_until = [], None
    for start, end in spans:
        if busy_until is not None and start > busy_until:
            gaps.append(start - busy_until)
        busy_until = end if busy_until is None else max(busy_until, end)
    gaps.sort(reverse=True)
    return {"device_ops": len(spans), "gaps": len(gaps),
            "largest_gaps_us": [float(g) for g in gaps[:top]],
            "median_gap_us": float(gaps[len(gaps) // 2]) if gaps else None}


def by_stream(prof) -> dict:
    """Device operations of a profile by CUDA stream: count and time of all
    of them, and of the host→device copies among them."""
    from torch.autograd import DeviceType

    streams = {}
    for evt in prof.profiler.kineto_results.events():
        if evt.device_type() != DeviceType.CUDA:
            continue
        row = streams.setdefault(str(evt.device_resource_id()), {
            "ops": 0, "device_ms": 0.0, "h2d_copies": 0, "h2d_ms": 0.0})
        ms = evt.duration_ns() * 1e-6
        row["ops"] += 1
        row["device_ms"] += ms
        if "Memcpy HtoD" in evt.name():
            row["h2d_copies"] += 1
            row["h2d_ms"] += ms
    return streams


def profiled(fn, top: int = 8, gaps: bool = False, streams: bool = False):
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
    copies = [r for r in rows if r[0].startswith(("Memcpy", "Memset"))]
    result = {
        "wall_s": wall, "device_busy_s": busy,
        "idle_share": max(0.0, 1.0 - busy / wall) if wall > 0 else None,
        "device_launches": sum(r[2] for r in rows),
        "copies": {"count": sum(r[2] for r in copies),
                   "device_ms": sum(r[1] for r in copies) * 1e-3},
        "top": [{"op": k[:90], "device_ms": us * 1e-3, "count": n}
                for k, us, n in rows[:top]],
    }
    if gaps:
        result["idle_gaps"] = idle_gaps(prof)
    if streams:
        result["streams"] = by_stream(prof)
    return result


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
    kernel_ms = sum(r["device_ms"] for r in dfd["top"] if "dfd_" in r["op"])
    result["dfd"] = {
        "shape": [257, 50, 89], "launches": n,
        "kernel_us_per_launch": kernel_ms * 1e3 / n if kernel_ms else None,
        "wall_us_per_call": dfd["wall_s"] * 1e6 / n, **dfd}

    frames, fps, _, gt, _ = chip_smoke.make_episode()
    list(Shot(Video(frames[:64], fps=fps), device="cuda"))      # warm-up
    result["shot"] = {"frames": len(frames), **profiled(
        lambda: list(Shot(Video(frames, fps=fps), device="cuda")))}
    list(Shot(Video(frames[:64], fps=fps), height=144, device="cuda"))
    result["shot_h144"] = {"frames": len(frames), "height": 144, **profiled(
        lambda: list(Shot(Video(frames, fps=fps), height=144, device="cuda")))}

    det = FaceDetector(device="cuda")
    det.detect_batch(frames[:32])                                # warm-up
    batches = [frames[i:i + 32] for i in range(0, 128, 32)]
    result["detect"] = {"frames": 128, **profiled(
        lambda: [det.detect_batch(b) for b in batches])}

    from pyannote_video_tpu_torch.core import Segment
    from pyannote_video_tpu_torch.ops.color import to_gray
    from pyannote_video_tpu_torch.pipeline.face_tracking import FaceTracking

    n = 32
    shot, segment = frames[:n], [Segment(0.0, n / fps)]
    tracker = FaceTracking(detect_every=chip_smoke.DETECT_EVERY, device="cuda")
    list(tracker(Video(shot, fps=fps), segment))                 # warm-up
    stage = profiled(lambda: list(tracker(Video(shot, fps=fps), segment)),
                     gaps=True)
    every = max(1, int(chip_smoke.DETECT_EVERY * fps))
    detections = tracker._detect_frames(shot, np.arange(0, n, every))
    grays = to_gray(torch.from_numpy(shot).cuda())
    ts = np.arange(n) / fps
    scans = profiled(lambda: tracker._track_passes(grays, ts, detections),
                     gaps=True)
    result["track"] = {
        "frames": n, "slots": 16, "detection_frames": len(detections),
        "launches_per_frame": stage["device_launches"] / n, **stage,
        "scans": {"steps": 2 * n,
                  "launches_per_step": scans["device_launches"] / (2 * n),
                  "wall_ms_per_step": scans["wall_s"] * 1e3 / (2 * n),
                  "device_busy_ms_per_step":
                      scans["device_busy_s"] * 1e3 / (2 * n), **scans}}

    from pyannote_video_tpu_torch.cli.face_cli import extract_batch
    from pyannote_video_tpu_torch.core.formats import TrackPoint
    from pyannote_video_tpu_torch.models.chip import extract_chips
    from pyannote_video_tpu_torch.models.embedder import FaceEmbedder
    from pyannote_video_tpu_torch.models.landmarks import LandmarkPredictor

    predictor = LandmarkPredictor(device="cuda")
    embedder = FaceEmbedder(device="cuda")
    video = Video(frames, fps=fps)
    picks = [f for f in range(0, len(frames), 5) if gt[f]][:64]
    chunk = [(f / fps, TrackPoint(
        t=f / fps, identifier=0, left=gt[f][0][0] / 1280, top=gt[f][0][1] / 720,
        right=gt[f][0][2] / 1280, bottom=gt[f][0][3] / 720, status="detection"))
        for f in picks]
    extract_batch(video, chunk, predictor, embedder, extract_chips)  # warm-up
    batch = profiled(lambda: extract_batch(video, chunk, predictor, embedder,
                                           extract_chips), gaps=True)
    stack = torch.from_numpy(frames[picks]).cuda()
    fidx = torch.arange(len(picks), device="cuda")
    boxes = torch.tensor([gt[f][0] for f in picks], dtype=torch.float32).cuda()
    landmarks = predictor.predict_device(stack, fidx, boxes)
    chips = extract_chips(stack, fidx, landmarks)
    # the batch's host side, without the profiler: stacking 64 frames, and
    # the pageable copy of the stack to the card
    t0 = time.perf_counter()
    stacked = np.stack([video(t) for t, _ in chunk])
    t1 = time.perf_counter()
    torch.from_numpy(stacked).cuda()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    result["extract"] = {
        "faces": len(chunk), "frames": len(picks), **batch,
        "stack_bytes": int(stacked.nbytes), "stack_wall_ms": (t1 - t0) * 1e3,
        "copy_wall_ms": (t2 - t1) * 1e3,
        "cascade": profiled(
            lambda: predictor.predict_device(stack, fidx, boxes), gaps=True),
        "chips": profiled(lambda: extract_chips(stack, fidx, landmarks)),
        "embedder": profiled(lambda: embedder.embed_device(chips), gaps=True)}

    # the default (streaming) engines over the first two shots
    import tempfile

    from pyannote_video_tpu_torch.cli.face_cli import extract, track
    from pyannote_video_tpu_torch.core import Timeline, dump
    from pyannote_video_tpu_torch.pipeline.streaming import StreamLegs

    n = 64
    with tempfile.TemporaryDirectory() as tmp:
        shot_json, tracking = f"{tmp}/shot.json", f"{tmp}/tracking.txt"
        with open(shot_json, "w") as fp:
            dump(Timeline([Segment(0.0, 32 / fps), Segment(32 / fps, n / fps)]), fp)

        def run_track(legs=None):
            track(Video(frames[:n], fps=fps), shot_json, tracking,
                  detect_every=chip_smoke.DETECT_EVERY, legs=legs, device="cuda")

        def run_extract(legs=None):
            extract(Video(frames[:n], fps=fps), "", "", tracking,
                    f"{tmp}/landmarks.txt", f"{tmp}/embeddings.txt", legs=legs,
                    device="cuda")

        for name, run in (("stream_track", run_track),
                          ("stream_extract", run_extract)):
            run()                                                # warm-up
            legs = StreamLegs()
            result[name] = {"frames": n, **profiled(lambda: run(legs), gaps=True,
                                                    streams=True),
                            "legs": legs.as_dict(),
                            "pinned_bytes": legs.pinned_bytes}

    text = json.dumps(result)
    print(text)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
