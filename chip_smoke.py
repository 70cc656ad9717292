#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``pyannote_video_tpu_torch``) on one GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA device and exits non-zero without one.  Phases, each
printing one JSON line:

1. device: the card's name, and its name and power limit from nvidia-smi;
2. build: compiles every hand-written kernel of the path (``csrc/*.cu``)
   with nvcc, one process per source, all started together;
3. dfd: the DFD kernel against its plain PyTorch version on the card
   (max_abs_err <= 1e-3), with and without ``subpixel``, at the shot
   stage's chunk shapes [257, 50, 89] (16:9) and [257, 50, 67] (4:3), at
   [12, 40, 60], at [65, 144, 256] (``Shot(height=144)``, frames cut into
   row bands), at [1025, 36, 64] (several pairs per CTA) and at
   [5, 1080, 1920] (column tiles), and through the run-time-parameter
   instance (radius=2, block=4); two launches on the same input must be
   bit-identical.  At [257, 50, 89] it times the kernel (100 launches in one
   CUDA graph, replayed), the wrapper (CUDA events around back-to-back
   calls, and the host's time per call) and the plain version;
4. shot: ``Shot`` on a 1280x720 synthetic episode (10 shots x 32 frames, so
   the 256-frame chunks carry a frame across their edge); the boundaries
   must sit at the true cuts, and match a CPU run of the port; then
   ``Shot(height=144)``, whose boundaries must match a CPU run;
5. detect: ``FaceDetector`` with the packaged detector and refiner on those
   frames in batches of 32; recall >= 0.9 at IoU >= 0.5, and on 2 frames the
   card's float32 boxes match the CPU's (same count, IoU >= 0.9);
6. dsst (before the main path): the tracker's tensor programs on the card
   against the port's own CPU run from the same seeded inputs: the patch
   sampler (max error <= 4e-3 on 0-255 values); ``restart_slots`` then 8
   ``_step_core`` steps on moving textured squares at 1280x720 with 16
   slots (positions and sizes within 1e-3 px, ``alive`` equal, PSR within
   rtol 1e-2); ``_optimal_match`` on 200 seeded random gated matrices and
   the tie patterns of the association tests, and ``_jv_match`` at 16
   detections (card result equal to the CPU's, element for element).  It
   prints the device launches of one ``_step_core`` and of one
   detection-frame step, and the mean time per step of a 64-frame scan;
7. extract_parts (before the main path): the extract stage's tensor
   programs on the card against the port's own CPU run, from 64 faces on 64
   frames of the 720p episode: ``predict_crops`` with the packaged 15-stage
   cascade (>= 95% of faces within 5e-3 px on every landmark, all within
   1 px; a face beyond 5e-3 px is a split that flipped on a feature one ulp
   from its threshold), the two samplers from the same matrices (<= 4e-3
   on 0-255) and the three chip cuts (mean error <= 4e-3, largest error
   within what the fitted transforms' coordinate difference explains), the
   float32 embedder (<= 1e-4), the bfloat16 embedder against the card's
   float32 (Euclidean distance <= 0.05, a twelfth of the clustering
   threshold) and ``pairwise_dist`` (<= 1e-5).  It prints the device
   launches, device ms and wall ms of one ``predict_crops`` and of one
   bfloat16 ``embedder.forward`` at 64 faces, and the bytes each must move;
8. stream_ingest (before the main path): the shipper of ``io/stream.py`` at
   the main path's shapes, 24 batches of 64 frames of 720p planes through
   ``run_stream`` at depth 2, each another window of the episode: every
   plane read back from the card equals its host plane byte for byte (a
   pinned buffer refilled too early, or a consumer that did not wait for
   the copy, would show here); luma gray on the card within 1e-4 of the
   CPU's and ``yuv420_to_rgb`` within 1e-3; pinned bytes, peak device
   memory and the copies' GB/s printed;
9. stream_track (on the main path, after shot and detect): ``do_shot``
   writes ``shot.json`` from the 720p episode, ``face_cli.track`` reads it
   and writes ``tracking.txt`` by its default engine, ``stream_tracks``
   (detection every 0.2 s).  Every shot has a track, no track crosses a
   cut, the true face of >= 90% of the frames is covered by a track point
   at IoU >= 0.4, every status is one of the reference's strings; the
   ``StreamLegs`` are printed and the main thread's legs add up to the wall
   within 15% + 0.25 s; and the first two shots streamed again on the CPU,
   with the card's detector answering, give the same (t, track, status)
   sequence with boxes within 2 px;
10. stream_extract (on the main path, same directory): ``face_cli.extract``
   reads ``tracking.txt`` and writes ``landmarks.txt`` and
   ``embeddings.txt`` by its default engine, ``stream_extract`` (chips cut
   from the YUV planes).  One line of each per track point, in (t, track)
   order; every embedding has 128 finite values and unit norm; the
   landmarks' mean lies in the track box and they sit within 10% of the
   face height of the episode's true landmarks; the faces of the first 64
   frames extracted again on the CPU agree under the rules of phase 7;
11. cluster (on the main path): ``FaceClustering(threshold=0.6)`` on
   ``embeddings.txt``; the labels equal a CPU run's.  It prints how many
   tracks share a cluster with a track of another identity (not gated: the
   packaged weights are trained on synthetic faces);
12. track, extract (beside the main path, ``PYV_NO_STREAM=1``, the first 3
   shots): the per-shot ``track`` writes the streamed file's (t, track)
   sequence, its boxes within 2.5/120 of the frame in the median and on
   >= 40% of the points, its statuses equal on >= half (its detector sees
   the RGB frame, the streamed one the YUV round trip, and another
   candidate of a face may win NMS, or none pass the threshold); given the
   streamed detections the per-shot engine writes the same (t, track,
   status) sequence with every box within 2.5/120; the chunked ``extract`` on the streamed
   points gives landmarks within 0.02 (normalised) and embeddings within
   0.05 of the streamed ones;
13. world2: ``track --rank 1 --world 2`` then ``--rank 0`` one after the
   other on the card; the merged file's point set (rounded to 3 decimals)
   equals the single worker's;
14. isolate_legs: 8 batches of 64 frames: pack, transfer (pinned, GB/s) and
   compute each alone, from RGB batches and from a raw I420 file written
   and read back (``write_yuv_file``, ``yuv_file_batches``), and the same
   file streamed overlapped;
15. thread (on the main path, after cluster): an 8-shot x 20-frame 720p
   episode whose shots thread as ``[0,1,0,1,2,3,2,3]``, chained
   ``do_shot`` -> ``shot.json`` -> ``do_thread`` (the CLI defaults: height
   200, lookahead 24, min_match 20, 500 keypoints) -> ``thread.json`` ->
   ``do_scene`` -> ``scene.json``.  Shots at the true cuts; thread pairwise
   F1 1.0 against the pattern; two scenes, shots 0-3 and 4-7; both files
   byte-equal to a CPU run of the port from the same ``shot.json``; ORB on
   the collar frames and on 16 frames, two per shot, card against CPU
   (keypoint positions and ``valid``
   equal, angle bins equal on >= ORB_ANGLE_SHARE of the valid slots,
   descriptor bits equal on >= ORB_DESC_SHARE); every pair's count equal
   between card and CPU, same-thread pairs >= 40, cross-thread <= 16.  It
   prints launches, device ms, wall ms and bytes to move of one
   ``detect_and_describe`` at [16, 200, 356] and of one 64-pair
   ``batched_ratio_matches``;
16. farneback (beside the main path): ``Shot(method="farneback")`` at
   height 50 on the 10-shot episode, boundaries at the true cuts at
   threshold FARNEBACK_THRESHOLD and equal to a CPU run; one [257, 50, 89]
   chunk through ``farneback_flow`` and ``warped_residual``, card against
   CPU (flows within FLOW_TOL px on >= FLOW_SHARE of the pixels, the
   residuals within rtol FLOW_DFD_RTOL); launches, device ms and wall ms of
   the chunk;
17. fused (beside the main path, after the kernel counts were read): the
   fused detect -> align -> embed program (``models/fused.py``) and its
   detect-only half on 64 frames of the 10-shot episode, bf16, 8 face slots
   per frame, with the packaged detector and refiner, the 15-stage cascade
   and ResNet-29 at width 1.0.  Detect-only equals ``FaceDetector``
   truncated to 8 slots (same count, IoU >= 0.9) with recall >= 0.9 at IoU
   >= 0.5, also on the 26 detection frames of a 128-frame shot; the fused
   program's ``valid`` and boxes equal detect-only's, and on its valid
   slots its landmarks and embeddings agree with ``predict_crops``,
   ``extract_chips`` and the bf16 embedder on the same boxes (the rule of
   phase 7; distance <= 0.05); in float32 on 2 frames the card equals the
   CPU (``valid``, boxes at IoU >= 0.9, landmarks by phase 7's rule,
   embeddings within 1e-4); ``entry()`` on the card; ``device_trace``
   around one fused call writes a trace holding CUDA kernels; two
   ``ShotScheduler`` workers on one card, merged, equal a plain loop of
   per-shot detection counts; ``dfd_pairs_reference_style`` on the card
   against its plain version (<= 1e-3).  It prints launches, device ms,
   wall ms, frames/s, face slots/s, bytes to move, HBM ms and peak device
   memory of one detect-only and one fused call at [64, 720, 1280, 3], and
   launches and times of the NMS rounds alone;
18. train (beside the main path, after fused): the trainers on the card at
   their own defaults, float32, TF32 off.  The embedder (ResNet-29 at width
   1.0 from the packaged file, 16 identities x 3 = 48 chips of 150²,
   clip(5) -> Adam(1e-3)), the detector (``deep_width`` 96 from a seeded
   init, 16 crops of 128², Adam on the cosine schedule) and the refiner
   (widths 32-128 from a seeded init, the 64² crops of one padded batch
   cut from a ``ServeMiner`` refresh on the packaged stage 1): one step on
   the card against the same step on the CPU, same params and batch (loss
   within TRAIN_LOSS_RTOL, every gradient within TRAIN_GRAD_TOL of
   max(its largest, 1% of the model's), the moved statistics within
   TRAIN_STAT_RTOL, the parameters after Adam within TRAIN_PARAM_TOL where
   |g| > 1e-3 of the model's and within two rates elsewhere); 5 timed
   steps (wall ms each, finite losses, peak device memory, samples/s),
   5 profiled ones (launches, device ms of each) and one whose convolution and
   matrix operations torch counts (their least time at the float32 peak,
   F32_OPS_PER_S); ``save_params`` then
   ``load_params`` gives a state whose forward equals the saved one's;
   each trainer's ``main`` for 2 steps; the detector's mining refresh (8
   negative + 8 positive frames of 360x480 through the bf16 pyramid: wall
   and host render seconds) and its pyramid card against CPU on 2 frames
   (logits within 5% of their span, >= 80% of the top cells shared); the
   ``ServeMiner`` refresh's wall; ``PYV_NO_REFINE`` left as it was; the
   landmark trainer's data and one tree, without OpenCV;
19. parallel (after train): the mesh path on the one card, world 1:
   ``make_mesh()`` is 1x1; two steps of ``make_train_step`` (width 0.25,
   8 chips, Adam(1e-3)) equal two of ``train_step`` with the same loss
   and Adam on the same batch, cuDNN deterministic (loss and every leaf
   within PARALLEL_RTOL relative); ``sharded_embed_fn`` equals
   ``embedder.forward`` (<= 1e-6); ms per step, launches and device ms,
   sharded against unsharded; ``run_dryrun(1)`` prints its lines; then
   ``dryrun_multichip(4, device="cpu")``, four gloo processes (dp 2 x tp 2)
   on this machine's torch, printing the dry run's lines, timed alone;
20. eval: ``evaluate`` at the JAX default (12 shots x 20 frames @ 640x480,
   6 identities, seed 101) in domains A and BC, with each stage's wall;
   domain A at 1.0 on EVAL_GATES, the rest printed; the DFD kernel's
   launches by the eval's ``Shot`` (its count reset just before); the small
   episode (4 shots x 10 frames @ 320x240) card against CPU (EVAL_EQUAL
   equal, landmark error within 1e-3); ``probe("A", seeds=(101,))`` card
   against CPU (``gt``, ``missed_at_0.5``, ``fp_n`` equal, scores within
   PROBE_SCORE_TOL) and its margin; the wall of each of these checks;
21. kernels: per kernel its launches on the main path (both shot runs,
   detect, stream_track, stream_extract, cluster and thread, the counts
   reset just before), error, times, bound, and the registers, spills and
   shared memory ptxas reports for each instance.

The last line is ``{"ok": true, "device": {...}}``.  Any failed check
raises, so the script exits non-zero without printing it.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

SEED = 7
DFD_SHAPES = [(257, 50, 89), (257, 50, 67), (12, 40, 60), (65, 144, 256),
              (1025, 36, 64), (5, 1080, 1920)]
RUNTIME_INSTANCE = {"radius": 2, "block": 4}
DFD_TOL = 1e-3
CHIP_TOL = 4e-3             # patch sampler, card vs CPU, on 0-255 values
STEP_POS_TOL = 1e-3         # px, after 8 steps, card vs CPU
STEP_PSR_RTOL = 1e-2
TRACK_BOX_TOL = 2.0         # px, card track file vs CPU re-run
DETECT_EVERY = 0.2          # seconds between detection frames
LANDMARK_TOL = 5e-3         # px, cascade card vs CPU, faces with no flipped split
LANDMARK_FLIP_TOL = 1.0     # px, every face
LANDMARK_AGREE_SHARE = 0.95
EMBED_F32_TOL = 1e-4        # float32 embedder, card vs CPU
EMBED_BF16_DIST = 0.05      # Euclidean, bf16 vs f32: a twelfth of the threshold
DIST_TOL = 1e-5
CLUSTER_THRESHOLD = 0.6
STREAM_BOX_TOL = 2.5 / 120.0    # streamed vs per-shot boxes, normalised
STREAM_LANDMARK_TOL = 0.02      # streamed vs chunked landmarks, normalised
THREAD_PATTERN = [0, 1, 0, 1, 2, 3, 2, 3]
ORB_DESC_SHARE = 0.999      # descriptor bits equal, card vs CPU
ORB_ANGLE_SHARE = 0.999     # angle bins equal on valid slots, card vs CPU
SAME_THREAD_MIN, CROSS_THREAD_MAX = 40, 16
FARNEBACK_THRESHOLD = 5.0   # cut peaks 13.7-18.6, other frames <= 2.0
FLOW_TOL = 1e-3             # px, Farneback flow card vs CPU
FLOW_SHARE = 0.999          # of the pixels (textureless ones sit at the guard)
FLOW_DFD_RTOL = 1e-4
FUSED_FACES = 8             # face slots per frame (the JAX package's MAX_FACES)
FUSED_FRAMES = 64           # frames per fused / detect-only call
TRAIN_STEPS = 5             # timed steps per gradient trainer
TRAIN_LOSS_RTOL = 1e-4      # one step, card vs CPU, float32: the loss
TRAIN_GRAD_TOL = 1e-3       # ... each gradient, of max(its largest, 1% of the model's)
TRAIN_STAT_RTOL = 1e-4      # ... the moved batch-norm statistics
TRAIN_PARAM_TOL = 1e-6      # ... the parameters after the step, where |g| > 1e-3 of the model's
# the tie patterns of the association tests
TIE_PATTERNS = [
    [[0.50, 0.45], [0.40, 0.00]], [[0.51, 0.49], [0.49, 0.51]],
    [[0.5, 0.5], [0.5, 0.5]], [[0.9, 0.2], [0.85, 0.0]],
    [[0.6, 0.0, 0.0], [0.7, 0.5, 0.0], [0.0, 0.6, 0.4]],
    [[0.0, 0.0], [0.0, 0.0], [0.0, 0.0]], [[0.3]],
    [[0.4, 0.4, 0.4]], [[0.4], [0.4], [0.4]],
]
PARALLEL_BATCH = 8          # chips of the world-1 sharded step, width 0.25
PARALLEL_STEPS = 5          # timed steps each, sharded and unsharded
PARALLEL_RTOL = 1e-6        # sharded step vs train_step: loss and every leaf
EVAL_GATES = ("boundary_f1", "thread_f1", "scene_f1", "track_precision",
              "cluster_purity")    # 1.0 in the JAX package's matrix, domain A
EVAL_SMALL = dict(n_shots=4, shot_frames=10, width=320, height=240)
EVAL_EQUAL = ("boundary_f1", "thread_f1", "scene_f1", "track_f1",
              "track_precision", "track_recall", "cluster_purity",
              "cluster_recall", "cluster_precision", "n_tracks", "n_clusters")
# probe scores card vs CPU, rounded to 0.01 as the probe reports them
PROBE_SCORE_TOL = 0.05
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


def graph_ms(fn, launches: int = 100, replays: int = 5) -> float:
    """Device time per call of ``fn``: ``launches`` calls captured in one
    CUDA graph, replayed ``replays`` times between CUDA events, so the
    host's cost per call is not in it."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    return cuda_ms(graph.replay, replays) / launches


def host_us(fn, calls: int = 200) -> float:
    """Host time per call of ``fn`` (enqueue only), in microseconds."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds / calls * 1e6


def ptxas_report(log: str) -> dict:
    """Registers, spills and static shared memory of each kernel in an
    ``nvcc -Xptxas -v`` log, by readable name."""
    report, name = {}, None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            inst = re.search(r"dfd_kernelILi(\d+)ELi(\d+)ELb([01])E", entry.group(1))
            if inst:
                r, b, sub = inst.groups()
                size = "run-time" if b == "0" else f"radius={r},block={b}"
                name = f"dfd_kernel<{size},subpixel={bool(int(sub))}>"
            else:
                name = re.sub(r"^_ZN.*?\d+(dfd_\w+?)E.*$", r"\1", entry.group(1))
            report[name] = {}
            continue
        spill = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads", line)
        if spill and name:
            report[name].update(stack_frame=int(spill.group(1)),
                                spill_stores=int(spill.group(2)),
                                spill_loads=int(spill.group(3)))
        used = re.search(r"Used (\d+) registers", line)
        if used and name:
            smem = re.search(r"(\d+) bytes smem", line)
            report[name].update(registers=int(used.group(1)),
                                static_smem=int(smem.group(1)) if smem else 0)
    return report


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
    ptxas = ptxas_report(cuda_build.log_path("dfd").read_text())
    check(any(k.startswith("dfd_kernel<radius=3") for k in ptxas),
          "ptxas reports the dfd kernel")
    emit({"phase": "build", "kernels": ["dfd"],
          "seconds": time.perf_counter() - t0, "ptxas": ptxas})
    return ptxas


def phase_dfd(ptxas: dict):
    import torch

    from pyannote_video_tpu_torch.ops.dfd import dfd_series, dfd_series_plain

    rng = np.random.default_rng(SEED)
    runs = [(shape, {}) for shape in DFD_SHAPES]
    runs.append((DFD_SHAPES[0], RUNTIME_INSTANCE))
    max_err, timing = 0.0, {}
    for shape, sizes in runs:
        gray = torch.from_numpy(
            rng.uniform(0, 255, shape).astype(np.float32)).cuda()
        for subpixel in (True, False):
            out = dfd_series(gray, subpixel=subpixel, **sizes)
            again = dfd_series(gray, subpixel=subpixel, **sizes)
            ref = dfd_series_plain(gray, subpixel=subpixel, **sizes)
            torch.cuda.synchronize()
            check(out.shape == ref.shape == (shape[0] - 1,), f"dfd shape {shape}")
            check(bool(torch.isfinite(out).all()), f"dfd finite {shape}")
            check(torch.equal(out, again), f"dfd {shape} {sizes} repeat launch")
            err = float((out - ref).abs().max())
            emit({"phase": "dfd", "shape": list(shape), **sizes,
                  "subpixel": subpixel, "max_abs_err": err,
                  "repeat_bit_identical": True})
            check(err <= DFD_TOL, f"dfd {shape} {sizes} subpixel={subpixel} err {err}")
            max_err = max(max_err, err)
        if shape == DFD_SHAPES[0] and not sizes:
            timing = {
                "kernel_ms": graph_ms(lambda: dfd_series(gray)),
                "wrapper_ms": cuda_ms(lambda: dfd_series(gray), 200),
                "host_us_per_call": host_us(lambda: dfd_series(gray)),
                "plain_ms": cuda_ms(lambda: dfd_series_plain(gray), 10),
            }
    nbytes, ops = dfd_work(*DFD_SHAPES[0])
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    bound = max(t_bytes, t_ops)
    return {
        "name": "dfd", "route": "cuda",
        "source": "pyannote_video_tpu_torch/csrc/dfd.cu",
        "replaces": "pyannote_video_tpu/ops/dfd_pallas.py:48",
        "max_abs_err": max_err, "ms": timing["kernel_ms"], **timing,
        "bound_ms": bound,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bound_share": bound / timing["kernel_ms"],
        "bound_shape": list(DFD_SHAPES[0]), "bytes": nbytes, "ops": ops,
        "library_ms": None, "ptxas": ptxas,
    }


def make_episode(n_shots: int = 10, shot_frames: int = 32, pattern=None):
    """A 1280x720 episode, rendered at 640x360 and upscaled 2x on the card
    (rendering at full size costs ~4x the host time); boxes scale with it.
    Returns frames, fps, cuts, the true boxes per frame, and per frame the
    true (landmarks [68, 2], identity) of each face."""
    import torch

    from pyannote_video_tpu_torch.ops.color import resize_bilinear
    from pyannote_video_tpu_torch.utils.synthetic import synthetic_episode

    ep = synthetic_episode(n_shots=n_shots, shot_frames=shot_frames, width=640,
                           height=360, n_identities=6, faces_per_shot=1,
                           seed=SEED, thread_pattern=pattern)
    frames = np.empty((len(ep.frames), 720, 1280, 3), dtype=np.uint8)
    for i in range(0, len(ep.frames), 64):
        up = resize_bilinear(torch.from_numpy(ep.frames[i:i + 64]).cuda(), 720, 1280)
        frames[i:i + 64] = up.round().clamp(0, 255).to(torch.uint8).cpu().numpy()
    gt = [[tuple(2.0 * v for v in f.box) for f in ep.faces_at(i)]
          for i in range(len(frames))]
    truth = [[(2.0 * f.landmarks, f.face_id) for f in ep.faces_at(i)]
             for i in range(len(frames))]
    return frames, ep.fps, ep.cuts, gt, truth


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

    # 144x256 frames: more shared memory than a CTA has, were they staged
    # whole
    tall = [s.end for s in Shot(Video(frames, fps=fps), height=144,
                                threshold=2.0, device="cuda")][:-1]
    tall_cpu = [s.end for s in Shot(Video(frames, fps=fps), height=144,
                                    threshold=2.0, device="cpu")][:-1]
    check(tall == tall_cpu, f"height 144: CPU {tall_cpu} == card {tall}")
    emit({"phase": "shot", "height": 144, "boundaries": len(tall),
          "cuts": len(cuts), "cuts_within_1.5_frames": sum(
              any(abs(c - g) <= 1.5 / fps for g in tall) for c in cuts)})


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


def dsst_step_bytes(n_slots: int) -> int:
    """Bytes one ``_step_core`` must move: the filter state read and
    written once, and the four taps of every pixel of the translation
    patch (64 x 64) and of the shared super-patch (128 x 128) read from
    the frame."""
    from pyannote_video_tpu_torch.ops import dsst

    state = dsst.init_state(1)
    state_bytes = sum(v.numel() * v.element_size() for v in state)
    taps = 4 * 4 * (dsst.P ** 2 + dsst._STEP_SUPER ** 2)
    return n_slots * (2 * state_bytes + taps)


def device_launches(fn) -> int:
    """Kernels and copies the device ran during ``fn()`` (torch.profiler)."""
    return device_profile(fn)[0]


def device_profile(fn):
    """(launches, device ms) of the kernels and copies the device ran during
    ``fn()`` (torch.profiler)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # a ``record_function`` range (``torch.optim`` wraps each step in one)
    # shows as a device row spanning its kernels' queue: not a launch
    rows = [evt for evt in prof.key_averages()
            if evt.device_type == DeviceType.CUDA and not evt.is_user_annotation]
    n = sum(evt.count for evt in rows)
    check(n > 0, "the profiler saw the device")
    return n, sum(float(evt.self_device_time_total) for evt in rows) * 1e-3


def moving_squares(T: int, n_objects: int, H: int = 720, W: int = 1280):
    """[T, H, W] float32 frames of textured squares drifting over a noisy
    background, and their boxes [T, n_objects, 4]."""
    rng = np.random.default_rng(SEED)
    bg = rng.uniform(20, 60, (H, W)).astype(np.float32)
    frames = np.empty((T, H, W), np.float32)
    boxes = np.empty((T, n_objects, 4), np.float32)
    objs = []
    for k in range(n_objects):
        # 12 x 12 random cells of 5-16 px: texture that survives the
        # sampler's decimation to a 64 x 64 patch
        tex = np.kron(rng.uniform(60, 255, (12, 12)),
                      np.ones((int(rng.integers(5, 17)),) * 2)).astype(np.float32)
        objs.append((tex, rng.uniform(220, H - 220), rng.uniform(220, W - 220),
                     rng.uniform(-1.5, 1.5), rng.uniform(-1.5, 1.5)))
    for t in range(T):
        img = bg.copy()
        for k, (tex, cy, cx, vy, vx) in enumerate(objs):
            size = tex.shape[0]
            y0 = int(round(cy + vy * t - size / 2))
            x0 = int(round(cx + vx * t - size / 2))
            img[y0:y0 + size, x0:x0 + size] = tex
            boxes[t, k] = (x0, y0, x0 + size, y0 + size)
        frames[t] = img
    return frames, boxes


def phase_dsst():
    import torch
    from scipy.optimize import linear_sum_assignment

    from pyannote_video_tpu_torch.ops import dsst
    from pyannote_video_tpu_torch.ops.warp import separable_resize_chips

    rng = np.random.default_rng(SEED)
    N, D, STEPS = 16, 8, 8
    out = {"phase": "dsst", "size": [1280, 720], "slots": N}

    # the patch sampler
    frames4 = rng.uniform(0, 255, (4, 720, 1280, 1)).astype(np.float32)
    mats = np.zeros((64, 2, 3), np.float32)
    mats[:, 0, 0], mats[:, 1, 1] = rng.uniform(0.3, 6.0, (2, 64))
    mats[:, 0, 2] = rng.uniform(-50, 1250, 64)
    mats[:, 1, 2] = rng.uniform(-50, 700, 64)
    idx = rng.integers(0, 4, 64)
    args = [torch.from_numpy(a) for a in (frames4, idx, mats)]
    chips_cpu = separable_resize_chips(*args, 64, 64)
    chips = separable_resize_chips(*[a.cuda() for a in args], 64, 64).cpu()
    out["chips_max_abs_err"] = float((chips - chips_cpu).abs().max())
    check(out["chips_max_abs_err"] <= CHIP_TOL,
          f"separable_resize_chips card vs CPU {out['chips_max_abs_err']}")

    # restart_slots, then STEPS steps, card against CPU
    frames, boxes = moving_squares(STEPS + 1, 5)
    slot_boxes = np.tile(np.asarray([[10, 10, 50, 50]], np.float32), (N, 1))
    mask = np.zeros((N,), bool)
    for k, slot in enumerate((0, 3, 4, 9, 15)):
        slot_boxes[slot], mask[slot] = boxes[0, k], True
    states, confs = {}, {}
    for dev in ("cpu", "cuda"):
        grays = torch.from_numpy(frames).to(dev)
        st = dsst.restart_slots(
            dsst.init_state(N, dev), grays,
            torch.zeros((N,), dtype=torch.long, device=dev),
            torch.from_numpy(slot_boxes).to(dev), torch.from_numpy(mask).to(dev))
        for t in range(1, STEPS + 1):
            st, _, conf = dsst._step_core(
                st, grays, torch.full((N,), t, dtype=torch.long, device=dev), 10.0)
        states[dev], confs[dev] = dsst.state_to_numpy(st), conf.cpu().numpy()
    pos_err = float(np.abs(states["cuda"]["pos"] - states["cpu"]["pos"]).max())
    size_err = float(np.abs(states["cuda"]["size"] - states["cpu"]["size"]).max())
    live = states["cpu"]["alive"]
    check(live.sum() == 5, f"the 5 targets are alive after {STEPS} steps: {live}")
    check(np.array_equal(states["cuda"]["alive"], live), "alive: card == CPU")
    check(pos_err <= STEP_POS_TOL and size_err <= STEP_POS_TOL,
          f"{STEPS} steps, card vs CPU: pos {pos_err} size {size_err}")
    psr_rel = float(np.abs(confs["cuda"][live] / confs["cpu"][live] - 1).max())
    check(psr_rel <= STEP_PSR_RTOL, f"PSR card vs CPU rel {psr_rel}")
    centre = states["cuda"]["pos"][[0, 3, 4, 9, 15]][:, ::-1]
    truth = (boxes[STEPS, :, :2] + boxes[STEPS, :, 2:]) / 2
    check(np.abs(centre - truth).max() < 4.0, "the trackers followed the squares")
    out.update(steps=STEPS, pos_max_abs_err=pos_err, size_max_abs_err=size_err,
               psr_max_rel_err=psr_rel)

    # the matchers: ties must fall on the card as on the CPU
    cases = [np.asarray(p, np.float32) for p in TIE_PATTERNS]
    for trial in range(200):
        ov = rng.uniform(0, 1, (4 if trial % 2 else N, D)).astype(np.float32)
        ov[rng.uniform(size=ov.shape) < 0.5] = 0.0
        cases.append(np.round(ov * 4) / 4 if trial % 5 == 0 else ov)
    wide = rng.uniform(0, 1, (N, 16)).astype(np.float32)
    wide[rng.uniform(size=wide.shape) < 0.6] = 0.0
    cases.append(wide)
    for ov in cases:
        on_cpu = dsst._optimal_match(torch.from_numpy(ov))
        on_card = dsst._optimal_match(torch.from_numpy(ov).cuda()).cpu()
        check(torch.equal(on_card, on_cpu),
              f"matcher card {on_card.tolist()} == CPU {on_cpu.tolist()}")
    rows, cols = linear_sum_assignment(-wide.astype(np.float64))
    total = float(sum(wide[n, d] for d, n in enumerate(on_card.tolist()) if n >= 0))
    check(abs(total - float(wide[rows, cols].sum())) < 1e-5,
          "_jv_match total equals Hungarian's")
    out.update(matcher_cases=len(cases), matcher_card_equals_cpu=True,
               jv_total=total)

    # launches and time per step
    T = 64
    frames, boxes = moving_squares(T, 5)
    grays = torch.from_numpy(frames).cuda()
    det_boxes = np.zeros((T, D, 4), np.float32)
    det_valid = np.zeros((T, D), bool)
    det_boxes[::5, :5], det_valid[::5, :5] = boxes[::5], True

    def scan(dets: bool, t0: int = 0, t1: int = T):
        dv = det_valid if dets else det_valid & (np.arange(T) == 0)[:, None]
        sl = slice(t0, t1)
        return dsst.shot_scan(
            dsst.init_state(N, "cuda"),
            torch.full((N,), -1, dtype=torch.long, device="cuda"), 0, grays,
            np.ones((t1 - t0,), bool), det_boxes[sl], dv[sl], 10.0, 0.5, 0.6,
            frame_index=np.arange(t0, t1))

    def wall_ms_per_step(dets: bool) -> float:
        scan(dets)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, packed, _ = scan(dets)
        torch.cuda.synchronize()
        check(bool((packed[:, :, dsst.PACK_STATUS] > 0).any()), "scan tracked")
        return (time.perf_counter() - t0) / T * 1e3

    state = dsst.restart_slots(
        dsst.init_state(N, "cuda"), grays,
        torch.zeros((N,), dtype=torch.long, device="cuda"),
        torch.from_numpy(slot_boxes).cuda(), torch.from_numpy(mask).cuda())
    frame1 = torch.full((N,), 1, dtype=torch.long, device="cuda")
    dsst._step_core(state, grays, frame1, 10.0)
    out["launches_per_step_core"] = device_launches(
        lambda: dsst._step_core(state, grays, frame1, 10.0))
    # a scan of one detection frame, less its fixed set-up (a scan of one
    # plain frame, less one _step_core)
    one_det = device_launches(lambda: scan(True, 5, 6))
    one_plain = device_launches(lambda: scan(False, 6, 7))
    out["launches_per_detection_step"] = (
        one_det - one_plain + out["launches_per_step_core"])
    out["launches_scan_setup"] = one_plain - out["launches_per_step_core"]
    out["scan_frames"] = T
    out["step_bytes"] = dsst_step_bytes(N)
    out["step_hbm_ms"] = out["step_bytes"] / HBM_BYTES_PER_S * 1e3
    out["ms_per_step_detect_every_5"] = wall_ms_per_step(True)
    out["ms_per_step_no_detections"] = wall_ms_per_step(False)
    emit(out)


def wall_ms(fn, reps: int = 3) -> float:
    """Mean wall time of ``fn()`` ending in a synchronise, after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def landmark_agreement(out: np.ndarray, ref: np.ndarray, what: str) -> dict:
    """The cascade rule: per face the largest landmark error in px; at
    least LANDMARK_AGREE_SHARE of the faces within LANDMARK_TOL (the others
    had a split flip), every face within LANDMARK_FLIP_TOL."""
    err = np.abs(out - ref).max(axis=(1, 2))
    agree = err <= LANDMARK_TOL
    check(agree.mean() >= LANDMARK_AGREE_SHARE,
          f"{what}: {int(agree.sum())} of {len(err)} faces within {LANDMARK_TOL} px")
    check(err.max() <= LANDMARK_FLIP_TOL, f"{what}: largest error {err.max()} px")
    return {"faces": len(err), "faces_with_flipped_split": int((~agree).sum()),
            "share_within_5e-3_px": float(agree.mean()),
            "max_err_px": float(err.max()),
            "max_err_px_agreeing": float(err[agree].max())}


def embedder_bytes(params, n: int) -> dict:
    """Bytes one ``embedder.forward`` of ``n`` chips must move: the weights
    once, the chips in, and each conv's float32 output map written once and
    read once (sizes walked from the block plan)."""
    from pyannote_video_tpu_torch.models.embedder import BLOCK_PLAN, CHIP_SIZE

    def tensors(node):
        if isinstance(node, dict):
            for v in node.values():
                yield from tensors(v)
        elif hasattr(node, "numel"):
            yield node

    weights = sum(t.numel() * t.element_size() for t in tensors(params))
    side = (CHIP_SIZE - 7) // 2 + 1                      # stem, VALID 7x7/2
    maps = n * params["stem"]["w"].shape[0] * side * side
    side = (side - 3) // 2 + 1                           # max-pool 3/2
    for i, down in enumerate(BLOCK_PLAN):
        if down:
            side = (side - 3) // 2 + 1                   # VALID 3x3/2
        channels = params["blocks"][f"block{i}"]["conv1"]["w"].shape[0]
        maps += 2 * n * channels * side * side           # conv1, conv2
    chips = n * CHIP_SIZE * CHIP_SIZE * 3 * 4
    return {"weights": weights, "chips_in": chips, "activations": 2 * 4 * maps,
            "total": weights + chips + 2 * 4 * maps}


def phase_extract_parts(frames, gt):
    import torch

    from pyannote_video_tpu_torch.models import chip, embedder, landmarks
    from pyannote_video_tpu_torch.models.weights import (
        LANDMARKS_FILE, default_embedder_params)
    from pyannote_video_tpu_torch.models.nn import state_to
    from pyannote_video_tpu_torch.ops.color import to_gray
    from pyannote_video_tpu_torch.ops.distance import pairwise_dist

    rng = np.random.default_rng(SEED)
    N = 64
    picks = [f for f in range(0, len(frames), 5) if gt[f]][:N]
    check(len(picks) == N, f"{N} frames with a face")
    stack = torch.from_numpy(frames[picks])                  # [64, 720, 1280, 3]
    fidx = torch.arange(N)
    # the true boxes, moved and resized by a few pixels as a tracker's are
    boxes = torch.from_numpy(
        np.asarray([gt[f][0] for f in picks], np.float32)
        + rng.uniform(-4, 4, (N, 4)).astype(np.float32))
    out = {"phase": "extract_parts", "size": [1280, 720], "faces": N,
           "frames": N}

    # the cascade
    cascade = {dev: landmarks._load(LANDMARKS_FILE, dev) for dev in ("cpu", "cuda")}
    check(cascade["cpu"]["n_stages"] == 15 and cascade["cpu"]["s0/i1"].shape[0] == 224,
          "the packaged cascade has 15 stages of 224 trees")
    lm_cpu = landmarks.predict_crops(cascade["cpu"], to_gray(stack), fidx, boxes)
    stack_d, fidx_d, boxes_d = stack.cuda(), fidx.cuda(), boxes.cuda()
    grays_d = to_gray(stack_d)
    lm_card = landmarks.predict_crops(cascade["cuda"], grays_d, fidx_d, boxes_d)
    check(bool(torch.isfinite(lm_card).all()), "landmarks finite")
    out["cascade"] = landmark_agreement(lm_card.cpu().numpy(), lm_cpu.numpy(),
                                        "predict_crops card vs CPU")

    # the chip cuts, from the same (CPU) landmarks on both devices.  The
    # samplers, given the same matrices, must agree within CHIP_TOL.  The
    # cuts fit their matrices on their own device: a mean over 68
    # coordinates of ~1000 px rounds by about an ulp of it (6e-5 px) per
    # device, and an edge of the image turns that into up to 255 levels
    # per px, so a cut's largest error is held to what the measured
    # coordinate difference explains, and its mean error to CHIP_TOL.
    from pyannote_video_tpu_torch.ops.warp import (gather_affine_warp,
                                                   separable_resize_chips)

    mats_cpu = chip.chip_transforms(lm_cpu)
    mats_card = chip.chip_transforms(lm_cpu.cuda()).cpu()
    corners = torch.tensor([[0.0, 0.0, 1.0], [149.0, 0.0, 1.0],
                            [0.0, 149.0, 1.0], [149.0, 149.0, 1.0]])
    coord_diff = float(((mats_card - mats_cpu) @ corners.T).abs().max())
    check(coord_diff <= 1e-3, f"chip transforms card vs CPU {coord_diff} px")
    out["chip_transform_max_coord_diff_px"] = coord_diff
    aligned = chip._axis_aligned(mats_cpu, 150.0)
    for name, sampler, mats in (
            ("separable_resize_chips", separable_resize_chips, aligned),
            ("gather_affine_warp", gather_affine_warp, mats_cpu)):
        on_cpu = sampler(stack, fidx, mats, 150, 150)
        on_card = sampler(stack_d, fidx_d, mats.cuda(), 150, 150).cpu()
        err = float((on_card - on_cpu).abs().max())
        check(err <= CHIP_TOL, f"{name} card vs CPU, same matrices: {err}")
        out[f"{name}_max_abs_err"] = err
    planes = (stack[..., 0].contiguous(), stack[:, ::2, ::2, 1].contiguous(),
              stack[:, ::2, ::2, 2].contiguous())
    cuts = {
        "extract_chips": lambda dev: chip.extract_chips(
            stack.to(dev), fidx.to(dev), lm_cpu.to(dev)),
        "extract_chips_exact": lambda dev: chip.extract_chips_exact(
            stack.to(dev), fidx.to(dev), lm_cpu.to(dev)),
        "extract_chips_yuv": lambda dev: chip.extract_chips_yuv(
            *(p.to(dev) for p in planes), fidx.to(dev), lm_cpu.to(dev)),
    }
    for name, cut in cuts.items():
        on_cpu, on_card = cut("cpu"), cut("cuda").cpu()
        check(on_card.shape == (N, 150, 150, 3), f"{name} shape")
        diff = (on_card - on_cpu).abs()
        err, mean_err = float(diff.max()), float(diff.mean())
        # the YUV inverse scales a plane's error by up to 2.017
        check(err <= 2.017 * 255.0 * coord_diff + CHIP_TOL and mean_err <= CHIP_TOL,
              f"{name} card vs CPU: max {err}, mean {mean_err}, "
              f"coordinates differ by {coord_diff} px")
        out[f"{name}_max_abs_err"] = err
        out[f"{name}_mean_abs_err"] = mean_err
    chips_cpu = cuts["extract_chips"]("cpu")
    chips_d = chips_cpu.cuda()

    # the embedder: float32 against the CPU, bfloat16 against the card's float32
    params = default_embedder_params()
    check(params["stem"]["w"].shape[0] == 32 and tuple(params["fc"].shape) == (256, 128),
          "the packaged embedder has full width")
    params_d = state_to(params, torch.device("cuda"))
    with torch.no_grad():
        emb_cpu = embedder.forward(params, chips_cpu, compute_dtype=torch.float32)
        emb_f32 = embedder.forward(params_d, chips_d, compute_dtype=torch.float32)
        emb_bf16 = embedder.forward(params_d, chips_d)
    check(bool(torch.isfinite(emb_bf16).all()), "embeddings finite")
    out["embedder_f32_max_abs_err"] = float((emb_f32.cpu() - emb_cpu).abs().max())
    check(out["embedder_f32_max_abs_err"] <= EMBED_F32_TOL,
          f"float32 embedder card vs CPU {out['embedder_f32_max_abs_err']}")
    out["embedder_bf16_max_dist"] = float((emb_bf16 - emb_f32).norm(dim=1).max())
    check(out["embedder_bf16_max_dist"] <= EMBED_BF16_DIST,
          f"bf16 embedder vs float32 {out['embedder_bf16_max_dist']}")

    # distances
    x = torch.from_numpy(rng.normal(0, 1, (320, 128)).astype(np.float32))
    x = x / x.norm(dim=1, keepdim=True)
    out["pairwise_dist_max_abs_err"] = float(
        (pairwise_dist(x.cuda()).cpu() - pairwise_dist(x)).abs().max())
    check(out["pairwise_dist_max_abs_err"] <= DIST_TOL,
          f"pairwise_dist card vs CPU {out['pairwise_dist_max_abs_err']}")

    # launches, device time and wall time of the two candidates for a kernel
    def run_cascade():
        return landmarks.predict_crops(cascade["cuda"], grays_d, fidx_d, boxes_d)

    def run_embedder():
        with torch.no_grad():
            return embedder.forward(params_d, chips_d)

    leaves = cascade["cpu"]["s0/leaves"]
    for name, fn, nbytes in (
            ("predict_crops", run_cascade,
             {"leaf_rows": 15 * N * leaves.shape[0] * leaves.shape[2] * 4,
              "crops": N * landmarks.CROP ** 2 * 4}),
            ("embedder_forward_bf16", run_embedder, embedder_bytes(params, N))):
        ms = wall_ms(fn)
        launches, device_ms = device_profile(fn)
        total = nbytes.get("total", sum(nbytes.values()))
        out[name] = {"launches": launches, "device_ms": device_ms, "wall_ms": ms,
                     "bytes": nbytes,
                     "hbm_ms": total / HBM_BYTES_PER_S * 1e3}
    emit(out)


@contextlib.contextmanager
def stopwatch(cls, *names):
    """Wall seconds spent inside methods ``names`` of ``cls`` while the
    context is open, as a dict by name."""
    seconds = dict.fromkeys(names, 0.0)
    saved = {name: getattr(cls, name) for name in names}

    def timed(name, fn):
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                seconds[name] += time.perf_counter() - t0
        return wrapper

    for name, fn in saved.items():
        setattr(cls, name, timed(name, fn))
    try:
        yield seconds
    finally:
        for name, fn in saved.items():
            setattr(cls, name, fn)


@contextlib.contextmanager
def older_engines():
    """``PYV_NO_STREAM=1`` while the context is open: ``track`` takes the
    per-shot engine and ``extract`` the chunked one."""
    saved = os.environ.get("PYV_NO_STREAM")
    os.environ["PYV_NO_STREAM"] = "1"
    try:
        yield
    finally:
        if saved is None:
            del os.environ["PYV_NO_STREAM"]
        else:
            os.environ["PYV_NO_STREAM"] = saved


def point_set(points):
    """A tracking file's points as ``tests/test_multihost.py`` compares
    them: rounded to 3 decimals, without track numbers."""
    return sorted((round(p.t, 3), round(p.left, 3), round(p.top, 3),
                   round(p.right, 3), round(p.bottom, 3), p.status)
                  for p in points)


def check_legs(legs, what: str) -> dict:
    """``StreamLegs`` as a dict; the main thread's legs must add up to the
    wall (the bar of ``tests/test_streaming_cli.py``)."""
    d = legs.as_dict()
    check(abs(d["main_thread_s"] - d["wall_s"]) < 0.15 * d["wall_s"] + 0.25,
          f"{what}: main-thread legs {d['main_thread_s']} s of wall {d['wall_s']} s")
    return d


def legs_efficiency(legs) -> float:
    """Pipelining efficiency of a streamed run from its three threads'
    busy seconds: packer, shipper, main thread (less its waits for batches)."""
    from pyannote_video_tpu_torch.io.stream import pipelining_efficiency

    main = legs.dispatch_s + legs.sync_s + legs.scan_s + legs.host_s
    return pipelining_efficiency(
        legs.wall_s, [legs.decode_s + legs.pack_s, legs.transfer_s, main])


def phase_stream_ingest(frames, fps):
    """The shipper at the main path's shapes: 24 batches of 64 frames of
    720p planes at depth 2, each a different window of the episode."""
    import torch

    from pyannote_video_tpu_torch.io.stream import pack_yuv420, run_stream
    from pyannote_video_tpu_torch.ops.color import yuv420_to_rgb, yuv_luma_to_gray

    n_batches, B = 24, 64
    planes = [np.concatenate(parts) for parts in zip(*(
        pack_yuv420(frames[i:i + B]) for i in range(0, len(frames), B)))]
    windows = [(13 * k + np.arange(B)) % len(frames) for k in range(n_batches)]

    def source():
        for idx in windows:
            yield idx / fps, tuple(p[idx] for p in planes)

    def compute(carry, ts, y, u, v):
        # a copy made on the consumer's stream at once, and the planes themselves
        return carry, (y.clone(), u.clone(), v.clone(), y, u, v)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _, results, stats = run_stream(source(), compute, None, depth=2,
                                   pack=False, device="cuda")
    peak = torch.cuda.max_memory_allocated()
    check(len(results) == n_batches, f"{len(results)} batches came through")
    for k, (idx, res) in enumerate(zip(windows, results)):
        for j, got in enumerate(res):
            check(got.is_cuda and got.dtype == torch.uint8,
                  f"batch {k}: plane {j} is a uint8 tensor on the card")
            check(np.array_equal(got.cpu().numpy(), planes[j % 3][idx]),
                  f"batch {k}: plane {j} equals the host plane byte for byte")
    check(stats.pinned_bytes == 3 * sum(p[:B].nbytes for p in planes),
          f"a ring of depth + 1 pinned slots: {stats.pinned_bytes} B")

    y, u, v = (torch.from_numpy(p[:4]) for p in planes)
    gray_err = float((yuv_luma_to_gray(y.cuda()).cpu() - yuv_luma_to_gray(y))
                     .abs().max())
    rgb_err = float((yuv420_to_rgb(y.cuda(), u.cuda(), v.cuda()).cpu()
                     - yuv420_to_rgb(y, u, v)).abs().max())
    check(gray_err <= 1e-4, f"luma gray card vs CPU {gray_err}")
    check(rgb_err <= 1e-3, f"yuv420_to_rgb card vs CPU {rgb_err}")
    emit({"phase": "stream_ingest", "batches": n_batches, "frames_per_batch": B,
          "depth": 2, "size": [1280, 720], "planes_byte_equal": True,
          "bytes_per_batch": int(sum(p[:B].nbytes for p in planes)),
          "pinned_bytes": stats.pinned_bytes, "peak_device_bytes": peak,
          "luma_gray_max_abs_err": gray_err, "yuv420_to_rgb_max_abs_err": rgb_err,
          "transfer_s": stats.transfer_s, "feed_wait_s": stats.feed_wait_s,
          "wall_s": stats.wall_s,
          "transfer_gb_per_s": stats.bytes_shipped / stats.transfer_s / 1e9})


def read_tracks(path):
    from pyannote_video_tpu_torch.core import formats

    points = formats.read_tracking(str(path))
    tracks = {}
    for p in points:
        tracks.setdefault(p.identifier, []).append(p)
    return points, tracks


def box_errors(a, b, what: str, statuses: bool = True) -> np.ndarray:
    """Per point the largest normalised coordinate difference of two
    tracking files that hold the same (t, track) sequence, and with
    ``statuses`` the same status at each point."""
    row = lambda p: (round(p.t, 3), p.identifier) + ((p.status,) if statuses else ())
    differ = [(row(p), row(q)) for p, q in zip(a, b) if row(p) != row(q)]
    if differ or len(a) != len(b):
        emit({"phase": "track", "comparison": what, "points": [len(a), len(b)],
              "first_differing_rows": differ[:8]})
    check(not differ and len(a) == len(b),
          f"{what}: the two files hold the same (t, track"
          f"{', status' if statuses else ''}) sequence")
    box = lambda pts: np.asarray([[p.left, p.top, p.right, p.bottom] for p in pts])
    return np.abs(box(a) - box(b)).max(axis=1)


def phase_stream_track(tmp, frames, fps, cuts, gt):
    """``do_shot`` then the default (streaming) ``track`` over the episode."""
    import torch

    from pyannote_video_tpu_torch.cli.face_cli import (MAX_GAP,
                                                       MIN_OVERLAP_RATIO, track)
    from pyannote_video_tpu_torch.cli.structure_cli import do_shot
    from pyannote_video_tpu_torch.core import load
    from pyannote_video_tpu_torch.io.video import Video
    from pyannote_video_tpu_torch.models.detector import FaceDetector
    from pyannote_video_tpu_torch.pipeline.face_tracking import FaceTracking
    from pyannote_video_tpu_torch.pipeline.streaming import (StreamLegs,
                                                             stream_tracks)

    W, H = 1280, 720
    shot_json, tracking_txt = Path(tmp, "shot.json"), Path(tmp, "tracking.txt")
    do_shot(Video(frames, fps=fps), str(shot_json), threshold=2.0,
            device="cuda")
    with open(shot_json) as fp:
        shots = list(load(fp))
    check(len(shots) == len(cuts) + 1, f"shot.json holds {len(shots)} shots")

    check(os.environ.get("PYV_NO_STREAM") != "1", "the default engines run")
    legs = StreamLegs()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    track(Video(frames, fps=fps), str(shot_json), str(tracking_txt),
          detect_every=DETECT_EVERY, legs=legs, device="cuda")
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    points, tracks = read_tracks(tracking_txt)
    check(len(points) > 0, "tracking.txt holds points")
    check(legs.frames == len(frames) and legs.batches == -(-len(frames) // 64),
          f"the streaming engine ran: {legs.frames} frames, {legs.batches} batches")
    check(legs.pinned_bytes > 0, "the planes were staged in pinned memory")

    for seg in shots:
        check(any(seg.start <= p.t < seg.end for p in points),
              f"a track in shot {seg.start:.2f}-{seg.end:.2f}")
    for ident, pts in tracks.items():
        ts = [p.t for p in pts]
        check(not any(min(ts) < c - 1e-6 <= max(ts) for c in cuts),
              f"track {ident} crosses a cut")
    parts = {"forward", "detection", "backward"}
    check(all(set(p.status.removeprefix("error(").removesuffix(")").split("+"))
              <= parts for p in points), "statuses are the reference's")
    by_time = {}
    for p in points:
        by_time.setdefault(round(p.t * fps), []).append(
            (p.left * W, p.top * H, p.right * W, p.bottom * H))
    faces = [(f, g) for f, boxes in enumerate(gt) for g in boxes]
    covered = sum(any(box_iou(g, b) >= 0.4 for b in by_time.get(f, []))
                  for f, g in faces)
    coverage = covered / len(faces)
    check(coverage >= 0.9, f"track coverage {coverage}")

    # the first two shots again by the streaming engine on the CPU, with the
    # card's detector answering for its detection frames
    n2 = int(round(shots[1].end * fps))
    card = FaceDetector(device="cuda")
    relay = FaceDetector(device="cpu")
    relay.candidates = lambda rgb: tuple(
        t.cpu() for t in card.candidates(rgb.cuda()))
    engine = FaceTracking(detect_every=DETECT_EVERY,
                          track_min_overlap_ratio=MIN_OVERLAP_RATIO,
                          track_max_gap=MAX_GAP, device="cpu")
    engine._batch_detector = relay
    cpu_tracks = list(stream_tracks(engine, Video(frames[:n2], fps=fps), shots[:2]))
    cpu_points = [(t, ident, status, box) for ident, trk in enumerate(cpu_tracks)
                  for t, box, status in trk]
    card_points = [p for p in points if p.t < shots[1].end - 1e-6]
    check([(round(t, 3), i, s) for t, i, s, _ in cpu_points]
          == [(round(p.t, 3), p.identifier, p.status) for p in card_points],
          "CPU re-run: same (t, track, status) sequence as the card's file")
    scale = np.asarray([W, H, W, H])
    box_err = float(max(
        np.abs(np.asarray(box) * scale
               - np.asarray([p.left, p.top, p.right, p.bottom]) * scale).max()
        for (_, _, _, box), p in zip(cpu_points, card_points)))
    check(box_err <= TRACK_BOX_TOL, f"CPU re-run boxes differ by {box_err} px")

    emit({"phase": "stream_track", "engine": "stream_tracks",
          "frames": len(frames), "size": [W, H],
          "shots": len(shots), "tracks": len(tracks), "points": len(points),
          "detect_every_s": DETECT_EVERY, "coverage_iou40": coverage,
          "seconds": seconds, "frames_per_s": len(frames) / seconds,
          "legs": check_legs(legs, "stream_track"),
          "pipelining_efficiency": legs_efficiency(legs),
          "pinned_bytes": legs.pinned_bytes, "peak_device_bytes": peak,
          "cpu_rerun_points": len(cpu_points), "cpu_rerun_box_max_err_px": box_err})
    return shots


def phase_stream_extract(tmp, frames, fps, truth):
    """The default (streaming) ``extract`` over the episode's track points."""
    import torch

    from pyannote_video_tpu_torch.cli.face_cli import extract
    from pyannote_video_tpu_torch.core import formats
    from pyannote_video_tpu_torch.io.video import Video
    from pyannote_video_tpu_torch.pipeline.streaming import StreamLegs

    W, H = 1280, 720
    size = np.asarray([W, H])
    tracking_txt = Path(tmp, "tracking.txt")
    landmarks_txt, embeddings_txt = Path(tmp, "landmarks.txt"), Path(tmp, "embeddings.txt")
    points = formats.read_tracking(str(tracking_txt))
    ordered = [p for _, group in formats.iter_tracking_by_time(points) for p in group]

    spent, legs = {}, StreamLegs()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    extract(Video(frames, fps=fps), "", "", str(tracking_txt),
            str(landmarks_txt), str(embeddings_txt), legs=legs, device="cuda",
            stats=spent)
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    check(legs.frames == len(frames) and legs.pinned_bytes > 0,
          f"the streaming engine ran: {legs.frames} frames")

    rows = formats.read_landmarks(str(landmarks_txt))
    times, idents, X = formats.read_embeddings(str(embeddings_txt))
    want = [(round(p.t, 3), p.identifier) for p in ordered]
    check([(t, i) for t, i, _ in rows] == want,
          "one landmarks line per track point, in (t, track) order")
    check(list(zip(times.tolist(), idents.tolist())) == want,
          "one embedding line per track point, in (t, track) order")
    check(X.shape == (len(points), 128) and bool(np.isfinite(X).all()),
          f"embeddings {X.shape} finite")
    norms = np.linalg.norm(X, axis=1)
    check(float(np.abs(norms - 1.0).max()) <= 1e-3, f"embedding norms {norms.min()}-{norms.max()}")

    lm = np.stack([pts for _, _, pts in rows])                  # normalized
    check(lm.shape == (len(points), 68, 2) and bool(np.isfinite(lm).all()),
          f"landmarks {lm.shape} finite")
    mean = lm.mean(axis=1)
    check(all(p.left <= mx <= p.right and p.top <= my <= p.bottom
              for p, (mx, my) in zip(ordered, mean)),
          "every face's mean landmark lies in its track box")
    errs, heights = [], []
    for p, pts in zip(ordered, lm * size):
        centre = np.asarray([(p.left + p.right) / 2 * W, (p.top + p.bottom) / 2 * H])
        true_lm, _ = min(truth[int(round(p.t * fps))],
                         key=lambda face: np.abs(face[0].mean(axis=0) - centre).sum())
        errs.append(np.linalg.norm(pts - true_lm, axis=1).mean())
        heights.append((p.bottom - p.top) * H)
    mean_err, mean_height = float(np.mean(errs)), float(np.mean(heights))
    check(mean_err <= 0.1 * mean_height,
          f"landmarks {mean_err} px from the truth at face height {mean_height}")

    # the faces of the first 64 frames again on the CPU (float32 convs
    # there: the exact algorithm, against the card's served bfloat16)
    first = Path(tmp, "tracking64.txt")
    head = [p for p in ordered if p.t < 64 / fps - 1e-6]
    with open(first, "w") as fp:
        for p in head:
            formats.write_track_point(fp, p)
    extract(Video(frames[:64], fps=fps), "", "", str(first),
            str(Path(tmp, "landmarks64.txt")), str(Path(tmp, "embeddings64.txt")),
            device="cpu", compute_dtype=torch.float32)
    cpu_rows = formats.read_landmarks(str(Path(tmp, "landmarks64.txt")))
    _, _, cpu_X = formats.read_embeddings(str(Path(tmp, "embeddings64.txt")))
    check([(t, i) for t, i, _ in cpu_rows] == want[:len(head)],
          "CPU re-run: same lines")
    agreement = landmark_agreement(
        lm[:len(head)] * size, np.stack([pts for _, _, pts in cpu_rows]) * size,
        "extract card vs CPU")
    dist = float(np.linalg.norm(X[:len(head)] - cpu_X, axis=1).max())
    check(dist <= EMBED_BF16_DIST, f"extract embeddings card bf16 vs CPU f32 {dist}")

    emit({"phase": "stream_extract", "engine": "stream_extract",
          "faces": len(points), "size": [W, H],
          "faces_per_dispatch": 64, "seconds": seconds,
          "faces_per_s": len(points) / seconds,
          "load_models_s": spent["load"],
          "legs": check_legs(legs, "stream_extract"),
          "pipelining_efficiency": legs_efficiency(legs),
          "pinned_bytes": legs.pinned_bytes, "peak_device_bytes": peak,
          "landmark_mean_err_px": mean_err, "face_height_px": mean_height,
          "cpu_rerun_faces": len(head), "cpu_rerun": agreement,
          "cpu_rerun_embedding_max_dist": dist})
    return ordered


def phase_older_engines(tmp, frames, fps, shots):
    """The per-shot ``track`` and the chunked ``extract`` (``PYV_NO_STREAM=1``)
    on the first 3 shots, each against the streamed files of the main path."""
    import torch

    from pyannote_video_tpu_torch.cli.face_cli import extract, track
    from pyannote_video_tpu_torch.core import Timeline, dump, formats
    from pyannote_video_tpu_torch.io.video import Video
    from pyannote_video_tpu_torch.pipeline.tracking import TrackingByDetection

    n_shots = 3
    end = shots[n_shots - 1].end
    n = int(round(end * fps))
    clip = lambda: Video(frames[:n], fps=fps)
    shot3 = Path(tmp, "shot3.json")
    with open(shot3, "w") as fp:
        dump(Timeline(shots[:n_shots]), fp)
    streamed = [p for p in formats.read_tracking(str(Path(tmp, "tracking.txt")))
                if p.t < end - 1e-6]

    per_shot_txt = Path(tmp, "tracking_per_shot.txt")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with older_engines(), stopwatch(TrackingByDetection, "_detect_frames",
                                    "_track_passes") as spent:
        track(clip(), str(shot3), str(per_shot_txt), detect_every=DETECT_EVERY,
              device="cuda")
    seconds = time.perf_counter() - t0
    check(spent["_track_passes"] > 0 and spent["_detect_frames"] > 0,
          "the per-shot engine ran")
    per_shot = formats.read_tracking(str(per_shot_txt))
    # each engine's own detections: on the YUV round trip another candidate
    # of the same face may win NMS (or none passes the threshold, and a
    # point's status is then the tracker's), and the tracker carries that
    # box to the next detection; so only the bulk of the points is held to
    # the bar, and most statuses must be equal
    err = box_errors(streamed, per_shot, "streamed vs per-shot", statuses=False)
    same_status = float(np.mean([p.status == q.status
                                 for p, q in zip(streamed, per_shot)]))
    emit({"phase": "track", "engine": "per-shot (PYV_NO_STREAM=1)",
          "shots": n_shots, "frames": n, "points": len(per_shot),
          "seconds": seconds, "frames_per_s": n / seconds,
          "share_detect": spent["_detect_frames"] / seconds,
          "share_scans": spent["_track_passes"] / seconds,
          "streamed_vs_per_shot_box_err_x120": {
              "max": float(err.max() * 120), "median": float(np.median(err) * 120),
              "share_within_2.5": float((err <= STREAM_BOX_TOL).mean())},
          "streamed_vs_per_shot_share_of_equal_statuses": same_status})
    check(float(np.median(err)) <= STREAM_BOX_TOL
          and float((err <= STREAM_BOX_TOL).mean()) >= 0.4,
          f"streamed vs per-shot boxes: median {np.median(err) * 120}/120")
    check(same_status >= 0.5, f"streamed vs per-shot statuses: {same_status} equal")

    # the per-shot engine again, given the streaming path's detections (the
    # card's detector on the YUV round trip of each detection frame): the
    # engines then differ only in their gray, and every box is held to the bar
    from pyannote_video_tpu_torch.cli.face_cli import MAX_GAP, MIN_OVERLAP_RATIO
    from pyannote_video_tpu_torch.io.stream import pack_yuv420
    from pyannote_video_tpu_torch.models.detector import FaceDetector
    from pyannote_video_tpu_torch.ops.color import yuv420_to_rgb
    from pyannote_video_tpu_torch.pipeline.face_tracking import FaceTracking

    detector = FaceDetector(device="cuda")
    every = max(1, int(DETECT_EVERY * fps))
    detections, key = {}, lambda frame: frame[::16, ::16].tobytes()
    for seg in shots[:n_shots]:
        idx = np.arange(int(round(seg.start * fps)), int(round(seg.end * fps)), every)
        rgb = yuv420_to_rgb(*(torch.from_numpy(plane).cuda()
                              for plane in pack_yuv420(frames[idx])))
        scores, boxes = (t.cpu().numpy() for t in detector.candidates(rgb))
        detections.update({key(frames[i]): detector.select(scores[k], boxes[k])
                           for k, i in enumerate(idx)})
    engine = FaceTracking(detect_every=DETECT_EVERY,
                          track_min_overlap_ratio=MIN_OVERLAP_RATIO,
                          track_max_gap=MAX_GAP, device="cuda")
    engine.detect_func = lambda frame: detections[key(frame)]
    fed = [formats.TrackPoint(t=t, identifier=ident, left=box[0], top=box[1],
                              right=box[2], bottom=box[3], status=status)
           for ident, trk in enumerate(engine(clip(), shots[:n_shots]))
           for t, box, status in trk]
    fed_err = box_errors(streamed, fed, "streamed vs per-shot given its detections")
    emit({"phase": "track", "engine": "per-shot, given the streamed detections",
          "shots": n_shots, "points": len(fed),
          "streamed_vs_per_shot_box_err_x120": {
              "max": float(fed_err.max() * 120),
              "median": float(np.median(fed_err) * 120)}})
    check(float(fed_err.max()) <= STREAM_BOX_TOL,
          f"same detections: streamed vs per-shot boxes differ by "
          f"{fed_err.max() * 120}/120")

    # the chunked extract on the streamed points of those shots
    first = Path(tmp, "tracking3.txt")
    with open(first, "w") as fp:
        for p in streamed:
            formats.write_track_point(fp, p)
    chunked_lm, chunked_emb = Path(tmp, "landmarks3.txt"), Path(tmp, "embeddings3.txt")
    spent = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with older_engines():
        extract(clip(), "", "", str(first), str(chunked_lm), str(chunked_emb),
                device="cuda", stats=spent)
    seconds = time.perf_counter() - t0
    check("cascade" in spent, "the chunked engine ran")
    rows = formats.read_landmarks(str(chunked_lm))
    _, _, X = formats.read_embeddings(str(chunked_emb))
    all_rows = formats.read_landmarks(str(Path(tmp, "landmarks.txt")))
    _, _, all_X = formats.read_embeddings(str(Path(tmp, "embeddings.txt")))
    check([(t, i) for t, i, _ in rows] == [(t, i) for t, i, _ in all_rows[:len(rows)]],
          "chunked and streamed extract write the same lines")
    lm_err = float(max(np.abs(a[2] - b[2]).max() for a, b in zip(rows, all_rows)))
    dist = np.linalg.norm(X - all_X[:len(X)], axis=1)
    emit({"phase": "extract", "engine": "chunked (PYV_NO_STREAM=1)",
          "shots": n_shots, "faces": len(rows), "seconds": seconds,
          "faces_per_s": len(rows) / seconds,
          "share_load_models": spent["load"] / seconds,
          "share_frames_and_copy": spent["frames"] / seconds,
          "share_cascade": spent["cascade"] / seconds,
          "share_chips": spent["chips"] / seconds,
          "share_embedder_and_readback": spent["embedder"] / seconds,
          "share_write": spent["write"] / seconds,
          "streamed_vs_chunked_landmark_max_err": lm_err,
          "streamed_vs_chunked_embedding_dist": {
              "max": float(dist.max()), "median": float(np.median(dist))}})
    check(lm_err <= STREAM_LANDMARK_TOL,
          f"streamed vs chunked landmarks differ by {lm_err} (normalised)")
    check(float(dist.max()) <= EMBED_BF16_DIST,
          f"streamed vs chunked embeddings are {dist.max()} apart")


def phase_world2(tmp, frames, fps):
    """``track --rank 1 --world 2`` then ``--rank 0``, one after the other on
    the card: the merged file holds the single worker's points."""
    from pyannote_video_tpu_torch.cli.face_cli import track
    from pyannote_video_tpu_torch.core import formats
    from pyannote_video_tpu_torch.io.video import Video
    from pyannote_video_tpu_torch.parallel.multihost import part_path
    from pyannote_video_tpu_torch.pipeline.streaming import StreamLegs

    sharded = Path(tmp, "tracking_world2.txt")
    seconds, legs = {}, {}
    for rank in (1, 0):
        legs[rank] = StreamLegs()
        t0 = time.perf_counter()
        track(Video(frames, fps=fps), str(Path(tmp, "shot.json")), str(sharded),
              detect_every=DETECT_EVERY, rank=rank, world=2, legs=legs[rank],
              device="cuda")
        seconds[rank] = time.perf_counter() - t0
    parts = [formats.read_tracking(part_path(str(sharded), r)) for r in (0, 1)]
    check(all(parts), "each worker wrote points")
    single = formats.read_tracking(str(Path(tmp, "tracking.txt")))
    merged = formats.read_tracking(str(sharded))
    check(len(merged) == len(parts[0]) + len(parts[1]) == len(single),
          f"{len(merged)} merged points for {len(single)}")
    same = point_set(merged) == point_set(single)
    if not same:
        a, b = set(point_set(merged)), set(point_set(single))
        emit({"phase": "world2", "only_sharded": sorted(a - b)[:8],
              "only_single": sorted(b - a)[:8]})
    check(same, "two workers' merged point set equals the single worker's")
    emit({"phase": "world2", "engine": "stream_tracks", "points": len(merged),
          "tracks": len({p.identifier for p in merged}),
          "points_by_rank": [len(p) for p in parts],
          "seconds_by_rank": [seconds[0], seconds[1]],
          "scan_s_by_rank": [legs[0].scan_s, legs[1].scan_s],
          "point_set_equals_single": True})


def phase_isolate_legs(tmp, frames, fps):
    """Each leg alone on 8 batches of 64 frames, the planes read back from
    a raw I420 file, and the same stream overlapped."""
    import torch

    from pyannote_video_tpu_torch.io.stream import (
        isolate_legs, pack_yuv420, pipelining_efficiency, run_stream,
        write_yuv_file, yuv_file_batches)
    from pyannote_video_tpu_torch.ops.color import yuv_luma_to_gray

    n_batches, B, H, W = 8, 64, 720, 1280
    batches = [((k * B + np.arange(B)) / fps,
                frames[(k * B + np.arange(B)) % len(frames)])
               for k in range(n_batches)]

    def compute(carry, ts, y, u, v):
        return carry, yuv_luma_to_gray(y).sum()

    alone = isolate_legs(batches, compute, None, device="cuda")
    path = str(Path(tmp, "episode.i420"))
    n = write_yuv_file(path, ((ts, pack_yuv420(f)) for ts, f in batches))
    check(n == n_batches * B, f"{n} frames in the I420 file")
    del batches
    packed = list(yuv_file_batches(path, H, W, B, fps=fps))
    check(len(packed) == n_batches, f"{len(packed)} batches read back")
    ref = pack_yuv420(frames[:B])
    check(all(np.array_equal(a, b) for a, b in zip(packed[0][1], ref)),
          "the file's first batch equals the packed planes")
    from_file = isolate_legs(packed, compute, None, pack=False, device="cuda")
    _, results, stats = run_stream(yuv_file_batches(path, H, W, B, fps=fps),
                                   compute, None, depth=2, pack=False,
                                   device="cuda")
    check(len(results) == n_batches, "the overlapped run saw every batch")
    sums = [float(r) for r in results]
    want = [float(yuv_luma_to_gray(
        torch.from_numpy(np.ascontiguousarray(y))).sum())
        for _, (y, _, _) in packed]
    check(all(abs(a - b) <= 1e-3 * abs(b) for a, b in zip(sums, want)),
          "the overlapped run's sums equal the CPU's")
    emit({"phase": "isolate_legs", "batches": n_batches, "frames_per_batch": B,
          "size": [W, H], "from_rgb": alone, "from_i420_file": from_file,
          "overlapped": stats.as_dict(),
          "pipelining_efficiency": pipelining_efficiency(
              stats.wall_s, [stats.decode_s, stats.transfer_s, stats.compute_s])})


def phase_cluster(tmp, ordered, fps, truth):
    from pyannote_video_tpu_torch.pipeline.clustering import FaceClustering

    embeddings_txt = str(Path(tmp, "embeddings.txt"))
    t0 = time.perf_counter()
    clustering = FaceClustering(threshold=CLUSTER_THRESHOLD, device="cuda")
    starting_point, features = clustering.model.preprocess(embeddings_txt)
    result = clustering(starting_point, features=features)
    seconds = time.perf_counter() - t0
    labels = {track: label for _, track, label in result.itertracks(yield_label=True)}
    on_cpu = FaceClustering(threshold=CLUSTER_THRESHOLD, device="cpu")
    cpu_result = on_cpu(*on_cpu.model.preprocess(embeddings_txt))
    check([(s.start, s.end, t, l) for s, t, l in result.itertracks(yield_label=True)]
          == [(s.start, s.end, t, l) for s, t, l in cpu_result.itertracks(yield_label=True)],
          "cluster labels: card == CPU")
    check(set(labels) <= {p.identifier for p in ordered} and len(labels) > 0,
          "every clustered track is a track of tracking.txt")

    # each track's identity: the episode's face at its frames (one per frame)
    votes = {}
    for p in ordered:
        faces = truth[int(round(p.t * fps))]
        if faces:
            votes.setdefault(p.identifier, []).append(faces[0][1])
    identity = {t: max(set(v), key=v.count) for t, v in votes.items()}
    mixed = sum(any(labels[o] == labels[t] and identity[o] != identity[t]
                    for o in labels if o != t) for t in labels)
    emit({"phase": "cluster", "threshold": CLUSTER_THRESHOLD,
          "tracks": len(labels), "clusters": len(set(labels.values())),
          "identities": len(set(identity.values())),
          "tracks_sharing_a_cluster_with_another_identity": mixed,
          "card_equals_cpu": True, "seconds": seconds})


def orb_bytes(B: int, H: int, W: int, K: int) -> int:
    """Bytes one ``detect_and_describe`` must move: the gray frames read
    once, keypoints, ``valid`` and float32 descriptors written once."""
    return 4 * B * H * W + B * K * (3 * 4 + 1 + 256 * 4)


def phase_thread(tmp):
    """shot -> thread -> scene through stage files, card against CPU."""
    import torch

    from pyannote_video_tpu_torch.cli.structure_cli import (do_scene, do_shot,
                                                            do_thread)
    from pyannote_video_tpu_torch.core import load
    from pyannote_video_tpu_torch.io.video import Video
    from pyannote_video_tpu_torch.ops.color import ingest_gray_resize_first
    from pyannote_video_tpu_torch.ops.orb import (batched_ratio_matches,
                                                  detect_and_describe)
    from pyannote_video_tpu_torch.pipeline.thread import Thread
    from pyannote_video_tpu_torch.utils.metrics import pairwise_prf

    frames, fps, cuts = make_episode(8, 20, THREAD_PATTERN)[:3]
    video = Video(frames, fps=fps)
    d = Path(tmp, "thread")
    d.mkdir()
    t0 = time.perf_counter()
    do_shot(video, str(d / "shot.json"), device="cuda")
    shot_s = time.perf_counter() - t0
    with open(d / "shot.json") as fp:
        shots = list(load(fp))
    found = [s.end for s in shots[:-1]]
    check(len(found) == len(cuts) and all(
        abs(c - g) <= 1.5 / fps for c, g in zip(cuts, found)),
        f"thread episode: boundaries {found} at cuts {cuts}")

    files = {}
    for dev in ("cuda", "cpu"):
        thread_json, scene_json = d / f"thread_{dev}.json", d / f"scene_{dev}.json"
        if dev == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        do_thread(video, str(d / "shot.json"), str(thread_json), device=dev)
        seconds = time.perf_counter() - t0
        do_scene(video, str(thread_json), str(scene_json))
        files[dev] = (thread_json.read_bytes(), scene_json.read_bytes(), seconds)
    check(files["cuda"][:2] == files["cpu"][:2],
          "thread.json and scene.json: card == CPU, byte for byte")
    with open(d / "thread_cuda.json") as fp:
        threads = list(load(fp).itertracks(yield_label=True))
    with open(d / "scene_cuda.json") as fp:
        scenes = [label for _, _, label in load(fp).itertracks(yield_label=True)]
    check(len(threads) == len(shots) == len(scenes), "one label per shot")
    f1 = pairwise_prf({i: lab for i, (_, _, lab) in enumerate(threads)},
                      dict(enumerate(THREAD_PATTERN)))["f1"]
    check(f1 == 1.0, f"thread pairwise F1 {f1}")
    check(len(set(scenes[:4])) == 1 and len(set(scenes[4:])) == 1
          and scenes[0] != scenes[4], f"scenes {scenes}")

    # ORB on the collar frames, and every pair's count, card against CPU
    feats, counts = {}, {}
    for dev in ("cuda", "cpu"):
        th = Thread(video, shot=shots, lookahead=24, device=dev)
        th._compute_features(shots)
        scorable = th._scorable_pairs(shots)
        counts[dev] = th._pair_counts(scorable)
    # the collar frames (20-frame shots: a shot's two collar times are its
    # middle frame, so fewer than 16), then a full batch of 16 frames, two
    # per shot, at which the programs are timed
    times = th._collar_times(shots)
    spread = [s.start + f * s.duration for s in shots for f in (0.25, 0.75)]
    for batch in (times, spread):
        raw = torch.from_numpy(np.stack([video(t) for t in batch])).cuda()
        grays = ingest_gray_resize_first(raw, th._out_h, th._out_w)
        for dev in ("cuda", "cpu"):
            feats.setdefault(dev, []).append(
                [a.cpu() for a in detect_and_describe(grays.to(dev))])
    check(tuple(grays.shape) == (16, 200, 356), f"ORB batch {tuple(grays.shape)}")
    k, v, desc = (torch.cat(a) for a in zip(*feats["cuda"]))
    k_cpu, v_cpu, desc_cpu = (torch.cat(a) for a in zip(*feats["cpu"]))
    check(torch.equal(v, v_cpu), "ORB valid: card == CPU")
    check(torch.equal(k[..., :2], k_cpu[..., :2]), "ORB keypoints: card == CPU")
    angle_share = float((k[..., 2] == k_cpu[..., 2])[v].float().mean())
    desc_share = float((desc == desc_cpu).float().mean())
    check(angle_share >= ORB_ANGLE_SHARE, f"ORB angle bins equal on {angle_share}")
    check(desc_share >= ORB_DESC_SHARE, f"ORB descriptor bits equal on {desc_share}")
    check(counts["cuda"] == counts["cpu"], "pair counts: card == CPU")
    pairs = [(shots.index(a), shots.index(b)) for a, b, _, _ in scorable]
    same = [n for (i, j), n in zip(pairs, counts["cuda"])
            if THREAD_PATTERN[i] == THREAD_PATTERN[j]]
    cross = [n for (i, j), n in zip(pairs, counts["cuda"])
             if THREAD_PATTERN[i] != THREAD_PATTERN[j]]
    check(len(pairs) == 28 and min(same) >= SAME_THREAD_MIN
          and max(cross) <= CROSS_THREAD_MAX,
          f"margins: same-thread {same}, cross-thread {cross}")

    # launches, device time, wall time and bytes of the two programs
    store, store_valid = th._feature_store()
    rows = torch.arange(64) % len(times)
    r1, r2 = rows.cuda(), rows.roll(1).cuda()
    d1, v1 = store.cuda()[r1], store_valid.cuda()[r1]
    d2, v2 = store.cuda()[r2], store_valid.cuda()[r2]
    B, H, W = grays.shape
    K = k.shape[1]
    programs = {}
    for name, fn, nbytes, ops in (
            ("detect_and_describe", lambda: detect_and_describe(grays),
             orb_bytes(B, H, W, K), None),
            ("batched_ratio_matches_64", lambda: batched_ratio_matches(d1, v1, d2, v2),
             d1.numel() * 2 + v1.numel() * 2 + 64 * 4, 2 * 64 * K * K * 256)):
        ms = wall_ms(fn)
        launches, device_ms = device_profile(fn)
        programs[name] = {"launches": launches, "device_ms": device_ms,
                          "wall_ms": ms, "bytes": nbytes,
                          "hbm_ms": nbytes / HBM_BYTES_PER_S * 1e3}
        if ops:
            programs[name].update(f32_ops=ops, f32_ms=ops / F32_OPS_PER_S * 1e3)
    emit({"phase": "thread", "size": [1280, 720], "frames": len(frames),
          "shots": len(shots), "orb_batch": [B, H, W], "max_keypoints": K,
          "pairs": len(pairs), "thread_f1": f1, "threads": sorted(
              {lab for _, _, lab in threads}), "scenes": scenes,
          "same_thread_min": min(same), "cross_thread_max": max(cross),
          "collar_frames": len(times), "orb_frames_compared": len(v),
          "orb_valid_per_frame": [int(n) for n in v.sum(dim=1)],
          "orb_angles_differing": int((k[..., 2] != k_cpu[..., 2])[v].sum()),
          "orb_desc_bits_differing": int((desc != desc_cpu).sum()),
          "orb_angle_share": angle_share, "orb_desc_share": desc_share,
          "files_card_equal_cpu": True, "do_shot_s": shot_s,
          "do_thread_s": files["cuda"][2], "do_thread_cpu_s": files["cpu"][2],
          **programs})


def phase_farneback(frames, fps, cuts):
    """``Shot(method="farneback")`` and one shot chunk's flow, card
    against CPU."""
    import torch

    from pyannote_video_tpu_torch.io.video import Video
    from pyannote_video_tpu_torch.ops.color import ingest_gray
    from pyannote_video_tpu_torch.ops.flow import (dfd_series_farneback,
                                                   farneback_flow,
                                                   warped_residual)
    from pyannote_video_tpu_torch.pipeline.shot import Shot

    out = {"phase": "farneback", "size": [1280, 720], "height": 50,
           "threshold": FARNEBACK_THRESHOLD}
    found = {}
    for dev in ("cuda", "cpu"):
        if dev == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        found[dev] = [s.end for s in Shot(Video(frames, fps=fps), method="farneback",
                                          threshold=FARNEBACK_THRESHOLD,
                                          device=dev)][:-1]
        out[f"shot_{dev}_s"] = time.perf_counter() - t0
    check(len(found["cuda"]) == len(cuts) and all(
        abs(c - g) <= 1.5 / fps for c, g in zip(cuts, found["cuda"])),
        f"farneback boundaries {found['cuda']} at cuts {cuts}")
    check(found["cuda"] == found["cpu"], "farneback boundaries: card == CPU")

    gray = ingest_gray(torch.from_numpy(frames[:257]).cuda(), 50, 89)
    prev, cur = gray[:-1], gray[1:]
    flow = farneback_flow(prev, cur)
    resid = warped_residual(prev, cur, flow)
    flow_cpu = farneback_flow(prev.cpu(), cur.cpu())
    resid_cpu = warped_residual(prev.cpu(), cur.cpu(), flow_cpu)
    err = (flow.cpu() - flow_cpu).abs()
    share = float((err <= FLOW_TOL).all(dim=-1).float().mean())
    rel = float(((resid.cpu() - resid_cpu).abs() / resid_cpu.abs()).max())
    check(share >= FLOW_SHARE, f"flow within {FLOW_TOL} px on {share}")
    check(rel <= FLOW_DFD_RTOL, f"warped residual card vs CPU rel {rel}")
    ms = wall_ms(lambda: dfd_series_farneback(gray))
    launches, device_ms = device_profile(lambda: dfd_series_farneback(gray))
    # bytes: the chunk read once and the series written once
    nbytes = gray.numel() * 4 + (gray.shape[0] - 1) * 4
    out.update(boundaries=len(found["cuda"]), cuts=len(cuts),
               chunk=list(gray.shape), flow_share_within_tol=share,
               flow_max_abs_err=float(err.max()), residual_max_rel_err=rel,
               chunk_launches=launches, chunk_device_ms=device_ms,
               chunk_wall_ms=ms, chunk_bytes=nbytes,
               chunk_hbm_ms=nbytes / HBM_BYTES_PER_S * 1e3)
    emit(out)


def state_bytes(*states) -> int:
    """Bytes of every tensor in (nested) parameter states."""
    def tensors(node):
        if isinstance(node, dict):
            for v in node.values():
                yield from tensors(v)
        elif hasattr(node, "numel"):
            yield node

    return sum(t.numel() * t.element_size() for s in states for t in tensors(s))


def phase_fused(tmp, frames, fps, cuts, gt):
    """The fused detect -> align -> embed program and its detect-only half
    on 64 frames of the episode, bf16, 8 face slots per frame, with the packaged detector,
    refiner, 15-stage cascade and ResNet-29 at width 1.0; ``entry()``,
    ``device_trace``, ``ShotScheduler`` and ``dfd_pairs_reference_style``
    on the card."""
    import json

    import torch

    from pyannote_video_tpu_torch.core import Segment
    from pyannote_video_tpu_torch.entry import entry
    from pyannote_video_tpu_torch.models import chip, embedder, landmarks
    from pyannote_video_tpu_torch.models.detector import FaceDetector
    from pyannote_video_tpu_torch.models.detector import (level_dims,
                                                          pyramid_candidates)
    from pyannote_video_tpu_torch.models.fused import (FusedFacePipeline,
                                                       _device_nms)
    from pyannote_video_tpu_torch.models.refiner import refine_scores
    from pyannote_video_tpu_torch.ops.color import ingest_gray, to_gray
    from pyannote_video_tpu_torch.ops.dfd import dfd_pairs_reference_style
    from pyannote_video_tpu_torch.parallel.scheduler import (ShotScheduler,
                                                             merge_results)
    from pyannote_video_tpu_torch.utils.profiling import device_trace

    M, N = FUSED_FACES, FUSED_FRAMES
    pipe = FusedFacePipeline(device="cuda")
    check(pipe.max_faces == M and "refiner" in pipe.detector_params,
          "the fused pipeline serves the packaged detector and refiner, 8 slots")
    check(pipe.landmark_params["n_stages"] == 15
          and pipe.embedder_params["stem"]["w"].shape[0] == 32,
          "the fused pipeline runs the 15-stage cascade and ResNet-29 at width 1.0")
    H, W = frames.shape[1:3]
    out = {"phase": "fused", "size": [W, H], "frames": N, "face_slots": M,
           "compute_dtype": "bfloat16"}
    picks = list(range(0, len(frames), len(frames) // N))[:N]
    host = frames[picks]
    stack = torch.from_numpy(host).cuda()
    detect = pipe.build_detect_only(H, W)
    fused = pipe._build(H, W)
    args = (pipe.detector_params, pipe.embedder_params, pipe.landmark_arrays)

    def slots(boxes, valid):
        return [[tuple(b) for b, v in zip(bs.tolist(), vs.tolist()) if v]
                for bs, vs in zip(boxes, valid)]

    # detect-only against FaceDetector (same weights and dtype, host NMS),
    # truncated to the slots, and against the truth
    det = FaceDetector(device="cuda")
    boxes, scores, valid = (t.cpu() for t in detect(pipe.detector_params, stack))
    found = slots(boxes, valid)
    ref = [d[:M] for d in det.detect_batch(host)]
    check(boxes_agree(found, ref) and boxes_agree(ref, found),
          "detect-only == FaceDetector truncated to 8 slots (count, IoU >= 0.9)")
    hits = sum(any(box_iou(g, d) >= 0.5 for d in dets)
               for boxes_gt, dets in zip([gt[i] for i in picks], found)
               for g in boxes_gt)
    total = sum(len(gt[i]) for i in picks)
    check(hits / total >= 0.9, f"detect-only recall {hits / total}")
    out["detect_only"] = {"recall_iou50": hits / total, "gt_faces": total,
                          "detections": int(valid.sum()),
                          "equals_face_detector": True}
    # the detection frames of a 128-frame shot, every 5th (bench.py's batch)
    shot = frames[0:128:5]
    sb, _, sv = (t.cpu() for t in detect(pipe.detector_params,
                                         torch.from_numpy(shot).cuda()))
    check(len(shot) == 26 and boxes_agree(slots(sb, sv),
                                          [d[:M] for d in det.detect_batch(shot)]),
          "detect-only on the 26 detection frames of a 128-frame shot")
    out["detect_only_shot_batch"] = {"frames": len(shot),
                                     "detections": int(sv.sum())}

    # the fused program on the same frames: detect-only's slots, and for the
    # valid slots the port's own extract pieces on the same boxes
    res = fused(*args, stack)
    check(torch.equal(res.valid.cpu(), valid), "fused valid == detect-only valid")
    check(boxes_agree(slots(res.boxes.cpu(), valid), found),
          "fused boxes == detect-only boxes")
    out["fused_vs_detect_only_max_box_diff_px"] = float(
        (res.boxes.cpu() - boxes).abs()[valid].max())
    fi, si = valid.nonzero(as_tuple=True)
    fi_d, si_d = fi.cuda(), si.cuda()
    with torch.no_grad():
        lm_ref = landmarks.predict_crops(pipe.landmark_params, to_gray(stack),
                                         fi_d, boxes[fi, si].cuda())
        emb_ref = embedder.forward(pipe.embedder_params,
                                   chip.extract_chips(stack, fi_d, lm_ref))
    out["landmarks_vs_extract"] = landmark_agreement(
        res.landmarks[fi_d, si_d].cpu().numpy(), lm_ref.cpu().numpy(),
        "fused landmarks vs predict_crops")
    dist = float((res.embeddings[fi_d, si_d] - emb_ref).norm(dim=1).max())
    check(dist <= EMBED_BF16_DIST, f"fused embeddings vs extract pieces {dist}")
    check(bool(torch.isfinite(res.embeddings).all()), "fused embeddings finite")
    out["embeddings_vs_extract_max_dist"] = dist

    # card against CPU in float32, on 2 frames
    r32 = {}
    for dev in ("cuda", "cpu"):
        o = FusedFacePipeline(compute_dtype=torch.float32, device=dev)(host[:2])
        r32[dev] = [t.cpu() for t in o]
    (cb, _, cv, cl, ce), (pb, _, pv, pl, pe) = r32["cuda"], r32["cpu"]
    check(torch.equal(cv, pv) and bool(pv.any()), "f32 valid: card == CPU")
    check(boxes_agree(slots(cb, cv), slots(pb, pv)), "f32 boxes: card vs CPU")
    emb_err = float((ce[pv] - pe[pv]).abs().max())
    check(emb_err <= EMBED_F32_TOL, f"f32 embeddings card vs CPU {emb_err}")
    out["card_vs_cpu_f32"] = {
        "faces": int(pv.sum()), "box_max_diff_px": float((cb - pb).abs()[pv].max()),
        "landmarks": landmark_agreement(cl[pv].numpy(), pl[pv].numpy(),
                                        "f32 fused landmarks card vs CPU"),
        "embedding_max_abs_err": emb_err}

    # entry()
    fn, eargs = entry()
    eout = fn(*eargs)
    torch.cuda.synchronize()
    out["entry_shapes"] = {k: list(v.shape) for k, v in eout._asdict().items()}
    check(out["entry_shapes"] == {"boxes": [2, 4, 4], "scores": [2, 4],
                                  "valid": [2, 4], "landmarks": [2, 4, 68, 2],
                                  "embeddings": [2, 4, 128]}, "entry() shapes")

    # device_trace around one fused call
    logdir = Path(tmp, "trace")
    with device_trace(str(logdir)):
        fused(*args, stack)
    traces = list(logdir.glob("*.pt.trace.json"))
    check(len(traces) == 1, "device_trace wrote one trace")
    events = json.loads(traces[0].read_text())["traceEvents"]
    n_kernels = sum(e.get("cat") == "kernel" for e in events)
    check(n_kernels > 0, "the trace holds CUDA kernels")
    out["device_trace"] = {"events": len(events), "kernels": n_kernels,
                           "bytes": traces[0].stat().st_size}

    # ShotScheduler: two workers on one card, merged, against a plain loop
    bounds = [0.0] + list(cuts) + [len(frames) / fps]
    shots = [Segment(a, b) for a, b in zip(bounds[:-1], bounds[1:])]

    def count(segment):
        idx = [i for i in range(0, len(frames), 4)
               if segment.start <= i / fps < segment.end]
        _, _, v = detect(pipe.detector_params, torch.from_numpy(frames[idx]).cuda())
        return int(v.sum())

    results = []
    for rank in (0, 1):
        results += list(ShotScheduler([torch.device("cuda", 0)], rank=rank,
                                      world=2).run(shots, count))
    sequential = [count(s) for s in shots]
    check(merge_results(results) == sequential,
          f"scheduler {merge_results(results)} == loop {sequential}")
    out["scheduler"] = {"shots": len(shots), "workers": 2,
                        "detections_per_shot": sequential}

    # dfd_pairs_reference_style: the kernel against the plain version
    gray = ingest_gray(torch.from_numpy(frames[:65]).cuda(), 50, 89)
    pairs = dfd_pairs_reference_style(gray[:-1], gray[1:])
    plain = dfd_pairs_reference_style(gray[:-1].cpu(), gray[1:].cpu())
    err = float((pairs.cpu() - plain).abs().max())
    check(pairs.shape == (64,) and err <= DFD_TOL,
          f"dfd_pairs_reference_style card vs plain {err}")
    out["dfd_pairs_max_abs_err"] = err

    # the NMS rounds alone, on this batch's thresholded candidates
    frames_f = stack.float()
    with torch.no_grad():
        cand_scores, cand_boxes = pyramid_candidates(
            pipe.detector_params, frames_f, level_dims(H, W))
        cand_scores = refine_scores(pipe.detector_params["refiner"], frames_f,
                                    cand_scores, cand_boxes)
    cand_scores = torch.where(cand_scores > pipe.threshold, cand_scores,
                              torch.full_like(cand_scores, float("-inf")))
    del frames_f

    def nms():
        return _device_nms(cand_boxes, cand_scores, pipe.nms_iou, M)

    check(torch.equal(nms()[2].cpu(), valid), "NMS alone == detect-only valid")
    launches, device_ms = device_profile(nms)
    out["nms"] = {"candidates": list(cand_scores.shape), "launches": launches,
                  "device_ms": device_ms, "wall_ms": wall_ms(nms)}

    # one detect-only and one fused call at [64, H, W, 3] uint8
    frames_bytes = stack.numel()
    det_params = state_bytes(pipe.detector_params)
    costs = {
        "detect_only": (lambda: detect(pipe.detector_params, stack),
                        frames_bytes + det_params + N * M * (16 + 4 + 1)),
        "fused": (lambda: fused(*args, stack),
                  frames_bytes + state_bytes(*args)
                  + N * M * (16 + 4 + 1 + 68 * 2 * 4 + 128 * 4)),
    }
    for name, (call, nbytes) in costs.items():
        ms = wall_ms(call)
        launches, device_ms = device_profile(call)
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        call()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        out.setdefault(name, {}).update(launches=launches, device_ms=device_ms, wall_ms=ms,
                         frames_per_s=N / ms * 1e3,
                         face_slots_per_s=N * M / ms * 1e3, bytes=nbytes,
                         hbm_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                         peak_device_bytes=peak,
                         peak_above_resident_bytes=peak - resident)
    emit(out)


def loss_and_grads(loss_fn, params, batch):
    """(loss, gradients by flat key, moved batch-norm statistics), on the
    host, of ``loss_fn`` on ``params`` and ``batch`` where they live."""
    import torch

    from pyannote_video_tpu_torch.models import nn

    leaves = {k: v.detach().requires_grad_(True)
              for k, v in nn.trainable_leaves(params).items()}
    loss, moved = loss_fn(nn.with_leaves(params, leaves), *batch)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    stats = {k: v.detach().cpu() for k, v in nn.flatten_params(moved).items()
             if k.endswith(("mean", "var"))}
    return float(loss.detach()), {k: g.cpu() for k, g in zip(leaves, grads)}, stats


def step_agreement(loss_fn, params, batch, make_opt) -> dict:
    """One step of a trainer on the card against the same step
    through the plain CPU path, same params and batch, float32 with TF32
    off: loss, every gradient, the moved statistics and the parameters
    after Adam."""
    import torch

    from pyannote_video_tpu_torch.models import nn
    from pyannote_video_tpu_torch.train.optim import train_step

    on = {dev: (nn.state_to(params, torch.device(dev)),
                [b.to(dev) for b in batch]) for dev in ("cuda", "cpu")}
    card, cpu = (loss_and_grads(loss_fn, *on[dev]) for dev in ("cuda", "cpu"))
    loss_rel = abs(card[0] - cpu[0]) / abs(cpu[0])
    check(np.isfinite(card[0]) and loss_rel <= TRAIN_LOSS_RTOL,
          f"loss card {card[0]} vs CPU {cpu[0]}")
    scale = max(float(g.abs().max()) for g in cpu[1].values())
    grad_rel = 0.0
    for key, g in cpu[1].items():
        err = float((card[1][key] - g).abs().max())
        rel = err / max(float(g.abs().max()), 1e-2 * scale)
        grad_rel = max(grad_rel, rel)
        check(rel <= TRAIN_GRAD_TOL, f"gradient {key}: card vs CPU {rel}")
    stat_rel = max(float(((card[2][k] - v).abs() / v.abs().clamp_min(1e-3)).max())
                   for k, v in cpu[2].items())
    check(stat_rel <= TRAIN_STAT_RTOL, f"statistics card vs CPU {stat_rel}")
    after = []
    for p, b in (on["cuda"], on["cpu"]):
        state, opt = make_opt(p)
        new, _ = train_step(loss_fn, state, opt, *b)
        after.append(nn.flatten_params(nn.state_to(new, torch.device("cpu"))))
    rate = opt.rate(0)
    param_err = noise_err = 0.0
    for key, g in cpu[1].items():
        diff = (after[0][key] - after[1][key]).abs()
        clear = g.abs() > 1e-3 * scale
        if clear.any():
            param_err = max(param_err, float(diff[clear].max()))
        if (~clear).any():
            noise_err = max(noise_err, float(diff[~clear].max()))
    check(param_err <= TRAIN_PARAM_TOL, f"parameters after the step {param_err}")
    check(noise_err <= 2 * rate + TRAIN_PARAM_TOL,
          f"parameters of noise-level gradients moved {noise_err}")
    return {"loss_card": card[0], "loss_cpu": cpu[0], "loss_rel": loss_rel,
            "grad_rel": grad_rel, "stat_rel": stat_rel,
            "param_err": param_err, "noise_param_err": noise_err}


def timed_steps(loss_fn, params, opt, batch, n: int = TRAIN_STEPS) -> tuple:
    """``n`` steps on the card: wall ms of each (ending in a synchronise),
    its loss, peak device memory; then ``n`` more, each under
    torch.profiler alone, for its launches and device ms; then one whose
    operations torch counts."""
    import torch

    from pyannote_video_tpu_torch.train.optim import train_step

    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    walls, losses = [], []
    for _ in range(n):
        t0 = time.perf_counter()
        params, loss = train_step(loss_fn, params, opt, *batch)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
    peak = torch.cuda.max_memory_allocated()
    losses = [float(v) for v in losses]
    check(bool(np.isfinite(losses).all()), f"finite losses {losses}")
    holder = [params]

    def one():
        holder[0], _ = train_step(loss_fn, holder[0], opt, *batch)

    profiled = [device_profile(one) for _ in range(n)]
    # the step's convolution and matrix operations (forward and backward),
    # counted by torch; their least time at the float32 peak
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        holder[0], _ = train_step(loss_fn, holder[0], opt, *batch)
    flops = counter.get_total_flops()
    samples = len(batch[0])
    return holder[0], {
        "steps": n, "wall_ms": walls, "losses": losses,
        "launches": [p[0] for p in profiled],
        "device_ms": [p[1] for p in profiled],
        "operations_per_step": flops,
        "bound_ms": flops / F32_OPS_PER_S * 1e3, "bound_by": "operations",
        "samples_per_s": samples / float(np.median(walls)) * 1e3,
        "peak_device_bytes": peak, "peak_above_resident_bytes": peak - resident}


def saved_and_read_back(tmp, name, params, forward, x) -> float:
    """``save_params`` to ``tmp``, ``load_params`` back: the forward on the
    read-back state against the forward on the state saved."""
    import torch

    from pyannote_video_tpu_torch.models import nn

    path = Path(tmp, f"{name}.npz")
    nn.save_params(path, params)
    back = nn.state_to(nn.load_params(path), x.device)
    with torch.no_grad():
        a = forward(params, x, compute_dtype=torch.float32)
        b = forward(back, x, compute_dtype=torch.float32)
    err = float((a - b).abs().max())
    check(err <= 1e-6, f"{name}: forward on the read-back state differs by {err}")
    return err


def run_main(module, argv) -> dict:
    """A trainer's ``main`` on the card, its step lines captured: wall
    seconds and the logged losses (finite)."""
    import importlib
    import io

    main_fn = importlib.import_module(
        f"pyannote_video_tpu_torch.train.{module}").main
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        check(main_fn(argv) == 0, f"{module}.main {argv}")
    seconds = time.perf_counter() - t0
    losses = [float(line.split()[3]) for line in out.getvalue().splitlines()
              if line.startswith("step")]
    check(len(losses) >= 1 and bool(np.isfinite(losses).all()),
          f"{module}.main losses {losses}")
    check(Path(argv[1]).exists(), f"{module}.main wrote {argv[1]}")
    return {"argv": argv[:1] + argv[2:], "seconds": seconds, "losses": losses}


def phase_train(tmp):
    """The trainers on the card at their own defaults (full width), each
    step held against the plain CPU path; the miners' refreshes; the
    landmark trainer's data without OpenCV."""
    import torch

    from pyannote_video_tpu_torch.models import detector, embedder, nn, refiner
    from pyannote_video_tpu_torch.models.weights import default_embedder_params
    from pyannote_video_tpu_torch.train import (data, mine, optim,
                                                train_detector,
                                                train_embedder,
                                                train_landmarks,
                                                train_refiner)

    t_phase = time.perf_counter()
    cuda = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    out = {"phase": "train", "dtype": "float32"}

    # embedder: ResNet-29 at width 1.0 from the packaged file (--resume),
    # 16 identities x 3 = 48 chips of 150², clip(5) -> adam(1e-3)
    params = default_embedder_params()
    check(params["stem"]["w"].shape[0] == 32, "ResNet-29 at width 1.0")
    bank = data.identity_bank(512, seed=1)
    t0 = time.perf_counter()
    chips, labels = data.embedding_batch(rng, bank, n_ident=16, per_ident=3)
    render_s = time.perf_counter() - t0
    batch = train_embedder.batch_tensors(chips, labels, "cpu")
    check(tuple(batch[0].shape) == (48, 150, 150, 3), "48 chips of 150²")

    def embedder_opt(p):
        return optim.adam(p, 1e-3, max_norm=5.0)

    row = {"batch": 48, "width": 1.0, "render_s": render_s,
           "card_vs_cpu": step_agreement(train_embedder.loss_fn, params, batch,
                                         embedder_opt)}
    state = nn.state_to(params, cuda)
    state, row["run"] = timed_steps(train_embedder.loss_fn, *embedder_opt(state),
                                    [b.to(cuda) for b in batch])
    row["save_read_back_err"] = saved_and_read_back(
        tmp, "embedder", state, embedder.forward, batch[0][:4].to(cuda))
    row["main"] = run_main("train_embedder",
                           ["2", str(Path(tmp, "embedder_main.npz")), "--resume"])
    out["embedder"] = row

    # detector: deep_width 96 from a seeded init, batch 16 of 128², cosine
    # adam(3e-4); the mining refresh at step 0 (8 + 8 frames of 360x480
    # through the bf16 pyramid)
    params = detector.init_params(torch.Generator().manual_seed(0), deep_width=96)
    t0 = time.perf_counter()
    frames, boxes, hard = data.detection_batch(rng, batch=16, height=128,
                                               width=128, return_hard=True)
    render_s = time.perf_counter() - t0
    batch = train_detector.batch_tensors(
        frames, *data.detection_targets(boxes, 128, 128), hard, "cpu")

    def detector_opt(p):
        return optim.adam(p, optim.cosine_decay_schedule(3e-4, 600, alpha=0.1))

    row = {"batch": 16, "size": 128, "deep_width": 96, "render_s": render_s,
           "card_vs_cpu": step_agreement(train_detector.loss_fn, params, batch,
                                         detector_opt)}
    state = nn.state_to(params, cuda)
    miner = mine.HardNegativeMiner(crop=128, seed=77, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    found = miner.refresh(state)
    found_pos = miner.refresh_positives(state)
    refresh_s = time.perf_counter() - t0
    check(miner.frames_per_refresh == 8 and len(miner) == found,
          "the refresh ran 8 frames and stored what it found")
    row["mining_refresh"] = {
        "frames": 2 * miner.frames_per_refresh, "size": [mine.MINE_W, mine.MINE_H],
        "wall_s": refresh_s, "render_s": miner.render_seconds,
        "negatives": found, "positives": found_pos,
        "max_logit": miner.last_max_logit}
    # the miner's bf16 pyramid, card vs CPU, on 2 of its frames
    two = np.stack([mine.negative_frame(np.random.default_rng(s)) for s in (1, 2)])
    dims = miner._dims
    levels = {dev: mine._read_levels(mine._pyramid_maps(
        nn.state_to(params, torch.device(dev)),
        torch.from_numpy(two).to(dev, torch.float32), dims))
        for dev in ("cuda", "cpu")}
    agree = total = 0
    logit_rel = 0.0
    for (cl, _), (pl, _) in zip(levels["cuda"], levels["cpu"]):
        logit_rel = max(logit_rel, float(np.abs(cl - pl).max())
                        / max(float(pl.max() - pl.min()), 1e-6))
        for b in range(len(two)):
            top_c = set(np.argsort(cl[b].ravel())[::-1][:mine.MINE_PER_FRAME])
            top_p = set(np.argsort(pl[b].ravel())[::-1][:mine.MINE_PER_FRAME])
            agree, total = agree + len(top_c & top_p), total + len(top_p)
    check(logit_rel <= 0.05, f"miner logits card vs CPU {logit_rel} of the span")
    check(agree >= 0.8 * total, f"miner top cells card vs CPU {agree}/{total}")
    row["mining_card_vs_cpu"] = {"logit_rel_span": logit_rel,
                                 "top_cells_shared": agree / total}
    state, row["run"] = timed_steps(train_detector.loss_fn, *detector_opt(state),
                                    [b.to(cuda) for b in batch])
    row["save_read_back_err"] = saved_and_read_back(
        tmp, "detector", state, detector.forward_maps, batch[0][:4].to(cuda))
    row["main"] = run_main("train_detector",
                           ["2", str(Path(tmp, "detector_main.npz"))])
    out["detector"] = row

    # refiner: widths (32, 64, 96, 128) from a seeded init, 64² crops from
    # a ServeMiner refresh on the packaged stage 1
    no_refine = os.environ.get("PYV_NO_REFINE")
    serve = train_refiner.ServeMiner(seed=7, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    serve.refresh()
    refresh_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    crops, labels, hard = train_refiner.pad_to_bucket(
        *train_refiner.crop_batch(rng, serve))
    render_s = time.perf_counter() - t0
    batch = train_refiner.batch_tensors(crops, labels, hard, "cpu")
    params = refiner.init_params(torch.Generator().manual_seed(0))
    check(params["c4"]["w"].shape[0] == 128, "refiner widths (32, 64, 96, 128)")

    def refiner_opt(p):
        return optim.adam(p, optim.cosine_decay_schedule(3e-4, 3000, alpha=0.1))

    row = {"batch": len(crops), "crop": refiner.CROP,
           "serve_refresh": {"frames": train_refiner.MINE_FRAMES,
                             "wall_s": refresh_s,
                             "render_s": serve.render_seconds,
                             "negatives": len(serve.neg),
                             "positives": len(serve.pos)},
           "batch_render_and_crop_s": render_s,
           "card_vs_cpu": step_agreement(train_refiner.loss_fn, params, batch,
                                         refiner_opt)}
    state = nn.state_to(params, cuda)
    state, row["run"] = timed_steps(train_refiner.loss_fn, *refiner_opt(state),
                                    [b.to(cuda) for b in batch])
    row["save_read_back_err"] = saved_and_read_back(
        tmp, "refiner", state, refiner.forward, batch[0][:8].to(cuda))
    row["main"] = run_main("train_refiner",
                           ["2", str(Path(tmp, "refiner_main.npz"))])
    check(os.environ.get("PYV_NO_REFINE") == no_refine,
          "the refiner's miner and trainer leave PYV_NO_REFINE as it was")
    out["refiner"] = row

    # landmarks: the ERT trainer's data and one tree, host only, no OpenCV
    t0 = time.perf_counter()
    grays, boxes, gts = train_landmarks.make_dataset(n_images=8, size=96)
    mean_shape = np.asarray(train_landmarks.CANONICAL_LANDMARKS, np.float32)
    shapes = np.broadcast_to(mean_shape.reshape(1, -1), gts.shape).copy()
    lrng = np.random.default_rng(0)
    anchor = lrng.integers(0, train_landmarks.N_POINTS, 80).astype(np.int32)
    offset = lrng.uniform(-0.25, 0.25, (80, 2)).astype(np.float32)
    feats = train_landmarks.extract_features(grays, boxes, shapes, mean_shape,
                                             anchor, offset)
    pts = mean_shape[anchor] + offset
    cdf = train_landmarks._pair_cdf(np.sqrt(((pts[:, None] - pts[None]) ** 2).sum(-1)))
    tree = train_landmarks.fit_tree(feats, gts - shapes, lrng, cdf)
    check(grays.shape == (16, 96, 96) and np.isfinite(tree[3]).all(),
          "landmark data and one tree")
    check("cv2" not in sys.modules, "the trainers ran without OpenCV")
    out["landmarks"] = {"images": 8, "samples": len(grays),
                        "host_s": time.perf_counter() - t0}
    out["phase_s"] = time.perf_counter() - t_phase
    emit(out)


def lines_of(fn, *args) -> list:
    """What ``fn(*args)`` prints, line by line."""
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fn(*args)
    return out.getvalue().splitlines()


def check_dryrun(lines, n: int, mesh: dict) -> None:
    check(len(lines) == 4 and all(line.endswith(" OK") for line in lines)
          and lines[0].startswith(f"dryrun[train]: mesh={mesh} loss=")
          and lines[1].startswith("dryrun[fused]: ")
          and lines[2] == "dryrun[scheduler]: 2 workers x 6 shots merged OK"
          and lines[3].startswith(f"dryrun_multichip({n}): mesh={mesh}"),
          f"the dry run's lines: {lines}")


def phase_parallel():
    """The mesh path on one card (world 1): the sharded step against
    ``train_step`` of the same loss, the sharded forward against the
    plain one, ``run_dryrun(1)``; then the 2 x 2 dry run as four gloo
    processes on this machine's CPU."""
    import torch
    import torch.distributed as dist

    from pyannote_video_tpu_torch.entry import dryrun_multichip
    from pyannote_video_tpu_torch.models import embedder, nn
    from pyannote_video_tpu_torch.parallel import sharding
    from pyannote_video_tpu_torch.parallel.dryrun import run_dryrun
    from pyannote_video_tpu_torch.parallel.mesh import make_mesh, mesh_shape
    from pyannote_video_tpu_torch.train.optim import adam, train_step

    t_phase = time.perf_counter()
    cuda = torch.device("cuda")
    mesh = make_mesh()
    shape = mesh_shape(mesh)
    check(shape == {"data": 1, "model": 1}, f"make_mesh() on one card: {shape}")
    rng = np.random.default_rng(SEED)
    params = nn.state_to(embedder.init_params(torch.Generator().manual_seed(0),
                                              width=0.25), cuda)
    chips = torch.from_numpy(rng.integers(0, 255, (PARALLEL_BATCH, 150, 150, 3))
                             .astype(np.float32)).to(cuda)
    labels = torch.from_numpy(rng.integers(0, 4, (PARALLEL_BATCH,))).to(cuda)

    # the same arithmetic on both sides: cuDNN's deterministic algorithms
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        s_params, s_opt = adam(sharding.shard_params_for_tp(params, mesh), 1e-3)
        step = sharding.make_train_step(mesh, s_opt)
        u_params, u_opt = adam(params, 1e-3)
        s_losses, u_losses = [], []
        for _ in range(2):
            s_params, loss = step(s_params, chips, labels)
            s_losses.append(float(loss))
            u_params, loss = train_step(sharding.loss_fn, u_params, u_opt,
                                        chips, labels)
            u_losses.append(float(loss))
    finally:
        torch.backends.cudnn.deterministic = deterministic
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(s_losses, u_losses))
    check(loss_rel <= PARALLEL_RTOL, f"sharded loss {s_losses} vs {u_losses}")
    a, b = nn.flatten_params(s_params), nn.flatten_params(u_params)
    leaf_rel, equal = 0.0, 0
    for key, ref in b.items():
        if not isinstance(ref, torch.Tensor):
            continue
        equal += bool(torch.equal(a[key], ref))
        leaf_rel = max(leaf_rel, float((a[key] - ref).abs().max())
                       / max(float(ref.abs().max()), 1e-30))
    check(leaf_rel <= PARALLEL_RTOL, f"sharded leaves vs train_step: {leaf_rel}")
    with torch.no_grad():
        emb_err = float((sharding.sharded_embed_fn(mesh)(params, chips)
                         - embedder.forward(params, chips)).abs().max())
    check(emb_err <= 1e-6, f"sharded_embed_fn vs forward: {emb_err}")

    # the mesh path's overhead: ms per step and launches, sharded against
    # unsharded, in turns
    walls = {"sharded": [], "unsharded": []}
    for _ in range(PARALLEL_STEPS):
        for name in walls:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if name == "sharded":
                s_params, _ = step(s_params, chips, labels)
            else:
                u_params, _ = train_step(sharding.loss_fn, u_params, u_opt,
                                         chips, labels)
            torch.cuda.synchronize()
            walls[name].append((time.perf_counter() - t0) * 1e3)
    holder = {"sharded": s_params, "unsharded": u_params}

    def one(name):
        if name == "sharded":
            holder[name], _ = step(holder[name], chips, labels)
        else:
            holder[name], _ = train_step(sharding.loss_fn, holder[name], u_opt,
                                         chips, labels)

    profiled = {name: device_profile(lambda: one(name)) for name in walls}

    t0 = time.perf_counter()
    dryrun_1 = lines_of(run_dryrun, 1)
    dryrun_1_s = time.perf_counter() - t0
    check_dryrun(dryrun_1, 1, {"data": 1, "model": 1})
    dist.destroy_process_group()
    check(not dist.is_initialized(), "the one-card group is gone")
    t0 = time.perf_counter()
    dryrun_4 = lines_of(dryrun_multichip, 4, "cpu")
    dryrun_4_s = time.perf_counter() - t0
    check_dryrun(dryrun_4, 4, {"data": 2, "model": 2})
    emit({"phase": "parallel", "mesh": shape, "width": 0.25,
          "batch": PARALLEL_BATCH,
          "sharded_vs_train_step": {"losses": s_losses, "loss_rel": loss_rel,
                                    "leaf_rel": leaf_rel, "equal_leaves": equal,
                                    "leaves": sum(isinstance(v, torch.Tensor)
                                                  for v in b.values())},
          "embed_err": emb_err,
          "step_wall_ms": walls,
          "launches": {k: v[0] for k, v in profiled.items()},
          "device_ms": {k: v[1] for k, v in profiled.items()},
          "run_dryrun_1": {"lines": dryrun_1, "wall_s": dryrun_1_s},
          "dryrun_multichip_4_cpu": {"lines": dryrun_4, "wall_s": dryrun_4_s},
          "phase_s": time.perf_counter() - t_phase})


def phase_eval():
    """The quality harnesses on the card: the default episode in domains A
    and BC (domain A gated on the values the JAX matrix records at 1.0),
    the small episode and the detector probe card against CPU."""
    from pyannote_video_tpu_torch.evals.eval_synthetic import evaluate
    from pyannote_video_tpu_torch.evals.probe_detector import probe
    from pyannote_video_tpu_torch.ops.dfd import dfd_series

    t_phase = time.perf_counter()
    out = {"phase": "eval"}
    dfd_series.launches = 0
    rows = {domain: evaluate(seed=101, domain=domain) for domain in ("A", "BC")}
    out["dfd_launches"] = dfd_series.launches
    check(out["dfd_launches"] > 0, "the eval's Shot launched the dfd kernel")
    for key in EVAL_GATES:
        check(rows["A"][key] == 1.0, f"domain A {key} {rows['A'][key]}")
    out["default"] = rows

    card = evaluate(seed=101, domain="A", **EVAL_SMALL)
    cpu = evaluate(seed=101, domain="A", device="cpu", **EVAL_SMALL)
    for key in EVAL_EQUAL:
        check(card[key] == cpu[key], f"small episode {key}: card {card[key]} "
                                     f"CPU {cpu[key]}")
    lm = abs(card["landmark_err_interocular"] - cpu["landmark_err_interocular"])
    check(lm <= 1e-3, f"small episode landmark error card vs CPU {lm}")
    out["small"] = {"card": card, "cpu": cpu, "landmark_diff": lm}

    walls = {}
    t0 = time.perf_counter()
    p_card = probe("A", seeds=(101,))
    walls["probe_card_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    p_cpu = probe("A", seeds=(101,), device="cpu")
    walls["probe_cpu_s"] = time.perf_counter() - t0
    for key in ("gt", "missed_at_0.5", "fp_n"):
        check(p_card[key] == p_cpu[key], f"probe {key}: card {p_card[key]} "
                                         f"CPU {p_cpu[key]}")
    score_diff = max(abs(p_card[k] - p_cpu[k])
                     for k in ("real_min", "real_p5", "real_p25", "fp_max"))
    check(score_diff <= PROBE_SCORE_TOL, f"probe scores card vs CPU {score_diff}")
    out["probe"] = {"card": p_card, "cpu": p_cpu, "score_diff": score_diff,
                    "margin": p_card.get("margin"), **walls}
    out["phase_s"] = time.perf_counter() - t_phase
    emit(out)


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
    dfd_row = phase_dfd(phase_build())
    phase_dsst()
    frames, fps, cuts, gt, truth = make_episode()
    phase_extract_parts(frames, gt)
    phase_stream_ingest(frames, fps)

    # the main path: every launch count starts at 0 here
    dfd_series.launches = 0
    phase_shot(frames, fps, cuts)
    phase_detect(frames, gt)
    # shot -> track -> extract -> cluster through stage files in one
    # directory, by the default (streaming) engines
    with tempfile.TemporaryDirectory() as tmp:
        shots = phase_stream_track(tmp, frames, fps, cuts, gt)
        ordered = phase_stream_extract(tmp, frames, fps, truth)
        phase_cluster(tmp, ordered, fps, truth)
        # shot -> thread -> scene, on another episode
        phase_thread(tmp)
        dfd_row["launches"] = dfd_series.launches
        check(dfd_row["launches"] > 0, "the shot path launched the dfd kernel")
        # beside the main path: the older engines, two workers, the legs
        # alone, the Farneback shot method
        phase_older_engines(tmp, frames, fps, shots)
        phase_world2(tmp, frames, fps)
        phase_isolate_legs(tmp, frames, fps)
        phase_farneback(frames, fps, cuts)
        # the fused detect -> align -> embed program, after the counts were read
        phase_fused(tmp, frames, fps, cuts, gt)
        # the trainers
        phase_train(tmp)
    # the mesh path, then the quality harnesses
    phase_parallel()
    phase_eval()

    emit({"kernels": [dfd_row]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
