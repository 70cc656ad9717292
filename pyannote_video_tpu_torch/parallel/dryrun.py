"""Multi-device dry run: exercise the full sharded execution paths on a mesh.

Port of ``pyannote_video_tpu/parallel/dryrun.py``.  Covers the three
parallel paths of the framework:

1. the sharded **training step** (dp over the chip batch + tp over the
   embedder's wide filters, ``parallel/sharding.py``);
2. the sharded **fused inference program** (detect→align→embed with the
   frame batch dp-sharded, ``models/fused.py``);
3. the **shot scheduler** (shot-level work division across workers with
   deterministic merge, ``parallel/scheduler.py``).

The JAX dry run is one controller over N virtual CPU devices; here it is
N processes, one device each, every one running ``run_dryrun`` on its
share.  ``launch`` starts such a group (gloo on the CPU, NCCL with one card
per rank), which is how ``entry.py:dryrun_multichip`` runs it.
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

from ..utils.device import DeviceLike, resolve_device

_REPO = Path(__file__).resolve().parents[2]
LAUNCH_TIMEOUT_S = 600.0    # a group that outlives this is stopped


def launch(world: int, target: str, args=(), device: DeviceLike = None) -> tuple:
    """Run ``target`` (``"module:function"``) on ``world`` fresh processes
    that form one ``torch.distributed`` group, each calling
    ``function(*args)``.

    Ranks find each other through a file store in a temporary directory (no
    port).  On ``cuda`` (the default) the group is NCCL and rank ``r``
    takes card ``r``; with ``device="cpu"`` it is gloo and each rank runs
    torch on one thread.  The ranks import ``target`` from the repository
    and from the caller's ``PYTHONPATH``.  Returns ``(results, output)``:
    each rank's return value, and what rank 0 printed.  A rank that fails
    or outlives ``LAUNCH_TIMEOUT_S`` stops every rank and raises with its
    output.
    """
    device = resolve_device(device)
    if device.type == "cuda":
        import torch

        if world > torch.cuda.device_count():
            raise RuntimeError(f"{world} ranks need {world} cards; this "
                               f"machine has {torch.cuda.device_count()}")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(_REPO)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    with tempfile.TemporaryDirectory(prefix="pyv_launch_") as tmp:
        with open(Path(tmp, "args.pkl"), "wb") as fp:
            pickle.dump(tuple(args), fp)
        logs = [open(Path(tmp, f"rank{r}.log"), "w+") for r in range(world)]
        procs = [subprocess.Popen(
            [sys.executable, "-c",
             "import sys; from pyannote_video_tpu_torch.parallel.dryrun "
             "import _rank_main; sys.exit(_rank_main(sys.argv[1:]))",
             str(r), str(world), tmp, device.type, target],
            stdout=logs[r], stderr=subprocess.STDOUT, env=env, cwd=_REPO)
            for r in range(world)]
        try:
            deadline = time.monotonic() + LAUNCH_TIMEOUT_S
            while True:
                codes = [p.poll() for p in procs]
                failed = next((r for r, c in enumerate(codes) if c not in (None, 0)),
                              None)
                if failed is None and time.monotonic() > deadline:
                    failed = codes.index(None) if None in codes else None
                if failed is not None or None not in codes:
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        # the rank that failed first: the others may have failed of it
        first = {r: int(Path(tmp, f"rank{r}.failed").read_text())
                 for r in range(world) if Path(tmp, f"rank{r}.failed").exists()}
        if failed is not None and first:
            failed = min(first, key=first.get)
        text = []
        for log in logs:
            log.seek(0)
            text.append(log.read())
            log.close()
        if failed is not None:
            raise RuntimeError(f"rank {failed} of {world} failed (exit "
                               f"{procs[failed].returncode}):\n"
                               + text[failed][-4000:])
        results = []
        for r in range(world):
            with open(Path(tmp, f"rank{r}.pkl"), "rb") as fp:
                results.append(pickle.load(fp))
    return results, text[0]


def _rank_main(argv) -> int:
    """One rank of ``launch``: join the group, call the target, write its
    return value where ``launch`` reads it."""
    import datetime
    import importlib

    import torch
    import torch.distributed as dist

    rank, world, tmp, device_type, target = argv
    rank, world = int(rank), int(world)
    if device_type == "cuda":
        torch.cuda.set_device(rank)
    else:
        torch.set_num_threads(1)
    dist.init_process_group(
        "nccl" if device_type == "cuda" else "gloo",
        init_method=f"file://{tmp}/store", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=300))
    try:
        module, name = target.split(":")
        with open(Path(tmp, "args.pkl"), "rb") as fp:
            args = pickle.load(fp)
        result = getattr(importlib.import_module(module), name)(*args)
        with open(Path(tmp, f"rank{rank}.pkl"), "wb") as fp:
            pickle.dump(result, fp)
    except BaseException:
        # before the group closes, so before any other rank fails of it
        Path(tmp, f"rank{rank}.failed").write_text(str(time.time_ns()))
        raise
    finally:
        dist.destroy_process_group()
    return 0


def run_dryrun(n_devices: int, device: DeviceLike = None) -> None:
    """This rank's share of the dry run over an ``n_devices`` mesh; every
    rank of an ``n_devices``-process group calls it (one process may call
    ``run_dryrun(1)`` without a group), and rank 0 prints the JAX dry run's
    lines.  ``device``: ``cuda`` unless ``"cpu"`` is asked for."""
    device = resolve_device(device)
    import torch
    import torch.distributed as dist

    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != n_devices:
        raise RuntimeError(f"need {n_devices} ranks, have {world}; launch "
                           "with entry.dryrun_multichip")

    from ..core import Segment
    from ..models import embedder
    from ..models.fused import FusedFacePipeline, FusedOutput
    from ..models.nn import state_to
    from ..train.optim import adam
    from .mesh import make_mesh, mesh_shape
    from .scheduler import ShotScheduler, merge_results
    from .sharding import (_group, _rows, all_gather, make_train_step,
                           shard_params_for_tp)

    def say(line: str) -> None:
        if not dist.is_initialized() or dist.get_rank() == 0:
            print(line, flush=True)

    model_par = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    mesh = make_mesh(n_devices=n_devices, model_parallelism=model_par,
                     device=device)
    shape = mesh_shape(mesh)
    rng = np.random.default_rng(0)

    # -- 1. sharded train step (dp batch + tp params) -----------------------
    params = embedder.init_params(torch.Generator().manual_seed(0), width=0.25)
    params = shard_params_for_tp(state_to(params, device), mesh)
    params, opt = adam(params, 1e-3)
    step = make_train_step(mesh, opt)
    batch = max(n_devices, 8)
    chips = torch.from_numpy(
        rng.integers(0, 255, (batch, 150, 150, 3)).astype(np.float32)).to(device)
    labels = torch.from_numpy(rng.integers(0, 4, (batch,))).to(device)
    params, loss = step(params, chips, labels)
    say(f"dryrun[train]: mesh={shape} loss={float(loss):.4f} OK")

    # -- 2. sharded fused inference (dp over the frame batch) ---------------
    dp = shape["data"]
    fb = max(2 * dp, 4)
    pipe = FusedFacePipeline(max_faces=4, device=device)
    fused = pipe._build(96, 128)
    frames = torch.from_numpy(
        rng.integers(0, 255, (fb, 96, 128, 3)).astype(np.uint8)).to(device)
    out = fused(pipe.detector_params, pipe.embedder_params,
                pipe.landmark_arrays, frames[_rows(mesh, fb)])
    out = FusedOutput(*(all_gather(v, _group(mesh, "data")) for v in out))
    say(f"dryrun[fused]: frames={fb}x96x128 dp={dp} "
        f"emb={tuple(out.embeddings.shape)} OK")

    # -- 3. shot scheduler: 2 workers, deterministic merge ------------------
    shots = [Segment(float(i), float(i) + 1.0) for i in range(6)]

    def process(seg: Segment):
        x = torch.full((4,), seg.start)
        return float(torch.sum(x * 2.0))

    results = []
    for rank in range(2):
        sched = ShotScheduler(devices=[device], rank=rank, world=2)
        results.extend(sched.run(shots, process))
    merged = merge_results(results)
    expected = [8.0 * s.start for s in shots]
    if merged != expected:
        raise RuntimeError(f"scheduler merge mismatch: {merged} != {expected}")
    say(f"dryrun[scheduler]: 2 workers x {len(shots)} shots merged OK")

    say(f"dryrun_multichip({n_devices}): mesh={shape} "
        f"loss={float(loss):.4f} OK")
