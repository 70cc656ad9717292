"""Entry points: the fused forward step and the multi-device dry run.

Counterparts of the JAX package's ``__graft_entry__.py``:
``fn, args = entry(); out = fn(*args)`` runs pyramid detection, the
refiner, device NMS, the landmark cascade, the chip cut and the ResNet-29
embedder over two seeded random 120×160 frames with 4 face slots each;
``dryrun_multichip(n)`` runs the sharded paths over an ``n``-device mesh.
Both run on the CUDA device unless ``device="cpu"`` is asked for.
"""

from __future__ import annotations

import numpy as np
import torch

from .utils.device import DeviceLike


def entry(device: DeviceLike = None):
    """(fn, args) of the fused program (``models/fused.py``):
    ``fn(*args)`` is a ``FusedOutput`` of [2, 4, ...] tensors."""
    from .models.fused import FusedFacePipeline

    pipe = FusedFacePipeline(max_faces=4, device=device)
    fused = pipe._build(120, 160)
    frames = torch.from_numpy(
        np.random.default_rng(0).integers(0, 255, (2, 120, 160, 3))
        .astype(np.uint8)).to(pipe.device)
    return fused, (pipe.detector_params, pipe.embedder_params,
                   pipe.landmark_arrays, frames)


def dryrun_multichip(n_devices: int, device: DeviceLike = None) -> list:
    """Run the full sharded paths (train step + fused inference + shot
    scheduler) over an ``n_devices`` mesh: ``parallel/dryrun.py``.

    Mesh: (data × model).  The chip/frame batch shards over ``data`` (dp);
    the embedder's wide conv filters / FC shard over ``model`` (tp)
    (``parallel/sharding.py``).  As the JAX entry re-executes a child with
    ``n`` virtual devices, this starts ``n`` processes, one device each:
    gloo processes on the CPU with ``device="cpu"``, else one per card,
    which needs ``n`` cards.  Prints rank 0's lines and returns them; a
    failed rank raises.
    """
    from .parallel.dryrun import launch
    from .utils.device import resolve_device

    device = resolve_device(device)
    _, output = launch(n_devices, "pyannote_video_tpu_torch.parallel.dryrun:run_dryrun",
                       (n_devices, device.type), device=device)
    print(output, end="", flush=True)
    return output.splitlines()


if __name__ == "__main__":
    fn, args = entry()
    out = fn(*args)
    print("entry OK:", {k: tuple(v.shape) for k, v in out._asdict().items()})
    dryrun_multichip(torch.cuda.device_count())
