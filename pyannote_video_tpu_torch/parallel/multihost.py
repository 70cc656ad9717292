"""Multi-worker execution: process-group wiring + shot-shard merge.

Port of ``pyannote_video_tpu/parallel/multihost.py``.  Model: every worker
runs the SAME CLI command with ``--rank r --world W``: shots are
independent work units, so worker r processes shots ``r, r+W, r+2W, …`` and
writes ``<output>.part{r}``; rank 0 (or a follow-up invocation) merges the
parts into the final stage file deterministically.  When a ``--coordinator
host:port`` is given, ``torch.distributed`` is initialised so that all
workers form one process group; independent workers on one host need no
coordinator: work division alone suffices.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional, Tuple


def init_distributed(coordinator: Optional[str], rank: int,
                     world: int) -> None:
    """Initialise the ``torch.distributed`` process group (idempotent;
    no-op for world<=1 or when no coordinator is given)."""
    if world <= 1 or not coordinator:
        return
    import torch
    import torch.distributed as dist

    if dist.is_initialized():
        return
    dist.init_process_group(
        backend="nccl" if torch.cuda.is_available() else "gloo",
        init_method=f"tcp://{coordinator}",
        world_size=world,
        rank=rank,
    )


def env_worker() -> Tuple[int, int, Optional[str]]:
    """(rank, world, coordinator) from the environment.

    Honoured variables: PYV_RANK, PYV_WORLD, PYV_COORDINATOR; explicit
    CLI flags win over these.
    """
    return (
        int(os.environ.get("PYV_RANK", "0")),
        int(os.environ.get("PYV_WORLD", "1")),
        os.environ.get("PYV_COORDINATOR") or None,
    )


def part_path(output: str, rank: int) -> str:
    return f"{output}.part{rank}"


def merge_tracking_parts(output: str, world: int,
                         wait_s: float = 0.0,
                         include_existing: bool = False) -> int:
    """Merge ``<output>.part{0..world-1}`` into ``<output>``.

    Tracks are renumbered deterministically by (first timestamp, source
    rank, local id) so the merged file is identical regardless of worker
    count or completion order.  With ``wait_s`` > 0, waits for missing
    part files (workers still running).  ``include_existing`` folds tracks
    already present in ``output`` into the merge pool (rank −1): the
    ``--resume`` case, where pre-restart tracks would otherwise be lost
    when this function rewrites the file.  Returns the number of tracks.
    """
    from ..core import formats

    paths = [part_path(output, r) for r in range(world)]
    deadline = time.time() + wait_s
    missing = [p for p in paths if not os.path.exists(p)]
    while missing and time.time() < deadline:
        time.sleep(0.2)
        missing = [p for p in paths if not os.path.exists(p)]
    if missing:
        raise FileNotFoundError(f"missing worker outputs: {missing}")

    tracks: Dict[Tuple[int, int], List] = {}
    if include_existing and os.path.exists(output):
        for point in formats.read_tracking(output):
            tracks.setdefault((-1, point.identifier), []).append(point)
    for r, p in enumerate(paths):
        for point in formats.read_tracking(p):
            tracks.setdefault((r, point.identifier), []).append(point)

    ordered = sorted(
        tracks.items(),
        key=lambda kv: (min(pt.t for pt in kv[1]), kv[0][0], kv[0][1]),
    )
    with open(output, "w") as fp:
        for new_id, (_, points) in enumerate(ordered):
            for pt in sorted(points, key=lambda q: q.t):
                fp.write(formats.FACE_TEMPLATE.format(
                    t=pt.t, identifier=new_id, status=pt.status,
                    left=pt.left, right=pt.right, top=pt.top,
                    bottom=pt.bottom,
                ))
    return len(ordered)
