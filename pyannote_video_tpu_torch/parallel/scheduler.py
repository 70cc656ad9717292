"""Shot-queue scheduler: shot-level parallelism over devices and workers.

Port of ``pyannote_video_tpu/parallel/scheduler.py``.  Shots are the
workload's embarrassingly parallel unit (tracking never crosses a shot
boundary), so this scheduler fans independent shots out:

* one device: shots in order;
* several devices: round-robin placement, each shot's work run under
  ``with torch.device(d):``, so the tensors it makes without a device land
  on its card (the counterpart of ``jax.default_device``);
* several workers: rank r of world W takes shots r, r+W, r+2W, ... and the
  results merge by shot index, so output files do not depend on the
  number of workers.

The scheduler only decides placement and order; a shot's own work is the
stage's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Iterator, List, Optional, Sequence, Tuple

import torch

from ..core import Segment
from ..utils.device import resolve_device


@dataclass
class ShotResult:
    index: int
    segment: Segment
    value: object


class ShotScheduler:
    """Distribute per-shot work across local devices and/or workers.

    Parameters
    ----------
    devices : list, optional
        Devices to round-robin over (default: every CUDA device, which
        raises without one; pass e.g. ``["cpu"]`` to run on the CPU).
    rank, world : int
        Work division (this worker processes shots where
        ``index % world == rank``).
    """

    def __init__(self, devices: Optional[Sequence] = None,
                 rank: int = 0, world: int = 1):
        if devices is None:
            resolve_device(None)          # raises without a card
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        self.devices = [torch.device(d) for d in devices]
        self.rank = rank
        self.world = world

    def my_shots(self, shots: Sequence[Segment]) -> List[Tuple[int, Segment]]:
        return [
            (i, s) for i, s in enumerate(shots) if i % self.world == self.rank
        ]

    def run(self, shots: Sequence[Segment],
            process: Callable[[Segment], object]) -> Iterator[ShotResult]:
        """Process this worker's shots, placing work round-robin on devices.

        Yields ShotResults in this worker's shot order (globally mergeable
        by ``index``).
        """
        for k, (index, segment) in enumerate(self.my_shots(shots)):
            device = self.devices[k % len(self.devices)]
            with torch.device(device):
                value = process(segment)
            yield ShotResult(index=index, segment=segment, value=value)


def merge_results(results: Sequence[ShotResult]) -> List[object]:
    """Merge per-shot results from any number of workers into shot order."""
    return [r.value for r in sorted(results, key=lambda r: r.index)]
