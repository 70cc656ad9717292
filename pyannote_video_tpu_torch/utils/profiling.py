"""Per-stage observability: wall-clock and item counters, and a device
trace.

``StageStats`` and ``PipelineStats`` are copies of those in
``pyannote_video_tpu/utils/profiling.py``: the structured per-stage
statistics (items per second, tracks) that the CLIs print under
``--verbose``.  ``device_trace`` wraps ``torch.profiler`` where the JAX
package wraps ``jax.profiler``.
"""

from __future__ import annotations

import contextlib
import json
import time
from dataclasses import dataclass, field
from typing import Dict, Iterator, Optional


@dataclass
class StageStats:
    name: str
    started: float = field(default_factory=time.perf_counter)
    wall_s: float = 0.0
    items: int = 0
    counters: Dict[str, float] = field(default_factory=dict)

    def add(self, n: int = 1, **counters: float) -> None:
        self.items += n
        for key, value in counters.items():
            self.counters[key] = self.counters.get(key, 0.0) + value

    def finish(self) -> "StageStats":
        self.wall_s = time.perf_counter() - self.started
        return self

    @property
    def items_per_s(self) -> float:
        return self.items / self.wall_s if self.wall_s > 0 else 0.0

    def to_dict(self) -> dict:
        return {
            "stage": self.name,
            "wall_s": round(self.wall_s, 3),
            "items": self.items,
            "items_per_s": round(self.items_per_s, 2),
            **{k: round(v, 3) for k, v in self.counters.items()},
        }

    def __str__(self) -> str:
        return json.dumps(self.to_dict())


class PipelineStats:
    """Collects StageStats across a pipeline run."""

    def __init__(self):
        self.stages: Dict[str, StageStats] = {}

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[StageStats]:
        st = StageStats(name)
        try:
            yield st
        finally:
            self.stages[name] = st.finish()

    def report(self) -> str:
        return "\n".join(str(s) for s in self.stages.values())


@contextlib.contextmanager
def device_trace(logdir: Optional[str] = None):
    """``torch.profiler`` trace around a code block, written into ``logdir``
    as a Chrome trace in TensorBoard's layout (``<worker>.<time>.pt.trace.json``).

    It records the host's operators, and the CUDA kernels and copies too
    when a CUDA device is present.  No-op when ``logdir`` is None: safe to
    leave in production code paths.
    """
    if logdir is None:
        yield
        return
    import torch
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)):
        try:
            yield
        finally:
            if cuda:
                torch.cuda.synchronize()
