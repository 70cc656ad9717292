"""Per-stage observability: wall-clock and item counters.

Copy of ``StageStats`` from ``pyannote_video_tpu/utils/profiling.py``: the
structured per-stage statistics (items per second, tracks) that the CLIs
print under ``--verbose``.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import Dict


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
