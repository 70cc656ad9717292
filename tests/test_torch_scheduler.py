"""The port's shot scheduler against the JAX package's, on the CPU.

Work division (``my_shots``) and the merge by shot index must be the JAX
package's for every world size; ``run`` places each shot round-robin on
the devices it was given, under ``with torch.device(d):``.
"""

import pytest
import torch

import jax

from pyannote_video_tpu.core import Segment as JSegment
from pyannote_video_tpu.parallel import scheduler as jscheduler

from pyannote_video_tpu_torch.core import Segment
from pyannote_video_tpu_torch.parallel.scheduler import (ShotResult,
                                                         ShotScheduler,
                                                         merge_results)


def _shots(n=7):
    return [Segment(0.4 * i, 0.4 * (i + 1)) for i in range(n)]


def _jshots(n=7):
    return [JSegment(0.4 * i, 0.4 * (i + 1)) for i in range(n)]


@pytest.mark.parametrize("world", [1, 2, 3])
def test_work_division_and_merge_match_jax(world):
    results, jresults = [], []
    for rank in range(world):
        ours = ShotScheduler(["cpu"], rank=rank, world=world)
        ref = jscheduler.ShotScheduler(jax.devices("cpu")[:1], rank=rank,
                                       world=world)
        mine = ours.my_shots(_shots())
        assert [(i, (s.start, s.end)) for i, s in mine] == [
            (i, (s.start, s.end)) for i, s in ref.my_shots(_jshots())]
        results += list(ours.run(_shots(), lambda s: round(s.start / 0.4)))
        jresults += list(ref.run(_jshots(), lambda s: round(s.start / 0.4)))
    # the workers' results, in any order, merge into shot order
    assert merge_results(results[::-1]) == jscheduler.merge_results(jresults) == list(range(7))


def test_run_places_shots_round_robin():
    seen = []

    def process(segment):
        seen.append(torch.empty(1).device.type)   # the default device here
        return segment.start

    out = list(ShotScheduler(["cpu", "meta"]).run(_shots(5), process))
    assert seen == ["cpu", "meta", "cpu", "meta", "cpu"]
    assert [r.index for r in out] == list(range(5))
    assert all(isinstance(r, ShotResult) for r in out)
    assert torch.empty(1).device.type == "cpu"

    out = list(ShotScheduler(["cpu", "cpu"], rank=1, world=2).run(
        _shots(5), lambda s: torch.ones(2).sum().item() + s.start))
    assert [r.index for r in out] == [1, 3]
    assert [r.value for r in out] == pytest.approx([2.4, 3.2])
    assert ShotScheduler(["cpu", "cpu"]).devices == [torch.device("cpu")] * 2
