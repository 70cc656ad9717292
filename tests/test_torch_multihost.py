"""The port's multi-worker module against the JAX package, on the CPU.

``parallel/multihost.py``: the same part files through both packages give
the same merged file, byte for byte; ``part_path`` and ``env_worker`` give
the same values.  Two workers against one, on the port's two ``track``
engines, are compared as ``tests/test_multihost.py`` compares them: by the
point set after rounding to 3 decimals.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from pyannote_video_tpu.parallel import multihost as jmultihost

from pyannote_video_tpu_torch.cli import face_cli
from pyannote_video_tpu_torch.core import Segment, Timeline, dump, formats
from pyannote_video_tpu_torch.io.video import Video
from pyannote_video_tpu_torch.parallel import multihost
from pyannote_video_tpu_torch.utils.synthetic import synthetic_episode

LINE = ("{t:.3f} {identifier:d} {left:.3f} {top:.3f} {right:.3f} "
        "{bottom:.3f} {status}\n")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The test runner's workers share the cores: with every worker's torch
    pool at full width the many small CPU operations of a scan mostly wait
    for each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write(path, rows):
    with open(path, "w") as fp:
        for t, identifier, left in rows:
            fp.write(LINE.format(t=t, identifier=identifier, left=left,
                                 top=0.1, right=left + 0.1, bottom=0.2,
                                 status="detection"))


def _parts(out, seed, world):
    """Seeded part files: tracks of a few points, ties in the first
    timestamp across ranks included."""
    rng = np.random.default_rng(seed)
    for r in range(world):
        rows = []
        for ident in range(int(rng.integers(1, 4))):
            t0 = float(rng.integers(0, 5)) / 2.0          # ties across ranks
            rows += [(t0 + 0.04 * k, ident, float(rng.uniform(0.1, 0.8)))
                     for k in rng.permutation(int(rng.integers(1, 5)))]
        _write(multihost.part_path(out, r), rows)


class TestMerge:
    @pytest.mark.parametrize("include_existing", [False, True])
    @pytest.mark.parametrize("seed,world", [(0, 2), (1, 3), (2, 1), (3, 4)])
    def test_same_file_as_the_jax_merge(self, tmp_path, seed, world,
                                        include_existing):
        out, jout = str(tmp_path / "t.txt"), str(tmp_path / "j" / "t.txt")
        _parts(out, seed, world)
        _write(out, [(0.1, 0, 0.5), (0.14, 0, 0.5), (7.0, 3, 0.2)])
        shutil.copytree(tmp_path, tmp_path / "j",
                        ignore=shutil.ignore_patterns("j"))
        n = multihost.merge_tracking_parts(out, world,
                                           include_existing=include_existing)
        jn = jmultihost.merge_tracking_parts(jout, world,
                                             include_existing=include_existing)
        assert n == jn > 0
        assert open(out).read() == open(jout).read()
        points = formats.read_tracking(out)
        assert {p.identifier for p in points} == set(range(n))
        # renumbered by first timestamp
        first = {}
        for p in points:
            first[p.identifier] = min(first.get(p.identifier, p.t), p.t)
        assert [first[i] for i in range(n)] == sorted(first.values())
        # merging again changes nothing
        assert multihost.merge_tracking_parts(out, world) <= n

    def test_merge_include_existing_keeps_resume_tracks(self, tmp_path):
        out = str(tmp_path / "t.txt")
        _write(out, [(0.1, 0, 0.1)])
        for r, t in ((0, 1.0), (1, 2.0)):
            _write(multihost.part_path(out, r), [(t, 0, 0.3)])
        assert multihost.merge_tracking_parts(out, 2, include_existing=True) == 3
        pts = formats.read_tracking(out)
        assert sorted(round(p.t, 3) for p in pts) == [0.1, 1.0, 2.0]
        by_id = {p.identifier: p.t for p in pts}
        assert by_id[0] == 0.1 and by_id[1] == 1.0 and by_id[2] == 2.0

    def test_missing_part_raises_after_the_wait(self, tmp_path):
        out = str(tmp_path / "t.txt")
        _write(multihost.part_path(out, 0), [(0.0, 0, 0.1)])
        with pytest.raises(FileNotFoundError, match="part1"):
            multihost.merge_tracking_parts(out, 2, wait_s=0.3)
        assert not os.path.exists(out)

    @pytest.mark.parametrize("rank", [0, 3, 12])
    def test_part_path(self, rank):
        assert multihost.part_path("a/b.txt", rank) == jmultihost.part_path(
            "a/b.txt", rank) == f"a/b.txt.part{rank}"

    @pytest.mark.parametrize("env", [
        {}, {"PYV_RANK": "2", "PYV_WORLD": "4"},
        {"PYV_RANK": "1", "PYV_WORLD": "2", "PYV_COORDINATOR": "host:1234"},
        {"PYV_COORDINATOR": ""}])
    def test_env_worker(self, monkeypatch, env):
        for key in ("PYV_RANK", "PYV_WORLD", "PYV_COORDINATOR"):
            monkeypatch.delenv(key, raising=False)
        for key, value in env.items():
            monkeypatch.setenv(key, value)
        assert multihost.env_worker() == jmultihost.env_worker()

    @pytest.mark.parametrize("coordinator,world", [(None, 2), ("", 4),
                                                   ("host:1", 1)])
    def test_init_distributed_is_a_no_op_without_a_coordinator(
            self, coordinator, world):
        multihost.init_distributed(coordinator, 0, world)
        assert not torch.distributed.is_initialized()


# -- two workers against one ---------------------------------------------------


def _point_set(path):
    return sorted((round(p.t, 3), round(p.left, 3), round(p.top, 3),
                   round(p.right, 3), round(p.bottom, 3), p.status)
                  for p in formats.read_tracking(path))


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_multihost")
    ep = synthetic_episode(n_shots=3, shot_frames=8, width=160, height=120,
                           seed=13, face_height_ratio=0.45)
    shot_json = str(d / "shot.json")
    with open(shot_json, "w") as fp:
        dump(Timeline([Segment(s, e) for s, e in ep.shots]), fp)
    return ep, shot_json, d


@pytest.fixture(autouse=True)
def _refine_on(monkeypatch):
    # the JAX package's refiner trainer leaves this set in its pytest worker
    monkeypatch.delenv("PYV_NO_REFINE", raising=False)


class TestWorkerShardedTracking:
    @pytest.mark.parametrize("no_stream", ["0", "1"],
                             ids=["streaming", "per-shot"])
    def test_two_worker_track_matches_single(self, clip, monkeypatch,
                                             no_stream):
        ep, shot_json, d = clip
        monkeypatch.setenv("PYV_NO_STREAM", no_stream)
        single = str(d / f"single{no_stream}.txt")
        sharded = str(d / f"sharded{no_stream}.txt")
        video = lambda: Video(ep.frames, fps=ep.fps)
        face_cli.track(video(), shot_json, single, detect_every=0.2,
                       device="cpu")
        # worker 1 first so rank 0's merge finds both parts at once
        for rank in (1, 0):
            face_cli.track(video(), shot_json, sharded, detect_every=0.2,
                           rank=rank, world=2, device="cpu")
        parts = [formats.read_tracking(multihost.part_path(sharded, r))
                 for r in (0, 1)]
        assert all(parts), "each worker tracked its shots"
        cuts = ep.cuts
        assert all(p.t < cuts[0] or p.t >= cuts[1] for p in parts[0])
        assert all(cuts[0] <= p.t < cuts[1] for p in parts[1])
        assert _point_set(sharded) == _point_set(single)
        n = multihost.merge_tracking_parts(sharded, 2)
        assert _point_set(sharded) == _point_set(single)
        assert n == len({p.identifier for p in formats.read_tracking(sharded)})

    def test_main_takes_rank_and_world(self, clip, monkeypatch):
        ep, shot_json, d = clip
        monkeypatch.delenv("PYV_NO_STREAM", raising=False)
        monkeypatch.setattr(
            "pyannote_video_tpu_torch.io.video.Video.__init__",
            lambda self, *a, **k: None)
        calls = []
        monkeypatch.setattr(face_cli, "track",
                            lambda *a, **k: calls.append(k))
        face_cli.main(["track", "--rank=1", "--world=2", "clip.avi",
                       shot_json, str(d / "m.txt")], device="cpu")
        assert calls[0]["rank"] == 1 and calls[0]["world"] == 2
        assert calls[0]["coordinator"] is None

    def test_resume_with_world_keeps_the_earlier_tracks(self, clip, monkeypatch):
        """``--resume --world 2``: the tracks of the shots finished before
        the restart survive the merge, which rewrites the file."""
        ep, shot_json, d = clip
        monkeypatch.delenv("PYV_NO_STREAM", raising=False)
        video = lambda: Video(ep.frames, fps=ep.fps)
        full = str(d / "full.txt")
        face_cli.track(video(), shot_json, full, detect_every=0.2, device="cpu")
        lines = open(full).read().splitlines(keepends=True)
        cut = ep.cuts[0]
        first = [ln for ln in lines if float(ln.split()[0]) < cut]
        second = [ln for ln in lines if float(ln.split()[0]) >= cut]
        assert first and second
        # interrupted in the second shot: its first points were written.
        # The workers of a run start together from that file; run one after
        # the other here, each is given the file as both would have found it
        resumed = str(d / "resumed.txt")
        for rank in (1, 0):
            with open(resumed, "w") as fp:
                fp.write("".join(first + second[:2]))
            face_cli.track(video(), shot_json, resumed, detect_every=0.2,
                           resume=True, rank=rank, world=2, device="cpu")
        assert _point_set(resumed) == _point_set(full)
        kept = [p for p in formats.read_tracking(resumed) if p.t < cut]
        assert len(kept) == len(first)
