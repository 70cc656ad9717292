"""The port's shot threading and scenes against the JAX package, on the CPU.

Same seeded synthetic episodes through ``pyannote_video_tpu``'s ``Thread``
and the port's (``device="cpu"``).  Tolerance: none.  ORB is integer-exact
by design (``ops/orb.py``), so annotations, every pair's match count and
the CLI's JSON files must be equal.
"""

import numpy as np
import pytest
import torch

from pyannote_video_tpu.core import Segment as JSegment
from pyannote_video_tpu.io.video import Video as JVideo
from pyannote_video_tpu.pipeline import thread as jthread
from pyannote_video_tpu.utils.synthetic import synthetic_episode

from pyannote_video_tpu_torch.core import Annotation, Segment
from pyannote_video_tpu_torch.io.video import Video
from pyannote_video_tpu_torch.pipeline import thread

# whole threads on the CPU beside five other test workers
torch.set_num_threads(1)


@pytest.mark.parametrize("lookahead", [1, 2, 3, 4, 5])
def test_product_lookahead_matches_jax(lookahead):
    for n in range(13):
        assert (list(thread.product_lookahead(range(n), lookahead))
                == list(jthread.product_lookahead(range(n), lookahead)))


def _both(ep):
    """(JAX video, shots), (port video, shots) of one episode."""
    return ((JVideo(ep.frames, fps=ep.fps), [JSegment(s, e) for s, e in ep.shots]),
            (Video(ep.frames, fps=ep.fps), [Segment(s, e) for s, e in ep.shots]))


# the three fast scenes of tests/test_pipeline.py::TestThread
SCENES = {
    "alternating": (dict(n_shots=4, seed=17, thread_pattern=[0, 1, 0, 1]), 3),
    "distinct": (dict(n_shots=3, seed=23), 2),
    "intertwined": (dict(n_shots=5, seed=29, thread_pattern=[0, 1, 0, 1, 2]), 3),
}


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_thread_annotation_matches_jax(scene):
    kwargs, lookahead = SCENES[scene]
    ep = synthetic_episode(shot_frames=12, width=160, height=120,
                           faces_per_shot=0, n_identities=1, **kwargs)
    (jv, jshots), (v, shots) = _both(ep)
    jth = jthread.Thread(jv, shot=jshots, lookahead=lookahead, min_match=20)
    th = thread.Thread(v, shot=shots, lookahead=lookahead, min_match=20,
                       device="cpu")
    ref, out = jth(), th()
    assert out.for_json() == ref.for_json()
    assert th.scenes(out).for_json() == jth.scenes(ref).for_json()
    pattern = kwargs.get("thread_pattern", list(range(kwargs["n_shots"])))
    labels = [lab for _, _, lab in out.itertracks(yield_label=True)]
    assert len(set(labels)) == len(set(pattern))


def test_every_pair_count_matches_jax_with_margins():
    """The 640×480 seed-202 episode of the JAX margins test: every
    lookahead pair's count equals JAX's, same-thread pairs clear
    min_match=20 by 2× and cross-thread pairs stay 20% below it; the
    batched counts of ``Thread`` equal the pair-by-pair ones."""
    pattern = [0, 1, 0, 1, 2, 3, 2, 3]
    ep = synthetic_episode(n_shots=8, shot_frames=20, width=640, height=480,
                           seed=202, thread_pattern=pattern, n_identities=6)
    (jv, jshots), (v, shots) = _both(ep)
    jth = jthread.Thread(jv, shot=jshots, lookahead=5, min_match=20)
    th = thread.Thread(v, shot=shots, lookahead=5, min_match=20, device="cpu")
    jth._compute_features(jshots)
    th._compute_features(shots)
    collar = 10.0 / v.frame_rate
    pairs = list(thread.product_lookahead(range(len(shots)), 5))
    counts = []
    for i, j in pairs:
        n = th._match(th._orb_at(shots[i].end - collar),
                      th._orb_at(shots[j].start + collar))
        ref = jth._match(jth._orb_at(jshots[i].end - collar),
                         jth._orb_at(jshots[j].start + collar))
        assert n == ref, f"pair ({i},{j}): {n} != JAX {ref}"
        if pattern[i] == pattern[j]:
            assert n >= 40, f"same-thread pair ({i},{j}) weak: {n}"
        else:
            assert n <= 16, f"cross-thread pair ({i},{j}) strong: {n}"
        counts.append(n)
    scorable = th._scorable_pairs(shots)
    assert [(shots.index(a), shots.index(b)) for a, b, _, _ in scorable] == pairs
    assert th._pair_counts(scorable) == counts


def _annotation(rng, n_shots, n_labels, module):
    ann = module.Annotation(uri="ep")
    t = 0.0
    for _ in range(n_shots):
        d = float(rng.uniform(0.5, 3.0))
        ann[module.Segment(t, t + d)] = "ABCDEFG"[int(rng.integers(n_labels))]
        t += d
    return ann


@pytest.mark.parametrize("seed", range(6))
def test_scenes_from_threads_matches_jax(seed):
    from pyannote_video_tpu import core as jcore
    from pyannote_video_tpu_torch import core

    n_shots, n_labels = [(1, 1), (3, 2), (6, 2), (9, 3), (12, 4), (20, 6)][seed]
    ref = jthread.scenes_from_threads(
        _annotation(np.random.default_rng(seed), n_shots, n_labels, jcore))
    out = thread.scenes_from_threads(
        _annotation(np.random.default_rng(seed), n_shots, n_labels, core))
    assert isinstance(out, Annotation)
    assert out.for_json() == ref.for_json()


def test_package_exports():
    from pyannote_video_tpu_torch import Annotation as A, Thread as T

    assert A is Annotation and T is thread.Thread


class TestStructureCLI:
    @pytest.fixture(scope="class")
    def files(self, tmp_path_factory):
        """A written episode and the JAX CLI's shot/thread/scene files."""
        pytest.importorskip("cv2")
        from pyannote_video_tpu.cli.structure_cli import main as jax_main
        from pyannote_video_tpu.utils.synthetic import write_synthetic_video

        tmp = tmp_path_factory.mktemp("structure")
        ep = synthetic_episode(n_shots=6, shot_frames=16, width=160,
                               height=120, seed=31,
                               thread_pattern=[0, 1, 0, 1, 2, 2],
                               faces_per_shot=0, n_identities=1)
        avi = str(tmp / "clip.avi")
        write_synthetic_video(avi, ep)
        for command, src in (("shot", None), ("thread", "shot"), ("scene", "thread")):
            jax_main([command, avi] + ([str(tmp / f"jax_{src}.json")] if src else [])
                     + [str(tmp / f"jax_{command}.json")])
        return tmp, avi

    @pytest.mark.parametrize("command,src", [("thread", "shot"), ("scene", "thread")])
    def test_json_byte_identical(self, files, command, src):
        from pyannote_video_tpu_torch.cli.structure_cli import main

        tmp, avi = files
        out = tmp / f"torch_{command}.json"
        main([command, avi, str(tmp / f"jax_{src}.json"), str(out)], device="cpu")
        ref = (tmp / f"jax_{command}.json").read_bytes()
        assert out.read_bytes() == ref
        assert ref.startswith(b'{"pyannote": "Annotation"')
        labels = {c["label"] for c in __import__("json").loads(ref)["content"]}
        assert len(labels) == (3 if command == "thread" else 2)
