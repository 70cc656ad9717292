"""The port's distances and face clustering against the JAX package, on the
CPU.  Distances within 1e-5 with an exactly zero diagonal; clustering
labels identical, segment for segment."""

import logging

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pyannote_video_tpu.core import formats as jformats
from pyannote_video_tpu.ops import distance as jdistance
from pyannote_video_tpu.pipeline.clustering import FaceClustering as JClustering

import pyannote_video_tpu_torch
from pyannote_video_tpu_torch.ops import distance
from pyannote_video_tpu_torch.pipeline.clustering import FaceClustering


def _unit(x):
    return x / np.linalg.norm(x, axis=1, keepdims=True)


class TestDistance:
    @pytest.mark.parametrize("name", ["pairwise_sqdist", "pairwise_dist"])
    def test_symmetric(self, name):
        x = _unit(np.random.default_rng(0).normal(0, 1, (40, 128))).astype(np.float32)
        if name == "pairwise_sqdist":
            # a duplicate row: ~1e-7 of cancellation noise off the diagonal
            # (its square root would be ~3e-4, so not for pairwise_dist)
            x[7] = x[3]
        ref = np.asarray(getattr(jdistance, name)(jnp.asarray(x)))
        out = getattr(distance, name)(torch.from_numpy(x))
        assert out.dtype == torch.float32 and out.shape == (40, 40)
        np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=0)
        assert (out.diagonal() == 0).all()
        assert float(out.min()) >= 0.0

    @pytest.mark.parametrize("name", ["pairwise_sqdist", "pairwise_dist"])
    def test_with_y(self, name):
        rng = np.random.default_rng(1)
        x = _unit(rng.normal(0, 1, (40, 128))).astype(np.float32)
        y = _unit(rng.normal(0, 1, (9, 128))).astype(np.float32)
        ref = np.asarray(getattr(jdistance, name)(jnp.asarray(x), jnp.asarray(y)))
        out = getattr(distance, name)(torch.from_numpy(x), torch.from_numpy(y))
        assert out.shape == (40, 9)
        np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=0)

    def test_float64_input_is_computed_in_float32(self):
        x = np.random.default_rng(2).normal(0, 1, (5, 16))
        out = distance.pairwise_dist(torch.from_numpy(x))
        assert out.dtype == torch.float32
        ref = np.linalg.norm(x[:, None] - x[None], axis=2)
        np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)


def _two_identities(path):
    rng = np.random.default_rng(0)
    centers = {0: rng.normal(0, 0.1, 128), 1: rng.normal(0, 0.1, 128) + 0.12}
    with open(path, "w") as fp:
        for track in range(6):
            for k in range(5):
                emb = centers[track % 2] + rng.normal(0, 0.02, 128)
                jformats.write_embedding_line(fp, track * 1.0 + k * 0.04,
                                              track, emb)


def _distant(seed, rows):
    def write(path):
        rng = np.random.default_rng(seed)
        with open(path, "w") as fp:
            for track in range(3):
                center = np.zeros(128)
                center[track] = 5.0
                for k in range(rows):
                    jformats.write_embedding_line(
                        fp, track + 0.04 * k, track,
                        center + rng.normal(0, 0.01, 128))
    return write


def _four_groups(path):
    """12 tracks of unit-norm embeddings in 4 well-separated groups, rows
    of different tracks interleaved in time."""
    rng = np.random.default_rng(5)
    centers = _unit(rng.normal(0, 1, (4, 128)))
    rows = []
    for track in range(12):
        for k in range(4):
            emb = _unit((centers[track % 4] + rng.normal(0, 0.01, 128))[None])[0]
            rows.append((0.5 * track + 0.2 * k, track, emb))
    rows.sort(key=lambda r: r[0])
    with open(path, "w") as fp:
        for t, track, emb in rows:
            jformats.write_embedding_line(fp, t, track, emb)


FILES = {"two_identities": (_two_identities, 2),
         "threshold_stops": (_distant(1, 3), 3),
         "three_distant": (_distant(2, 2), 3),
         "four_groups": (_four_groups, 4)}


def _labels(result):
    return [(seg.start, seg.end, track, label)
            for seg, track, label in result.itertracks(yield_label=True)]


class TestFaceClustering:
    @pytest.mark.parametrize("force", [False, True])
    @pytest.mark.parametrize("name", sorted(FILES))
    def test_labels_identical(self, name, force, tmp_path):
        write, n_clusters = FILES[name]
        path = str(tmp_path / "emb.txt")
        write(path)
        jc = JClustering(threshold=0.6, force=force)
        ref = jc(*jc.model.preprocess(path))
        pc = FaceClustering(threshold=0.6, force=force, device="cpu")
        starting_point, features = pc.model.preprocess(path)
        out = pc(starting_point, features=features)
        assert _labels(out) == _labels(ref)
        assert len({l for *_, l in _labels(out)}) == (1 if force else n_clusters)
        assert out.modality == "face"

    def test_preprocess_matches(self, tmp_path):
        path = str(tmp_path / "emb.txt")
        _four_groups(path)
        sp_ref, f_ref = JClustering().model.preprocess(path)
        sp, f = FaceClustering(device="cpu").model.preprocess(path)
        assert _labels(sp) == _labels(sp_ref)
        for key in ("tracks", "times", "X"):
            np.testing.assert_array_equal(f[key], f_ref[key])

    def test_threshold_is_strict_and_smaller_id_is_kept(self, tmp_path):
        path = str(tmp_path / "emb.txt")
        with open(path, "w") as fp:
            for track, x in ((3, 0.0), (9, 0.5), (5, 2.0)):
                for k in range(2):
                    emb = np.zeros(128)
                    emb[0] = x
                    jformats.write_embedding_line(fp, track + 0.04 * k, track, emb)
        loose = FaceClustering(threshold=0.5, device="cpu")
        out = {t: l for _, _, t, l in _labels(loose(*loose.model.preprocess(path)))}
        assert out == {3: 3, 9: 3, 5: 5}            # 0.5 > 0.5 is false: merged
        tight = FaceClustering(threshold=0.49, device="cpu")
        out = {t: l for _, _, t, l in _labels(tight(*tight.model.preprocess(path)))}
        assert out == {3: 3, 9: 9, 5: 5}

    def test_logger_reports_merges(self, tmp_path, caplog):
        path = str(tmp_path / "emb.txt")
        _two_identities(path)
        logger = logging.getLogger("clustering-test")
        pc = FaceClustering(logger=logger, device="cpu")
        with caplog.at_level(logging.INFO, logger="clustering-test"):
            pc(*pc.model.preprocess(path))
        assert sum("merged" in r.message for r in caplog.records) == 4

    def test_exported_from_the_package(self):
        from pyannote_video_tpu_torch.pipeline.face import Face

        assert pyannote_video_tpu_torch.FaceClustering is FaceClustering
        assert pyannote_video_tpu_torch.Face is Face
        assert {"Face", "FaceClustering"} <= set(pyannote_video_tpu_torch.__all__)
