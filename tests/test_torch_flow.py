"""The port's Farneback flow (``ops/flow.py``) and ``Shot(method=
"farneback")`` against the JAX package, on the CPU.

Same numpy-seeded inputs through the JAX function and its PyTorch
counterpart.  Tolerances: the expansion coefficients atol 1e-4 (taps
summed in another order than XLA's convolution, on 0-255 images);
flows atol 1e-3 px on textured pixels, where the 2×2 system is well
conditioned (on textureless pixels ``det`` sits at its 1e-9 guard and an
ulp moves the solution anywhere); the DFD series rtol 1e-4; shot
boundaries exactly.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pyannote_video_tpu.ops import flow as jflow
from pyannote_video_tpu.utils.synthetic import synthetic_episode

from pyannote_video_tpu_torch.ops import flow

# whole shot series on the CPU beside five other test workers
torch.set_num_threads(1)

COEF_ATOL = 1e-4
FLOW_ATOL = 1e-3
DFD_RTOL = 1e-4


def _smooth_noise(shape, seed=0, sigma=2.0):
    from scipy.ndimage import gaussian_filter

    rng = np.random.default_rng(seed)
    return gaussian_filter(rng.uniform(0, 255, shape).astype(np.float32), sigma)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def test_weights_equal_jax():
    for ours, ref in zip(flow._poly_expansion_weights(5, 1.1),
                         jflow._poly_expansion_weights(5, 1.1)):
        assert ours.tobytes() == ref.tobytes()
    assert flow._pyramid(50, 89, 3) == [(12, 22), (25, 44), (50, 89)]


@pytest.mark.parametrize("name", ["sep_corr", "warp_field", "box_blur"])
def test_parts_match_jax(name):
    rng = np.random.default_rng(1)
    x = rng.uniform(0, 255, (2, 23, 31)).astype(np.float32)
    field = rng.uniform(0, 255, (2, 23, 31, 3)).astype(np.float32)
    fl = rng.normal(0, 4, (2, 23, 31, 2)).astype(np.float32)
    k0, k1, _, _ = flow._poly_expansion_weights(5, 1.1)
    if name == "sep_corr":
        ref, out = jflow._sep_corr(jnp.asarray(x), k1, k0), flow._sep_corr(_t(x), k1, k0)
    elif name == "warp_field":
        ref = jflow._warp_field(jnp.asarray(field), jnp.asarray(fl))
        out = flow._warp_field(_t(field), _t(fl))
    else:
        ref, out = jflow._box_blur(jnp.asarray(field), 15), flow._box_blur(_t(field), 15)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=COEF_ATOL, rtol=0)


class TestPolyExpansion:
    def test_quadratic_recovered(self):
        H, W = 40, 50
        yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
        img = 0.02 * (xx - 25) ** 2 + 0.5 * (yy - 20) + 30.0
        A, b = flow.poly_expansion(_t(img[None]))
        assert A.shape == (1, H, W, 2, 2) and b.shape == (1, H, W, 2)
        assert abs(float(A[0, 20, 25, 0, 0]) - 0.02) < 0.005
        assert abs(float(b[0, 20, 25, 1]) - 0.5) < 0.05

    def test_matches_jax(self):
        img = _smooth_noise((2, 40, 50), seed=4)
        jA, jb = jflow.poly_expansion(jnp.asarray(img))
        A, b = flow.poly_expansion(_t(img))
        np.testing.assert_allclose(A.numpy(), np.asarray(jA), atol=COEF_ATOL, rtol=0)
        np.testing.assert_allclose(b.numpy(), np.asarray(jb), atol=COEF_ATOL, rtol=0)


class TestFlow:
    def test_translation_recovered(self):
        big = _smooth_noise((80, 100), seed=1)
        f0 = big[10:60, 10:80]
        f1 = big[12:62, 13:83]  # content shifted by (dy=2, dx=3)
        out = flow.farneback_flow(_t(f0[None]), _t(f1[None]))[0].numpy()
        ref = np.asarray(jflow.farneback_flow(jnp.asarray(f0[None]),
                                              jnp.asarray(f1[None])))[0]
        interior = out[10:40, 10:60]
        assert abs(np.median(interior[..., 0]) + 3.0) < 0.3
        assert abs(np.median(interior[..., 1]) + 2.0) < 0.3
        np.testing.assert_allclose(out, ref, atol=FLOW_ATOL, rtol=0)

    def test_batch_matches_jax(self):
        """Three pairs at the shot stage's width, incl. a cut: flows on the
        textured frames, one tap order away from JAX's."""
        frames = np.stack([_smooth_noise((50, 89), seed=s) for s in range(4)])
        frames[1] = np.roll(frames[0], (1, 2), axis=(0, 1))
        out = flow.farneback_flow(_t(frames[:-1]), _t(frames[1:])).numpy()
        ref = np.asarray(jflow.farneback_flow(jnp.asarray(frames[:-1]),
                                              jnp.asarray(frames[1:])))
        assert out.shape == (3, 50, 89, 2)
        np.testing.assert_allclose(out, ref, atol=FLOW_ATOL, rtol=0)

    def test_batch_shapes(self):
        f = torch.zeros((3, 40, 50))
        assert flow.farneback_flow(f, f).shape == (3, 40, 50, 2)

    def test_residual_separates_cut(self):
        big = _smooth_noise((80, 100), seed=2)
        f0 = big[10:60, 10:80]
        f1 = big[11:61, 12:82]
        f_cut = _smooth_noise((50, 70), seed=3)
        frames = np.stack([f0, f1, f_cut])
        d = flow.dfd_series_farneback(_t(frames)).numpy()
        ref = np.asarray(jflow.dfd_series_farneback(jnp.asarray(frames)))
        assert d[0] < 0.15 * d[1]
        np.testing.assert_allclose(d, ref, rtol=DFD_RTOL, atol=0)

    def test_warped_residual_matches_jax(self):
        rng = np.random.default_rng(6)
        prev, cur = (_smooth_noise((2, 30, 41), seed=s) for s in (7, 8))
        fl = rng.normal(0, 2, (2, 30, 41, 2)).astype(np.float32)
        out = flow.warped_residual(_t(prev), _t(cur), _t(fl)).numpy()
        ref = np.asarray(jflow.warped_residual(jnp.asarray(prev), jnp.asarray(cur),
                                               jnp.asarray(fl)))
        np.testing.assert_allclose(out, ref, rtol=DFD_RTOL, atol=0)


class TestShotFarneback:
    @pytest.fixture(scope="class")
    def episode(self):
        return synthetic_episode(n_shots=4, shot_frames=16, width=160,
                                 height=120, seed=7)

    @pytest.mark.parametrize("batch_size", [256, 16])
    def test_boundaries_match_jax(self, episode, batch_size):
        from pyannote_video_tpu import Video as JVideo
        from pyannote_video_tpu.pipeline.shot import Shot as JShot

        from pyannote_video_tpu_torch.io.video import Video
        from pyannote_video_tpu_torch.pipeline.shot import Shot

        for threshold in (2.0, 1.0):
            ref = JShot(JVideo(episode.frames, fps=episode.fps), threshold=threshold,
                        batch_size=batch_size, method="farneback")
            out = Shot(Video(episode.frames, fps=episode.fps), threshold=threshold,
                       batch_size=batch_size, method="farneback", device="cpu")
            ref_segments = [(s.start, s.end) for s in ref]
            assert [(s.start, s.end) for s in out] == ref_segments
            if threshold == 2.0:
                # cuts at frames 16/32/48: with 16-frame chunks each cut
                # pair spans a chunk edge and counts through the carry
                found = [end for _, end in ref_segments[:-1]]
                assert len(found) == len(episode.cuts)
                for expected, got in zip(episode.cuts, found):
                    assert abs(expected - got) <= 1.5 / episode.fps

    def test_unknown_method_raises(self, episode):
        from pyannote_video_tpu_torch.io.video import Video
        from pyannote_video_tpu_torch.pipeline.shot import Shot

        with pytest.raises(ValueError, match="unknown DFD method"):
            Shot(Video(episode.frames, fps=episode.fps), method="lucas-kanade",
                 device="cpu")
