"""The port's ORB (``ops/orb.py``) against the JAX package, on the CPU.

Same numpy-seeded inputs through the JAX function and its PyTorch
counterpart.  Tolerances: the BRIEF pattern, keypoints (x, y and the
quantised angle), ``valid``, Hamming distances and match counts exactly
(every value is an integer, or an angle bin, by construction); descriptor
bits on their share of equal bits, ≥ ``DESC_SHARE``: ``cos``/``sin`` may
differ by an ulp between XLA and torch and move a rotated sample point
that lies at .5 to the other pixel.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pyannote_video_tpu.ops import orb as jorb
from pyannote_video_tpu.utils.synthetic import _background

from pyannote_video_tpu_torch.ops import orb

DESC_SHARE = 0.999


def _frames(shape, seed):
    """[B, H, W] float32 gray frames with corners: the synthetic
    backgrounds plus seeded noise."""
    B, H, W = shape
    rng = np.random.default_rng(seed)
    g = np.stack([_background(W, H, rng).mean(axis=2) for _ in range(B)])
    return (g + rng.normal(0, 3, g.shape)).astype(np.float32)


def test_brief_pattern_bit_equal():
    ref = jorb._brief_pattern()
    out = orb._brief_pattern()
    assert out.dtype == ref.dtype == np.float32
    assert out.tobytes() == ref.tobytes()
    assert orb._CIRCLE.tobytes() == jorb._CIRCLE.tobytes()
    assert (orb.N_BITS, orb.PATCH, orb.FAST_T, orb.MAX_KP) == (
        jorb.N_BITS, jorb.PATCH, jorb.FAST_T, jorb.MAX_KP)


@pytest.mark.parametrize("shape", [(2, 120, 160), (3, 200, 267), (2, 97, 131)])
def test_detect_and_describe_matches_jax(shape):
    g = _frames(shape, seed=shape[2])
    jk, jv, jd = (np.asarray(a) for a in jorb.detect_and_describe(jnp.asarray(g)))
    k, v, d = (a.numpy() for a in orb.detect_and_describe(torch.from_numpy(g)))
    assert k.shape == (shape[0], orb.MAX_KP, 3) and d.shape == (shape[0], orb.MAX_KP, 256)
    assert v.dtype == np.bool_ and d.dtype == np.float32
    assert v.sum() > 20 * shape[0]
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_array_equal(k, jk)          # x, y and angle bins
    assert set(np.unique(d)) <= {0.0, 1.0}
    assert (d == jd).mean() >= DESC_SHARE


def test_detect_and_describe_threshold_and_slots():
    g = _frames((1, 120, 160), seed=5)
    for kp, threshold in ((64, 20.0), (300, 35.0)):
        jk, jv, _ = jorb.detect_and_describe(jnp.asarray(g), max_kp=kp,
                                             threshold=threshold)
        k, v, _ = orb.detect_and_describe(torch.from_numpy(g), max_kp=kp,
                                          threshold=threshold)
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(k.numpy(), np.asarray(jk))


def _descriptors(rng, Q, K, n_valid):
    """Seeded {0,1} descriptors where half the rows are noisy copies of the
    other side's (so the ratio test passes for some), and masks with the
    given valid counts."""
    d2 = (rng.uniform(size=(Q, K, 256)) < 0.5).astype(np.float32)
    flip = rng.uniform(size=d2.shape) < rng.uniform(0.02, 0.4, (Q, K, 1))
    d1 = np.where(flip, 1.0 - d2, d2).astype(np.float32)
    d1[:, K // 2:] = (rng.uniform(size=(Q, K - K // 2, 256)) < 0.5)
    v1 = np.zeros((Q, K), bool)
    v2 = np.zeros((Q, K), bool)
    for q in range(Q):
        v1[q, rng.permutation(K)[:n_valid[q][0]]] = True
        v2[q, rng.permutation(K)[:n_valid[q][1]]] = True
    return d1, v1, d2, v2


def test_hamming_and_ratio_matches_match_jax():
    rng = np.random.default_rng(11)
    K = 40
    n_valid = [(K, K), (0, K), (K, 0), (1, K), (K, 1), (1, 1), (2, 2),
               (25, 3), (3, 25), (K, 2)]
    d1, v1, d2, v2 = _descriptors(rng, len(n_valid), K, n_valid)
    args = [torch.from_numpy(a) for a in (d1, v1, d2, v2)]
    counts = orb.batched_ratio_matches(*args)
    ref = np.asarray(jorb.batched_ratio_matches(*(jnp.asarray(a) for a in (d1, v1, d2, v2))))
    assert counts.dtype == torch.int32
    np.testing.assert_array_equal(counts.numpy(), ref)
    assert ref[0] > 0
    for q in range(len(n_valid)):
        jb, js = jorb.hamming_2nn(d1[q], v1[q], d2[q], v2[q])
        b, s = orb.hamming_2nn(*(a[q] for a in args))
        np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
        assert orb.count_ratio_matches(*(a[q] for a in args)) == (
            jorb.count_ratio_matches(d1[q], v1[q], d2[q], v2[q])) == ref[q]


def test_matches_are_exact_under_tf32_flags():
    """{0,1} products summed over 256 bits are integers: the result does
    not depend on the matmul precision the caller chose."""
    rng = np.random.default_rng(12)
    d1, v1, d2, v2 = _descriptors(rng, 3, 30, [(30, 30)] * 3)
    args = [torch.from_numpy(a) for a in (d1, v1, d2, v2)]
    ref = orb.batched_ratio_matches(*args)
    saved = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("medium")
        assert torch.equal(orb.batched_ratio_matches(*args), ref)
    finally:
        torch.set_float32_matmul_precision(saved)


class TestOrbParity:
    def test_fast_corners_recover_cv2(self):
        """The port's FAST-9 (cv2-score ranking) recovers cv2's corners, as
        ``tests/test_flow.py::TestOrbParity`` holds the JAX one."""
        cv2 = pytest.importorskip("cv2")

        rng = np.random.default_rng(3)
        gray_u8 = _background(320, 240, rng).mean(axis=2).astype(np.uint8)
        fast = cv2.FastFeatureDetector_create(threshold=20, nonmaxSuppression=True)
        cv_pts = np.asarray([k.pt for k in fast.detect(gray_u8, None)])
        kps, valid, _ = orb.detect_and_describe(
            torch.from_numpy(gray_u8[None].astype(np.float32)))
        ours = kps[0][valid[0]].numpy()[:, :2]
        assert len(ours) >= len(cv_pts) * 0.5
        d = np.sqrt(((cv_pts[:, None, :] - ours[None, :, :]) ** 2).sum(-1))
        recall = (d.min(axis=1) <= 2.0).mean()
        assert recall > 0.75, f"only {recall:.0%} of cv2 corners recovered"
