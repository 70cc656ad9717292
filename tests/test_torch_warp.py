"""The port's patch sampler and tensor box functions against the JAX package.

Same numpy-seeded inputs through ``separable_resize_chips`` of both
packages.  Tolerance 4e-3 on 0-255 values: XLA fuses the coordinate
multiply-add and PyTorch does not, so a tap weight can differ in its last
bits.  Box functions: 1e-4 relative to the areas.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pyannote_video_tpu.ops import boxes as jboxes
from pyannote_video_tpu.ops.warp import separable_resize_chips as jax_chips

from pyannote_video_tpu_torch.ops import boxes
from pyannote_video_tpu_torch.ops.warp import separable_resize_chips


def _both(frames, idx, mats, out_h, out_w):
    ref = np.asarray(jax_chips(jnp.asarray(frames), jnp.asarray(idx),
                               jnp.asarray(mats), out_h, out_w))
    out = separable_resize_chips(
        torch.from_numpy(frames), torch.from_numpy(idx),
        torch.from_numpy(mats), out_h, out_w)
    assert out.dtype == torch.float32
    return out.numpy(), ref


def _random_matrices(rng, n, H, W):
    mats = np.zeros((n, 2, 3), np.float32)
    mats[:, 0, 0] = rng.uniform(0.3, 3.0, n)
    mats[:, 1, 1] = rng.uniform(0.3, 3.0, n)
    mats[:, 0, 2] = rng.uniform(-10, W - 5, n)
    mats[:, 1, 2] = rng.uniform(-10, H - 5, n)
    return mats


class TestSeparableResizeChips:
    @pytest.mark.parametrize("dtype", [np.uint8, np.float32])
    @pytest.mark.parametrize("channels", [1, 3])
    def test_random_scales_and_offsets(self, dtype, channels):
        rng = np.random.default_rng(0)
        T, H, W = 3, 40, 56
        frames = rng.uniform(0, 255, (T, H, W, channels)).astype(dtype)
        n = 12
        mats = _random_matrices(rng, n, H, W)
        idx = rng.integers(0, T, n).astype(np.int32)
        out, ref = _both(frames, idx, mats, 9, 11)
        assert out.shape == ref.shape == (n, 9, 11, channels)
        np.testing.assert_allclose(out, ref, atol=4e-3, rtol=0)

    def test_region_larger_than_the_frame(self):
        rng = np.random.default_rng(1)
        frames = rng.uniform(0, 255, (1, 20, 24, 1)).astype(np.float32)
        mats = np.asarray([[[10.0, 0.0, -40.0], [0.0, 10.0, -40.0]],
                           [[4.0, 0.0, -7.5], [0.0, 3.0, 5.25]]], np.float32)
        idx = np.zeros((2,), np.int32)
        out, ref = _both(frames, idx, mats, 12, 12)
        np.testing.assert_allclose(out, ref, atol=4e-3, rtol=0)
        # the far corners clamp to the frame's corner pixels
        assert out[0, 0, 0, 0] == frames[0, 0, 0, 0]
        assert out[0, -1, -1, 0] == frames[0, -1, -1, 0]

    def test_rotation_component_is_ignored(self):
        rng = np.random.default_rng(2)
        frames = rng.uniform(0, 255, (1, 30, 30, 1)).astype(np.float32)
        mats = np.asarray([[[1.5, 0.7, 2.0], [-0.4, 1.2, 3.0]]], np.float32)
        idx = np.zeros((1,), np.int32)
        out, ref = _both(frames, idx, mats, 8, 8)
        np.testing.assert_allclose(out, ref, atol=4e-3, rtol=0)
        straight = mats.copy()
        straight[:, 0, 1] = straight[:, 1, 0] = 0.0
        out2, _ = _both(frames, idx, straight, 8, 8)
        np.testing.assert_array_equal(out, out2)


def _random_boxes(rng, n):
    c = rng.uniform(10, 200, (n, 2))
    wh = rng.uniform(4, 80, (n, 2))
    return np.concatenate([c - wh / 2, c + wh / 2], axis=1).astype(np.float32)


class TestTensorBoxes:
    @pytest.fixture(scope="class")
    def ab(self):
        rng = np.random.default_rng(3)
        a, b = _random_boxes(rng, 16), _random_boxes(rng, 8)
        b[0] = a[0]                      # identical pair
        b[1] = a[1] + 1000.0             # disjoint pair
        b[2] = [a[2, 2] + 0.5, a[2, 1], a[2, 2] + 30, a[2, 3]]  # touching
        return a, b

    def _scale(self, a, b):
        return float(max(np.asarray(jboxes.box_area(a)).max(),
                         np.asarray(jboxes.box_area(b)).max()))

    def test_box_area(self, ab):
        a, _ = ab
        np.testing.assert_allclose(
            boxes.box_area_t(torch.from_numpy(a)).numpy(),
            np.asarray(jboxes.box_area(a)), rtol=1e-6)

    def test_intersection_area(self, ab):
        a, b = ab
        out = boxes.intersection_area_t(torch.from_numpy(a), torch.from_numpy(b))
        np.testing.assert_allclose(
            out.numpy(), np.asarray(jboxes.intersection_area(a, b)),
            atol=1e-4 * self._scale(a, b), rtol=0)

    @pytest.mark.parametrize("ratio", [0.3, 0.5])
    def test_gated_overlap(self, ab, ratio):
        a, b = ab
        out = boxes.gated_overlap_t(torch.from_numpy(a), torch.from_numpy(b),
                                    ratio).numpy()
        ref = np.asarray(jboxes.gated_overlap(a, b, ratio))
        assert np.array_equal(out > 0, ref > 0)
        np.testing.assert_allclose(out, ref, atol=1e-4 * self._scale(a, b),
                                   rtol=0)

    def test_overlap_min_ratio(self, ab):
        a, b = ab
        out = boxes.overlap_min_ratio_t(torch.from_numpy(a), torch.from_numpy(b))
        np.testing.assert_allclose(
            out.numpy(), np.asarray(jboxes.overlap_min_ratio(a, b)),
            atol=1e-4, rtol=0)

    def test_normalize_boxes(self, ab):
        a, _ = ab
        np.testing.assert_allclose(
            boxes.normalize_boxes(a, 320, 240),
            np.asarray(jboxes.normalize_boxes(a, 320, 240)), rtol=1e-6)
