"""The port's extract stage against the JAX package, on the CPU.

Same numpy-seeded inputs through each function of both packages.
Tolerances: coordinates and matrices 1e-4; pixels 4e-3 on 0-255 (tap
weights differ in their last bits between the two compilers); landmarks
5e-3 px, the bound the JAX package's own test holds its two cascade forms
to; a face beyond that is a split that flipped on a feature one ulp from
its threshold, bounded at 1 px; pooling, residual blocks and the float32
embedder 1e-5 / 1e-4; the bfloat16 embedder 0.05 in Euclidean distance (a
twelfth of the clustering threshold).  Images whose chips are cut from
*fitted* transforms are smooth: the two fits differ by ~1e-5 px, which a
noise image would turn into more than the pixel tolerance.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pyannote_video_tpu import Video as JVideo
from pyannote_video_tpu.cli import face_cli as jface_cli
from pyannote_video_tpu.core import formats as jformats
from pyannote_video_tpu.models import chip as jchip
from pyannote_video_tpu.models import embedder as jembedder
from pyannote_video_tpu.models import landmarks as jlandmarks
from pyannote_video_tpu.models import nn as jnn
from pyannote_video_tpu.models.weights import EMBEDDER_FILE as J_EMBEDDER_FILE
from pyannote_video_tpu.models.weights import LANDMARKS_FILE as J_LANDMARKS_FILE
from pyannote_video_tpu.ops import warp as jwarp
from pyannote_video_tpu.utils.synthetic import synthetic_episode

from pyannote_video_tpu_torch.cli import face_cli
from pyannote_video_tpu_torch.core import formats
from pyannote_video_tpu_torch.io.video import Video
from pyannote_video_tpu_torch.models import chip, embedder, landmarks, nn, weights
from pyannote_video_tpu_torch.ops import warp

from test_landmarks_parity import _crops_and_frames, _random_cascade

PIXEL_TOL = 4e-3
LANDMARK_TOL = 5e-3


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _smooth_frames(rng, T, H, W, C=3):
    """Low-pass random frames, uint8: gradients of a few levels per pixel."""
    coarse = rng.uniform(0, 255, (T, H // 8 + 2, W // 8 + 2, C))
    up = np.kron(coarse, np.ones((1, 8, 8, 1)))[:, :H + 8, :W + 8]
    k = np.ones(9) / 9.0
    for axis in (1, 2):
        up = np.apply_along_axis(lambda v: np.convolve(v, k, "same"), axis, up)
    return np.clip(up[:, 4:H + 4, 4:W + 4], 0, 255).astype(np.uint8)


def _rolled_landmarks(rng, boxes, max_roll=0.3, jitter=1.0):
    """Mean-shape landmarks in ``boxes``, rolled and jittered per face."""
    lm = np.asarray(jchip.box_to_landmarks(jnp.asarray(boxes)))
    th = rng.uniform(-max_roll, max_roll, len(boxes))
    R = np.stack([np.stack([np.cos(th), -np.sin(th)], 1),
                  np.stack([np.sin(th), np.cos(th)], 1)], 1)
    c = lm.mean(1, keepdims=True)
    return ((lm - c) @ R.transpose(0, 2, 1) + c
            + rng.normal(0, jitter, lm.shape)).astype(np.float32)


# -- weight loading -----------------------------------------------------------


class TestParams:
    def test_packaged_embedder_loads(self):
        state = nn.load_params(weights.EMBEDDER_FILE)
        assert set(state) >= {"stem", "stem_bn", "blocks", "fc"}
        assert state["stem"]["w"].shape == (32, 3, 7, 7)
        assert state["fc"].shape == (256, 128)
        assert len(state["blocks"]) == len(embedder.BLOCK_PLAN) == 14
        ref = jnn.load_params(str(J_EMBEDDER_FILE))
        w = np.asarray(ref["blocks"]["block3"]["conv1"]["w"])      # HWIO
        np.testing.assert_array_equal(
            state["blocks"]["block3"]["conv1"]["w"].numpy(),
            w.transpose(3, 2, 0, 1))
        np.testing.assert_array_equal(state["fc"].numpy(), np.asarray(ref["fc"]))
        np.testing.assert_array_equal(
            state["blocks"]["block13"]["bn2"]["var"].numpy(),
            np.asarray(ref["blocks"]["block13"]["bn2"]["var"]))

    def test_packaged_cascade_loads(self):
        params = landmarks._load(weights.LANDMARKS_FILE)
        ref = jlandmarks._load(str(J_LANDMARKS_FILE))
        assert weights.LANDMARKS_FILE.samefile(J_LANDMARKS_FILE)
        for key in ("n_stages", "depth", "bilinear_tail"):
            assert isinstance(params[key], int) and params[key] == ref[key]
        assert set(params) == set(ref)
        assert params["s0/anchor"].dtype == torch.long
        assert params["s3/i1"].dtype == torch.long
        assert params["s14/leaves"].dtype == torch.float32
        for key in ("mean_shape", "s0/anchor", "s7/i2", "s7/thresh",
                    "s14/leaves", "s2/offset"):
            np.testing.assert_array_equal(params[key].numpy(),
                                          np.asarray(ref[key]))

    def test_random_narrow_embedder_carries_across(self):
        p = jembedder.init_params(jax.random.PRNGKey(3), width=0.125)
        flat = {k: np.asarray(v) for k, v in jnn.flatten_params(p).items()}
        state = nn.params_from_jax(flat)
        assert state["stem"]["w"].shape == (8, 3, 7, 7)
        assert state["fc"].shape == (32, 128)
        assert state["blocks"]["block7"]["conv1"]["w"].shape == (16, 8, 3, 3)
        assert "normalized_head" not in state

    @pytest.mark.parametrize("flag", [0, 1])
    def test_normalized_head_becomes_a_bool(self, flag):
        state = nn.params_from_jax({"fc": np.eye(4, dtype=np.float32),
                                    "normalized_head": np.asarray(flag)})
        assert state["normalized_head"] is bool(flag)

    def test_missing_packaged_file_raises(self, monkeypatch, tmp_path):
        monkeypatch.setattr(weights, "EMBEDDER_FILE", tmp_path / "none.npz")
        monkeypatch.setattr(weights, "LANDMARKS_FILE", tmp_path / "none.npz")
        with pytest.raises(FileNotFoundError):
            embedder.FaceEmbedder(device="cpu")
        with pytest.raises(FileNotFoundError):
            landmarks.LandmarkPredictor(device="cpu")

    def test_other_width_without_params_waits_for_training(self):
        """Another width asks for a fresh model, as the JAX class does: the
        shapes of that width, drawn from a generator seeded 0 (so twice the
        same model), and embeddings of the right shape."""
        a = embedder.FaceEmbedder(width=0.5, device="cpu")
        b = embedder.FaceEmbedder(width=0.5, device="cpu")
        assert a.params["stem"]["w"].shape == (16, 3, 7, 7)
        assert a.params["fc"].shape == (128, 128)
        assert a.params["blocks"]["block12"]["conv2"]["w"].shape == (128, 128, 3, 3)
        for key, value in nn.flatten_params(a.params).items():
            assert torch.equal(value, nn.flatten_params(b.params)[key]), key
        emb = a(np.zeros((2, 150, 150, 3), np.uint8))
        assert emb.shape == (2, 128) and np.isfinite(emb).all()


# -- ops/warp.py --------------------------------------------------------------


class TestWarp:
    @pytest.mark.parametrize("channels", [0, 3])
    def test_bilinear_sample(self, channels):
        rng = np.random.default_rng(0)
        shape = (30, 41) + ((channels,) if channels else ())
        image = rng.uniform(0, 255, shape).astype(np.float32)
        ys = rng.uniform(-4, 34, (7, 9)).astype(np.float32)
        xs = rng.uniform(-4, 45, (7, 9)).astype(np.float32)
        ref = np.asarray(jwarp.bilinear_sample(jnp.asarray(image),
                                               jnp.asarray(ys), jnp.asarray(xs)))
        out = warp.bilinear_sample(_t(image), _t(ys), _t(xs)).numpy()
        assert out.shape == ref.shape
        np.testing.assert_allclose(out, ref, atol=PIXEL_TOL, rtol=0)

    @pytest.mark.parametrize("dtype", [np.uint8, np.float32])
    def test_gather_affine_warp(self, dtype):
        rng = np.random.default_rng(1)
        T, H, W = 3, 40, 56
        frames = rng.uniform(0, 255, (T, H, W, 3)).astype(dtype)
        n = 6
        th = rng.uniform(-0.5, 0.5, n)
        sc = rng.uniform(0.4, 2.0, n)
        mats = np.stack([
            np.stack([sc * np.cos(th), -sc * np.sin(th), rng.uniform(-5, W, n)], 1),
            np.stack([sc * np.sin(th), sc * np.cos(th), rng.uniform(-5, H, n)], 1),
        ], 1).astype(np.float32)
        idx = rng.integers(0, T, n).astype(np.int32)
        ref = np.asarray(jwarp.gather_affine_warp(
            jnp.asarray(frames).astype(jnp.float32), jnp.asarray(idx),
            jnp.asarray(mats), 11, 13))
        out = warp.gather_affine_warp(_t(frames), _t(idx), _t(mats), 11, 13)
        assert out.dtype == torch.float32 and out.shape == (n, 11, 13, 3)
        np.testing.assert_allclose(out.numpy(), ref, atol=PIXEL_TOL, rtol=0)
        # the thin forms: one image, and image i with matrix i
        one = warp.affine_warp(_t(frames[1]), _t(mats[0]), 11, 13).numpy()
        ref_one = np.asarray(jwarp.affine_warp(
            jnp.asarray(frames[1]).astype(jnp.float32), jnp.asarray(mats[0]),
            11, 13))
        np.testing.assert_allclose(one, ref_one, atol=PIXEL_TOL, rtol=0)
        each = warp.batched_affine_warp(_t(frames), _t(mats[:T]), 11, 13).numpy()
        ref_each = np.asarray(jwarp.batched_affine_warp(
            jnp.asarray(frames).astype(jnp.float32), jnp.asarray(mats[:T]),
            11, 13))
        np.testing.assert_allclose(each, ref_each, atol=PIXEL_TOL, rtol=0)

    def test_similarity_from_points_batched_against_vmap(self):
        rng = np.random.default_rng(2)
        src = rng.uniform(0, 150, (68, 2)).astype(np.float32)
        dst = rng.uniform(0, 300, (9, 68, 2)).astype(np.float32)
        ref = np.asarray(jax.vmap(
            lambda d: jwarp.similarity_from_points(jnp.asarray(src), d))(
                jnp.asarray(dst)))
        out = warp.similarity_from_points(_t(src), _t(dst)).numpy()
        assert out.shape == (9, 2, 3)
        np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)
        single = warp.similarity_from_points(_t(src), _t(dst[4])).numpy()
        np.testing.assert_allclose(single, ref[4], atol=1e-4, rtol=0)

    def test_invert_affine(self):
        rng = np.random.default_rng(3)
        th = rng.uniform(-1, 1, 5)
        sc = rng.uniform(0.5, 3.0, 5)
        mats = np.stack([
            np.stack([sc * np.cos(th), -sc * np.sin(th), rng.uniform(-9, 9, 5)], 1),
            np.stack([sc * np.sin(th), sc * np.cos(th), rng.uniform(-9, 9, 5)], 1),
        ], 1).astype(np.float32)
        out = warp.invert_affine(_t(mats)).numpy()
        for m, o in zip(mats, out):
            ref = np.asarray(jwarp.invert_affine(jnp.asarray(m)))
            np.testing.assert_allclose(o, ref, atol=1e-4, rtol=0)
        np.testing.assert_allclose(
            warp.invert_affine(_t(mats[0])).numpy(), out[0], atol=0, rtol=0)


# -- models/landmarks.py ------------------------------------------------------


class TestCascade:
    @pytest.mark.parametrize("size", ["crops", "frames"])
    @pytest.mark.parametrize("bilinear_tail", [None, 1, 0])
    def test_random_cascades(self, bilinear_tail, size):
        """The three cascades of the JAX package's dense-vs-gather test, on
        128²-class crops (its dense branch) and on the 320² padded frames
        (its gather branch): the port has one form for both."""
        rng = np.random.default_rng(42)
        params = _random_cascade(rng, bilinear_tail=bilinear_tail)
        crops, frames, boxes_crop, boxes_frame = _crops_and_frames(rng, 5)
        images, boxes = ((crops, boxes_crop) if size == "crops"
                         else (frames, boxes_frame))
        ref = np.asarray(jlandmarks.predict_cascade(
            params, jnp.asarray(images), jnp.asarray(boxes)))
        out = landmarks.predict_cascade(
            landmarks.cascade_from_jax(params), _t(images), _t(boxes)).numpy()
        np.testing.assert_allclose(out, ref, atol=LANDMARK_TOL, rtol=0)

    def test_dlib_branch_with_boxes_off_the_frame(self):
        rng = np.random.default_rng(3)
        params = _random_cascade(rng, n_stages=2, bilinear_tail=0)
        img = rng.uniform(100.0, 255.0, (3, 64, 64)).astype(np.float32)
        boxes = np.asarray([[-16.0, -16.0, 16.0, 16.0],
                            [40.0, 44.0, 80.0, 84.0],
                            [20.0, -10.0, 50.0, 20.0]], np.float32)
        ref = np.asarray(jlandmarks.predict_cascade(
            params, jnp.asarray(img), jnp.asarray(boxes)))
        tp = landmarks.cascade_from_jax(params)
        out = landmarks.predict_cascade(tp, _t(img), _t(boxes)).numpy()
        np.testing.assert_allclose(out, ref, atol=LANDMARK_TOL, rtol=0)
        # and the mask matters: a clamping cascade gives other landmarks
        clamped = landmarks.predict_cascade(
            {**tp, "bilinear_tail": 2}, _t(img), _t(boxes)).numpy()
        assert np.abs(clamped - out).max() > 1e-2

    def test_similarity_to_current(self):
        rng = np.random.default_rng(4)
        mean = np.asarray(jlandmarks.CANONICAL_LANDMARKS, np.float32)
        shapes = (mean[None] * rng.uniform(0.5, 1.5, (6, 1, 1))
                  + rng.normal(0, 0.05, (6, 68, 2))).astype(np.float32)
        a, b = landmarks._similarity_to_current(_t(mean), _t(shapes))
        for i in range(6):
            ref = np.asarray(jlandmarks._similarity_to_current(
                jnp.asarray(mean), jnp.asarray(shapes[i])))
            np.testing.assert_allclose(
                [[a[i], -b[i]], [b[i], a[i]]], ref, atol=1e-5, rtol=0)

    def test_mean_shape_only_returns_the_mean_shape_in_the_box(self):
        boxes = np.asarray([[10.0, 20.0, 50.0, 80.0]], np.float32)
        out = landmarks.predict_cascade(
            landmarks.mean_shape_only(), torch.zeros(1, 90, 90), _t(boxes))
        ref = np.asarray(jchip.box_to_landmarks(jnp.asarray(boxes)))
        np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=0)


@pytest.fixture(scope="module")
def episode():
    return synthetic_episode(n_shots=2, shot_frames=12, width=160, height=120,
                             seed=5, face_height_ratio=0.5)


def _jax_leaves(monkeypatch, params, grays, fidx, boxes):
    """The JAX cascade's landmarks and per-stage leaf indices: the function
    runs op by op and its last ``one_hot`` of a stage takes the leaves."""
    n_leaves = 1 << params["depth"]
    seen = []
    real = jax.nn.one_hot

    def spy(x, num_classes, **kw):
        if num_classes == n_leaves:
            seen.append(np.asarray(x))
        return real(x, num_classes, **kw)

    monkeypatch.setattr(jax.nn, "one_hot", spy)
    lm = np.asarray(jlandmarks.predict_crops(
        params, jnp.asarray(grays), jnp.asarray(fidx), jnp.asarray(boxes)))
    monkeypatch.undo()
    return lm, seen


class TestPackagedCascade:
    def test_predict_crops_on_eight_faces(self, episode, monkeypatch):
        faces = episode.faces[::3][:8]
        assert len(faces) == 8
        frames = np.stack([episode.frames[o.frame] for o in faces])
        grays = (frames.astype(np.float32) @ np.asarray(
            [0.299, 0.587, 0.114], np.float32))
        fidx = np.arange(8, dtype=np.int32)
        boxes = np.asarray([o.box for o in faces], np.float32)

        jparams = jlandmarks._load(str(J_LANDMARKS_FILE))
        ref, ref_leaves = _jax_leaves(monkeypatch, jparams, grays, fidx, boxes)
        out, out_leaves = landmarks.predict_crops(
            landmarks._load(weights.LANDMARKS_FILE), _t(grays), _t(fidx),
            _t(boxes), return_leaves=True)
        err = np.abs(out.numpy() - ref).max(axis=(1, 2))
        agree = err <= LANDMARK_TOL
        assert agree.sum() >= 7, f"per-face error (px): {err}"
        assert err.max() <= 1.0, f"per-face error (px): {err}"
        assert len(ref_leaves) == len(out_leaves) == jparams["n_stages"] == 15
        for s, (a, b) in enumerate(zip(out_leaves, ref_leaves)):
            assert a.shape == (8, 224)
            np.testing.assert_array_equal(
                a.numpy()[agree], b[agree], err_msg=f"stage {s}")
        # the cascade moved the shape: it is not the mean shape in the box
        mean = np.asarray(jchip.box_to_landmarks(jnp.asarray(boxes)))
        assert np.abs(out.numpy() - mean).max() > 1.0

    def test_predictor_predict_batch(self, episode):
        faces = episode.faces[:4]
        frames = np.stack([episode.frames[o.frame] for o in faces])
        fidx = np.arange(4, dtype=np.int32)
        boxes = np.asarray([o.box for o in faces], np.float32)
        ref = jlandmarks.LandmarkPredictor().predict_batch(frames, fidx, boxes)
        out = landmarks.LandmarkPredictor(device="cpu").predict_batch(
            frames, fidx, boxes)
        err = np.abs(out - ref).max(axis=(1, 2))
        assert (err <= LANDMARK_TOL).sum() >= 3 and err.max() <= 1.0, err
        gray = landmarks.LandmarkPredictor(device="cpu").predict_batch(
            frames.astype(np.float32) @ np.asarray([0.299, 0.587, 0.114],
                                                   np.float32), fidx, boxes)
        assert np.abs(gray - out).max() <= 1.0


# -- models/chip.py -----------------------------------------------------------


class TestChips:
    @pytest.fixture(scope="class")
    def scene(self):
        rng = np.random.default_rng(7)
        frames = _smooth_frames(rng, 3, 120, 160)
        boxes = np.asarray([[30, 20, 90, 80], [60, 40, 110, 95],
                            [10, 10, 60, 70], [100, 50, 150, 110],
                            [-10, 30, 40, 85]], np.float32)
        fidx = np.asarray([0, 1, 2, 1, 0], np.int32)
        return frames, fidx, _rolled_landmarks(rng, boxes)

    def test_canonical_chip_landmarks(self):
        np.testing.assert_array_equal(chip.canonical_chip_landmarks(),
                                      jchip.canonical_chip_landmarks())
        np.testing.assert_array_equal(chip.canonical_chip_landmarks(96, 0.1),
                                      jchip.canonical_chip_landmarks(96, 0.1))

    def test_chip_transforms_and_axis_aligned(self, scene):
        _, _, lm = scene
        ref = jchip.chip_transforms(jnp.asarray(lm))
        out = chip.chip_transforms(_t(lm))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=0)
        ref_aa = np.asarray(jchip._axis_aligned(ref, 150.0))
        out_aa = chip._axis_aligned(out, 150.0).numpy()
        np.testing.assert_allclose(out_aa, ref_aa, atol=1e-4, rtol=0)
        assert (out_aa[:, 0, 1] == 0).all() and (out_aa[:, 1, 0] == 0).all()

    @pytest.mark.parametrize("name", ["extract_chips", "extract_chips_exact"])
    def test_rgb_chips(self, scene, name):
        frames, fidx, lm = scene
        ref = np.asarray(getattr(jchip, name)(
            jnp.asarray(frames), jnp.asarray(fidx), jnp.asarray(lm)))
        out = getattr(chip, name)(_t(frames), _t(fidx), _t(lm))
        assert out.dtype == torch.float32 and out.shape == (5, 150, 150, 3)
        np.testing.assert_allclose(out.numpy(), ref, atol=PIXEL_TOL, rtol=0)

    def test_exact_chips_keep_the_roll(self, scene):
        frames, fidx, lm = scene
        a = chip.extract_chips(_t(frames), _t(fidx), _t(lm)).numpy()
        b = chip.extract_chips_exact(_t(frames), _t(fidx), _t(lm)).numpy()
        assert np.abs(a - b).max() > 5.0

    def test_yuv_chips(self, scene):
        frames, fidx, lm = scene
        y = frames[..., 0].copy()
        u = frames[:, ::2, ::2, 1].copy()
        v = frames[:, ::2, ::2, 2].copy()
        ref = np.asarray(jchip.extract_chips_yuv(
            jnp.asarray(y), jnp.asarray(u), jnp.asarray(v), jnp.asarray(fidx),
            jnp.asarray(lm)))
        out = chip.extract_chips_yuv(_t(y), _t(u), _t(v), _t(fidx), _t(lm))
        assert out.shape == (5, 150, 150, 3)
        assert float(out.min()) >= 0.0 and float(out.max()) <= 255.0
        np.testing.assert_allclose(out.numpy(), ref, atol=PIXEL_TOL, rtol=0)

    def test_box_to_landmarks(self):
        boxes = np.asarray([[30, 20, 90, 80], [-5, 4, 33, 61.5]], np.float32)
        np.testing.assert_allclose(
            chip.box_to_landmarks(_t(boxes)).numpy(),
            np.asarray(jchip.box_to_landmarks(jnp.asarray(boxes))),
            atol=1e-4, rtol=0)


# -- models/nn.py and models/embedder.py --------------------------------------


def _nchw(x):
    return _t(np.asarray(x).transpose(0, 3, 1, 2))


def _nhwc(t):
    return t.numpy().transpose(0, 2, 3, 1)


class TestBlocks:
    @pytest.mark.parametrize("size", [35, 8])
    @pytest.mark.parametrize("down", [False, True])
    def test_resblock(self, down, size):
        """Odd sizes: at 35 the pooled skip (17) agrees with the VALID
        strided conv (17); at 8 it is 4 against 3 and must be cropped."""
        rng = np.random.default_rng(size + down)
        c_in, c_out = 6, (10 if down else 6)
        p = jnn.resblock_init(jax.random.PRNGKey(size), c_in, c_out)
        for bn in ("bn1", "bn2"):
            p[bn] = {"scale": jnp.asarray(rng.uniform(0.5, 1.5, c_out), jnp.float32),
                     "bias": jnp.asarray(rng.normal(0, 0.2, c_out), jnp.float32),
                     "mean": jnp.asarray(rng.normal(0, 0.2, c_out), jnp.float32),
                     "var": jnp.asarray(rng.uniform(0.5, 2.0, c_out), jnp.float32)}
        x = rng.normal(0, 1, (2, size, size, c_in)).astype(np.float32)
        ref, _ = jnn.resblock(p, jnp.asarray(x), down=down)
        state = nn.params_from_jax(
            {k: np.asarray(v) for k, v in jnn.flatten_params(p).items()})
        out, _ = nn.resblock(state, _nchw(x), down=down)
        assert _nhwc(out).shape == np.asarray(ref).shape
        if down:
            assert out.shape[2] == (size - 3) // 2 + 1
        np.testing.assert_allclose(_nhwc(out), np.asarray(ref), atol=1e-5, rtol=0)

    @pytest.mark.parametrize("size", [35, 72])
    def test_max_pool(self, size):
        x = np.random.default_rng(0).normal(0, 1, (2, size, size, 5)).astype(np.float32)
        ref = np.asarray(jnn.max_pool(jnp.asarray(x), 3, 2))
        np.testing.assert_allclose(_nhwc(nn.max_pool(_nchw(x), 3, 2)), ref,
                                   atol=1e-5, rtol=0)

    @pytest.mark.parametrize("size", [35, 8])
    def test_avg_pool(self, size):
        x = np.random.default_rng(1).normal(0, 1, (2, size, size, 5)).astype(np.float32)
        ref = np.asarray(jnn.avg_pool(jnp.asarray(x), 2, 2))
        np.testing.assert_allclose(_nhwc(nn.avg_pool(_nchw(x), 2, 2)), ref,
                                   atol=1e-5, rtol=0)

    def test_global_avg_pool(self):
        x = np.random.default_rng(2).normal(0, 1, (3, 4, 5, 6)).astype(np.float32)
        ref = np.asarray(jnn.global_avg_pool(jnp.asarray(x)))
        np.testing.assert_allclose(nn.global_avg_pool(_nchw(x)).numpy(), ref,
                                   atol=1e-6, rtol=0)


class TestEmbedder:
    def test_plan_and_constants(self):
        assert embedder.BLOCK_PLAN == jembedder.BLOCK_PLAN
        assert embedder._LEVELS == jembedder._LEVELS
        assert (embedder.CHIP_SIZE, embedder.EMBED_DIM) == (150, 128)

    @pytest.mark.parametrize("head", [None, True, False])
    def test_narrow_float32(self, head):
        rng = np.random.default_rng(11)
        p = jembedder.init_params(jax.random.PRNGKey(1), width=0.125)
        if head is not None:
            p["normalized_head"] = jnp.asarray(int(head))
        chips = rng.uniform(0, 255, (4, 150, 150, 3)).astype(np.float32)
        ref, _ = jembedder.forward(p, jnp.asarray(chips),
                                   compute_dtype=jnp.float32)
        state = nn.params_from_jax(
            {k: np.asarray(v) for k, v in jnn.flatten_params(p).items()})
        out = embedder.forward(state, _t(chips), compute_dtype=torch.float32)
        assert out.shape == (4, 128) and out.dtype == torch.float32
        scale = max(1.0, float(np.abs(np.asarray(ref)).max()))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                                   atol=1e-4 * scale, rtol=0)
        norms = np.linalg.norm(out.numpy(), axis=1)
        if head is False:
            assert np.abs(norms - 1.0).max() > 1e-2
        else:
            np.testing.assert_allclose(norms, 1.0, atol=1e-5)

    @pytest.fixture(scope="class")
    def face_chips(self, episode):
        faces = [episode.faces[0], episode.faces[-1]]
        frames = np.stack([episode.frames[o.frame] for o in faces])
        lm = np.stack([o.landmarks for o in faces]).astype(np.float32)
        return chip.extract_chips(_t(frames), torch.arange(2), _t(lm)).numpy()

    def test_packaged_float32(self, face_chips):
        ref, _ = jembedder.forward(jnn.load_params(str(J_EMBEDDER_FILE)),
                                   jnp.asarray(face_chips),
                                   compute_dtype=jnp.float32)
        out = embedder.forward(weights.default_embedder_params(),
                               _t(face_chips), compute_dtype=torch.float32)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=0)

    def test_packaged_bfloat16_distance(self, face_chips):
        ref = np.asarray(jembedder.embed(
            jnn.load_params(str(J_EMBEDDER_FILE)), jnp.asarray(face_chips)))
        out = embedder.FaceEmbedder(device="cpu")(face_chips)
        dist = np.linalg.norm(out - ref, axis=1)
        assert dist.max() <= 0.05, f"bf16 distance to JAX bf16: {dist}"
        np.testing.assert_allclose(np.linalg.norm(out, axis=1), 1.0, atol=1e-3)


# -- the slice as a whole -----------------------------------------------------


def _tracking_file(ep, path):
    """One tracking file from the episode's true boxes, one track per shot."""
    W, H = ep.frames.shape[2], ep.frames.shape[1]
    shot_frames = len(ep.frames) // len(ep.shots)
    with open(path, "w") as fp:
        for o in ep.faces:
            l, t, r, b = o.box
            formats.write_track_point(fp, formats.TrackPoint(
                t=o.frame / ep.fps, identifier=o.frame // shot_frames,
                left=l / W, top=t / H, right=r / W, bottom=b / H,
                status="detection"))
    return W, H


class TestChain:
    @pytest.fixture(scope="class")
    def chain(self, episode, tmp_path_factory):
        tmp = tmp_path_factory.mktemp("chain")
        tracking = str(tmp / "tracking.txt")
        W, H = _tracking_file(episode, tracking)
        paths = {k: str(tmp / k) for k in
                 ("jlm", "jemb", "lm", "emb", "xlm", "xemb")}
        jface_cli._extract_legacy(
            JVideo(episode.frames, fps=episode.fps),
            jlandmarks.LandmarkPredictor(), _F32JaxEmbedder(),
            jformats.read_tracking(tracking), paths["jlm"], paths["jemb"],
            False)
        # the chunked engine, which is what ``_extract_legacy`` is
        with pytest.MonkeyPatch.context() as patch:
            patch.setenv("PYV_NO_STREAM", "1")
            face_cli.extract(Video(episode.frames, fps=episode.fps), "", "",
                             tracking, paths["lm"], paths["emb"], device="cpu",
                             compute_dtype=torch.float32)
            face_cli.extract(Video(episode.frames, fps=episode.fps), "", "",
                             tracking, paths["xlm"], paths["xemb"],
                             exact_chips=True, device="cpu",
                             compute_dtype=torch.float32)
        return tracking, paths, (W, H)

    def test_same_lines_in_the_same_order(self, chain, episode):
        tracking, paths, _ = chain
        points = jformats.read_tracking(tracking)
        ref = jformats.read_landmarks(paths["jlm"])
        out = jformats.read_landmarks(paths["lm"])      # the JAX parser reads
        assert len(out) == len(ref) == len(points) == len(episode.faces)
        assert [(t, i) for t, i, _ in out] == [(t, i) for t, i, _ in ref]
        rt, ri, _ = jformats.read_embeddings(paths["jemb"])
        ot, oi, ox = jformats.read_embeddings(paths["emb"])
        np.testing.assert_array_equal(ot, rt)
        np.testing.assert_array_equal(oi, ri)
        assert ox.shape == (len(points), 128)
        assert [(t, i) for t, i, _ in out] == sorted(
            (round(p.t, 3), p.identifier) for p in points)

    def test_landmarks_within_tolerance(self, chain):
        _, paths, (W, H) = chain
        ref = np.stack([lm for _, _, lm in jformats.read_landmarks(paths["jlm"])])
        out = np.stack([lm for _, _, lm in formats.read_landmarks(paths["lm"])])
        # the files hold 5 decimals of a normalized coordinate
        err = (np.abs(out - ref) * [W, H]).max(axis=(1, 2))
        tol = LANDMARK_TOL + 1e-5 * W
        assert (err <= tol).mean() >= 0.9, err
        assert err.max() <= 1.0, err

    def test_embeddings_within_tolerance(self, chain):
        _, paths, (W, H) = chain
        ref_lm = np.stack([lm for _, _, lm in jformats.read_landmarks(paths["jlm"])])
        out_lm = np.stack([lm for _, _, lm in formats.read_landmarks(paths["lm"])])
        same = (np.abs(out_lm - ref_lm) * [W, H]).max(axis=(1, 2)) <= LANDMARK_TOL + 1e-5 * W
        _, _, ref = jformats.read_embeddings(paths["jemb"])
        _, _, out = formats.read_embeddings(paths["emb"])
        assert same.mean() >= 0.9
        # where the landmarks agree the chips do, and so do the embeddings
        assert np.abs(out - ref)[same].max() <= 1e-3
        # a flipped split moves a landmark by a leaf delta and the chip with it
        assert np.linalg.norm(out - ref, axis=1).max() <= 0.05

    def test_exact_chips_give_other_embeddings(self, chain):
        _, paths, _ = chain
        _, _, a = formats.read_embeddings(paths["emb"])
        _, _, b = formats.read_embeddings(paths["xemb"])
        assert a.shape == b.shape
        np.testing.assert_allclose(np.linalg.norm(b, axis=1), 1.0, atol=1e-3)
        assert [(t, i) for t, i, _ in formats.read_landmarks(paths["xlm"])] == \
            [(t, i) for t, i, _ in formats.read_landmarks(paths["lm"])]

    def test_clustering_labels_identical(self, chain):
        from pyannote_video_tpu.pipeline.clustering import FaceClustering as JClustering
        from pyannote_video_tpu_torch.pipeline.clustering import FaceClustering

        _, paths, _ = chain
        jc = JClustering(threshold=0.6)
        ref = jc(*_pre(jc, paths["emb"]))
        pc = FaceClustering(threshold=0.6, device="cpu")
        out = pc(*_pre(pc, paths["emb"]))
        assert ([(s.start, s.end, t, l) for s, t, l in out.itertracks(yield_label=True)]
                == [(s.start, s.end, t, l) for s, t, l in ref.itertracks(yield_label=True)])

    def test_cli_main_extract(self, chain, episode, tmp_path, monkeypatch):
        """``main(["extract", ...])`` reaches ``extract`` with its flags."""
        tracking, paths, _ = chain
        calls = {}
        monkeypatch.setattr(face_cli, "extract",
                            lambda *a, **k: calls.update(args=a, kwargs=k))
        monkeypatch.setattr(
            "pyannote_video_tpu_torch.io.video.Video.__init__",
            lambda self, *a, **k: None)
        face_cli.main(["extract", "--exact-chips", "clip.avi", tracking, "", "",
                       str(tmp_path / "l"), str(tmp_path / "e")], device="cpu")
        assert calls["args"][1:] == ("", "", tracking, str(tmp_path / "l"),
                                     str(tmp_path / "e"))
        assert calls["kwargs"]["exact_chips"] is True
        assert calls["kwargs"]["device"] == torch.device("cpu")

    @pytest.mark.parametrize("argv", [
        ["demo", "clip.avi", "tracking.txt", "out.avi"],
        ["demo", "--label=labels.txt", "clip.avi", "tracking.txt", "out.avi"]])
    def test_unported_commands_name_their_roadmap_item(self, argv, monkeypatch):
        """No command is left unported: ``demo`` runs, with its flags."""
        calls = {}
        monkeypatch.setattr(face_cli, "demo",
                            lambda *a, **k: calls.update(args=a, kwargs=k))
        assert face_cli.main(argv, device="cpu") is None
        assert calls["args"] == ("clip.avi", "tracking.txt", "out.avi")
        assert calls["kwargs"]["labels_path"] == (
            "labels.txt" if "--label=labels.txt" in argv else None)


def _pre(clustering, path):
    starting_point, features = clustering.model.preprocess(path)
    return starting_point, features


class _F32JaxEmbedder:
    """The JAX embedder with float32 convs, called as ``FaceEmbedder`` is."""

    def __init__(self):
        params = jnn.load_params(str(J_EMBEDDER_FILE))
        self._fn = jax.jit(lambda chips: jembedder.forward(
            params, chips, compute_dtype=jnp.float32)[0])

    def __call__(self, chips):
        return np.asarray(self._fn(jnp.asarray(chips)))


class TestFace:
    def test_against_jax_face_on_one_frame(self, episode):
        from pyannote_video_tpu.pipeline import face as jface
        from pyannote_video_tpu_torch.pipeline import face as pface

        rgb = episode.frames[3]
        boxes = [episode.faces_at(3)[0].box]
        jf = jface.Face(landmarks=str(J_LANDMARKS_FILE))
        pf = pface.Face(landmarks=str(weights.LANDMARKS_FILE), device="cpu")
        jf.face_detector_ = lambda frame: boxes
        pf.face_detector_ = lambda frame: boxes
        (jb, jl, je), = list(jf(rgb, return_landmarks=True, return_embedding=True))
        (pb, pl, pe), = list(pf(rgb, return_landmarks=True, return_embedding=True))
        assert tuple(pb) == tuple(jb) and pb.width() == jb.width()
        err = np.abs(pl.parts() - jl.parts()).max()
        assert pl.num_parts() == 68 and err <= 1.0
        if err <= LANDMARK_TOL:
            assert np.linalg.norm(pe - je) <= 0.05, np.linalg.norm(pe - je)
        assert pe.shape == (128,) and abs(np.linalg.norm(pe) - 1.0) <= 1e-3
        # plain iteration, and the mean shape when no landmark model is given
        assert [tuple(b) for b in pf(rgb)] == [tuple(jb)]
        pm = pface.Face(device="cpu")
        jm = jface.Face()
        np.testing.assert_allclose(
            pm.get_landmarks(rgb, pb).parts(), jm.get_landmarks(rgb, jb).parts(),
            atol=1e-4, rtol=0)
        debug = pf.get_debug(rgb, pb, pl, size=64)
        assert debug.shape == (64, 64, 3)
        np.testing.assert_array_equal(
            debug, jf.get_debug(rgb, jb, pface.Landmarks(pl.parts()), size=64))
        assert pface.SMALLEST_FACE == jface.SMALLEST_FACE
