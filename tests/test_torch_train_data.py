"""The port's training data against the JAX package's, on the CPU.

The JAX generators call OpenCV (``warpAffine``, ``filter2D``, ``resize``);
the port's call ``utils/imops.py``, which the machine with the card can
run.  Against OpenCV on float32 images: ``warp_affine`` within 1e-2 and
``filter2d`` within 1e-4 on 0-255 values, ``bilinear_resize`` within 1e-2.
On equal seeds every box, label, target, hard flag, identity and window is
exactly equal (no draw depends on a pixel value); uint8 images differ by at
most 1 (a float32 rounding carried over an integer by the final cast) on at
most 0.1% of their values; float32 landmark images within 0.05; refiner
crops, which go through per-crop colour gains, within 2 on at most 0.1%
of their values.  The ERT fit is NumPy in both packages: equal features
and draws give equal trees.
"""

import dataclasses
from types import SimpleNamespace

import cv2
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pyannote_video_tpu.models import refiner as jrefiner
from pyannote_video_tpu.train import data as jdata
from pyannote_video_tpu.train import mine as jmine
from pyannote_video_tpu.train import train_landmarks as jtl
from pyannote_video_tpu.train import train_refiner as jtr

from pyannote_video_tpu_torch.models import landmarks, refiner
from pyannote_video_tpu_torch.train import data, mine
from pyannote_video_tpu_torch.train import train_landmarks as ptl
from pyannote_video_tpu_torch.train import train_refiner as ptr
from pyannote_video_tpu_torch.utils import imops

torch.set_num_threads(1)

U8_SHARE = 1e-3


def _close_u8(ours, theirs, tol=1, share=U8_SHARE):
    assert ours.shape == theirs.shape and ours.dtype == theirs.dtype
    diff = np.abs(ours.astype(np.int32) - theirs.astype(np.int32))
    assert diff.max() <= tol, diff.max()
    assert (diff > 0).mean() <= share, (diff > 0).mean()


# -- utils/imops.py against OpenCV ---------------------------------------------


def _affine(rng, c):
    th = np.deg2rad(rng.uniform(-30, 30))
    A = (np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
         @ np.array([[rng.uniform(0.76, 1.0), rng.uniform(-0.11, 0.11)],
                     [0.0, rng.uniform(0.85, 1.18)]]))
    return np.concatenate([A, [[c[0]], [c[1]]] - A @ [[c[0]], [c[1]]]],
                          axis=1).astype(np.float32)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("channels", [0, 3])
def test_warp_affine_matches_opencv(seed, channels):
    rng = np.random.default_rng(seed)
    shape = (96, 120) + ((channels,) if channels else ())
    image = rng.uniform(0, 255, shape).astype(np.float32)
    M = _affine(rng, (60.0, 48.0))
    ref = cv2.warpAffine(image, M, (120, 96), flags=cv2.INTER_LINEAR,
                         borderMode=cv2.BORDER_REFLECT)
    out = imops.warp_affine(image, M, (120, 96))
    assert out.dtype == np.float32 and out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=1e-2, rtol=0)


@pytest.mark.parametrize("k", [3, 4, 7, 10])
@pytest.mark.parametrize("vertical", [False, True])
def test_filter2d_matches_opencv(k, vertical):
    rng = np.random.default_rng(k)
    image = rng.uniform(0, 255, (40, 52, 3)).astype(np.float32)
    kern = np.full((1, k), 1.0 / k, np.float32)
    kern = kern.T if vertical else kern
    np.testing.assert_allclose(imops.filter2d(image, kern),
                               cv2.filter2D(image, -1, kern), atol=1e-4, rtol=0)


@pytest.mark.parametrize("size", [(300, 260, 128, 111), (170, 170, 150, 150),
                                  (75, 75, 150, 150)])
def test_bilinear_resize_matches_opencv_on_float32(size):
    h, w, oh, ow = size
    image = np.random.default_rng(h).uniform(0, 255, (h, w, 3)).astype(np.float32)
    np.testing.assert_allclose(
        imops.bilinear_resize(image, ow, oh),
        cv2.resize(image, (ow, oh), interpolation=cv2.INTER_LINEAR),
        atol=1e-2, rtol=0)


# -- train/data.py --------------------------------------------------------------


@pytest.mark.parametrize("seed", range(3))
def test_detection_batch_equals_jax(seed):
    jframes, jboxes, jhard = jdata.detection_batch(
        np.random.default_rng(seed), batch=6, return_hard=True)
    frames, boxes, hard = data.detection_batch(
        np.random.default_rng(seed), batch=6, return_hard=True)
    assert boxes == jboxes
    assert np.array_equal(hard, jhard)
    for ours, theirs in zip(data.detection_targets(boxes, 128, 128),
                            jdata.detection_targets(jboxes, 128, 128)):
        assert np.array_equal(ours, theirs)
    _close_u8(frames, jframes)


def test_identity_bank_and_embedding_batch_equal_jax():
    bank, jbank = data.identity_bank(12, seed=5), jdata.identity_bank(12, seed=5)
    assert {k: dataclasses.astuple(v) for k, v in bank.items()} == {
        k: dataclasses.astuple(v) for k, v in jbank.items()}
    chips, labels = data.embedding_batch(np.random.default_rng(2), bank,
                                         n_ident=4, per_ident=3)
    jchips, jlabels = jdata.embedding_batch(np.random.default_rng(2), jbank,
                                            n_ident=4, per_ident=3)
    assert np.array_equal(labels, jlabels)
    _close_u8(chips, jchips)


@pytest.mark.parametrize("seed", range(2))
def test_mining_frames_equal_jax(seed):
    _close_u8(mine.negative_frame(np.random.default_rng(seed)),
              jmine.negative_frame(np.random.default_rng(seed)))
    frame, gt = mine.positive_frame(np.random.default_rng(seed))
    jframe, jgt = jmine.positive_frame(np.random.default_rng(seed))
    assert gt == jgt
    _close_u8(frame, jframe)


# -- train/train_refiner.py -----------------------------------------------------


@pytest.mark.parametrize("seed", range(3))
def test_refiner_scene_equals_jax(seed):
    frame, gt, distract, hard = ptr.scene(np.random.default_rng(seed))
    jframe, jgt, jdistract, jhard = jtr.scene(np.random.default_rng(seed))
    assert gt == jgt and distract == jdistract
    assert np.array_equal(hard, jhard)
    _close_u8(frame, jframe)


def test_crop_windows_equal_jax():
    rng = np.random.default_rng(0)
    boxes = [tuple(rng.uniform(-50, 400, 2)) for _ in range(50)]
    boxes = [(l, t, l + rng.uniform(5, 200), t + rng.uniform(5, 200))
             for l, t in boxes]
    gt = boxes[:3]
    for box in boxes:
        assert np.array_equal(ptr._window(box),
                              np.asarray(jrefiner.crop_boxes(jnp.asarray(box))))
        assert ptr._clean_negative(box, gt) == jtr._clean_negative(box, gt)
        assert ptr._jitter_box(np.random.default_rng(1), box) == \
            jtr._jitter_box(np.random.default_rng(1), box)
    crops = rng.uniform(0, 255, (9, 8, 8, 3)).astype(np.float32)
    assert np.array_equal(ptr._color_aug(np.random.default_rng(3), crops),
                          jtr._color_aug(np.random.default_rng(3), crops))


def _stub_miner(device=None):
    """A miner whose buffers are empty: ``crop_batch`` then draws nothing
    from them, so both packages consume the generator alike."""
    empty = np.zeros((0, 64, 64, 3), np.float32)
    return SimpleNamespace(device=device, sample_neg=lambda rng, k: empty,
                           sample_pos=lambda rng, k: (empty, np.zeros(0, np.float32)))


def test_crop_batch_equals_jax():
    crops, labels, hard = ptr.crop_batch(np.random.default_rng(6),
                                         _stub_miner(torch.device("cpu")),
                                         n_scenes=2)
    jcrops, jlabels, jhard = jtr.crop_batch(np.random.default_rng(6),
                                            _stub_miner(), n_scenes=2)
    assert np.array_equal(labels, jlabels) and np.array_equal(hard, jhard)
    diff = np.abs(crops - jcrops)
    assert diff.max() <= 2.0 and (diff > 1e-2).mean() <= U8_SHARE


def test_pad_to_bucket_keeps_the_black_negatives():
    crops = np.ones((33, 64, 64, 3), np.float32)
    labels = np.ones(33, np.float32)
    out, lab, hard = ptr.pad_to_bucket(crops, labels, labels.copy())
    assert out.shape[0] == lab.shape[0] == hard.shape[0] == 64
    assert not out[33:].any() and not lab[33:].any() and not hard[33:].any()
    same = ptr.pad_to_bucket(out, lab, hard)
    assert same[0].shape[0] == 64


# -- train/train_landmarks.py ---------------------------------------------------


def test_landmark_dataset_equals_jax():
    grays, boxes, gts = ptl.make_dataset(n_images=6, size=96, seed=4)
    jgrays, jboxes, jgts = jtl.make_dataset(n_images=6, size=96, seed=4)
    assert np.array_equal(boxes, jboxes) and np.array_equal(gts, jgts)
    assert grays.dtype == jgrays.dtype == np.float32
    np.testing.assert_allclose(grays, jgrays, atol=0.05, rtol=0)


def test_landmark_fit_is_the_jax_fit():
    """Equal features and draws give equal features and trees."""
    grays, boxes, gts = jtl.make_dataset(n_images=8, size=96, seed=5)
    mean_shape = np.asarray(ptl.CANONICAL_LANDMARKS, np.float32)
    shapes = np.broadcast_to(mean_shape.reshape(1, -1), gts.shape).copy()
    rng = np.random.default_rng(0)
    anchor = rng.integers(0, ptl.N_POINTS, size=60).astype(np.int32)
    offset = rng.uniform(-0.25, 0.25, size=(60, 2)).astype(np.float32)
    for bilinear in (False, True):
        feats = ptl.extract_features(grays, boxes, shapes, mean_shape, anchor,
                                     offset, bilinear=bilinear)
        assert np.array_equal(feats, jtl.extract_features(
            grays, boxes, shapes, mean_shape, anchor, offset, bilinear=bilinear))
    pts = mean_shape[anchor] + offset
    cdf = ptl._pair_cdf(np.sqrt(((pts[:, None] - pts[None]) ** 2).sum(-1)))
    ours = ptl.fit_tree(feats, gts - shapes, np.random.default_rng(7), cdf)
    theirs = jtl.fit_tree(feats, gts - shapes, np.random.default_rng(7), cdf)
    for a, b in zip(ours, theirs):
        assert np.array_equal(a, b)


def test_landmark_train_smoke(monkeypatch, tmp_path):
    """A 2-stage cascade of 4 trees fits, is saved, and the port's
    predictor and the JAX package's read it to the same landmarks."""
    from pyannote_video_tpu.models import landmarks as jlandmarks

    for name, value in (("N_STAGES", 2), ("N_TREES", 4), ("POOL", 40),
                        ("BILINEAR_TAIL", 2)):
        monkeypatch.setattr(ptl, name, value)
    monkeypatch.setattr(ptl, "make_dataset",
                        lambda n_images, seed: _small_dataset(n_images, seed))
    params = ptl.train(n_images=10, seed=0, verbose=False)
    path = tmp_path / "landmarks.npz"
    landmarks.save(path, params)
    frames = np.random.default_rng(0).uniform(0, 255, (1, 96, 96, 3)).astype(np.uint8)
    box = np.asarray([[20, 18, 76, 80]], np.float32)
    ours = landmarks.LandmarkPredictor(str(path), device="cpu").predict_batch(
        frames, np.asarray([0]), box)
    theirs = jlandmarks.LandmarkPredictor(str(path)).predict_batch(
        frames, np.asarray([0]), box)
    assert np.isfinite(ours).all()
    np.testing.assert_allclose(ours, theirs, atol=5e-3)


_make_dataset = ptl.make_dataset


def _small_dataset(n_images, seed):
    return _make_dataset(n_images=n_images, size=96, seed=seed)
