"""The port's face detector against the JAX package, on the CPU.

The algorithm is compared in float32: crops to 1e-4 where the sample
coordinates are exact (see ``test_crop_resize`` for arbitrary ones), score
maps and refined logits to 1e-3.  The served bfloat16 path rounds at other
places in the two frameworks (a JAX bf16 conv returns float32, a PyTorch
one rounds to bf16), so it is compared after threshold and NMS: same boxes,
each matched at IoU >= 0.9.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pyannote_video_tpu.models import detector as jdet
from pyannote_video_tpu.models import refiner as jref
from pyannote_video_tpu.models.nn import load_params as jax_load
from pyannote_video_tpu.ops.boxes import nms as jax_nms
from pyannote_video_tpu.ops.crop import crop_resize as jax_crop
from pyannote_video_tpu.utils.synthetic import synthetic_episode

from pyannote_video_tpu_torch.models import detector, refiner
from pyannote_video_tpu_torch.models import weights
from pyannote_video_tpu_torch.models.nn import load_params, params_from_jax
from pyannote_video_tpu_torch.ops.boxes import nms
from pyannote_video_tpu_torch.ops.crop import crop_resize


def iou(a, b):
    ix0, iy0 = max(a[0], b[0]), max(a[1], b[1])
    ix1, iy1 = min(a[2], b[2]), min(a[3], b[3])
    inter = max(0.0, ix1 - ix0) * max(0.0, iy1 - iy0)
    union = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter
    return inter / union


def assert_same_boxes(out, ref, min_iou=0.9):
    assert len(out) == len(ref)
    for o, r in zip(out, ref):
        assert len(o) == len(r)
        for box in r:
            assert max(iou(box, b) for b in o) >= min_iou


@pytest.fixture(autouse=True)
def served_detector_env(monkeypatch):
    """Both packages serve the refiner unless ``PYV_NO_REFINE=1``; a JAX
    training helper sets that variable for the rest of its process
    (``train/train_refiner.py``), so each test here starts without it."""
    monkeypatch.delenv("PYV_NO_REFINE", raising=False)


@pytest.fixture(scope="module")
def frames():
    ep = synthetic_episode(n_shots=2, shot_frames=8, width=160, height=120,
                           seed=21, face_height_ratio=0.45)
    return ep.frames[::4]


@pytest.fixture(scope="module")
def jax_params():
    return jax_load(str(weights.DETECTOR_FILE)), jax_load(str(weights.REFINER_FILE))


@pytest.fixture(scope="module")
def torch_params():
    return load_params(weights.DETECTOR_FILE), load_params(weights.REFINER_FILE)


class TestParams:
    def test_params_from_jax_layout(self):
        rng = np.random.default_rng(0)
        flat = {"c1/w": rng.normal(size=(3, 3, 3, 8)),
                "c1/b": rng.normal(size=8),
                "c2/w": rng.normal(size=(3, 3, 8, 6)),
                "c2/b": rng.normal(size=6),
                "d1/w": rng.normal(size=(2 * 2 * 6, 5)),
                "d2/w": rng.normal(size=(5, 1))}
        state = params_from_jax(flat)
        np.testing.assert_array_equal(state["c2"]["w"].numpy(),
                                      flat["c2/w"].transpose(3, 2, 0, 1).astype(np.float32))
        np.testing.assert_array_equal(state["d2"]["w"].numpy(), flat["d2/w"].T.astype(np.float32))
        # d1 reads a flattened [6, 2, 2] NCHW map; the JAX package flattened
        # the same map as NHWC [2, 2, 6]: row (c, h, w) here = row (h, w, c) there
        fmap = rng.normal(size=(1, 6, 2, 2)).astype(np.float32)
        ours = fmap.reshape(1, -1) @ state["d1"]["w"].numpy().T
        theirs = fmap.transpose(0, 2, 3, 1).reshape(1, -1) @ flat["d1/w"]
        np.testing.assert_allclose(ours, theirs, rtol=1e-5, atol=1e-5)
        assert all(t.dtype == torch.float32 for layer in state.values()
                   for t in layer.values())

    def test_packaged_weights_load(self, torch_params):
        det, ref = torch_params
        assert tuple(det["c1"]["w"].shape) == (16, 3, 5, 5)
        assert tuple(det["head"]["w"].shape) == (5, 45, 9, 9)
        assert tuple(ref["d1"]["w"].shape) == (128, 2048)


class TestOps:
    @pytest.mark.parametrize("integer_boxes,atol", [(True, 1e-4), (False, 4e-3)])
    def test_crop_resize(self, integer_boxes, atol):
        """With integer boxes every sample coordinate is exact in float32
        and only the sums' order differs (1e-4).  With arbitrary boxes the
        coordinate itself rounds differently (XLA fuses it into an fma):
        ~8e-6 at coordinates near 64, times two taps of up to 255 (4e-3)."""
        rng = np.random.default_rng(1)
        fr = rng.uniform(0, 255, (2, 48, 64, 3)).astype(np.float32)
        bx = rng.uniform(-10, 70, (2, 5, 4)).astype(np.float32)
        if integer_boxes:
            bx = np.round(bx)
        ref = np.asarray(jax_crop(jnp.asarray(fr), jnp.asarray(bx), 16))
        out = crop_resize(torch.from_numpy(fr), torch.from_numpy(bx), 16).numpy()
        np.testing.assert_allclose(out, ref, atol=atol, rtol=0)

    def test_nms(self):
        rng = np.random.default_rng(2)
        xy = rng.uniform(0, 80, (30, 2))
        wh = rng.uniform(10, 40, (30, 2))
        boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
        scores = rng.normal(size=30).astype(np.float32)
        assert nms(boxes, scores, 0.3) == jax_nms(boxes, scores, 0.3)

    def test_pyramid_levels(self):
        for hw in [(120, 160), (720, 1280), (481, 853)]:
            assert detector.pyramid_scales(*hw) == jdet.pyramid_scales(*hw)
            assert detector.pyramid_scales(*hw, upsample=1) == \
                jdet.pyramid_scales(*hw, upsample=1)


class TestForward:
    def test_forward_maps_f32(self, jax_params, torch_params):
        img = np.random.default_rng(3).uniform(0, 255, (2, 64, 80, 3)).astype(np.float32)
        ref, _ = jdet.forward_maps(jax_params[0], jnp.asarray(img),
                                   compute_dtype=jnp.float32)
        out = detector.forward_maps(torch_params[0], torch.from_numpy(img),
                                    compute_dtype=torch.float32)
        assert tuple(out.shape) == (2, 8, 10, 5)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-3, rtol=0)

    def test_refine_scores_f32(self, jax_params, torch_params):
        rng = np.random.default_rng(4)
        fr = rng.uniform(0, 255, (2, 48, 64, 3)).astype(np.float32)
        sc = rng.uniform(-2, 8, (2, 40)).astype(np.float32)
        bb = rng.uniform(0, 40, (2, 40, 4)).astype(np.float32)
        bb[..., 2:] += bb[..., :2]
        ref = jref.refine_scores(jax_params[1], jnp.asarray(fr), jnp.asarray(sc),
                                 jnp.asarray(bb), compute_dtype=jnp.float32)
        out = refiner.refine_scores(torch_params[1], torch.from_numpy(fr),
                                    torch.from_numpy(sc), torch.from_numpy(bb),
                                    compute_dtype=torch.float32)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-3, rtol=0)
        assert (out.numpy() == refiner.UNREFINED).sum() >= 40 * 2 - 2 * refiner.REFINE_K


class TestFaceDetector:
    def test_served_bf16_boxes_match_jax(self, frames):
        ref = jdet.FaceDetector()
        out = detector.FaceDetector(device="cpu")
        assert "refiner" in out.params
        assert out.threshold == ref.threshold == detector.DEFAULT_THRESHOLD
        got = out.detect_batch(frames)
        assert sum(map(len, got)) >= len(frames) - 1   # the faces are found
        assert_same_boxes(got, ref.detect_batch(frames))

    def test_no_refine_switch_matches_jax(self, frames, monkeypatch):
        monkeypatch.setenv("PYV_NO_REFINE", "1")
        ref = jdet.FaceDetector()
        out = detector.FaceDetector(device="cpu")
        assert "refiner" not in out.params
        assert out.threshold == ref.threshold == detector.STAGE1_THRESHOLD
        assert_same_boxes(out.detect_batch(frames[:2]), ref.detect_batch(frames[:2]))

    def test_missing_refiner_serves_stage1(self, monkeypatch, tmp_path):
        monkeypatch.setattr(weights, "REFINER_FILE", tmp_path / "missing.npz")
        assert weights.default_refiner_params() is None
        out = detector.FaceDetector(device="cpu")
        assert "refiner" not in out.params
        assert out.threshold == detector.STAGE1_THRESHOLD
