"""The port's fused detect → align → embed program against the JAX package,
on the CPU.

Same numpy-seeded inputs through both packages.  ``_device_nms`` is exact:
indices (through the boxes they pick), scores and ``valid``, on seeded
candidate sets with all-``-inf`` frames, tied scores and NaN coordinates,
and against the greedy NumPy reference of ``tests/test_warp_dsst.py``.
The served bfloat16 detector rounds at other places in the two frameworks
(a JAX bf16 conv returns float32, a PyTorch one rounds to bf16), so the
detect-only and fused programs are held to JAX's ``valid`` exactly and to
its valid boxes at IoU >= 0.9.  The tail is fed JAX's selected boxes:
float32 landmarks within 5e-3 px (``tests/test_torch_extract.py``), the
float32 embedder within 1e-4 on JAX's chips, bfloat16 within 0.05 of
float32.  Also here: ``entry()``, ``with_refiner``, the JAX serving
parameter set, ``device_trace`` and ``PipelineStats`` around a program,
and the held-out render domains (``utils/synthetic_shift.py``).

Three JAX programs are compiled (detect-only, fused, and ``entry()``'s
traced for its shapes only), each ~7 s on the CPU.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pyannote_video_tpu.models import chip as jchip
from pyannote_video_tpu.models import detector as jdet
from pyannote_video_tpu.models import embedder as jembedder
from pyannote_video_tpu.models import fused as jfused
from pyannote_video_tpu.models.weights import DETECTOR_FILE as J_DETECTOR_FILE
from pyannote_video_tpu.ops import boxes as jboxes
from pyannote_video_tpu.utils import synthetic as jsynthetic
from pyannote_video_tpu.utils import synthetic_shift as jshift

from pyannote_video_tpu_torch.models import chip, detector, embedder, fused, nn
from pyannote_video_tpu_torch.models import landmarks, weights
from pyannote_video_tpu_torch.ops.boxes import iou_t
from pyannote_video_tpu_torch.ops.color import to_gray
from pyannote_video_tpu_torch.utils import synthetic, synthetic_shift

from test_warp_dsst import TestDeviceNMS

pytestmark = pytest.mark.skipif(
    not J_DETECTOR_FILE.exists(), reason="no trained weights")

H, W, M = 120, 160, 4
LANDMARK_TOL = 5e-3
EMBED_F32_TOL = 1e-4
EMBED_BF16_DIST = 0.05


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The test runner's workers share the cores: whole pipelines at full
    torch width mostly wait for each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _served_env(monkeypatch):
    # the JAX package's refiner trainer leaves this set in its pytest worker
    monkeypatch.delenv("PYV_NO_REFINE", raising=False)


def _iou(a, b):
    ix0, iy0 = max(a[0], b[0]), max(a[1], b[1])
    ix1, iy1 = min(a[2], b[2]), min(a[3], b[3])
    inter = max(0.0, ix1 - ix0) * max(0.0, iy1 - iy0)
    union = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter
    return inter / union


def _assert_same_detections(boxes, valid, ref_boxes, ref_valid, min_iou=0.9):
    np.testing.assert_array_equal(valid, ref_valid)
    for f in range(len(valid)):
        for k in np.flatnonzero(ref_valid[f]):
            assert _iou(boxes[f, k], ref_boxes[f, k]) >= min_iou, (f, k)


# -- device NMS ---------------------------------------------------------------


def _candidates(seed, kind, B=3, K=24):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(20, 200, size=(B, K, 2))
    wh = rng.uniform(10, 40, size=(B, K, 2))
    boxes = np.concatenate([centers - wh / 2, centers + wh / 2],
                           axis=-1).astype(np.float32)
    scores = rng.uniform(-1, 8, size=(B, K)).astype(np.float32)
    scores = np.where(scores > 2.5, scores, -np.inf).astype(np.float32)
    if kind == "all_inf":
        scores[1] = -np.inf
    elif kind == "ties":
        scores[:, ::3] = 6.0           # equal maxima: the first index wins
        boxes[:, 3] = boxes[:, 0]      # and an exact duplicate box
    elif kind == "nan_box":
        boxes[0, 5] = np.nan           # NaN overlaps nothing, itself included
        scores[0, 5] = 9.0
        boxes[2, 7, 2:] = boxes[2, 7, :2] - 5.0   # inverted: IoU 0
        scores[2, 7] = 8.5
    elif kind == "crowded":
        boxes[:] = boxes[:, :1] + rng.uniform(-3, 3, (B, K, 4)).astype(np.float32)
    return boxes, scores


NMS_CASES = [(seed, kind) for kind in ("random", "all_inf", "ties", "nan_box",
                                       "crowded") for seed in (0, 1)]


@pytest.mark.parametrize("seed,kind", NMS_CASES)
def test_device_nms_matches_jax(seed, kind):
    boxes, scores = _candidates(seed, kind)
    jb, js, jv = jax.vmap(lambda b, s: jfused._device_nms(b, s, 0.3, 8))(
        jnp.asarray(boxes), jnp.asarray(scores))
    pb, ps, pv = fused._device_nms(torch.from_numpy(boxes),
                                   torch.from_numpy(scores), 0.3, 8)
    np.testing.assert_array_equal(pb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
    if kind == "all_inf":
        assert not pv[1].any()
        np.testing.assert_array_equal(pb[1].numpy(), np.repeat(boxes[1, :1], 8, 0))
    # one frame's [K, 4], [K] form gives that frame's row
    b1, s1, v1 = fused._device_nms(torch.from_numpy(boxes[0]),
                                   torch.from_numpy(scores[0]), 0.3, 8)
    np.testing.assert_array_equal(b1.numpy(), pb[0].numpy())
    np.testing.assert_array_equal(s1.numpy(), ps[0].numpy())
    np.testing.assert_array_equal(v1.numpy(), pv[0].numpy())


@pytest.mark.parametrize("seed,kind", [c for c in NMS_CASES if c[1] != "nan_box"])
def test_device_nms_is_greedy_nms(seed, kind):
    """The numpy greedy reference (no NaN boxes: it does not suppress a
    winner that overlaps nothing, itself included)."""
    boxes, scores = _candidates(seed, kind)
    pb, ps, pv = fused._device_nms(torch.from_numpy(boxes),
                                   torch.from_numpy(scores), 0.3, 8)
    for f in range(len(boxes)):
        picks = TestDeviceNMS()._np_greedy_nms(boxes[f], scores[f].copy(),
                                               0.3, 0.7, 8)
        assert int(pv[f].sum()) == len(picks)
        np.testing.assert_array_equal(pb[f, :len(picks)].numpy(), boxes[f, picks])
        np.testing.assert_array_equal(ps[f, :len(picks)].numpy(), scores[f, picks])


@pytest.mark.parametrize("seed", range(3))
def test_iou_t_matches_jax(seed):
    boxes, _ = _candidates(seed, "crowded")
    a, b = boxes[0], boxes[1, :7]
    np.testing.assert_allclose(iou_t(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
                               np.asarray(jboxes.iou(a, b)), rtol=1e-6, atol=1e-7)
    # batched over a leading axis
    np.testing.assert_allclose(
        iou_t(torch.from_numpy(boxes), torch.from_numpy(boxes))[1].numpy(),
        np.asarray(jboxes.iou(boxes[1], boxes[1])), rtol=1e-6, atol=1e-7)


# -- the programs ---------------------------------------------------------------


@pytest.fixture(scope="module")
def frames():
    ep = jsynthetic.synthetic_episode(n_shots=2, shot_frames=8, width=W,
                                      height=H, seed=21, face_height_ratio=0.45)
    return ep.frames[[0, 8]]


@pytest.fixture(scope="module")
def jax_pipe():
    return jfused.FusedFacePipeline(max_faces=M)


@pytest.fixture(scope="module")
def jax_detect(jax_pipe, frames):
    out = jax_pipe.build_detect_only(H, W)(jax_pipe.detector_params,
                                           jnp.asarray(frames))
    return [np.asarray(x) for x in out]


@pytest.fixture(scope="module")
def jax_out(jax_pipe, frames):
    return jfused.FusedOutput(*(np.array(x) for x in jax_pipe(frames)))


@pytest.fixture(scope="module")
def port_pipe():
    return fused.FusedFacePipeline(max_faces=M, device="cpu")


def test_detect_only_matches_jax(port_pipe, frames, jax_detect):
    fn = port_pipe.build_detect_only(H, W)
    boxes, scores, valid = fn(port_pipe.detector_params, torch.from_numpy(frames))
    assert boxes.shape == (2, M, 4) and scores.shape == (2, M)
    assert valid.dtype == torch.bool and valid.any(dim=1).all()
    jb, js, jv = jax_detect
    _assert_same_detections(boxes.numpy(), valid.numpy(), jb, jv)
    assert np.isneginf(scores.numpy()[~valid.numpy()]).all()


def test_fused_matches_jax(port_pipe, frames, jax_out, jax_detect):
    out = port_pipe(frames)
    assert isinstance(out, fused.FusedOutput)
    for name, ref in jax_out._asdict().items():
        assert tuple(getattr(out, name).shape) == ref.shape, name
    _assert_same_detections(out.boxes.numpy(), out.valid.numpy(),
                            jax_out.boxes, jax_out.valid)
    # JAX's fused program selects what its detect-only program selects
    np.testing.assert_array_equal(jax_out.valid, jax_detect[2])
    emb = out.embeddings.numpy()
    assert np.isfinite(emb).all()
    np.testing.assert_allclose(np.linalg.norm(emb, axis=-1), 1.0, atol=1e-3)
    # the program is cached per (H, W, B)
    assert list(port_pipe._built) == [(H, W, 2)]
    port_pipe(frames)
    assert list(port_pipe._built) == [(H, W, 2)]


def test_fused_tail_on_jax_boxes(port_pipe, frames, jax_pipe, jax_out):
    """JAX's selected boxes through the port's tail: cascade, chips and the
    embedder, every slot (valid or not) as the program computes them."""
    B = len(frames)
    flat = jax_out.boxes.reshape(B * M, 4)
    fidx = np.repeat(np.arange(B), M)
    lm = landmarks.predict_crops(port_pipe.landmark_params,
                                 to_gray(torch.from_numpy(frames)),
                                 torch.from_numpy(fidx), torch.from_numpy(flat))
    err = np.abs(lm.numpy() - jax_out.landmarks.reshape(B * M, 68, 2)).max()
    assert err <= LANDMARK_TOL, err

    # the embedder on JAX's chips of JAX's landmarks: float32 against JAX's
    # float32 convs, bfloat16 against the port's float32
    jlm = jnp.asarray(jax_out.landmarks.reshape(B * M, 68, 2))
    jchips = np.array(jchip.extract_chips(jnp.asarray(frames),
                                            jnp.asarray(fidx), jlm))
    ref = np.asarray(jembedder.forward(jax_pipe.embedder_params,
                                       jnp.asarray(jchips), train=False,
                                       compute_dtype=jnp.float32)[0])
    with torch.no_grad():
        f32 = embedder.forward(port_pipe.embedder_params,
                               torch.from_numpy(jchips),
                               compute_dtype=torch.float32).numpy()
        bf16 = embedder.forward(port_pipe.embedder_params,
                                torch.from_numpy(jchips)).numpy()
    assert np.abs(f32 - ref).max() <= EMBED_F32_TOL
    assert np.linalg.norm(bf16 - f32, axis=1).max() <= EMBED_BF16_DIST
    # the port's own chips of those landmarks: the same chips up to the
    # fitted transforms' rounding, so the same embeddings within bf16's
    pchips = chip.extract_chips(torch.from_numpy(frames), torch.from_numpy(fidx),
                                torch.from_numpy(np.array(jlm)))
    assert float((pchips - torch.from_numpy(jchips)).abs().mean()) <= 4e-3


def test_device_trace_records_a_program(port_pipe, frames, tmp_path):
    import json

    from pyannote_video_tpu.utils.profiling import PipelineStats as JStats
    from pyannote_video_tpu_torch.utils.profiling import PipelineStats, device_trace

    detect = port_pipe.build_detect_only(H, W)
    with device_trace(None):
        detect(port_pipe.detector_params, torch.from_numpy(frames))
    assert not list(tmp_path.iterdir())
    stats, jstats = PipelineStats(), JStats()
    for st in (stats, jstats):
        with st.stage("detect") as stage, device_trace(str(tmp_path)):
            detect(port_pipe.detector_params, torch.from_numpy(frames))
            stage.add(len(frames), faces=2)
    traces = list(tmp_path.glob("*.pt.trace.json"))
    assert len(traces) == 2
    names = {e.get("name") for e in json.loads(traces[0].read_text())["traceEvents"]}
    assert "aten::conv2d" in names and "aten::argmax" in names
    ours, ref = (json.loads(line) for line in (stats.report(), jstats.report()))
    assert ours.keys() == ref.keys()
    assert {k: ours[k] for k in ("stage", "items", "faces")} == {
        "stage": "detect", "items": 2, "faces": 2.0}


def test_fused_without_a_cascade_places_the_mean_shape(frames):
    pipe = fused.FusedFacePipeline(max_faces=2, landmark_params=landmarks.mean_shape_only(),
                                   compute_dtype=torch.float32, device="cpu")
    out = pipe(frames)
    np.testing.assert_array_equal(
        out.landmarks.reshape(-1, 68, 2).numpy(),
        chip.box_to_landmarks(out.boxes.reshape(-1, 4)).numpy())


def test_entry_matches_jax_entry():
    import __graft_entry__

    from pyannote_video_tpu_torch.entry import entry

    jfn, jargs = __graft_entry__.entry()
    shapes = jax.eval_shape(jfn, *jargs)
    fn, args = entry(device="cpu")
    np.testing.assert_array_equal(args[3].numpy(), np.asarray(jargs[3]))
    out = fn(*args)
    for name, ref in shapes._asdict().items():
        got = getattr(out, name)
        assert tuple(got.shape) == tuple(ref.shape), name
        assert str(got.dtype).replace("torch.", "") == str(ref.dtype), name


# -- parameters -----------------------------------------------------------------


def _same_state(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], dict):
            _same_state(a[k], b[k])
        elif isinstance(a[k], torch.Tensor):
            assert torch.equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


def test_with_refiner_matches_jax(monkeypatch, tmp_path):
    base = weights.default_detector_params()
    jbase = {"c1": {}}
    served = detector.with_refiner(base)
    assert "refiner" in served and "refiner" not in base
    assert ("refiner" in jdet.with_refiner(jbase)) == ("refiner" in served)
    _same_state(served["refiner"], weights.default_refiner_params())
    assert detector.with_refiner(served) is served
    # an explicit file
    path = tmp_path / "refiner.npz"
    path.write_bytes(weights.REFINER_FILE.read_bytes())
    _same_state(detector.with_refiner(base, str(path))["refiner"],
                served["refiner"])
    # the kill switch
    monkeypatch.setenv("PYV_NO_REFINE", "1")
    assert "refiner" not in detector.with_refiner(base)
    assert "refiner" not in jdet.with_refiner(jbase)
    assert "refiner" not in detector.FaceDetector(device="cpu").params
    plain = fused.FusedFacePipeline(device="cpu")
    assert "refiner" not in plain.detector_params
    assert plain.threshold == detector.STAGE1_THRESHOLD


def test_params_from_jax_takes_the_serving_set(jax_pipe):
    """The JAX serving set (derived ``c1_s2d`` stem, nested ``refiner``)
    converts to the port's served state: the stem is dropped, the refiner
    converted as its own file is."""
    assert "c1_s2d" in jax_pipe.detector_params
    state = nn.params_from_jax(jax_pipe.detector_params)
    assert "c1_s2d" not in state
    _same_state(state, detector.with_refiner(weights.default_detector_params()))
    # and a flat one, as flattened by the JAX package
    from pyannote_video_tpu.models.nn import flatten_params

    _same_state(nn.params_from_jax(flatten_params(jax_pipe.detector_params)), state)


# -- held-out render domains ----------------------------------------------------


@pytest.mark.parametrize("domain", ["A", "B", "C", "BC"])
def test_domain_hooks_render_jax_episodes(domain):
    kw = dict(n_shots=2, shot_frames=3, width=128, height=96, n_identities=2,
              seed=12)
    ours = synthetic.synthetic_episode(**kw, **synthetic_shift.domain_hooks(domain))
    ref = jsynthetic.synthetic_episode(**kw, **jshift.domain_hooks(domain))
    np.testing.assert_array_equal(ours.frames, ref.frames)
    assert [f.box for f in ours.faces] == [f.box for f in ref.faces]
    for a, b in zip(ours.faces, ref.faces):
        np.testing.assert_array_equal(a.landmarks, b.landmarks)
