"""The training half of the port's models against the JAX package's, on
the CPU: train-mode batch norm, residual blocks and forwards, the
initialisers, the optimiser and the parameter writer.

Tolerances: train-mode outputs and moved statistics within 1e-5; the
optimiser's updated parameters within 1e-6 wherever |g| > 1e-6 over three
steps on identical gradients; the cosine schedule equal to optax's at count
0 and from ``steps`` on, and within 1e-6 relative at every count between
(a few float32 ulps: XLA folds and fuses optax's float32 expression, and
its cosine is not Python's); a JAX forward on a file the port saved equal to the
port's forward within 1e-4; He-normal filters within 5% of their standard
deviation on the large filters.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from pyannote_video_tpu.models import detector as jdetector
from pyannote_video_tpu.models import embedder as jembedder
from pyannote_video_tpu.models import landmarks as jlandmarks
from pyannote_video_tpu.models import nn as jnn
from pyannote_video_tpu.models import refiner as jrefiner

from pyannote_video_tpu_torch.models import (detector, embedder, landmarks,
                                             nn, refiner, weights)
from pyannote_video_tpu_torch.train import optim

TOL = 1e-5


def _port(params):
    return nn.params_from_jax(jnn.flatten_params(jax.tree.map(np.asarray, params)))


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def _bn_params(rng, c):
    return {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
            "bias": rng.normal(0, 0.3, c).astype(np.float32),
            "mean": rng.normal(0, 0.3, c).astype(np.float32),
            "var": rng.uniform(0.5, 2.0, c).astype(np.float32)}


@pytest.mark.parametrize("shape", [(4, 9, 11, 6), (2, 3, 3, 16)])
def test_batch_norm_train(shape):
    rng = np.random.default_rng(shape[0])
    x = rng.normal(1.0, 2.0, shape).astype(np.float32)
    params = _bn_params(rng, shape[-1])
    jy, jnew = jnn.batch_norm(jax.tree.map(jnp.asarray, params),
                              jnp.asarray(x), train=True)
    py, pnew = nn.batch_norm({k: torch.from_numpy(v) for k, v in params.items()},
                             _nchw(x), train=True)
    np.testing.assert_allclose(py.numpy().transpose(0, 2, 3, 1), np.asarray(jy),
                               atol=TOL)
    for k in ("mean", "var"):
        np.testing.assert_allclose(pnew[k].numpy(), np.asarray(jnew[k]), atol=TOL)
        assert not pnew[k].requires_grad
    # the other fields are the input's own
    assert pnew["scale"] is not None and np.array_equal(pnew["scale"].numpy(),
                                                        params["scale"])


def test_batch_norm_train_gradient_flows_through_the_batch_statistics():
    rng = np.random.default_rng(2)
    x = rng.normal(0.0, 1.0, (3, 5, 5, 4)).astype(np.float32)
    params = _bn_params(rng, 4)
    w = rng.normal(size=x.shape).astype(np.float32)

    def jloss(x):
        y, _ = jnn.batch_norm(jax.tree.map(jnp.asarray, params), x, train=True)
        return jnp.sum(y * w)

    jg = np.asarray(jax.grad(jloss)(jnp.asarray(x)))
    xt = _nchw(x).requires_grad_(True)
    y, _ = nn.batch_norm({k: torch.from_numpy(v) for k, v in params.items()},
                         xt, train=True)
    (y * _nchw(w)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy().transpose(0, 2, 3, 1), jg, atol=1e-4)


@pytest.mark.parametrize("down", [False, True])
def test_resblock_train(down):
    jparams = jnn.resblock_init(jax.random.PRNGKey(int(down)), 8, 16 if down else 8)
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (3, 13, 13, 8)).astype(np.float32)
    jy, jnew = jnn.resblock(jparams, jnp.asarray(x), down=down, train=True)
    py, pnew = nn.resblock(_port(jparams), _nchw(x), down=down, train=True)
    np.testing.assert_allclose(py.numpy().transpose(0, 2, 3, 1), np.asarray(jy),
                               atol=TOL)
    jflat, pflat = nn.flatten_params(_port(jnew)), nn.flatten_params(pnew)
    assert set(jflat) == set(pflat)
    for k in jflat:
        np.testing.assert_allclose(pflat[k].detach().numpy(), jflat[k].numpy(),
                                   atol=TOL, err_msg=k)


def _compare_train_forward(jfwd, pfwd, jparams, x):
    jy, jnew = jax.jit(lambda p, x: jfwd(p, x, train=True,
                                         compute_dtype=jnp.float32))(
        jparams, jnp.asarray(x))
    py, pnew = pfwd(_port(jparams), torch.from_numpy(x), train=True,
                    compute_dtype=torch.float32)
    np.testing.assert_allclose(py.detach().numpy(), np.asarray(jy), atol=TOL,
                               rtol=TOL)
    jflat, pflat = nn.flatten_params(_port(jnew)), nn.flatten_params(pnew)
    assert set(jflat) == set(pflat)
    for k in jflat:
        np.testing.assert_allclose(pflat[k].detach().numpy(), jflat[k].numpy(),
                                   atol=TOL, rtol=TOL, err_msg=k)


def test_detector_forward_maps_train():
    jparams = jdetector.init_params(jax.random.PRNGKey(0), deep_width=12)
    x = np.random.default_rng(0).uniform(0, 255, (3, 64, 64, 3)).astype(np.float32)
    _compare_train_forward(jdetector.forward_maps, detector.forward_maps,
                           jparams, x)


def test_refiner_forward_train():
    jparams = jrefiner.init_params(jax.random.PRNGKey(1), widths=(8, 8, 8, 8))
    x = np.random.default_rng(1).uniform(0, 255, (5, 64, 64, 3)).astype(np.float32)
    _compare_train_forward(jrefiner.forward, refiner.forward, jparams, x)


def test_embedder_forward_train():
    jparams = jembedder.init_params(jax.random.PRNGKey(2), width=0.125)
    x = np.random.default_rng(2).uniform(0, 255, (4, 150, 150, 3)).astype(np.float32)
    _compare_train_forward(jembedder.forward, embedder.forward, jparams, x)


def test_inference_forward_ignores_the_train_path():
    """``train=False`` still returns the output alone, from the recorded
    statistics."""
    params = refiner.init_params(torch.Generator().manual_seed(0), widths=(8, 8, 8, 8))
    out = refiner.forward(params, torch.zeros(2, 64, 64, 3),
                          compute_dtype=torch.float32)
    assert isinstance(out, torch.Tensor) and out.shape == (2,)


# -- initialisers -------------------------------------------------------------


def _shapes(state):
    return {k: tuple(v.shape) for k, v in nn.flatten_params(state).items()
            if isinstance(v, torch.Tensor)}


def _jax_shapes(init):
    """The port-layout shapes of a JAX initialiser's parameters (traced,
    not drawn)."""
    spec = jax.eval_shape(lambda: init(jax.random.PRNGKey(0)))
    return _shapes(_port(jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), spec)))


@pytest.mark.parametrize("name", ["detector", "refiner", "embedder"])
def test_init_params_shapes_and_statistics(name):
    g = torch.Generator().manual_seed(0)
    if name == "detector":
        state = detector.init_params(g, deep_width=96)
        ref = _jax_shapes(lambda k: jdetector.init_params(k, deep_width=96))
    elif name == "refiner":
        state = refiner.init_params(g)
        ref = _jax_shapes(jrefiner.init_params)
    else:
        state = embedder.init_params(g, width=1.0)
        ref = _jax_shapes(lambda k: jembedder.init_params(k, width=1.0))
    assert _shapes(state) == ref
    for key, value in nn.flatten_params(state).items():
        assert value.dtype == torch.float32, key
        leaf = key.rsplit("/", 1)[-1]
        if leaf in ("b", "bias", "mean"):
            assert not value.any(), key
        elif leaf in ("scale", "var"):
            assert bool((value == 1).all()), key
        elif value.numel() >= 20000:
            # He-normal: std sqrt(2 / fan_in) (the embedder's fc sqrt(1 / in))
            fan_in = (value.shape[0] if key == "fc"
                      else value[0].numel() if value.ndim == 4
                      else value.shape[1])
            gain = 1.0 if key == "fc" else 2.0
            std = float(value.std())
            assert abs(std / np.sqrt(gain / fan_in) - 1) < 0.05, (key, std)


def test_init_params_follow_the_generator():
    a = detector.init_params(torch.Generator().manual_seed(3), deep_width=8)
    b = detector.init_params(torch.Generator().manual_seed(3), deep_width=8)
    c = detector.init_params(torch.Generator().manual_seed(4), deep_width=8)
    assert torch.equal(a["c4"]["w"], b["c4"]["w"])
    assert not torch.equal(a["c4"]["w"], c["c4"]["w"])


# -- optimiser ----------------------------------------------------------------


def _grads(seed, scale):
    rng = np.random.default_rng(seed)
    g = {"a": rng.normal(size=(6, 5)).astype(np.float32) * scale,
         "b": rng.normal(size=(7,)).astype(np.float32) * scale}
    g["a"][0, :3] = [0.0, 1e-9, -1e-9]
    return g


@pytest.mark.parametrize("which", ["cosine", "clip", "clip-inactive"])
def test_three_adam_steps_equal_optax(which):
    rng = np.random.default_rng(1)
    params = {"a": rng.normal(size=(6, 5)).astype(np.float32),
              "b": rng.normal(size=(7,)).astype(np.float32)}
    leaves = [torch.from_numpy(params[k].copy()) for k in "ab"]
    if which == "cosine":
        tx = optax.adam(optax.cosine_decay_schedule(3e-4, 600, alpha=0.1))
        opt = optim.Adam(leaves, optim.cosine_decay_schedule(3e-4, 600, alpha=0.1))
        scales = (1.0, 0.3, 2.0)
    else:
        tx = optax.chain(optax.clip_by_global_norm(5.0), optax.adam(1e-3))
        opt = optim.Adam(leaves, 1e-3, max_norm=5.0)
        # a global norm of ~20 is clipped; ~0.2 is not
        scales = (3.0, 0.04, 3.0) if which == "clip" else (0.04, 0.03, 0.05)
    state, p = tx.init(params), dict(params)
    for step, scale in enumerate(scales):
        g = _grads(step, scale)
        updates, state = tx.update(g, state, p)
        p = optax.apply_updates(p, updates)
        opt.step([torch.from_numpy(g[k]) for k in "ab"])
        for i, k in enumerate("ab"):
            big = np.abs(g[k]) > 1e-6
            np.testing.assert_allclose(leaves[i].numpy()[big],
                                       np.asarray(p[k])[big], atol=1e-6, rtol=0)
    assert opt.count == 3


def test_adam_takes_channels_last_gradients():
    """A convolution's weight gradient can come back channels-last; the
    step pairs each gradient value with its own weight all the same."""
    rng = np.random.default_rng(2)
    w = rng.normal(size=(4, 3, 2, 2)).astype(np.float32)
    g = rng.normal(size=(4, 3, 2, 2)).astype(np.float32)
    steps = []
    for grad in (torch.from_numpy(g),
                 torch.from_numpy(g).to(memory_format=torch.channels_last)):
        leaves = [torch.from_numpy(w.copy())]
        optim.Adam(leaves, 1e-3).step([grad])
        steps.append(leaves[0])
    assert not steps[0].equal(torch.from_numpy(w))
    assert torch.equal(steps[0], steps[1])


@pytest.mark.parametrize("lr,steps", [(3e-4, 600), (3e-4, 3000), (1e-3, 7)])
def test_cosine_schedule(lr, steps):
    ref = jax.jit(optax.cosine_decay_schedule(lr, steps, alpha=0.1))
    ours = optim.cosine_decay_schedule(lr, steps, alpha=0.1)
    counts = list(range(0, min(steps + 3, 40))) + [steps // 2, steps, steps + 5]
    for count in counts:
        want = np.float32(ref(jnp.asarray(count, jnp.int32)))
        got = np.float32(ours(count))
        if count == 0 or count >= steps:
            assert got == want, (count, got, want)
        assert abs(got - want) <= 1e-6 * want, (count, got, want)


def test_clip_rule_is_optax_s():
    """Scaled only when the norm reaches max_norm, by max_norm / norm (no
    1e-6 added, unlike ``torch.nn.utils.clip_grad_norm_``)."""
    g = [torch.tensor([3.0, 4.0])]
    assert torch.equal(optim.clip_by_global_norm(g, 5.0)[0], g[0])
    assert torch.equal(optim.clip_by_global_norm(g, 5.5)[0], g[0])
    out = optim.clip_by_global_norm(g, 2.5)[0]
    assert torch.equal(out, g[0] / 5.0 * 2.5)


def test_hinge_splits_the_gradient_at_a_tie():
    x = torch.tensor([-1.0, 0.0, 2.0], requires_grad=True)
    nn.hinge(x).sum().backward()
    jg = jax.grad(lambda v: jnp.sum(jnp.maximum(v, 0.0)))(jnp.asarray([-1.0, 0.0, 2.0]))
    assert x.grad.tolist() == np.asarray(jg).tolist() == [0.0, 0.5, 1.0]


# -- the parameter writer -----------------------------------------------------


@pytest.mark.parametrize("name", ["detector", "refiner", "embedder"])
def test_save_params_is_read_by_jax(name, tmp_path):
    g = torch.Generator().manual_seed(1)
    rng = np.random.default_rng(1)
    if name == "detector":
        state = detector.init_params(g, deep_width=12)
        x = rng.uniform(0, 255, (2, 64, 64, 3)).astype(np.float32)
        jfwd, pfwd = jdetector.forward_maps, detector.forward_maps
    elif name == "refiner":
        state = refiner.init_params(g, widths=(8, 8, 8, 16))
        x = rng.uniform(0, 255, (3, 64, 64, 3)).astype(np.float32)
        jfwd, pfwd = jrefiner.forward, refiner.forward
    else:
        state = embedder.init_params(g, width=0.25)
        state["normalized_head"] = False
        x = rng.uniform(0, 255, (2, 150, 150, 3)).astype(np.float32)
        jfwd, pfwd = jembedder.forward, embedder.forward
    # statistics that are not the identity, as after training
    for key, value in nn.flatten_params(state).items():
        if key.endswith(("mean", "var")):
            value.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, value.shape)
                                         .astype(np.float32)))
    path = tmp_path / f"{name}.npz"
    nn.save_params(path, state)
    jparams = jnn.load_params(str(path))
    jy, _ = jfwd(jparams, jnp.asarray(x), compute_dtype=jnp.float32)
    py = pfwd(state, torch.from_numpy(x), compute_dtype=torch.float32)
    np.testing.assert_allclose(py.numpy(), np.asarray(jy), atol=1e-4, rtol=1e-4)
    # and the port reads its own file back to the same state
    back = nn.flatten_params(nn.load_params(path))
    for key, value in nn.flatten_params(state).items():
        if isinstance(value, torch.Tensor):
            assert torch.equal(back[key], value), key
        else:
            assert back[key] == value, key


def test_params_to_jax_inverts_params_from_jax():
    with np.load(weights.REFINER_FILE) as data:
        flat = {k: data[k] for k in data.files}
    back = nn.flatten_params(nn.params_to_jax(nn.params_from_jax(flat)))
    assert set(back) == set(flat)
    for key in flat:
        assert np.array_equal(back[key], flat[key]), key


def test_a_refiner_goes_to_its_own_file(tmp_path):
    state = {**detector.init_params(torch.Generator().manual_seed(0), deep_width=8),
             "refiner": refiner.init_params(torch.Generator().manual_seed(1),
                                            widths=(8, 8, 8, 8))}
    with pytest.raises(ValueError, match="refiner"):
        nn.save_params(tmp_path / "det.npz", state)
    nn.save_params(tmp_path / "det.npz", state, refiner_path=tmp_path / "ref.npz")
    with np.load(tmp_path / "det.npz") as det, np.load(tmp_path / "ref.npz") as ref:
        assert not any(k.startswith("refiner") for k in det.files)
        assert "d1/w" in ref.files and "c1/w" in det.files


def test_landmarks_save_is_read_by_both_predictors(tmp_path):
    """A port-saved cascade (the packaged one cut to 3 stages of 40 trees)
    gives the same landmarks through either package's predictor."""
    with np.load(weights.LANDMARKS_FILE) as data:
        flat = {k: data[k] for k in data.files}
    cut = {k: (v[:40] if k.endswith(("i1", "i2", "thresh", "leaves")) else v)
           for k, v in flat.items() if not k.startswith("s")
           or int(k[1:].split("/")[0]) < 3}
    cut["n_stages"] = np.asarray(3)
    cut["bilinear_tail"] = np.asarray(3)
    path = tmp_path / "landmarks.npz"
    landmarks.save(path, landmarks.cascade_from_jax(cut))
    with np.load(path) as data:
        assert data["s0/anchor"].dtype == np.int32
        assert data["s2/leaves"].dtype == np.float32
    rng = np.random.default_rng(0)
    frames = rng.uniform(0, 255, (2, 96, 120, 3)).astype(np.uint8)
    boxes = np.asarray([[30, 20, 80, 75], [10, 15, 70, 80]], np.float32)
    idx = np.asarray([0, 1])
    port = landmarks.LandmarkPredictor(str(path), device="cpu")
    ours = port.predict_batch(frames, idx, boxes)
    theirs = jlandmarks.LandmarkPredictor(str(path)).predict_batch(frames, idx, boxes)
    assert ours.shape == (2, 68, 2)
    np.testing.assert_allclose(ours, theirs, atol=5e-3)
