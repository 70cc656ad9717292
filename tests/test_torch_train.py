"""The port's trainers against the JAX package's, on the CPU.

Each trainer's ``loss_fn`` and its gradient against ``jax.value_and_grad``
of the JAX ``loss_fn`` on the same parameters and batch: the loss within
1e-5 relative, each gradient tensor within 1e-4 of its largest magnitude.
A conv bias in front of a train-mode batch norm has a gradient of exactly
zero (the norm subtracts the batch mean); both packages give rounding noise
there, which is held to 1e-4 of the largest gradient of the whole model.
One whole step (loss, gradient, Adam) gives the same parameters within
1e-6 wherever the gradient is above 1e-3 of the model's largest (Adam's
first step moves a parameter by about the rate whatever its gradient's
size, so rounding noise would move it by ±rate).  The serve-scale
miner's pyramid gives logits within bfloat16 tolerance of JAX's, and the
cells it harvests agree as sets.  Each trainer's ``train`` runs two steps
on the CPU to a finite loss and a state the serving classes take.

Sizes are small: detector ``deep_width`` 8 at 64², refiner widths
(8, 8, 8, 8), embedder width 0.125, batches of at most 8.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from pyannote_video_tpu.models import detector as jdetector
from pyannote_video_tpu.models import embedder as jembedder
from pyannote_video_tpu.models import nn as jnn
from pyannote_video_tpu.models import refiner as jrefiner
from pyannote_video_tpu.train import data as jdata
from pyannote_video_tpu.train import mine as jmine
from pyannote_video_tpu.train import train_detector as jtd
from pyannote_video_tpu.train import train_embedder as jte
from pyannote_video_tpu.train import train_refiner as jtr

from pyannote_video_tpu_torch.models import detector, embedder, nn, refiner
from pyannote_video_tpu_torch.train import mine, optim
from pyannote_video_tpu_torch.train import train_detector as ptd
from pyannote_video_tpu_torch.train import train_embedder as pte
from pyannote_video_tpu_torch.train import train_refiner as ptr

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4

# the trainers step on the CPU here: six test workers at full torch width
# thrash
torch.set_num_threads(1)


def _port(params):
    """A JAX parameter set (or gradient of one) in the port's layout."""
    return nn.params_from_jax(jnn.flatten_params(jax.tree.map(np.asarray, params)))


def _value_and_grad(jax_loss_fn, jparams, jbatch, port_loss_fn, pbatch):
    (jl, jbn), jg = jax.jit(jax.value_and_grad(jax_loss_fn, has_aux=True))(
        jparams, *jbatch)
    pparams = _port(jparams)
    leaves = {k: v.detach().requires_grad_(True)
              for k, v in nn.trainable_leaves(pparams).items()}
    pl, pbn = port_loss_fn(nn.with_leaves(pparams, leaves), *pbatch)
    pg = dict(zip(leaves, torch.autograd.grad(pl, list(leaves.values()))))
    return (float(jl), nn.flatten_params(_port(jbn)),
            nn.flatten_params(_port(jg)), float(pl.detach()),
            nn.flatten_params(pbn), pg)


def _check(result, zero_grad=()):
    jl, jbn, jg, pl, pbn, pg = result
    assert abs(pl - jl) <= LOSS_RTOL * abs(jl), (pl, jl)
    scale = max(float(v.abs().max()) for v in jg.values())
    assert set(pg) == {k for k in jg if k.rsplit("/", 1)[-1] not in ("mean", "var")}
    for key, grad in pg.items():
        ref = jg[key].numpy()
        err = float(np.abs(grad.numpy() - ref).max())
        if key in zero_grad:
            assert err <= GRAD_TOL * scale, (key, err, scale)
            assert float(np.abs(ref).max()) <= GRAD_TOL * scale, key
        else:
            assert err <= GRAD_TOL * float(np.abs(ref).max()), (key, err)
    for key in jbn:
        if key.endswith(("mean", "var")):
            np.testing.assert_allclose(pbn[key].numpy(), jbn[key].numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=key)


def _detector_batch(seed, batch=4, size=64):
    rng = np.random.default_rng(seed)
    frames, boxes, hard = jdata.detection_batch(rng, batch=batch, height=size,
                                                width=size, return_hard=True)
    labels, deltas, mask = jdata.detection_targets(boxes, size, size)
    return frames, labels, deltas, mask, hard


@pytest.mark.parametrize("seed", [0, 1])
def test_detector_loss_and_gradient(seed):
    jparams = jdetector.init_params(jax.random.PRNGKey(seed), deep_width=8)
    batch = _detector_batch(seed)
    jbatch = (jnp.asarray(batch[0], jnp.float32),) + tuple(
        jnp.asarray(a) for a in batch[1:])
    result = _value_and_grad(jtd.loss_fn, jparams, jbatch, ptd.loss_fn,
                             ptd.batch_tensors(*batch, "cpu"))
    _check(result, zero_grad={f"c{i}/b" for i in range(1, 7)})


def _refiner_batch(seed, n=8):
    rng = np.random.default_rng(seed)
    crops = rng.uniform(0, 255, (n, refiner.CROP, refiner.CROP, 3)).astype(np.float32)
    labels = (rng.random(n) < 0.5).astype(np.float32)
    hard = ((rng.random(n) < 0.5) & (labels > 0)).astype(np.float32)
    return crops, labels, hard


@pytest.mark.parametrize("seed", [0, 1])
def test_refiner_loss_and_gradient(seed):
    jparams = jrefiner.init_params(jax.random.PRNGKey(seed), widths=(8, 8, 8, 8))
    batch = _refiner_batch(seed)
    result = _value_and_grad(jtr.loss_fn, jparams,
                             tuple(jnp.asarray(a) for a in batch),
                             ptr.loss_fn, ptr.batch_tensors(*batch, "cpu"))
    _check(result, zero_grad={f"c{i}/b" for i in range(1, 5)})


def _embedder_batch(seed, n_ident=2, per_ident=2):
    rng = np.random.default_rng(seed)
    bank = jdata.identity_bank(6, seed=seed + 1)
    return jdata.embedding_batch(rng, bank, n_ident=n_ident, per_ident=per_ident)


def test_embedder_loss_and_gradient():
    jparams = jembedder.init_params(jax.random.PRNGKey(3), width=0.125)
    chips, labels = _embedder_batch(3)
    result = _value_and_grad(
        jte.loss_fn, jparams, (jnp.asarray(chips, jnp.float32), jnp.asarray(labels)),
        pte.loss_fn, pte.batch_tensors(chips, labels, "cpu"))
    zero = {"stem/b"} | {f"blocks/block{i}/conv{j}/b"
                         for i in range(len(embedder.BLOCK_PLAN)) for j in (1, 2)}
    _check(result, zero_grad=zero)


def test_refiner_step_equals_optax_step():
    """One whole step: loss, gradient and the cosine-scheduled Adam."""
    jparams = jrefiner.init_params(jax.random.PRNGKey(4), widths=(8, 8, 8, 8))
    batch = _refiner_batch(4)
    tx = optax.adam(optax.cosine_decay_schedule(3e-4, 10, alpha=0.1))
    (_, jbn), jg = jax.jit(jax.value_and_grad(jtr.loss_fn, has_aux=True))(
        jparams, *(jnp.asarray(a) for a in batch))
    updates, _ = tx.update(jg, tx.init(jparams), jbn)
    jnew = nn.flatten_params(_port(optax.apply_updates(jbn, updates)))
    grads = nn.flatten_params(_port(jg))
    # the conv biases in front of a batch norm carry rounding noise only,
    # which Adam's first step turns into ±lr: held apart by the model scale
    scale = max(float(v.abs().max()) for v in grads.values())

    pparams = _port(jparams)
    state, opt = optim.adam(pparams, optim.cosine_decay_schedule(3e-4, 10, alpha=0.1))
    pnew, loss = optim.train_step(ptr.loss_fn, state, opt,
                                  *ptr.batch_tensors(*batch, "cpu"))
    pnew = nn.flatten_params(pnew)
    assert loss.shape == () and not loss.requires_grad
    for key, ref in jnew.items():
        out = pnew[key].numpy()
        if key.endswith(("mean", "var")):
            np.testing.assert_allclose(out, ref.numpy(), rtol=1e-5, atol=1e-6)
            continue
        clear = np.abs(grads[key].numpy()) > 1e-3 * scale
        np.testing.assert_allclose(out[clear], ref.numpy()[clear], atol=1e-6,
                                   err_msg=key)


def test_pyramid_maps_match_jax_and_harvest_the_same_cells():
    """The miner's bf16 pyramid on 2 negative frames: logits within 0.05
    of the level's logit range, and the cells above the harvest gate that
    both packages rank first agree on at least 80%."""
    jparams = jdetector.init_params(jax.random.PRNGKey(5), deep_width=8)
    rng = np.random.default_rng(5)
    frames = np.stack([jmine.negative_frame(rng, h=120, w=160) for _ in range(2)])
    dims = ((120, 160), (90, 120), (68, 90))
    jlevels = jmine._pyramid_maps(jparams, jnp.asarray(frames, jnp.float32), dims)
    plevels = mine._read_levels(mine._pyramid_maps(
        _port(jparams), torch.from_numpy(frames).to(torch.float32), dims))
    agree = total = 0
    for (jl, jimg), (pl, pimg) in zip(jlevels, plevels):
        jl = np.asarray(jl, np.float32)
        span = float(jl.max() - jl.min())
        assert np.abs(pl - jl).max() <= 0.05 * span
        assert np.abs(pimg - np.asarray(jimg, np.float32)).max() <= 2.0
        for b in range(len(frames)):
            top_j = set(np.argsort(jl[b].ravel())[::-1][:jmine.MINE_PER_FRAME])
            top_p = set(np.argsort(pl[b].ravel())[::-1][:jmine.MINE_PER_FRAME])
            agree += len(top_j & top_p)
            total += len(top_j)
    assert agree >= 0.8 * total, (agree, total)


def test_hard_negative_miner_harvests_batch_crops():
    params = detector.init_params(torch.Generator().manual_seed(5), deep_width=8)
    miner = mine.HardNegativeMiner(frames_per_refresh=1, seed=3, device="cpu")
    found = miner.refresh(params)
    assert found > 0 and len(miner) == found
    assert miner.last_max_logit > mine.MINE_MIN_LOGIT
    assert miner.render_seconds > 0
    crops = miner.sample(np.random.default_rng(0), 4)
    assert crops and all(c.shape == (128, 128, 3) and c.dtype == np.uint8
                         for c in crops)


def test_serve_miner_keeps_the_environment(monkeypatch):
    """The port's ServeMiner serves stage 1 without the refiner and
    without setting PYV_NO_REFINE for the process."""
    monkeypatch.delenv("PYV_NO_REFINE", raising=False)
    miner = ptr.ServeMiner(seed=1, device="cpu")
    miner.refresh(n_frames=1)
    assert "PYV_NO_REFINE" not in os.environ
    assert "refiner" not in miner.params
    for crop in miner.neg + [c for c, _ in miner.pos]:
        assert crop.shape == (refiner.CROP, refiner.CROP, 3)
    crops, labels, hard = ptr.crop_batch(np.random.default_rng(4), miner,
                                         n_scenes=1)
    assert crops.shape[1:] == (64, 64, 3)
    assert labels.shape == hard.shape == (crops.shape[0],)
    assert float(hard[labels == 0].max(initial=0.0)) == 0.0


def test_detector_train_smoke(capsys):
    """Two steps with the serve-scale miner on (a refresh at step 0
    renders 8 negative and 8 positive frames of 360×480)."""
    params = ptd.train(steps=2, batch=4, size=64, deep_width=8, log_every=1,
                       device="cpu")
    out = capsys.readouterr().out
    losses = [float(line.split()[3]) for line in out.splitlines()
              if line.startswith("step")]
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert "mined neg" in out
    det = detector.FaceDetector(params=params, device="cpu",
                                compute_dtype=torch.float32)
    assert isinstance(det(np.zeros((64, 64, 3), np.uint8)), list)
    maps = detector.forward_maps(params, torch.zeros(1, 64, 64, 3))
    assert maps.shape == (1, 8, 8, 5) and bool(torch.isfinite(maps).all())
    for key, value in nn.flatten_params(params).items():
        assert bool(torch.isfinite(value).all()), key


def test_embedder_train_smoke(capsys):
    params = pte.train(steps=2, n_ident=2, per_ident=2, width=0.125,
                       log_every=1, device="cpu")
    losses = [float(line.split()[3]) for line in capsys.readouterr().out.splitlines()
              if line.startswith("step")]
    assert len(losses) == 2 and np.isfinite(losses).all()
    emb = embedder.FaceEmbedder(params=params, device="cpu")(
        np.zeros((2, 150, 150, 3), np.uint8))
    assert emb.shape == (2, 128) and np.isfinite(emb).all()


def test_refiner_train_smoke(monkeypatch, capsys):
    """Two steps, each batch cut from one scene (the default renders four)
    and the miner refreshed on one frame."""
    crop_batch = ptr.crop_batch
    monkeypatch.delenv("PYV_NO_REFINE", raising=False)
    monkeypatch.setattr(ptr, "MINE_FRAMES", 1)
    monkeypatch.setattr(ptr, "crop_batch",
                        lambda rng, miner: crop_batch(rng, miner, n_scenes=1))
    init = refiner.init_params(torch.Generator().manual_seed(0), widths=(8, 8, 8, 8))
    params = ptr.train(steps=2, log_every=1, init_params=init, device="cpu")
    losses = [float(line.split()[3]) for line in capsys.readouterr().out.splitlines()
              if line.startswith("step")]
    assert len(losses) == 2 and np.isfinite(losses).all()
    logits = refiner.forward(params, torch.zeros(2, refiner.CROP, refiner.CROP, 3))
    assert logits.shape == (2,) and bool(torch.isfinite(logits).all())
    assert "PYV_NO_REFINE" not in os.environ

