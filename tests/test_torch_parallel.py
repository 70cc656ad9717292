"""The port's mesh, sharded embedder, sharded train step and dry run
against the JAX package's, on the CPU.

The port's ranks are gloo processes (``parallel/dryrun.py:launch``: a file
store in a temporary directory, no port, one torch thread each); the JAX
side runs on ``tests/conftest.py``'s 8 virtual CPU devices.  The train
step is compared over two steps from width-0.125 params carried across by
``params_from_jax``, on a batch whose same-label pairs all lie across the
two data shards: the loss within 1e-5 relative, every batch-norm statistic
within 1e-4 of its largest magnitude, every leaf within 1e-4 of its
largest magnitude where the gradient is clear of rounding noise at both
steps (above 1e-3 of the model's largest).  Elsewhere Adam moves an entry
by about the rate whatever its gradient's size, so noise there (the conv
biases in front of a batch norm have a gradient of exactly zero) is held
to two rates per step, and a recorded mean, which takes 0.01 of the
batch mean and so of that bias's first step, gets 0.01 × 2 rates more.
A step is also taken with Adam's ``eps`` far above every gradient (rate
1e3, eps 1e4): the update is then 0.1 times the gradient, linear in it,
and nothing amplifies noise, so every entry of every leaf's update is held
within 1e-4 of that leaf's largest update, with no carve-out but the conv
biases (each in front of a batch norm, so their gradient is exactly zero
and their update rounding noise, held within 1e-4 of the model's largest
update).  That check takes one step: a second one starts from params that
already differ by the first step's float32 rounding, and at this rate it
moves the loss by up to 70%, which carries that difference into the
second loss beyond 1e-5.  A data-parallel step of the DDP kind (local
batch norm, local pairs, summed gradients) misses these tolerances, with
either Adam.

The rank functions below run in the ranks, which import this file: it
imports JAX only inside the tests.
"""

import os

import numpy as np
import pytest
import torch

from pyannote_video_tpu_torch.models import nn
from pyannote_video_tpu_torch.parallel.dryrun import launch

LOSS_RTOL = 1e-5
LEAF_TOL = 1e-4
LR = 1e-3
# (rate, eps, steps) of each Adam: optax.adam(1e-3), and one whose first
# update rate·g/(|g| + eps) is 0.1·g to 1e-4 relative (every |g| < 1)
OPTIMISERS = {"adam": (LR, 1e-8, 2), "linear": (1e3, 1e4, 1)}
BN_MOMENTUM = 0.99
EMBED_BF16_DIST = 0.05      # as tests/test_torch_extract.py
TESTS = str(__import__("pathlib").Path(__file__).resolve().parent)

torch.set_num_threads(1)


# -- rank functions ---------------------------------------------------------

def _mesh_rank(model_parallelism):
    from pyannote_video_tpu_torch.parallel.mesh import make_mesh, mesh_shape

    return mesh_shape(make_mesh(model_parallelism=model_parallelism, device="cpu"))


def _sharded_rank(flat, chips, labels):
    """dp 2 × tp 2: the placements, the sharded forward, and train steps
    from the same params with each of ``OPTIMISERS``; returns for each the
    full leaves after them (gathered) and the losses."""
    from pyannote_video_tpu_torch.parallel import sharding
    from pyannote_video_tpu_torch.parallel.mesh import make_mesh
    from pyannote_video_tpu_torch.train.optim import adam

    mesh = make_mesh(model_parallelism=2, device="cpu")
    params = sharding.shard_params_for_tp(nn.params_from_jax(flat), mesh)
    placements = {k: [repr(p) for p in v.placements]
                  for k, v in sharding._sharded(params).items()}
    shapes = {k: tuple(v.to_local().shape)
              for k, v in sharding._sharded(params).items()}
    chips, labels = torch.from_numpy(chips), torch.from_numpy(labels)
    emb = sharding.sharded_embed_fn(mesh)(params, chips).numpy()
    runs = {}
    for name, (rate, eps, steps) in OPTIMISERS.items():
        trained, opt = adam(params, rate)
        opt.param_groups[0]["eps"] = eps
        step = sharding.make_train_step(mesh, opt)
        losses = []
        for _ in range(steps):
            trained, loss = step(trained, chips, labels)
            losses.append(float(loss))
        full = {k: sharding._full(sharding.local_part(v), v.placements, mesh)
                for k, v in sharding._sharded(trained).items()}
        state = nn.flatten_params(nn.with_leaves(trained, full))
        runs[name] = {"losses": losses,
                      "params": {k: v.numpy() for k, v in state.items()
                                 if isinstance(v, torch.Tensor)}}
    moments = {tuple(s["exp_avg"].shape) for s in opt.state.values()}
    return {"placements": placements, "local_shapes": shapes, "emb": emb,
            "moment_shapes": moments, "runs": runs}


def _failing_rank():
    import torch.distributed as dist

    if dist.get_rank() == 1:
        raise RuntimeError("rank one fails")
    dist.barrier()       # waits for rank 1 forever: launch must stop it


# -- the JAX side and the comparison ----------------------------------------

@pytest.fixture(scope="module")
def case():
    """Width-0.125 params, a batch of 8 chips whose two data shards hold
    one chip of each of the same 4 identities, and JAX's dp 2 × tp 2
    results on them, with each of ``OPTIMISERS``."""
    import jax
    import optax

    from pyannote_video_tpu.models import embedder as jembedder
    from pyannote_video_tpu.models import nn as jnn
    from pyannote_video_tpu.parallel import mesh as jmesh
    from pyannote_video_tpu.parallel import sharding as jsharding
    from pyannote_video_tpu.train import data as jdata

    jparams = jembedder.init_params(jax.random.PRNGKey(5), width=0.125)
    chips, labels = jdata.embedding_batch(np.random.default_rng(5),
                                          jdata.identity_bank(8, seed=6),
                                          n_ident=4, per_ident=2)
    order = np.argsort(np.arange(8) % 2, kind="stable")   # 0,2,4,6,1,3,5,7
    chips = chips[order].astype(np.float32)
    labels = np.searchsorted(np.unique(labels), labels[order]).astype(np.int64)
    assert labels[:4].tolist() == labels[4:].tolist() and len(set(labels)) == 4

    mesh = jmesh.make_mesh(n_devices=4, model_parallelism=2)
    with mesh:
        sharded = jsharding.shard_params_for_tp(jparams, mesh)
        emb = np.asarray(jsharding.sharded_embed_fn(mesh)(jparams, chips))
        runs = {}
        for name, (rate, eps, steps) in OPTIMISERS.items():
            tx = optax.adam(rate, eps=eps)
            opt_state = tx.init(sharded)
            step = jsharding.make_train_step(mesh, tx)
            losses, params = [], sharded
            for _ in range(steps):
                params, opt_state, loss = step(params, opt_state, chips,
                                               labels.astype(np.int32))
                losses.append(float(loss))
            after = nn.flatten_params(nn.params_from_jax(
                jnn.flatten_params(jax.tree.map(np.asarray, params))))
            runs[name] = {"losses": losses,
                          "params": {k: v.numpy() for k, v in after.items()
                                     if isinstance(v, torch.Tensor)}}
    flat = {k: np.asarray(v) for k, v in jnn.flatten_params(jparams).items()}
    specs = {"/".join(k.key for k in path): tuple(v.sharding.spec)
             for path, v in jax.tree_util.tree_flatten_with_path(sharded)[0]}
    before = nn.flatten_params(nn.params_from_jax(flat))
    return {"flat": flat, "chips": chips, "labels": labels, "emb": emb,
            "specs": specs, "runs": runs,
            "before": {k: v.numpy() for k, v in before.items()
                       if isinstance(v, torch.Tensor)}}


@pytest.fixture(scope="module")
def tests_on_path():
    """The ranks import this file's rank functions through ``PYTHONPATH``."""
    with pytest.MonkeyPatch.context() as patch:
        patch.setenv("PYTHONPATH", os.pathsep.join(
            p for p in (TESTS, os.environ.get("PYTHONPATH")) if p))
        yield


@pytest.fixture(scope="module")
def ranks(case, tests_on_path):
    results, _ = launch(4, "test_torch_parallel:_sharded_rank",
                        (case["flat"], case["chips"], case["labels"]),
                        device="cpu")
    return results


def _clear_of_noise(case):
    """Per leaf, the entries whose gradient is above 1e-3 of the model's
    largest at both steps (the port's single-process gradients of the same
    loss, at the parameters each step starts from)."""
    from pyannote_video_tpu_torch.parallel import sharding
    from pyannote_video_tpu_torch.train.optim import adam, train_step

    chips, labels = torch.from_numpy(case["chips"]), torch.from_numpy(case["labels"])
    params, opt = adam(nn.params_from_jax(case["flat"]), LR)
    clear = None
    for _ in range(2):
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in nn.trainable_leaves(params).items()}
        loss, _ = sharding.loss_fn(nn.with_leaves(params, leaves), chips, labels)
        grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        scale = max(float(g.abs().max()) for g in grads.values())
        now = {k: (g.abs() > 1e-3 * scale).numpy() for k, g in grads.items()}
        clear = now if clear is None else {k: clear[k] & now[k] for k in now}
        params, _ = train_step(sharding.loss_fn, params, opt, chips, labels)
    return clear


def _violation(losses, params, case, clear) -> float:
    """The largest error over its tolerance, of the losses and of every
    leaf and statistic against JAX's after two steps of ``optax.adam(1e-3)``
    (≤ 1 passes)."""
    jax_run = case["runs"]["adam"]
    worst = max(abs(p - j) / (LOSS_RTOL * abs(j))
                for p, j in zip(losses, jax_run["losses"]))
    for key, ref in jax_run["params"].items():
        err = np.abs(params[key] - ref)
        tol = LEAF_TOL * float(np.abs(ref).max())
        if key.endswith("/mean"):
            # 0.01 of the batch mean, which moves one for one with the free
            # conv bias in front: its first step is noise, ±LR in each package
            tol += (1 - BN_MOMENTUM) * 2 * LR
        if key in clear:
            worst = max(worst, float(err[clear[key]].max(initial=0.0)) / tol,
                        float(err[~clear[key]].max(initial=0.0)) / (4 * LR + tol))
        else:
            worst = max(worst, float(err.max()) / tol)
    return worst


def _linear_violation(losses, params, case) -> float:
    """The largest error over its tolerance against JAX's after the step
    of the linear Adam (≤ 1 passes): the loss; each statistic within
    1e-4 of its largest magnitude; each leaf's update within 1e-4 of its
    largest update, plus a float32 ulp of the leaf for the rounding of
    the sum; the conv biases' within 1e-4 of the model's largest update."""
    jax_run = case["runs"]["linear"]
    worst = max(abs(p - j) / (LOSS_RTOL * abs(j))
                for p, j in zip(losses, jax_run["losses"]))
    update = {k: np.abs(jax_run["params"][k] - v).max()
              for k, v in case["before"].items()
              if not k.endswith(("/mean", "/var"))}
    for key, ref in jax_run["params"].items():
        err = float(np.abs(params[key] - ref).max())
        scale = float(np.abs(ref).max())
        if key.endswith(("/mean", "/var")):
            tol = LEAF_TOL * scale
        elif key.endswith("/b"):
            tol = LEAF_TOL * max(update.values())
        else:
            tol = LEAF_TOL * update[key] + float(np.spacing(np.float32(scale)))
        worst = max(worst, err / tol)
    return worst


def _local_batch_step(case, optimiser):
    """The steps of the DDP kind: each shard's loss over its own pairs with
    its own batch norm, gradients summed over the shards; the summed
    losses and the leaves after them."""
    from pyannote_video_tpu_torch.parallel import sharding
    from pyannote_video_tpu_torch.train.optim import adam

    rate, eps, steps = OPTIMISERS[optimiser]
    chips, labels = torch.from_numpy(case["chips"]), torch.from_numpy(case["labels"])
    params, opt = adam(nn.params_from_jax(case["flat"]), rate)
    opt.param_groups[0]["eps"] = eps
    losses = []
    for _ in range(steps):
        leaves = nn.trainable_leaves(params)
        grads, total = None, 0.0
        for rows in (slice(0, 4), slice(4, 8)):
            grad_of = {k: v.detach().requires_grad_(True) for k, v in leaves.items()}
            loss, moved = sharding.loss_fn(nn.with_leaves(params, grad_of),
                                           chips[rows], labels[rows])
            g = torch.autograd.grad(loss, list(grad_of.values()))
            grads = g if grads is None else [a + b for a, b in zip(grads, g)]
            total += float(loss.detach())
        opt.step(grads)
        params = nn.with_leaves(moved, leaves)
        losses.append(total)
    return losses, {k: v.numpy() for k, v in nn.flatten_params(params).items()
                    if isinstance(v, torch.Tensor)}


def test_mesh_shapes(tests_on_path):
    results, _ = launch(8, "test_torch_parallel:_mesh_rank", (2,), device="cpu")
    assert results == [{"data": 4, "model": 2}] * 8


def test_one_process_mesh_makes_its_own_group():
    import torch.distributed as dist

    from pyannote_video_tpu_torch.parallel.mesh import make_mesh, mesh_shape

    assert not dist.is_initialized()
    try:
        assert mesh_shape(make_mesh(device="cpu")) == {"data": 1, "model": 1}
        assert dist.get_world_size() == 1
    finally:
        dist.destroy_process_group()


def test_indivisible_raises_before_touching_a_group():
    import torch.distributed as dist

    from pyannote_video_tpu_torch.parallel.mesh import make_mesh

    with pytest.raises(ValueError, match="not divisible"):
        make_mesh(n_devices=7, model_parallelism=2, device="cpu")
    assert not dist.is_initialized()


def test_placements_are_dtensor_ones():
    from torch.distributed.tensor import Replicate, Shard

    from pyannote_video_tpu_torch.parallel import mesh

    assert mesh.data_sharding(None) == [Shard(0), Replicate()]
    assert mesh.replicated(None) == [Replicate(), Replicate()]
    assert mesh.model_sharding(None, 3, 4) == [Replicate(), Shard(3)]
    assert mesh.model_sharding(None, -1, 2) == [Replicate(), Shard(1)]
    with pytest.raises(ValueError):
        mesh.model_sharding(None, 4, 4)


def test_shard_params_for_tp_shards_the_leaves_jax_shards(case, ranks):
    jax_sharded = {k: spec.index("model") for k, spec in case["specs"].items()
                   if "model" in spec}
    # HWIO axis 3 (cout) is OIHW axis 0; the FC [in, out] keeps axis 0
    assert {k: {3: 0, 0: 0}[a] for k, a in jax_sharded.items()} == {
        k: 0 for k in jax_sharded}
    assert set(jax_sharded) == {k for k, v in case["flat"].items()
                                if v.ndim in (2, 4)}
    for rank in ranks:
        assert set(rank["placements"]) == set(jax_sharded)
        assert all(p == ["Replicate()", "Shard(dim=0)"]
                   for p in rank["placements"].values())
        for key, shape in rank["local_shapes"].items():
            full = nn.params_from_jax({key: case["flat"][key]})
            full = nn.flatten_params(full)[key].shape
            assert shape == (full[0] // 2,) + tuple(full[1:]), key
        # each rank keeps Adam moments of its slices only
        assert rank["moment_shapes"] <= set(rank["local_shapes"].values()) | {
            tuple(v.shape) for k, v in nn.flatten_params(
                nn.params_from_jax(case["flat"])).items()
            if k not in rank["local_shapes"]}


def test_sharded_embed_matches_the_forward_and_jax(case, ranks):
    from pyannote_video_tpu_torch.models import embedder

    with torch.no_grad():
        ref = embedder.forward(nn.params_from_jax(case["flat"]),
                               torch.from_numpy(case["chips"])).numpy()
    for rank in ranks:
        np.testing.assert_allclose(rank["emb"], ref, atol=1e-6, rtol=0)
    dist = np.linalg.norm(ranks[0]["emb"] - case["emb"], axis=1)
    assert float(dist.max()) <= EMBED_BF16_DIST, dist


def test_sharded_embed_refuses_an_uneven_batch():
    from pyannote_video_tpu_torch.parallel import sharding

    class Mesh:
        mesh_dim_names, shape = ("data", "model"), (3, 1)

    with pytest.raises(ValueError, match="does not split"):
        sharding._rows(Mesh(), 8)


def test_train_step_matches_jax_over_two_steps(case, ranks):
    clear = _clear_of_noise(case)
    # the entries held to their leaf's scale, and those held to 4 rates
    noisy = {k: float(1 - v.mean()) for k, v in clear.items() if not v.all()}
    print("entries outside the clear set, per leaf:", noisy,
          "of all:", sum(int((~v).sum()) for v in clear.values()),
          "/", sum(v.size for v in clear.values()))
    worst = [_violation(r["runs"]["adam"]["losses"], r["runs"]["adam"]["params"],
                        case, clear) for r in ranks]
    print("worst error over its tolerance, per rank:", worst)
    for rank in ranks:
        assert rank["runs"]["adam"]["losses"] == ranks[0]["runs"]["adam"]["losses"]
    assert max(worst) <= 1.0


def test_linear_train_step_matches_jax(case, ranks):
    worst = [_linear_violation(r["runs"]["linear"]["losses"],
                               r["runs"]["linear"]["params"], case) for r in ranks]
    print("worst error over its tolerance, per rank:", worst)
    for rank in ranks:
        assert rank["runs"]["linear"]["losses"] == ranks[0]["runs"]["linear"]["losses"]
    assert max(worst) <= 1.0


def test_a_local_batch_step_misses_the_tolerance(case):
    # its loss is another function's; JAX's is passed, so the leaves alone
    # have to miss
    _, params = _local_batch_step(case, "adam")
    worst = _violation(case["runs"]["adam"]["losses"], params, case,
                       _clear_of_noise(case))
    print("worst error over its tolerance:", worst)
    assert worst > 1.0


def test_a_local_batch_linear_step_misses_the_tolerance(case):
    _, params = _local_batch_step(case, "linear")
    worst = _linear_violation(case["runs"]["linear"]["losses"], params, case)
    print("worst error over its tolerance:", worst)
    assert worst > 1.0


def test_a_failed_rank_stops_the_group(tests_on_path):
    import time

    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed") as error:
        launch(2, "test_torch_parallel:_failing_rank", device="cpu")
    assert "rank one fails" in str(error.value)
    assert time.monotonic() - t0 < 60


@pytest.mark.parametrize("seed", [0, 1])
def test_batch_norm_summed_over_one_part_is_the_local_one(seed):
    """The ``psum`` form with the identity for a sum (a batch that is all
    here) gives the local statistics, to float32 rounding."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((4, 6, 5, 7), generator=g) * 3 + 1
    params = nn.bn_init(6)
    ref, ref_bn = nn.batch_norm(params, x, train=True)
    out, out_bn = nn.batch_norm(params, x, train=True, psum=lambda t: t)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
    for key in ("mean", "var"):
        torch.testing.assert_close(out_bn[key], ref_bn[key], rtol=1e-6, atol=1e-6)


def test_train_step_refuses_a_clip():
    from pyannote_video_tpu_torch.parallel.sharding import make_train_step
    from pyannote_video_tpu_torch.train.optim import Adam

    with pytest.raises(ValueError, match="clip"):
        make_train_step(None, Adam([torch.zeros(2)], LR, max_norm=5.0))


def test_dryrun_multichip_prints_the_three_paths(capsys):
    from pyannote_video_tpu_torch.entry import dryrun_multichip

    dryrun_multichip(4, device="cpu")
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("dryrun[train]: mesh={'data': 2, 'model': 2} loss=")
    assert out[1] == "dryrun[fused]: frames=4x96x128 dp=2 emb=(4, 4, 128) OK"
    assert out[2] == "dryrun[scheduler]: 2 workers x 6 shots merged OK"
    assert out[3].startswith("dryrun_multichip(4): mesh={'data': 2, 'model': 2}")
    assert all(line.endswith(" OK") for line in out) and len(out) == 4
