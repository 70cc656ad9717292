"""Sharded inference and training over a device mesh.

Port of ``pyannote_video_tpu/parallel/sharding.py``.  The JAX module
annotates shardings and lets XLA insert the collectives; here each
process computes its share and every collective is written out, over the
mesh's ``data`` and ``model`` groups:

* **data parallel**: the chip batch splits over ``data`` (rank ``d`` takes
  rows ``d·b … (d+1)·b − 1`` of the global batch every rank is given, as
  ``distribute_tensor`` takes it); outputs are all-gathered;
* **tensor-parallel storage**: the embedder's conv filters (OIHW, on dim 0,
  ``cout``) and its FC ([in, out], on dim 0) are stored as ``DTensor``s
  holding this rank's ``1/tp`` slice, and so are their Adam moments; the
  forward all-gathers them along ``model`` (the model group then computes
  the same thing on every rank, so a gathered leaf's gradient is its own
  slice of the full one);
* **training** keeps the global semantics XLA keeps: batch norm uses the
  statistics of the whole batch (``models/nn.py:batch_norm``'s ``psum``)
  and the metric loss runs over all pairs of the whole batch.  Rank ``d``
  sums the hinge terms of its own rows of the pair matrix, over the mask
  sums of the whole matrix; the loss is the sum of the rank shares, the
  gather of the embeddings sums its gradient back over ``data``, and the
  parameter gradients are summed over ``data``.

A group of one rank needs no collective: there every one is the identity
and the step is ``train/optim.py:train_step`` of ``loss_fn``.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..models import embedder
from ..models.nn import (State, flatten_params, hinge, trainable_leaves,
                         unflatten_params, with_leaves)
from ..ops.distance import pairwise_sqdist
from ..train.optim import Adam, local_part
from ..utils.device import resolve_device
from .mesh import mesh_shape, model_sharding


class _AllReduce(torch.autograd.Function):
    """Sum over a group.  Every rank uses the sum, so the gradient of each
    rank's input is the sum of the ranks' gradients."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _AllGather(torch.autograd.Function):
    """Concatenation of the group's tensors along ``dim``.  Backward: this
    rank's slice of the gradient, summed over the group first when the
    ranks' gradients differ (``summed``: a reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, group, dim, summed):
        ctx.group, ctx.dim, ctx.summed = group, dim, summed
        ctx.rank, ctx.size = dist.get_rank(group), x.shape[dim]
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous()
        if ctx.summed:
            grad = grad.clone()
            dist.all_reduce(grad, group=ctx.group)
        return grad.narrow(ctx.dim, ctx.rank * ctx.size, ctx.size), None, None, None


def _group(mesh, axis: str):
    """The process group of ``axis`` through this rank, or ``None`` when
    it holds this rank alone (every collective over it is the identity)."""
    return mesh.get_group(axis) if mesh_shape(mesh)[axis] > 1 else None


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable sum over ``group`` (``None``: the identity)."""
    return x if group is None else _AllReduce.apply(x, group)


def all_gather(x: torch.Tensor, group, dim: int = 0,
               summed: bool = True) -> torch.Tensor:
    """Differentiable concatenation over ``group`` along ``dim`` (``None``:
    the identity); bool tensors travel as bytes."""
    if group is None:
        return x
    if x.dtype == torch.bool:
        return _AllGather.apply(x.to(torch.uint8), group, dim, summed).to(torch.bool)
    return _AllGather.apply(x, group, dim, summed)


def _rows(mesh, n: int) -> slice:
    """This data rank's rows of an ``n``-row global batch."""
    dp = mesh_shape(mesh)["data"]
    if n % dp:
        raise ValueError(f"a batch of {n} does not split over {dp} data ranks")
    d, b = mesh.get_local_rank("data"), n // dp
    return slice(d * b, (d + 1) * b)


def _full(part: torch.Tensor, placements, mesh) -> torch.Tensor:
    """A sharded leaf's full value from this rank's ``part``, gathered
    along each mesh dim it is sharded over (differentiable: the gradient
    of ``part`` is its slice of the full one's)."""
    from torch.distributed.tensor import Shard

    for axis, placement in zip(mesh.mesh_dim_names, placements):
        if isinstance(placement, Shard):
            part = all_gather(part, _group(mesh, axis), placement.dim, summed=False)
    return part


def _sharded(params: State) -> dict:
    """The sharded leaves of ``params`` (``DTensor``s), by flat key."""
    return {k: v for k, v in flatten_params(params).items()
            if getattr(v, "placements", None) is not None}


def shard_params_for_tp(params: State, mesh) -> State:
    """Place embedder params with model-axis sharding on wide dimensions.

    Conv filters OIHW shard on dim 0 (``cout``; the JAX rule's HWIO axis 3)
    when the model-axis size divides it; the FC [in, 128] shards on dim 0
    (``in``).  Such a leaf becomes a ``DTensor`` that holds this rank's
    slice (``model_sharding(mesh, 0, ndim)``); everything else stays a plain
    tensor, replicated on every rank.  With model axis size 1 this is pure
    replication: ``params`` come back as they are.
    """
    from torch.distributed.tensor import DTensor

    tp = mesh_shape(mesh)["model"]
    if tp == 1:
        return params
    m = mesh.get_local_rank("model")

    def place(leaf):
        if (not isinstance(leaf, torch.Tensor) or leaf.ndim not in (2, 4)
                or leaf.shape[0] % tp):
            return leaf
        part = leaf.detach().chunk(tp, dim=0)[m].contiguous()
        return DTensor.from_local(part, mesh, model_sharding(mesh, 0, leaf.ndim),
                                  run_check=False)

    with torch.no_grad():
        return unflatten_params({k: place(v) for k, v in flatten_params(params).items()})


def sharded_embed_fn(mesh):
    """The data-parallel embedder forward over the mesh:
    ``run(params, chips [B, 150, 150, 3]) → [B, 128]`` on every rank.  Each
    data rank embeds its rows with the gathered params, in
    ``embedder.forward``'s default bfloat16; ``B`` must split evenly.  A
    mesh of CUDA devices needs a card."""
    resolve_device(mesh.device_type)
    group = _group(mesh, "data")

    @torch.no_grad()
    def run(params: State, chips: torch.Tensor) -> torch.Tensor:
        full = with_leaves(params, {k: _full(local_part(v), v.placements, mesh)
                                    for k, v in _sharded(params).items()})
        emb = embedder.forward(full, chips[_rows(mesh, len(chips))])
        return all_gather(emb, group)

    return run


def metric_loss(emb: torch.Tensor, labels: torch.Tensor, threshold: float = 0.6,
                margin: float = 0.04, rows: slice = None) -> torch.Tensor:
    """The sharded trainer's own loss (JAX `sharding.py:80-98`): hinges at
    ``threshold ∓ margin`` on the distances of same- and different-label
    pairs of ``emb`` [B, 128], each normalised by its mask's sum over the
    whole [B, B] matrix.  ``rows``: the rows of the pair matrix whose terms
    are summed (all by default), so that the shares of disjoint rows add up
    to the loss."""
    d = torch.sqrt(pairwise_sqdist(emb, emb) + 1e-9)
    same = (labels[:, None] == labels[None, :]).to(torch.float32)
    eye = torch.eye(labels.shape[0], dtype=torch.float32, device=d.device)
    same_mask = same * (1.0 - eye)
    diff_mask = 1.0 - same
    n_same = torch.sum(same_mask).clamp_min(1.0)
    n_diff = torch.sum(diff_mask).clamp_min(1.0)
    if rows is not None:
        d, same_mask, diff_mask = d[rows], same_mask[rows], diff_mask[rows]
    same_loss = hinge(d - (threshold - margin)) * same_mask
    diff_loss = hinge((threshold + margin) - d) * diff_mask
    return torch.sum(same_loss) / n_same + torch.sum(diff_loss) / n_diff


def loss_fn(params: State, chips: torch.Tensor, labels: torch.Tensor,
            threshold: float = 0.6, margin: float = 0.04):
    """``(metric_loss, params with the statistics moved)`` of the whole
    batch on one process, float32: what the sharded step computes, as a
    ``train/optim.py:train_step`` loss."""
    emb, params_new = embedder.forward(params, chips, train=True,
                                       compute_dtype=torch.float32)
    return metric_loss(emb, labels, threshold, margin), params_new


def make_train_step(mesh, opt: Adam, threshold: float = 0.6,
                    margin: float = 0.04):
    """Sharded metric-learning train step (dp over batch, tp over params).

    Returns ``step(params, chips, labels) → (params, loss)``, the form of
    ``train/optim.py:train_step``: ``params`` is the state whose leaves
    ``opt`` holds (``optim.adam`` of ``shard_params_for_tp``'s state),
    ``chips`` [B, 150, 150, 3] and ``labels`` [B] the global batch, the same
    on every rank.  The loss is the whole batch's, the same on every rank,
    left on the device; nothing is read on the host.

    ``opt`` must not clip: a global-norm clip over sharded leaves would see
    this rank's slices only.
    """
    if opt.max_norm is not None:
        raise ValueError("the sharded step does not clip: Adam(max_norm=...) "
                         "would take the norm of this rank's slices only")
    resolve_device(mesh.device_type)
    data = _group(mesh, "data")
    batch_psum = None if data is None else lambda x: psum(x, data)

    def step(params: State, chips: torch.Tensor, labels: torch.Tensor):
        rows = _rows(mesh, len(labels))
        leaves = trainable_leaves(params)
        local = {k: local_part(v) for k, v in leaves.items()}
        if any(a is not b for a, b in zip(local.values(), opt.param_groups[0]["params"])):
            raise ValueError("the step takes the state whose leaves its "
                             "optimiser holds (see train/optim.py:adam)")
        grad_of = {k: v.detach().requires_grad_(True) for k, v in local.items()}
        full = {k: _full(v, getattr(leaves[k], "placements", ()), mesh)
                for k, v in grad_of.items()}
        emb, params_bn = embedder.forward(
            with_leaves(params, full), chips[rows], train=True,
            compute_dtype=torch.float32, psum=batch_psum)
        loss = metric_loss(all_gather(emb, data), labels, threshold, margin,
                           rows=None if data is None else rows)
        grads = [g.contiguous() for g in
                 torch.autograd.grad(loss, list(grad_of.values()))]
        if data is not None:
            for g in grads:
                dist.all_reduce(g, group=data)
        opt.step(grads)
        return with_leaves(params_bn, leaves), psum(loss.detach(), data)

    return step
