"""The trainers' optimiser: what ``optax`` gives the JAX package's trainers.

* ``cosine_decay_schedule(lr, steps, alpha)`` — ``optax.cosine_decay_schedule``
  (`train_detector.py:138`, `train_refiner.py:450`): the rate of update
  ``count`` (the first update at count 0) is
  ``lr · ((1 − alpha) · ½(1 + cos(π · min(count, steps) / steps)) + alpha)``;
* ``Adam`` — ``optax.adam`` with its defaults (b1 0.9, b2 0.999, eps 1e-8, no
  eps_root) on ``torch.optim.Adam``, optionally behind
  ``optax.clip_by_global_norm(max_norm)`` (`train_embedder.py:123`), whose
  rule is exact: the gradients are scaled by ``max_norm / norm`` only when
  ``norm ≥ max_norm`` (``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to the
  norm and scales always, another rule).

The optimiser updates the leaves that ``models/nn.py:trainable_leaves``
names.  optax also carries moments for the batch norms' recorded
statistics, whose gradient is zero and whose update is therefore zero; the
port leaves them out.  Nothing here reads a device value on the host: the
clip's test is a device tensor and the step count is the host's own.
"""

from __future__ import annotations

import math
from typing import Callable, List, Sequence, Tuple, Union

import numpy as np
import torch

from ..models.nn import State, trainable_leaves, with_leaves

Schedule = Callable[[int], float]


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0) -> Schedule:
    """The learning rate of update ``count`` (0 for the first), in float32.

    optax's expression is evaluated by XLA, which folds its constants, fuses
    it and takes another cosine; the rates agree exactly at count 0 and
    from ``decay_steps`` on, and within 1e-6 relative (a few float32 ulps)
    between (``tests/test_torch_train_nn.py``).
    """
    if not decay_steps > 0:
        raise ValueError(f"decay_steps must be positive, got {decay_steps}")
    f32 = np.float32

    def schedule(count: int) -> float:
        c = f32(min(count, decay_steps))
        cosine = f32(0.5) * (f32(1.0) + f32(math.cos(
            f32(math.pi) * c / f32(decay_steps))))
        return float(f32(init_value) * ((f32(1.0) - f32(alpha)) * cosine
                                        + f32(alpha)))

    return schedule


def clip_by_global_norm(grads: Sequence[torch.Tensor],
                        max_norm: float) -> List[torch.Tensor]:
    """optax's rule: unchanged while the global norm is under ``max_norm``,
    else each gradient times ``max_norm / norm`` (as ``(g / norm) ·
    max_norm``).  The test stays on the device."""
    norm = torch.sqrt(torch.stack([torch.sum(g * g) for g in grads]).sum())
    keep = norm < max_norm
    return [torch.where(keep, g, g / norm * max_norm) for g in grads]


class Adam(torch.optim.Adam):
    """``optax.chain(clip_by_global_norm(max_norm), adam(learning_rate))``
    on the fused ``torch.optim.Adam``, with optax's defaults (b1 0.9, b2
    0.999, eps 1e-8).  The two orders of operations differ by rounding only
    (``tests/test_torch_train_nn.py`` holds three steps to optax's within
    1e-6).

    ``step(grads)`` updates the leaves in place and advances the count;
    ``learning_rate`` is a float or a schedule of the count.
    """

    def __init__(self, leaves: Sequence[torch.Tensor],
                 learning_rate: Union[float, Schedule],
                 max_norm: float = None):
        self.learning_rate = learning_rate
        self.max_norm = max_norm
        self.count = 0
        super().__init__(list(leaves), lr=self.rate(0), eps=1e-8, fused=True)

    def rate(self, count: int) -> float:
        lr = self.learning_rate
        return lr(count) if callable(lr) else lr

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        grads = list(grads)
        if self.max_norm is not None:
            grads = clip_by_global_norm(grads, self.max_norm)
        group = self.param_groups[0]
        # the fused kernel pairs a leaf with its gradient in memory order,
        # and a convolution's weight gradient can come back channels-last
        for leaf, g in zip(group["params"], grads):
            leaf.grad = g.contiguous()
        group["lr"] = self.rate(self.count)
        super().step()
        self.zero_grad()        # no gradient is held between steps
        self.count += 1


def local_part(leaf: torch.Tensor) -> torch.Tensor:
    """The tensor that holds a leaf's values on this process: a sharded
    leaf's own slice (a ``DTensor`` of ``parallel/sharding.py``), else the
    leaf itself.  The same object on every call, so an optimiser that
    updates it in place updates the leaf."""
    to_local = getattr(leaf, "to_local", None)
    if to_local is None:
        return leaf
    with torch.no_grad():
        return to_local()


def adam(params: State, learning_rate: Union[float, Schedule],
         max_norm: float = None) -> Tuple[State, Adam]:
    """A copy of ``params`` and the ``Adam`` that trains its leaves in place
    (the caller's ``params`` is never changed).  Of a sharded leaf the
    optimiser holds this process's slice, and its moments are that size."""
    leaves = {k: v.detach().clone(memory_format=torch.contiguous_format)
              for k, v in trainable_leaves(params).items()}
    return (with_leaves(params, leaves),
            Adam([local_part(v) for v in leaves.values()], learning_rate,
                 max_norm=max_norm))


def train_step(loss_fn, params: State, opt: Adam, *batch):
    """One optimiser step of a trainer: ``loss_fn(params, *batch)`` returns
    ``(loss, params with the batch norms' statistics moved)``; the gradient
    of the loss with respect to ``trainable_leaves(params)`` goes through
    ``opt``, which updates those leaves in place: they must be its own (the
    state ``adam`` returned, or the last step's).  Returns ``(new params,
    loss)`` with the loss left on the device: nothing here reads a device
    value on the host.
    """
    leaves = trainable_leaves(params)
    if any(a is not b for a, b in zip(leaves.values(), opt.param_groups[0]["params"])):
        raise ValueError("train_step takes the state whose leaves its "
                         "optimiser holds (see adam)")
    grad_of = {k: v.detach().requires_grad_(True) for k, v in leaves.items()}
    loss, params_bn = loss_fn(with_leaves(params, grad_of), *batch)
    opt.step(torch.autograd.grad(loss, list(grad_of.values())))
    return with_leaves(params_bn, leaves), loss.detach()
