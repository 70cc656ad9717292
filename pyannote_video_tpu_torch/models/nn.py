"""Building blocks of the port's conv nets, their initialisers, and the
weight reader and writer.

Port of ``pyannote_video_tpu/models/nn.py``.  The JAX package keeps NHWC
activations and HWIO filters; here activations are NCHW and filters OIHW,
PyTorch's own layout.  ``params_from_jax`` converts the packaged ``.npz``
files (flat ``"a/b/name"`` keys) once at load time and ``params_to_jax``
converts back, so a file the port saves is one the JAX package reads.

A state is a nested dict of tensors: ``{"c1": {"w", "b"}, "bn1": {"scale",
"bias", "mean", "var"}, "d1": {"w", "b"}, ...}`` for the detector and the
refiner, ``{"stem": {...}, "stem_bn": {...}, "blocks": {"block0": {"conv1":
{...}, "bn1": {...}, ...}}, "fc": tensor}`` for the embedder.

Training (``train=True``): batch norm normalises with the batch's own mean
and biased variance, gradients flow through both, and the recorded
statistics move as ``0.99·old + 0.01·batch``, as in the JAX package.  The
recorded ``mean`` and ``var`` are buffers, not trained leaves
(``trainable_leaves``); the ``*_init`` functions draw from an explicit
``torch.Generator``.
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

State = Dict[str, object]


def conv_init(generator: torch.Generator, k_h: int, k_w: int, c_in: int,
              c_out: int) -> Dict[str, torch.Tensor]:
    """He-normal conv filter (OIHW) + zero bias (`nn.py:29`)."""
    w = torch.randn((c_out, c_in, k_h, k_w), generator=generator)
    return {"w": w * float(np.sqrt(2.0 / (k_h * k_w * c_in))),
            "b": torch.zeros(c_out)}


def dense_init(generator: torch.Generator, c_in: int, c_out: int) -> torch.Tensor:
    """He-normal ``[out, in]`` weights (``F.linear``'s layout)."""
    w = torch.randn((c_out, c_in), generator=generator)
    return w * float(np.sqrt(2.0 / c_in))


def bn_init(c: int) -> Dict[str, torch.Tensor]:
    """Identity batch norm (`nn.py:57`)."""
    return {"scale": torch.ones(c), "bias": torch.zeros(c),
            "mean": torch.zeros(c), "var": torch.ones(c)}


def conv(params: Dict[str, torch.Tensor], x: torch.Tensor, stride: int = 1,
         dlib_padding: bool = True, compute_dtype=torch.float32) -> torch.Tensor:
    """2-D convolution, NCHW × OIHW → NCHW, returned in float32 with the
    bias added in float32.

    Padding follows the JAX package (`nn.py:43-46`): VALID for dlib-style
    strided convs, else ``(k//2, (k-1)//2)`` on each axis.  In bfloat16 the
    JAX conv accumulates into float32 (``preferred_element_type``); a
    PyTorch bfloat16 conv rounds its output to bfloat16 before the cast,
    so the two differ by bfloat16 rounding there.
    """
    w = params["w"].to(compute_dtype)
    x = x.to(compute_dtype)
    k_h, k_w = w.shape[2], w.shape[3]
    if not (dlib_padding and stride > 1):
        x = F.pad(x, (k_w // 2, (k_w - 1) // 2, k_h // 2, (k_h - 1) // 2))
    out = F.conv2d(x, w, stride=stride)
    return out.to(torch.float32) + params["b"].to(torch.float32)[:, None, None]


def batch_norm(params: Dict[str, torch.Tensor], x: torch.Tensor,
               train: bool = False, eps: float = 1e-5, psum=None):
    """Batch norm over NCHW channels (`nn.py:66-86`); returns ``(output,
    params)``, as the JAX function does.

    Inference is dlib's ``affine`` layer, a frozen scale+shift from the
    recorded statistics, and returns ``params`` as they are.
    ``train=True`` normalises with the batch's mean and biased variance and
    returns the params with the statistics moved; the moved statistics
    carry no gradient.

    ``psum``: a differentiable sum over the processes that hold the other
    parts of the batch (``parallel/sharding.py``), or ``None`` for a batch
    that is all here.  With it, the mean is the summed sum over the summed
    count and the variance the summed squared deviations over the same
    count: the statistics of the whole batch, as XLA computes them for a
    batch sharded over devices.
    """
    if train:
        if psum is None:
            mean = x.mean(dim=(0, 2, 3))
            var = ((x - mean[:, None, None]) ** 2).mean(dim=(0, 2, 3))
        else:
            count = x.new_full((1,), float(x.numel() // x.shape[1]))
            total = psum(torch.cat([x.sum(dim=(0, 2, 3)), count]))
            mean = total[:-1] / total[-1]
            var = psum(((x - mean[:, None, None]) ** 2).sum(dim=(0, 2, 3))) / total[-1]
        momentum = 0.99
        new_params = {
            **params,
            "mean": (momentum * params["mean"] + (1 - momentum) * mean).detach(),
            "var": (momentum * params["var"] + (1 - momentum) * var).detach(),
        }
    else:
        mean, var = params["mean"], params["var"]
        new_params = params
    inv = torch.rsqrt(var + eps) * params["scale"]
    y = (x - mean[:, None, None]) * inv[:, None, None] + params["bias"][:, None, None]
    return y, new_params


def max_pool(x: torch.Tensor, window: int, stride: int) -> torch.Tensor:
    """VALID max pooling over NCHW (`nn.py:89-97` with dlib padding)."""
    return F.max_pool2d(x, window, stride)


def avg_pool(x: torch.Tensor, window: int, stride: int) -> torch.Tensor:
    """VALID average pooling over NCHW (`nn.py:100-107`)."""
    return F.avg_pool2d(x, window, stride)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """[B, C, H, W] → [B, C]."""
    return x.mean(dim=(2, 3))


def resblock_init(generator: torch.Generator, c_in: int, c_out: int):
    """Two 3×3 convs and their batch norms (`nn.py:117`)."""
    return {"conv1": conv_init(generator, 3, 3, c_in, c_out),
            "bn1": bn_init(c_out),
            "conv2": conv_init(generator, 3, 3, c_out, c_out),
            "bn2": bn_init(c_out)}


def resblock(params, x: torch.Tensor, down: bool = False,
             compute_dtype=torch.float32, train: bool = False, psum=None):
    """dlib-style residual block (`nn.py:127-156`).

    down=False: y = relu(x + bn2(conv2(relu(bn1(conv1(x))))))
    down=True : VALID stride-2 conv1; skip = 2×2 stride-2 average pool of
                x, cropped to the conv output's height and width (the
                VALID conv can be one pixel smaller than the pooled skip)
                and zero-padded on channels (dlib ``residual_down``).

    Returns ``(output, params)``, with both batch norms' statistics moved
    when ``train=True`` and unchanged otherwise; ``psum`` as in
    ``batch_norm``.
    """
    h = conv(params["conv1"], x, stride=2 if down else 1,
             compute_dtype=compute_dtype)
    h, bn1 = batch_norm(params["bn1"], h, train=train, psum=psum)
    h = conv(params["conv2"], F.relu(h), stride=1, compute_dtype=compute_dtype)
    h, bn2 = batch_norm(params["bn2"], h, train=train, psum=psum)
    if down:
        skip = avg_pool(x, 2, 2)[:, :, : h.shape[2], : h.shape[3]]
        c_extra = h.shape[1] - skip.shape[1]
        if c_extra > 0:
            skip = F.pad(skip, (0, 0, 0, 0, 0, c_extra))
    else:
        skip = x
    out = F.relu(h + skip)
    return out, {**params, "bn1": bn1, "bn2": bn2}


def hinge(x: torch.Tensor) -> torch.Tensor:
    """``max(x, 0)`` with the JAX package's gradient at a tie
    (``jnp.maximum(x, 0.0)`` gives half to each side at ``x == 0``;
    ``relu`` and ``clamp`` give 0 or 1)."""
    return torch.maximum(x, x.new_zeros(()))


def sigmoid_binary_cross_entropy(logits: torch.Tensor,
                                 labels: torch.Tensor) -> torch.Tensor:
    """Element-wise BCE on logits, optax's formula:
    ``−labels·log σ(x) − (1 − labels)·log σ(−x)``."""
    labels = labels.to(logits.dtype)
    return -labels * F.logsigmoid(logits) - (1.0 - labels) * F.logsigmoid(-logits)


def top_k(x: torch.Tensor, k: int):
    """Top-k along the last axis, ties broken by the lower index, as
    ``jax.lax.top_k`` does (``torch.topk`` promises no tie order)."""
    values, index = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], index[..., :k]


def _to_port_layout(node: dict, top: bool) -> dict:
    """One level of a nested numpy state, converted in place (see
    ``params_from_jax``)."""
    convs = sorted((k for k, v in node.items() if re.fullmatch(r"c\d+", k)
                    and isinstance(v, dict) and v["w"].ndim == 4),
                   key=lambda k: int(k[1:])) if top else []
    # channels of the last conv's output (HWIO, before any transpose)
    c = node[convs[-1]]["w"].shape[3] if convs else 0
    for layer, arrays in node.items():
        if not isinstance(arrays, dict):
            continue
        w = arrays.get("w")
        if isinstance(w, dict) or w is None:
            _to_port_layout(arrays, top=False)
            continue
        if w.ndim == 4:
            arrays["w"] = w.transpose(3, 2, 0, 1)
        elif w.ndim == 2:
            if layer == "d1" and convs:
                side = int(round(np.sqrt(w.shape[0] // c)))
                if side * side * c != w.shape[0]:
                    raise ValueError(f"d1/w rows {w.shape[0]} are not a "
                                     f"square map of {c} channels")
                w = (w.reshape(side, side, c, -1).transpose(2, 0, 1, 3)
                     .reshape(w.shape[0], -1))
            arrays["w"] = w.T
    return node


def _to_tensors(node):
    if isinstance(node, dict):
        return {k: _to_tensors(v) for k, v in node.items()}
    if isinstance(node, np.ndarray):
        return torch.from_numpy(np.array(node, order="C"))
    return node


def flatten_params(params, prefix: str = "") -> Dict[str, object]:
    """A nested parameter set → flat ``"a/b/name"`` keys (`nn.py:162`; a
    flat one passes through)."""
    flat: Dict[str, object] = {}
    for key, value in params.items():
        name = f"{prefix}/{key}" if prefix else key
        if isinstance(value, dict):
            flat.update(flatten_params(value, name))
        else:
            flat[name] = value
    return flat


def unflatten_params(flat: Dict[str, object]) -> dict:
    """Flat ``"a/b/name"`` keys → a nested dict of the same values
    (`nn.py:173`)."""
    nested: dict = {}
    for key, value in flat.items():
        *parents, name = key.split("/")
        node = nested
        for parent in parents:
            node = node.setdefault(parent, {})
        node[name] = value
    return nested


def params_from_jax(params: Dict[str, object]) -> State:
    """JAX parameters → a nested state of float32 CPU tensors.

    ``params`` is flat (an ``.npz`` file's ``"a/b/name"`` arrays) or nested
    (a JAX parameter set, arrays of any array type).  A detector's serving
    set (``FusedFacePipeline().detector_params`` of the JAX package) is
    taken as it is: its ``c1_s2d`` stem is derived from ``c1`` and dropped
    (this port serves the canonical stem), and its ``refiner`` is
    converted as the top-level state it was loaded from.

    Keys nest at every ``/`` (``blocks/block0/conv1/w`` →
    ``state["blocks"]["block0"]["conv1"]["w"]``); a key without one is a
    top-level array.  In a layer (a dict that holds ``w``) at any depth:

    * conv filters ``w`` [kh, kw, in, out] (HWIO) → [out, in, kh, kw] (OIHW);
    * dense weights ``w`` [in, out] → [out, in] (``F.linear``'s layout);
    * the first dense layer after the convs (top-level ``d1`` beside
      top-level ``c1..``) reads a flattened feature map: the JAX package
      flattens NHWC, this port flattens NCHW, so its input rows are
      permuted from (h, w, c) to (c, h, w) order.

    Top-level arrays keep their layout: the embedder's ``fc`` stays
    [in, out] and its forward computes ``pooled @ fc``.  The embedder's
    optional ``normalized_head`` scalar becomes a Python bool.
    ``params_to_jax`` inverts this.
    """
    flat = flatten_params(params)
    refiner = {k[len("refiner/"):]: v for k, v in flat.items()
               if k.startswith("refiner/")}
    state = unflatten_params({
        key: (bool(np.asarray(value)) if key == "normalized_head"
              else np.asarray(value, dtype=np.float32))
        for key, value in flat.items()
        if not key.startswith(("c1_s2d/", "refiner/"))})
    state = _to_tensors(_to_port_layout(state, top=True))
    if refiner:
        state["refiner"] = params_from_jax(refiner)
    return state


def _to_jax_layout(node: dict, top: bool) -> dict:
    """One level of a nested numpy state in the port's layout, converted in
    place to the JAX package's (the inverse of ``_to_port_layout``)."""
    convs = sorted((k for k, v in node.items() if re.fullmatch(r"c\d+", k)
                    and isinstance(v, dict) and v["w"].ndim == 4),
                   key=lambda k: int(k[1:])) if top else []
    # channels of the last conv's output (OIHW)
    c = node[convs[-1]]["w"].shape[0] if convs else 0
    for layer, arrays in node.items():
        if not isinstance(arrays, dict):
            continue
        w = arrays.get("w")
        if isinstance(w, dict) or w is None:
            _to_jax_layout(arrays, top=False)
            continue
        if w.ndim == 4:
            arrays["w"] = w.transpose(2, 3, 1, 0)
        elif w.ndim == 2:
            w = w.T
            if layer == "d1" and convs:
                side = int(round(np.sqrt(w.shape[0] // c)))
                w = (w.reshape(c, side, side, -1).transpose(1, 2, 0, 3)
                     .reshape(w.shape[0], -1))
            arrays["w"] = np.ascontiguousarray(w)
    return node


def params_to_jax(state: State) -> dict:
    """A port state → the nested numpy parameter set of the JAX package,
    in its layout (HWIO filters, [in, out] dense weights, ``d1``'s rows in
    (h, w, c) order), the inverse of ``params_from_jax``.

    The arrays are float32 copies on the host; ``normalized_head`` becomes
    the float32 scalar the JAX files hold.  A nested ``refiner`` is a state
    of its own and is refused here: it is saved to its own file
    (``save_params``).
    """
    if "refiner" in state:
        raise ValueError("the refiner is a state of its own: convert "
                         "state['refiner'] apart from the stage-1 state")
    flat = {key: (np.asarray(1.0 if value else 0.0, np.float32)
                  if key == "normalized_head"
                  else value.detach().to("cpu", torch.float32).numpy().copy())
            for key, value in flatten_params(state).items()}
    return _to_jax_layout(unflatten_params(flat), top=True)


def save_params(path, state: State, refiner_path=None) -> None:
    """Write a port state as a JAX-package ``.npz`` file (`nn.py:184`):
    flat ``"a/b/name"`` keys in the JAX layout, which
    ``pyannote_video_tpu.models.nn.load_params`` reads back.

    A serving state's nested ``refiner`` is written to ``refiner_path``,
    its own file, never into the stage-1 file; a state that holds one
    without a ``refiner_path`` raises.
    """
    if "refiner" in state:
        if refiner_path is None:
            raise ValueError("this state holds a refiner: give refiner_path "
                             "for its own file")
        save_params(refiner_path, state["refiner"])
        state = {k: v for k, v in state.items() if k != "refiner"}
    np.savez_compressed(path, **flatten_params(params_to_jax(state)))


def trainable_leaves(state: State) -> Dict[str, torch.Tensor]:
    """The leaves a trainer updates, by flat key in sorted order: every
    tensor but the batch norms' recorded ``mean`` and ``var`` (buffers that
    training moves by their own rule) and flags."""
    return {key: value for key, value in sorted(flatten_params(state).items())
            if isinstance(value, torch.Tensor)
            and key.rsplit("/", 1)[-1] not in ("mean", "var")}


def with_leaves(state: State, leaves: Dict[str, torch.Tensor]) -> State:
    """``state`` with the leaves named by flat key replaced."""
    return unflatten_params({**flatten_params(state), **leaves})


def load_params(path) -> State:
    """Read a JAX-package ``.npz`` parameter file into a port state."""
    with np.load(path) as data:
        return params_from_jax({k: data[k] for k in data.files})


def state_to(state, device: torch.device):
    """A copy of a (nested) state with every tensor on ``device``; entries
    that are not tensors (flags, counts) are kept."""
    if isinstance(state, dict):
        return {k: state_to(v, device) for k, v in state.items()}
    return state.to(device) if isinstance(state, torch.Tensor) else state
