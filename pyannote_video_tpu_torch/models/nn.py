"""Inference building blocks for the port's conv nets, and the weight loader.

Port of the inference half of ``pyannote_video_tpu/models/nn.py``.  The JAX
package keeps NHWC activations and HWIO filters; here activations are NCHW
and filters OIHW, PyTorch's own layout, and ``params_from_jax`` converts the
packaged ``.npz`` files (flat ``"a/b/name"`` keys) once at load time.

A state is a nested dict of tensors: ``{"c1": {"w", "b"}, "bn1": {"scale",
"bias", "mean", "var"}, "d1": {"w", "b"}, ...}`` for the detector and the
refiner, ``{"stem": {...}, "stem_bn": {...}, "blocks": {"block0": {"conv1":
{...}, "bn1": {...}, ...}}, "fc": tensor}`` for the embedder.  Training
(``train=True``, the ``*_init`` functions) is not ported.
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

State = Dict[str, object]


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
               eps: float = 1e-5) -> torch.Tensor:
    """Inference batch norm over NCHW channels (`nn.py:66-86`): dlib's
    ``affine`` layer, a frozen scale+shift from the recorded statistics."""
    inv = torch.rsqrt(params["var"] + eps) * params["scale"]
    return ((x - params["mean"][:, None, None]) * inv[:, None, None]
            + params["bias"][:, None, None])


def max_pool(x: torch.Tensor, window: int, stride: int) -> torch.Tensor:
    """VALID max pooling over NCHW (`nn.py:89-97` with dlib padding)."""
    return F.max_pool2d(x, window, stride)


def avg_pool(x: torch.Tensor, window: int, stride: int) -> torch.Tensor:
    """VALID average pooling over NCHW (`nn.py:100-107`)."""
    return F.avg_pool2d(x, window, stride)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """[B, C, H, W] → [B, C]."""
    return x.mean(dim=(2, 3))


def resblock(params, x: torch.Tensor, down: bool = False,
             compute_dtype=torch.float32) -> torch.Tensor:
    """dlib-style residual block, inference only (`nn.py:127-156`).

    down=False: y = relu(x + bn2(conv2(relu(bn1(conv1(x))))))
    down=True : VALID stride-2 conv1; skip = 2×2 stride-2 average pool of
                x, cropped to the conv output's height and width (the
                VALID conv can be one pixel smaller than the pooled skip)
                and zero-padded on channels (dlib ``residual_down``).
    """
    h = conv(params["conv1"], x, stride=2 if down else 1,
             compute_dtype=compute_dtype)
    h = F.relu(batch_norm(params["bn1"], h))
    h = conv(params["conv2"], h, stride=1, compute_dtype=compute_dtype)
    h = batch_norm(params["bn2"], h)
    if down:
        skip = avg_pool(x, 2, 2)[:, :, : h.shape[2], : h.shape[3]]
        c_extra = h.shape[1] - skip.shape[1]
        if c_extra > 0:
            skip = F.pad(skip, (0, 0, 0, 0, 0, c_extra))
    else:
        skip = x
    return F.relu(h + skip)


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


def _flatten(params, prefix: str = "") -> Dict[str, object]:
    """A nested JAX parameter set → flat ``"a/b/name"`` keys (a flat one
    passes through)."""
    flat: Dict[str, object] = {}
    for key, value in params.items():
        name = f"{prefix}/{key}" if prefix else key
        if isinstance(value, dict):
            flat.update(_flatten(value, name))
        else:
            flat[name] = value
    return flat


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
    """
    flat = _flatten(params)
    refiner = {k[len("refiner/"):]: v for k, v in flat.items()
               if k.startswith("refiner/")}
    state: dict = {}
    for key, value in flat.items():
        if key.startswith(("c1_s2d/", "refiner/")):
            continue
        *parents, name = key.split("/")
        node = state
        for parent in parents:
            node = node.setdefault(parent, {})
        if not parents and name == "normalized_head":
            node[name] = bool(np.asarray(value))
        else:
            node[name] = np.asarray(value, dtype=np.float32)
    state = _to_tensors(_to_port_layout(state, top=True))
    if refiner:
        state["refiner"] = params_from_jax(refiner)
    return state


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
