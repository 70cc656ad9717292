"""Inference building blocks for the port's conv nets, and the weight loader.

Port of the inference half of ``pyannote_video_tpu/models/nn.py``.  The JAX
package keeps NHWC activations and HWIO filters; here activations are NCHW
and filters OIHW, PyTorch's own layout, and ``params_from_jax`` converts the
packaged ``.npz`` files (flat ``"layer/name"`` keys) once at load time.

A state is a nested dict of tensors: ``{"c1": {"w", "b"}, "bn1": {"scale",
"bias", "mean", "var"}, "d1": {"w", "b"}, ...}``.
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

State = Dict[str, Dict[str, torch.Tensor]]


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


def top_k(x: torch.Tensor, k: int):
    """Top-k along the last axis, ties broken by the lower index, as
    ``jax.lax.top_k`` does (``torch.topk`` promises no tie order)."""
    values, index = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], index[..., :k]


def params_from_jax(flat: Dict[str, np.ndarray]) -> State:
    """Flat JAX ``.npz`` arrays → a state of float32 CPU tensors.

    * conv filters ``*/w`` [kh, kw, in, out] (HWIO) → [out, in, kh, kw] (OIHW);
    * dense weights ``*/w`` [in, out] → [out, in] (``F.linear``'s layout);
    * the first dense layer after the convs (``d1``) reads a flattened
      feature map: the JAX package flattens NHWC, this port flattens NCHW,
      so its input rows are permuted from (h, w, c) to (c, h, w) order.
    """
    state: State = {}
    for key, value in flat.items():
        layer, name = key.split("/")
        state.setdefault(layer, {})[name] = np.asarray(value, dtype=np.float32)
    convs = sorted((k for k in state if re.fullmatch(r"c\d+", k)
                    and state[k]["w"].ndim == 4), key=lambda k: int(k[1:]))
    # channels of the last conv's output (HWIO, before any transpose)
    c = state[convs[-1]]["w"].shape[3] if convs else 0
    for layer, arrays in state.items():
        w = arrays.get("w")
        if w is None:
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
    return {layer: {name: torch.from_numpy(np.ascontiguousarray(a))
                    for name, a in arrays.items()}
            for layer, arrays in state.items()}


def load_params(path) -> State:
    """Read a JAX-package ``.npz`` parameter file into a port state."""
    with np.load(path) as data:
        return params_from_jax({k: data[k] for k in data.files})


def state_to(state, device: torch.device):
    """A copy of a (nested) state with every tensor on ``device``."""
    if isinstance(state, dict):
        return {k: state_to(v, device) for k, v in state.items()}
    return state.to(device)
