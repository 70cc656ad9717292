"""ResNet-29 face embedder (dlib ``face_recognition_model_v1`` architecture).

Port of ``pyannote_video_tpu/models/embedder.py``: dlib's
29-conv metric-learning ResNet

    conv32 7×7/2 → maxpool 3×3/2
    → 3× res32                       (alevel4)
    → down64  + 3× res64             (alevel3)
    → down128 + 2× res128            (alevel2)
    → down256 + 2× res256            (alevel1)
    → down256                        (alevel0)
    → global avg pool → fc(128, no bias)

on 150×150 aligned face chips, producing 128-d embeddings.  The packaged
weights have the full dlib width (stem 32, fc 256 → 128); a ``width``
multiplier scales every channel count of a fresh model (``init_params``).
The convs run in cuDNN, in bfloat16 by default; the ``fc`` product is a
plain ``torch.matmul`` in float32.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .nn import (State, batch_norm, bn_init, conv, conv_init, global_avg_pool,
                 load_params, max_pool, resblock, resblock_init, state_to)
from ..utils.device import DeviceLike, resolve_device

CHIP_SIZE = 150
EMBED_DIM = 128

# (channels, n_plain_blocks) per level after the stem; each level except the
# first starts with a down-sampling block.  Matches dlib's
# alevel4..alevel0 stack (29 convs in all).
_LEVELS: List[Tuple[int, int]] = [(32, 3), (64, 3), (128, 2), (256, 2), (256, 0)]

# dlib input normalisation: (pixel - 122.782) / 256
_INPUT_MEAN = 122.782
_INPUT_SCALE = 256.0


def _ch(base: int, width: float) -> int:
    return max(8, int(round(base * width)))


def init_params(generator: torch.Generator, width: float = 1.0) -> State:
    """A fresh ResNet-29 at ``width`` (`embedder.py:62`): He-normal convs
    from ``generator``, identity batch norms, ``fc`` [in, 128] with std
    ``sqrt(1/in)``."""
    c_in = _ch(32, width)
    params: State = {"stem": conv_init(generator, 7, 7, 3, c_in),
                     "stem_bn": bn_init(c_in)}
    blocks: State = {}
    for level, (c_base, n_plain) in enumerate(_LEVELS):
        c_out = _ch(c_base, width)
        for _ in range(n_plain + (level > 0)):
            blocks[f"block{len(blocks)}"] = resblock_init(generator, c_in, c_out)
            c_in = c_out
    params["blocks"] = blocks
    fc = torch.randn((c_in, EMBED_DIM), generator=generator)
    params["fc"] = fc * float(np.sqrt(1.0 / c_in))
    return params


def _block_plan() -> List[bool]:
    """down-flag per block index, derived from _LEVELS."""
    plan: List[bool] = []
    for level, (_, n_plain) in enumerate(_LEVELS):
        if level > 0:
            plan.append(True)
        plan.extend([False] * n_plain)
    return plan


BLOCK_PLAN = _block_plan()  # [False×3, True, F×3, True, F×2, True, F×2, True]


def forward(params: State, chips: torch.Tensor,
            compute_dtype=torch.bfloat16, train: bool = False, psum=None):
    """Chips ``[B, 150, 150, 3]`` uint8/float (NHWC, as every chip function
    returns them) → embeddings ``[B, 128]`` float32; with ``train=True``
    (`embedder.py:99-146`) ``(embeddings, params with every batch norm's
    statistics moved)``; ``psum`` (``models/nn.py:batch_norm``) makes
    every batch norm use the statistics of a batch split over processes.

    ``params["fc"]`` is [in, out] and the head is ``pooled @ fc`` in
    float32.  The embedding is L2-normalised unless the weights carry
    ``normalized_head`` and it is false: dlib's own net emits unnormalised
    embeddings, and the 0.6 clustering threshold is calibrated on those, so
    weights converted from a ``.dat`` file skip the rescale; files without
    the flag were all trained with the normalised head.
    """
    x = ((chips.to(torch.float32) - _INPUT_MEAN) / _INPUT_SCALE).permute(0, 3, 1, 2)

    h = conv(params["stem"], x, stride=2, compute_dtype=compute_dtype)
    h, stem_bn = batch_norm(params["stem_bn"], h, train=train, psum=psum)
    h = max_pool(F.relu(h), 3, 2)
    blocks = {}
    for i, down in enumerate(BLOCK_PLAN):
        h, blocks[f"block{i}"] = resblock(params["blocks"][f"block{i}"], h,
                                          down=down, compute_dtype=compute_dtype,
                                          train=train, psum=psum)

    pooled = global_avg_pool(h)
    emb = torch.matmul(pooled.to(torch.float32), params["fc"])
    if params.get("normalized_head", True):
        emb = emb * torch.rsqrt((emb * emb).sum(dim=-1, keepdim=True) + 1e-12)
    if train:
        return emb, {**params, "stem_bn": stem_bn, "blocks": blocks}
    return emb


@torch.no_grad()
def embed(params: State, chips: torch.Tensor) -> torch.Tensor:
    """Inference entry point: bfloat16 convs."""
    return forward(params, chips)


class FaceEmbedder:
    """Holds the parameters on a device; mirrors
    ``dlib.face_recognition_model_v1(model_path)``, with paths that point
    at ``.npz`` parameter files.

    Without ``model_path`` and ``params`` it loads the packaged weights
    (width 1.0), whose absence raises; another ``width`` asks for a fresh
    model, drawn from a generator seeded 0, as the JAX class does.
    ``device``: ``cuda`` unless ``"cpu"`` is asked for.
    """

    def __init__(self, model_path: Optional[str] = None, width: float = 1.0,
                 params: Optional[State] = None,
                 compute_dtype=torch.bfloat16, device: DeviceLike = None):
        self.device = resolve_device(device)
        if params is None:
            if model_path is not None:
                params = load_params(model_path)
            elif width == 1.0:
                from .weights import default_embedder_params

                params = default_embedder_params()
            else:
                params = init_params(torch.Generator().manual_seed(0),
                                     width=width)
        self.params = state_to(params, self.device)
        self.compute_dtype = compute_dtype

    @torch.no_grad()
    def embed_device(self, chips: torch.Tensor) -> torch.Tensor:
        """Chips on the embedder's device → embeddings left there."""
        return forward(self.params, chips, compute_dtype=self.compute_dtype)

    def __call__(self, chips) -> np.ndarray:
        if not isinstance(chips, torch.Tensor):
            chips = torch.from_numpy(np.asarray(chips))
        return self.embed_device(chips.to(self.device)).cpu().numpy()
