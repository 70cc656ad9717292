"""CNN face detector: multi-scale FCN over an image pyramid, batched.

Port of ``pyannote_video_tpu/models/detector.py``.  dlib's MMOD
face-net channel plan (16/32/32/45, a stride-8 downsampler of 3× conv5×5/2,
3× conv5×5/1 and a 9×9 head of 1 score + 4 box deltas) slid over a chained
3/4-ratio image pyramid; per level a device top-K picks candidate cells and
decodes boxes in original-image coordinates, so only ``[B, K, 4]``
candidates reach the host, where threshold and NMS run.  The stage-2
refiner (``models/refiner.py``) re-scores the top candidates when loaded.
``init_params`` and ``forward_maps(train=True)`` are the trainer's
(``train/train_detector.py``).

Public functions keep the JAX package's NHWC layout at their edges
(images ``[B, H, W, 3]``, maps ``[B, h/8, w/8, 5]``) and run NCHW inside.

The JAX package serves the stem as a space-to-depth 3×3 conv over 12
channels (`detector.py:104-175`), a TPU matrix-unit tiling trick that is
exact by construction; this port serves the canonical 5×5 stride-2 stem,
which computes the same function.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .nn import (State, batch_norm, bn_init, conv, conv_init, load_params,
                 state_to, top_k)
from ..ops.boxes import nms
from ..ops.color import resize_bilinear
from ..utils.device import DeviceLike, resolve_device

WINDOW = 40          # base detection window (px) — MMOD face window size
# smallest face (px) the detector can see: what ``detect_smallest`` of the
# tracking stage and the ``Face`` facade mean (dlib HOG used 36)
SMALLEST_FACE = WINDOW
STRIDE = 8           # total downsampling of the FCN
PYRAMID_RATIO = 0.75
TOPK = 16            # candidates per level per frame
# operating threshold on the REFINED cascade score (`models/refiner.py`)
DEFAULT_THRESHOLD = 4.0
# threshold for the pyramid logits when NO refiner is loaded
# (PYV_NO_REFINE=1 or missing weights)
STAGE1_THRESHOLD = 4.5


def init_params(generator: torch.Generator, deep_width: int = 45) -> State:
    """A fresh detector (`detector.py:65`): dlib's MMOD channel plan
    (16/32/32/45) with the stride-8 tail c4-c6 and the head at
    ``deep_width`` channels (the trainer's default is 96); He-normal
    filters drawn from ``generator``, zero biases, identity batch norms."""
    dw = deep_width
    plan = [(3, 16), (16, 32), (32, 32), (32, dw), (dw, dw), (dw, dw)]
    params: State = {}
    for i, (c_in, c_out) in enumerate(plan, start=1):
        params[f"c{i}"] = conv_init(generator, 5, 5, c_in, c_out)
        params[f"bn{i}"] = bn_init(c_out)
    # head: 1 score + 4 box deltas (dx, dy, log dw, log dh)
    params["head"] = conv_init(generator, 9, 9, dw, 5)
    return params


def forward_maps(params: State, images: torch.Tensor,
                 compute_dtype=torch.bfloat16, train: bool = False):
    """FCN forward: images [B, h, w, 3] float → maps [B, h/8, w/8, 5] float32.

    ``train=True`` (`detector.py:178-211`) normalises with batch
    statistics and returns ``(maps, params with the statistics moved)``.
    """
    # normalize in the compute dtype, as the JAX package does
    x = (images.to(compute_dtype) / 256.0 - 0.5).permute(0, 3, 1, 2)
    new: State = {}
    for i, stride in zip(range(1, 7), (2, 2, 2, 1, 1, 1)):
        x = conv(params[f"c{i}"], x, stride=stride, dlib_padding=False,
                 compute_dtype=compute_dtype)
        x, new[f"bn{i}"] = batch_norm(params[f"bn{i}"], x, train=train)
        x = F.relu(x)
    maps = conv(params["head"], x, stride=1, dlib_padding=False,
                compute_dtype=compute_dtype).permute(0, 2, 3, 1)
    return (maps, {**params, **new}) if train else maps


def pyramid_scales(height: int, width: int, upsample: int = 0,
                   min_dim: float = WINDOW + 8) -> List[float]:
    """Pyramid level scales (original → level), largest first.

    ``upsample`` adds 2× levels above the original resolution so faces
    smaller than the 40 px window become detectable.
    """
    scales = [2.0 ** u for u in range(upsample, 0, -1)]
    s = 1.0
    while min(height, width) * s >= min_dim:
        scales.append(s)
        s *= PYRAMID_RATIO
    if not scales:
        scales = [1.0]
    return scales


def level_dims(height: int, width: int, upsample: int = 0):
    """[(level_h, level_w, scale)] of the pyramid for height×width frames
    (``int(round(...))`` is Python's banker's rounding, as in JAX)."""
    return [
        (max(STRIDE * 2, int(round(height * s))),
         max(STRIDE * 2, int(round(width * s))), s)
        for s in pyramid_scales(height, width, upsample=upsample)
    ]


def _decode_level(params: State, imgs: torch.Tensor, scale: float,
                  compute_dtype=torch.bfloat16):
    """FCN + device top-K decode for ONE already-resized pyramid level.

    Returns (scores [B, K], boxes [B, K, 4]) in ORIGINAL image coordinates.
    """
    maps = forward_maps(params, imgs, compute_dtype=compute_dtype)
    B, mh, mw, _ = maps.shape
    logits = maps[..., 0].reshape(B, mh * mw)
    k = min(TOPK, mh * mw)
    top_scores, top_idx = top_k(logits, k)

    rows = torch.div(top_idx, mw, rounding_mode="floor").to(torch.float32)
    cols = (top_idx % mw).to(torch.float32)
    deltas = maps[..., 1:].reshape(B, mh * mw, 4)
    d = torch.gather(deltas, 1, top_idx[..., None].expand(B, k, 4))

    # cell center in level coords, regressed window, mapped back to original
    cx = (cols + 0.5) * STRIDE + d[..., 0] * WINDOW
    cy = (rows + 0.5) * STRIDE + d[..., 1] * WINDOW
    w = WINDOW * torch.exp(d[..., 2].clamp(-1.5, 1.5))
    h = WINDOW * torch.exp(d[..., 3].clamp(-1.5, 1.5))
    inv = 1.0 / scale
    boxes = torch.stack(
        [(cx - w / 2) * inv, (cy - h / 2) * inv,
         (cx + w / 2) * inv, (cy + h / 2) * inv],
        dim=-1,
    )
    return top_scores, boxes


def pyramid_candidates(params: State, frames: torch.Tensor, level_dims,
                       compute_dtype=torch.bfloat16
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """All pyramid levels with CHAINED downsampling — dlib's
    ``pyramid_down`` semantics (each level resamples the previous one), in
    the compute dtype.

    ``level_dims``: [(level_h, level_w, scale)] largest first.  Returns
    (scores [B, K_total], boxes [B, K_total, 4]) in original coordinates.
    """
    ss, bb = [], []
    cur = frames.to(compute_dtype)
    for (lh, lw, s) in level_dims:
        if s > 1.0:
            # upsampled levels always interpolate the original frames
            imgs = resize_bilinear(frames.to(compute_dtype), lh, lw)
        elif (lh, lw) == (cur.shape[1], cur.shape[2]):
            imgs = cur
        else:
            imgs = resize_bilinear(cur, lh, lw)
            cur = imgs
        sc, bx = _decode_level(params, imgs, s, compute_dtype=compute_dtype)
        ss.append(sc)
        bb.append(bx)
    return torch.cat(ss, dim=1), torch.cat(bb, dim=1)


def with_refiner(params: State, refiner_path: Optional[str] = None) -> State:
    """Serving-time state with the stage-2 refine cascade attached under the
    ``"refiner"`` key (``models/refiner.py``).

    A run-time key: the stage-1 and refiner weight files stay separate.
    ``PYV_NO_REFINE=1`` serves the plain single-stage pyramid (A/B kill
    switch), and so does a state that has no packaged refiner to take.
    """
    if os.environ.get("PYV_NO_REFINE") == "1" or "refiner" in params:
        return params
    if refiner_path is not None:
        return {**params, "refiner": load_params(refiner_path)}
    from .weights import default_refiner_params

    ref = default_refiner_params()
    return {**params, "refiner": ref} if ref is not None else params


class FaceDetector:
    """Multi-scale CNN face detector.

    Parameters
    ----------
    model_path : str, optional
        .npz parameter file (defaults to the packaged synthetic-data weights).
    threshold : float, optional
        Detection logit threshold; defaults to DEFAULT_THRESHOLD when the
        refine cascade is loaded, STAGE1_THRESHOLD otherwise.
    upsample : int
        Number of 2× upsampling pyramid levels.
    params : dict, optional
        A ready state (``models/nn.py``), instead of a file.
    refiner_path : str, optional
        .npz for the stage-2 crop refiner; defaults to the packaged
        weights.  ``PYV_NO_REFINE=1`` serves the single-stage pyramid.
    compute_dtype : torch.dtype
        bfloat16 serves as the JAX package does; float32 for comparisons.
    device : str or torch.device, optional
        ``cuda`` unless ``"cpu"`` is asked for.
    """

    def __init__(self, model_path: Optional[str] = None,
                 threshold: Optional[float] = None,
                 upsample: int = 0, params: Optional[State] = None,
                 nms_iou: float = 0.3, refiner_path: Optional[str] = None,
                 compute_dtype=torch.bfloat16, device: DeviceLike = None):
        self.device = resolve_device(device)
        if params is None:
            if model_path is not None:
                params = load_params(model_path)
            else:
                from .weights import default_detector_params

                params = default_detector_params()
        self.params = state_to(with_refiner(params, refiner_path), self.device)
        if threshold is None:
            threshold = (DEFAULT_THRESHOLD if "refiner" in self.params
                         else STAGE1_THRESHOLD)
        self.threshold = threshold
        self.upsample = upsample
        self.nms_iou = nms_iou
        self.compute_dtype = compute_dtype

    def level_dims(self, H: int, W: int):
        """[(level_h, level_w, scale)] of the pyramid for H×W frames."""
        return level_dims(H, W, self.upsample)

    @torch.no_grad()
    def candidates(self, frames: torch.Tensor):
        """Device scores [B, K_total] and boxes [B, K_total, 4] for frames
        [B, H, W, 3] float32 on the detector's device: stage-2 logits when
        the refiner is loaded (boxes are always stage-1 regressions)."""
        dims = self.level_dims(frames.shape[1], frames.shape[2])
        scores, boxes = pyramid_candidates(self.params, frames, dims,
                                           compute_dtype=self.compute_dtype)
        if "refiner" in self.params:
            from .refiner import refine_scores

            scores = refine_scores(self.params["refiner"], frames, scores,
                                   boxes, compute_dtype=self.compute_dtype)
        return scores, boxes

    def select(self, scores: np.ndarray,
               boxes: np.ndarray) -> List[Tuple[float, float, float, float]]:
        """Host threshold + NMS over ONE frame's candidates (scores [K],
        boxes [K, 4], as read back from ``candidates``): the detections."""
        mask = scores > self.threshold
        cand_boxes, cand_scores = boxes[mask], scores[mask]
        keep = (nms(cand_boxes, cand_scores, iou_threshold=self.nms_iou)
                if len(cand_boxes) else [])
        return [tuple(float(v) for v in cand_boxes[j]) for j in keep]

    def detect_batch(self, frames: np.ndarray) -> List[List[Tuple[float, float, float, float]]]:
        """Detect faces in a frame batch [B, H, W, 3] uint8.

        Returns per-frame lists of (left, top, right, bottom) boxes — the
        ``detect_func`` contract of the tracking stage.
        """
        frames_t = torch.from_numpy(np.asarray(frames)).to(self.device,
                                                            torch.float32)
        scores_t, boxes_t = self.candidates(frames_t)
        scores = scores_t.cpu().numpy()   # [B, K_total]
        boxes = boxes_t.cpu().numpy()     # [B, K_total, 4]
        return [self.select(scores[i], boxes[i]) for i in range(len(scores))]

    def __call__(self, frame: np.ndarray):
        """Single-frame detection."""
        return self.detect_batch(frame[None])[0]
