"""Fused detect → align → embed over frame batches.

Port of ``pyannote_video_tpu/models/fused.py``.  Pyramid detection, the
stage-2 refiner, greedy NMS on the device, the ERT landmark cascade on
per-face crops, chip alignment and the ResNet-29 embedder run back to back
over a frame batch with a fixed number of face slots per frame; empty slots
are masked by ``valid``, and every slot is computed, valid or not, so the
shapes never depend on the data.  The JAX package compiles this as one XLA
program; here it is one enqueue of PyTorch operations that never reads a
device value on the host, so the caller's one read of the output is the
only wait.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from . import detector as det
from . import embedder as emb
from .chip import box_to_landmarks, extract_chips
from .nn import State, state_to
from ..utils.device import DeviceLike, resolve_device

MAX_FACES = 8  # face slots per frame

# the static entries of a cascade (they set its loop structure); the rest
# are the arrays the built programs take as an argument
_CASCADE_STATIC = ("n_stages", "depth", "bilinear_tail")


class FusedOutput(NamedTuple):
    boxes: torch.Tensor       # [B, M, 4] pixel coords
    scores: torch.Tensor      # [B, M]
    valid: torch.Tensor       # [B, M] bool
    landmarks: torch.Tensor   # [B, M, 68, 2]
    embeddings: torch.Tensor  # [B, M, 128]


def _device_nms(boxes: torch.Tensor, scores: torch.Tensor, iou_thresh: float,
                max_out: int):
    """Greedy NMS on the device: boxes [B, K, 4], scores [B, K] (or [K, 4],
    [K]) → (boxes, scores, valid) with ``max_out`` slots per frame.

    ``max_out`` rounds, each taking the best live candidate of every frame
    (the first index on ties, as ``jnp.argmax``) and suppressing its
    overlaps (IoU above ``iou_thresh`` or containment above 0.7): full
    greedy NMS truncated to ``max_out`` picks.  A winner is suppressed
    explicitly besides its row of the overlap matrix, since a degenerate
    candidate (an inverted box with IoU 0, NaN coordinates) overlaps
    nothing, itself included, and would be picked again.  Once every
    candidate is ``-inf`` a round records index 0 with score ``-inf``;
    ``valid`` is where the score is finite.
    """
    from ..ops.boxes import iou_t, overlap_min_ratio_t

    single = scores.dim() == 1
    if single:
        boxes, scores = boxes[None], scores[None]
    sup = (iou_t(boxes, boxes) > iou_thresh) | (
        overlap_min_ratio_t(boxes, boxes) > 0.7)              # [B, K, K]
    rows = torch.arange(scores.shape[0], device=scores.device)
    live = scores
    picks, picked = [], []
    for _ in range(max_out):
        idx = live.argmax(dim=1)                              # [B]
        picks.append(idx)
        picked.append(live.gather(1, idx[:, None])[:, 0])
        live = live.masked_fill(sup[rows, idx], float("-inf"))
        live = live.scatter(1, idx[:, None], float("-inf"))
    out_idx = torch.stack(picks, dim=1)                       # [B, max_out]
    out_scores = torch.stack(picked, dim=1)
    out_boxes = torch.gather(boxes, 1, out_idx[..., None].expand(-1, -1, 4))
    valid = torch.isfinite(out_scores)
    if single:
        return out_boxes[0], out_scores[0], valid[0]
    return out_boxes, out_scores, valid


class FusedFacePipeline:
    """detect → align → embed over frame batches.

    Parameters default to the packaged detector (with its refiner, unless
    ``PYV_NO_REFINE=1``), landmark cascade and embedder; each may be given
    as a port state instead.  ``compute_dtype`` is the detector's, the
    refiner's and the embedder's conv dtype (bfloat16 serves, float32
    compares).  ``device``: ``cuda`` unless ``"cpu"`` is asked for.
    """

    def __init__(self, detector_params: Optional[State] = None,
                 embedder_params: Optional[State] = None,
                 landmark_params: Optional[dict] = None,
                 threshold: Optional[float] = None, nms_iou: float = 0.3,
                 upsample: int = 0, max_faces: int = MAX_FACES,
                 compute_dtype=torch.bfloat16, device: DeviceLike = None):
        from .landmarks import LandmarkPredictor
        from .weights import default_detector_params, default_embedder_params

        self.device = resolve_device(device)
        self.detector_params = state_to(det.with_refiner(
            detector_params or default_detector_params()), self.device)
        if threshold is None:
            threshold = (det.DEFAULT_THRESHOLD
                         if "refiner" in self.detector_params
                         else det.STAGE1_THRESHOLD)
        self.embedder_params = state_to(
            embedder_params or default_embedder_params(), self.device)
        if landmark_params is None:
            landmark_params = LandmarkPredictor(device=self.device).params
        self.landmark_params = state_to(landmark_params, self.device)
        self.landmark_arrays = {k: v for k, v in self.landmark_params.items()
                                if k not in _CASCADE_STATIC}
        self.threshold = threshold
        self.nms_iou = nms_iou
        self.upsample = upsample
        self.max_faces = max_faces
        self.compute_dtype = compute_dtype
        self._built = {}

    def _candidates(self, det_params: State, frames_u8: torch.Tensor,
                    dims) -> tuple:
        """Pyramid candidates, refined when the state holds a refiner, with
        every score at or under the threshold set to ``-inf``, through NMS:
        (boxes [B, M, 4], scores [B, M], valid [B, M])."""
        frames = frames_u8.to(torch.float32)
        scores, boxes = det.pyramid_candidates(det_params, frames, dims,
                                               compute_dtype=self.compute_dtype)
        if "refiner" in det_params:
            from .refiner import refine_scores

            scores = refine_scores(det_params["refiner"], frames, scores,
                                   boxes, compute_dtype=self.compute_dtype)
        # candidates at or under the threshold can never be selected
        scores = torch.where(scores > self.threshold, scores,
                             torch.full_like(scores, float("-inf")))
        return _device_nms(boxes, scores, self.nms_iou, self.max_faces)

    def _build(self, H: int, W: int):
        """The fused program for H×W frames: ``(det_params, emb_params,
        lm_arrays, frames_u8 [B, H, W, 3]) → FusedOutput``, every tensor on
        the frames' device, nothing read on the host."""
        dims = det.level_dims(H, W, self.upsample)
        max_faces = self.max_faces
        compute_dtype = self.compute_dtype
        lm_static = {k: int(self.landmark_params[k]) for k in _CASCADE_STATIC
                     if k in self.landmark_params}
        lm_static.setdefault("n_stages", 0)
        lm_static.setdefault("depth", 3)
        has_cascade = lm_static["n_stages"] > 0

        @torch.no_grad()
        def fused(det_params, emb_params, lm_arrays, frames_u8):
            B = frames_u8.shape[0]
            sel_boxes, sel_scores, valid = self._candidates(
                det_params, frames_u8, dims)
            flat_boxes = sel_boxes.reshape(B * max_faces, 4)
            frame_idx = torch.arange(B, device=frames_u8.device
                                     ).repeat_interleave(max_faces)
            if has_cascade:
                from ..ops.color import to_gray
                from .landmarks import predict_crops

                landmarks = predict_crops({**lm_arrays, **lm_static},
                                          to_gray(frames_u8), frame_idx,
                                          flat_boxes)         # [B*M, 68, 2]
            else:
                landmarks = box_to_landmarks(flat_boxes)      # [B*M, 68, 2]
            chips = extract_chips(frames_u8, frame_idx, landmarks)
            embeddings = emb.forward(emb_params, chips,
                                     compute_dtype=compute_dtype)
            return FusedOutput(
                boxes=sel_boxes,
                scores=sel_scores,
                valid=valid,
                landmarks=landmarks.reshape(B, max_faces, 68, 2),
                embeddings=embeddings.reshape(B, max_faces, emb.EMBED_DIM),
            )

        return fused

    def build_detect_only(self, H: int, W: int):
        """Pyramid detection and device NMS, with no landmark or embedding
        tail: ``(det_params, frames_u8 [B, H, W, 3]) → (boxes [B, M, 4],
        scores [B, M], valid [B, M])``.  This is what the tracking stage
        consumes; the full program would run the cascade, the chip cut and
        the embedder on every slot of every detection frame."""
        dims = det.level_dims(H, W, self.upsample)

        @torch.no_grad()
        def detect_only(det_params, frames_u8):
            return self._candidates(det_params, frames_u8, dims)

        return detect_only

    def __call__(self, frames) -> FusedOutput:
        """frames [B, H, W, 3] uint8 (numpy or tensor) → FusedOutput of
        tensors on the pipeline's device."""
        if not isinstance(frames, torch.Tensor):
            frames = torch.from_numpy(np.ascontiguousarray(frames))
        frames = frames.to(self.device, torch.uint8)
        B, H, W = frames.shape[:3]
        key = (H, W, B)
        if key not in self._built:
            self._built[key] = self._build(H, W)
        return self._built[key](self.detector_params, self.embedder_params,
                                self.landmark_arrays, frames)
