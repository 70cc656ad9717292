"""Box geometry: overlaps and greedy NMS on the host, gated overlaps on
the device.

Port of ``pyannote_video_tpu/ops/boxes.py``.  Boxes are ``(left, top,
right, bottom)`` rows; areas use dlib's closed-grid convention (width =
right - left + 1).  The numpy forms serve detection's NMS on a few dozen
host boxes; the ``*_t`` tensor forms run on the device in float32, inside
the tracking scan and the fused program's NMS (``models/fused.py``).
"""

from __future__ import annotations

import numpy as np
import torch


def box_area(boxes) -> np.ndarray:
    boxes = np.asarray(boxes, dtype=np.float32)
    w = np.maximum(0.0, boxes[..., 2] - boxes[..., 0] + 1.0)
    h = np.maximum(0.0, boxes[..., 3] - boxes[..., 1] + 1.0)
    return w * h


def intersection_area(a, b) -> np.ndarray:
    """Pairwise intersection areas: a [N,4] × b [M,4] → [N, M]."""
    a = np.asarray(a, dtype=np.float32)
    b = np.asarray(b, dtype=np.float32)
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.maximum(0.0, rb - lt + 1.0)
    inter = wh[..., 0] * wh[..., 1]
    # dlib's intersect() of disjoint rects is an empty rect with area 0
    disjoint = (rb[..., 0] < lt[..., 0]) | (rb[..., 1] < lt[..., 1])
    return np.where(disjoint, np.float32(0.0), inter)


def iou(a, b) -> np.ndarray:
    inter = intersection_area(a, b)
    union = box_area(a)[:, None] + box_area(b)[None, :] - inter
    return inter / np.maximum(union, np.float32(1e-9))


def overlap_min_ratio(a, b) -> np.ndarray:
    """Intersection over the SMALLER box's area — catches contained
    duplicates that plain IoU misses."""
    inter = intersection_area(a, b)
    min_area = np.minimum(box_area(a)[:, None], box_area(b)[None, :])
    return inter / np.maximum(min_area, np.float32(1e-9))


def nms(boxes: np.ndarray, scores: np.ndarray, iou_threshold: float = 0.4,
        max_out: int = 64, containment_threshold: float = 0.7):
    """Greedy non-maximum suppression over a few dozen candidates.

    Suppresses on IoU > iou_threshold OR containment (intersection /
    min-area) > containment_threshold — multi-scale pyramid detectors
    produce nested duplicates that IoU alone keeps.

    Returns indices of kept boxes, highest score first.
    """
    boxes = np.asarray(boxes, dtype=np.float32)
    scores = np.asarray(scores, dtype=np.float32)
    order = np.argsort(-scores)
    keep = []
    iou_mat = iou(boxes, boxes)
    cont_mat = overlap_min_ratio(boxes, boxes)
    for i in order:
        if len(keep) >= max_out:
            break
        if all(
            iou_mat[i, j] <= iou_threshold
            and cont_mat[i, j] <= containment_threshold
            for j in keep
        ):
            keep.append(int(i))
    return keep


# -- tensor forms (the tracking scan's association, on the state's device) --


def box_area_t(boxes: torch.Tensor) -> torch.Tensor:
    boxes = boxes.to(torch.float32)
    w = (boxes[..., 2] - boxes[..., 0] + 1.0).clamp_min(0.0)
    h = (boxes[..., 3] - boxes[..., 1] + 1.0).clamp_min(0.0)
    return w * h


def intersection_area_t(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise intersection areas: a [..., N, 4] × b [..., M, 4] →
    [..., N, M]."""
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt + 1.0).clamp_min(0.0)
    inter = wh[..., 0] * wh[..., 1]
    disjoint = (rb[..., 0] < lt[..., 0]) | (rb[..., 1] < lt[..., 1])
    return torch.where(disjoint, torch.zeros_like(inter), inter)


def gated_overlap_t(a: torch.Tensor, b: torch.Tensor,
                    min_overlap_ratio: float) -> torch.Tensor:
    """Overlap area, zeroed whenever it is below ``min_overlap_ratio``
    times EITHER box's area (the reference's ``_match`` gate)."""
    inter = intersection_area_t(a, b)
    area_a = box_area_t(a)[:, None]
    area_b = box_area_t(b)[None, :]
    gate = ((inter >= min_overlap_ratio * area_a)
            & (inter >= min_overlap_ratio * area_b))
    return torch.where(gate, inter, torch.zeros_like(inter))


def iou_t(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU on the device: a [..., N, 4] × b [..., M, 4] →
    [..., N, M]."""
    inter = intersection_area_t(a, b)
    union = box_area_t(a)[..., :, None] + box_area_t(b)[..., None, :] - inter
    return inter / union.clamp_min(1e-9)


def overlap_min_ratio_t(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Intersection over the SMALLER box's area, on the device (batched
    as ``iou_t``)."""
    inter = intersection_area_t(a, b)
    min_area = torch.minimum(box_area_t(a)[..., :, None],
                             box_area_t(b)[..., None, :])
    return inter / min_area.clamp_min(1e-9)


def normalize_boxes(boxes, frame_width: float, frame_height: float) -> np.ndarray:
    """Pixel boxes → frame-size-normalised coords."""
    scale = np.asarray([frame_width, frame_height, frame_width, frame_height],
                       dtype=np.float32)
    return np.asarray(boxes, dtype=np.float32) / scale
