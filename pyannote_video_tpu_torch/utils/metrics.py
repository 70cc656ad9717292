"""Quality metrics: shot-boundary F1, track F1, cluster purity.

The evaluation protocol of BASELINE.md: shot boundary F1 against known
cuts, per-frame track F1 against ground-truth boxes, and cluster purity
against ground-truth identities.  Used by the synthetic evaluation harness
(`evals/eval_synthetic.py`) in lieu of the pyannote-data sample episode
(no media files in this environment).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple



def boundary_f1(predicted: Sequence[float], truth: Sequence[float],
                tolerance: float) -> Dict[str, float]:
    """Shot-boundary precision/recall/F1 with a time tolerance."""
    predicted = sorted(predicted)
    truth = sorted(truth)
    used = set()
    tp = 0
    for p in predicted:
        for i, t in enumerate(truth):
            if i in used:
                continue
            if abs(p - t) <= tolerance:
                used.add(i)
                tp += 1
                break
    precision = tp / len(predicted) if predicted else (1.0 if not truth else 0.0)
    recall = tp / len(truth) if truth else 1.0
    f1 = (2 * precision * recall / (precision + recall)
          if precision + recall > 0 else 0.0)
    return {"precision": precision, "recall": recall, "f1": f1}


def iou_xyxy(a, b) -> float:
    ix0, iy0 = max(a[0], b[0]), max(a[1], b[1])
    ix1, iy1 = min(a[2], b[2]), min(a[3], b[3])
    inter = max(0.0, ix1 - ix0) * max(0.0, iy1 - iy0)
    union = ((a[2] - a[0]) * (a[3] - a[1])
             + (b[2] - b[0]) * (b[3] - b[1]) - inter)
    return inter / union if union > 0 else 0.0


def track_frame_f1(
    predicted: Dict[float, List[Tuple[float, float, float, float]]],
    truth: Dict[float, List[Tuple[float, float, float, float]]],
    iou_threshold: float = 0.4,
) -> Dict[str, float]:
    """Per-frame detection/tracking F1: boxes matched greedily by IoU.

    predicted/truth: timestamp → list of (l, t, r, b) boxes (same coord
    space).
    """
    tp = fp = fn = 0
    for t, truth_boxes in truth.items():
        pred_boxes = list(predicted.get(t, []))
        matched = set()
        for g in truth_boxes:
            best_j, best_iou = -1, iou_threshold
            for j, p in enumerate(pred_boxes):
                if j in matched:
                    continue
                v = iou_xyxy(p, g)
                if v >= best_iou:
                    best_j, best_iou = j, v
            if best_j >= 0:
                matched.add(best_j)
                tp += 1
            else:
                fn += 1
        fp += len(pred_boxes) - len(matched)
    for t, pred_boxes in predicted.items():
        if t not in truth:
            fp += len(pred_boxes)
    precision = tp / (tp + fp) if tp + fp else 1.0
    recall = tp / (tp + fn) if tp + fn else 1.0
    f1 = (2 * precision * recall / (precision + recall)
          if precision + recall > 0 else 0.0)
    return {"precision": precision, "recall": recall, "f1": f1}


def cluster_purity(assignment: Dict[int, object],
                   truth: Dict[int, object]) -> float:
    """Purity of a track→cluster assignment against track→identity truth.

    purity = Σ_c max_i |c ∩ i| / N over clusters c and identities i.
    """
    clusters: Dict[object, List[int]] = {}
    for track, cluster in assignment.items():
        clusters.setdefault(cluster, []).append(track)
    n = sum(len(m) for m in clusters.values())
    if n == 0:
        return 1.0
    correct = 0
    for members in clusters.values():
        counts: Dict[object, int] = {}
        for track in members:
            ident = truth.get(track)
            counts[ident] = counts.get(ident, 0) + 1
        correct += max(counts.values())
    return correct / n


def pairwise_prf(assignment: Dict[int, object],
                 truth: Dict[int, object]) -> Dict[str, float]:
    """Pairwise precision/recall/F1 of a clustering against truth labels.

    Over all item pairs: a pair predicted same-cluster is a true positive
    when it is same-label in truth.  Recall exposes UNDER-merging (purity
    alone rewards over-splitting); precision exposes over-merging.
    """
    import itertools

    items = [k for k in assignment if k in truth]
    tp = fp = fn = 0
    for i, j in itertools.combinations(items, 2):
        same_pred = assignment[i] == assignment[j]
        same_true = truth[i] == truth[j]
        if same_pred and same_true:
            tp += 1
        elif same_pred:
            fp += 1
        elif same_true:
            fn += 1
    precision = tp / (tp + fp) if (tp + fp) else 1.0
    recall = tp / (tp + fn) if (tp + fn) else 1.0
    f1 = (2 * precision * recall / (precision + recall)
          if precision + recall else 0.0)
    return {"precision": precision, "recall": recall, "f1": f1}
