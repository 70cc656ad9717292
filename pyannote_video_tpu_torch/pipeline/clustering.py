"""Face clustering: hierarchical agglomerative clustering on embeddings.

Reference-compatible ``FaceClustering`` (`face/clustering.py:122-148`):
average-link HAC where cluster similarity is the NEGATIVE mean pairwise
Euclidean distance between the clusters' embeddings
(`clustering.py:92-114`), stopping when the best merge's distance exceeds
``threshold`` (DistanceThreshold semantics, default 0.6).

Port of ``pyannote_video_tpu/pipeline/clustering.py``.  The O(n²·d)
embedding-distance matrix is computed on the device (`ops/distance.py`)
and read back once; the linkage loop (tiny, O(k²) cluster pairs on
precomputed means) stays on the host, in numpy and Python floats exactly
as the JAX package runs it.  Average-link mean distances are updated
incrementally with counts — no re-scan of the embedding matrix per merge.
"""

from __future__ import annotations

import heapq
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..core import Annotation, Segment
from ..core.formats import read_embeddings
from ..ops.distance import pairwise_dist
from ..utils.device import DeviceLike, resolve_device


class _Model:
    """Preprocessing identical in effect to the reference `_Model`
    (`clustering.py:49-119`)."""

    @staticmethod
    def preprocess(embedding_path: str):
        """Embedding file → (starting_point Annotation, features).

        Mirrors `clustering.py:59-82`: one initial cluster per track,
        labelled by the track id, spanning the track's time extent.
        """
        times, tracks, X = read_embeddings(embedding_path)
        order = np.lexsort((times, tracks))
        times, tracks, X = times[order], tracks[order], X[order]

        starting_point = Annotation(modality="face")
        for track in np.unique(tracks):
            sel = tracks == track
            segment = Segment(float(times[sel].min()), float(times[sel].max()))
            if not segment:
                continue
            starting_point[segment, int(track)] = int(track)
        return starting_point, {"tracks": tracks, "X": X, "times": times}


class FaceClustering:
    """Agglomerative clustering of face tracks by embedding distance.

    Usage (reference `clustering.py:130-135`):
        >>> clustering = FaceClustering(threshold=0.6)
        >>> starting_point, features = clustering.model.preprocess(embeddings)
        >>> result = clustering(starting_point, features=features)

    ``result`` is an Annotation mapping each track's segment to its cluster
    label (the smallest member track id).  ``device``: ``cuda`` unless
    ``"cpu"`` is asked for.
    """

    def __init__(self, threshold: float = 0.6, force: bool = False,
                 logger=None, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.threshold = threshold
        self.force = force
        self.logger = logger
        self.model = _Model()

    def __call__(self, starting_point: Annotation, features=None) -> Annotation:
        tracks = features["tracks"]
        X = np.asarray(features["X"], dtype=np.float32)

        # full pairwise distance matrix on the device, read back once
        D = pairwise_dist(torch.from_numpy(X).to(self.device)).cpu().numpy()

        # initial clusters = tracks; mean inter-cluster distances + counts
        labels: List[int] = [int(t) for t in np.unique(tracks)]
        members: Dict[int, List[int]] = {
            l: list(np.nonzero(tracks == l)[0]) for l in labels
        }
        # sum of pairwise distances between clusters (for O(1) merges)
        sums: Dict[Tuple[int, int], float] = {}
        counts: Dict[Tuple[int, int], int] = {}

        def key(a: int, b: int) -> Tuple[int, int]:
            return (a, b) if a < b else (b, a)

        for i, a in enumerate(labels):
            ia = members[a]
            for b in labels[i + 1 :]:
                ib = members[b]
                sums[key(a, b)] = float(D[np.ix_(ia, ib)].sum())
                counts[key(a, b)] = len(ia) * len(ib)

        heap: List[Tuple[float, int, int]] = [
            (sums[k] / counts[k], k[0], k[1]) for k in sums
        ]
        heapq.heapify(heap)
        active = set(labels)
        assignment: Dict[int, int] = {l: l for l in labels}

        while len(active) > 1 and heap:
            dist, a, b = heapq.heappop(heap)
            if a not in active or b not in active:
                continue
            cur = sums[key(a, b)] / counts[key(a, b)]
            if abs(cur - dist) > 1e-12:
                continue  # stale entry
            if dist > self.threshold and not self.force:
                break
            # merge b into a (keep smaller id as label, reference keeps
            # cluster names stable through its HAC engine)
            keep, drop = (a, b) if a < b else (b, a)
            active.discard(drop)
            for other in list(active):
                if other == keep:
                    continue
                k_new = key(keep, other)
                k_old_a = key(a, other)
                k_old_b = key(b, other)
                sums[k_new] = sums.get(k_old_a, 0.0) + sums.get(k_old_b, 0.0)
                counts[k_new] = counts.get(k_old_a, 0) + counts.get(k_old_b, 0)
                heapq.heappush(
                    heap, (sums[k_new] / counts[k_new], k_new[0], k_new[1])
                )
            members[keep] = members[keep] + members[drop]
            for l, tgt in assignment.items():
                if tgt == drop:
                    assignment[l] = keep
            if self.logger is not None:
                self.logger.info(f"merged {drop} into {keep} at {dist:.4f}")

        # relabel the starting-point annotation with cluster labels
        result = Annotation(uri=starting_point.uri, modality="face")
        for segment, track, label in starting_point.itertracks(yield_label=True):
            result[segment, track] = assignment.get(int(label), int(label))
        return result
