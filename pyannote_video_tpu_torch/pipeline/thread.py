"""Shot threading — batched ORB matching across shot boundaries.

Port of ``pyannote_video_tpu/pipeline/thread.py``: same constructor surface
(``Thread(video, shot, height=200, min_match=20, lookahead=5)``, plus
``device``), same outputs (a labelled, smoothed ``Annotation``; scenes as
biconnected components).  The collar frames (2 per shot) are gathered once
and ORB runs over them in batches (``ops/orb.py:detect_and_describe``);
the features stay in one device tensor, and the lookahead pairs are
scored by an index gather into it, 64 pairs per batched Hamming product.
The host reads the valid-keypoint counts once per feature batch and the
match counts once per 64 pairs.

Note: pyannote-video passes ``(height, w*height/h)`` as OpenCV's
``(width, height)``, actually producing width-`height` frames
(`thread.py:107,142`).  Like the JAX package, this implements the intended
semantics (output height = ``height``); ORB match counts are
orientation-agnostic.
"""

from __future__ import annotations

from collections import deque
from itertools import combinations
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core import Annotation, Segment, string_generator
from ..core.graph import Graph
from ..io.video import Video
from ..ops.color import ingest_gray_resize_first
from ..ops.orb import batched_ratio_matches, count_ratio_matches, detect_and_describe
from ..utils.device import DeviceLike, resolve_device

PAIRS_PER_BATCH = 64


def pairwise(iterable):
    """s -> (s0, s1), (s1, s2), ... (pyannote.core.utils.generators)."""
    items = list(iterable)
    return zip(items, items[1:])


def product_lookahead(iterable, lookahead: int):
    """Pairs (shot_n, shot_n+k), k ≤ lookahead — reference
    `thread.py:52-81` semantics including the tail-combinations case."""
    cache: deque = deque([], lookahead + 1)
    for item in iterable:
        cache.append(item)
        if len(cache) < lookahead + 1:
            continue
        for j in range(lookahead):
            yield cache[0], cache[j + 1]
    if len(cache) == lookahead + 1:
        cache.popleft()
    for item1, item2 in combinations(cache, 2):
        yield item1, item2


class Thread:
    """Shot threading based on ORB features.

    Parameters
    ----------
    video : Video
    shot : iterable of Segment, optional
        Shot segmentation (defaults to running `Shot(video)`).
    height : int
        Frames are resized to this height before ORB. Defaults to 200.
    min_match : int
        Minimum Lowe-ratio matches to connect two shots. Defaults to 20.
    lookahead : int
        Compare each shot to this many following shots. Defaults to 5
        (the CLI default is 24, `pyannote-structure.py:49`).
    device : str or torch.device, optional
        Where the work runs; ``cuda`` unless ``"cpu"`` is asked for.
    """

    def __init__(self, video: Video, shot=None, height: int = 200,
                 min_match: int = 20, lookahead: int = 5,
                 verbose: bool = False, batch_size: int = 16,
                 max_keypoints: int = 500, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.video = video
        self.height = height
        self.lookahead = lookahead
        self.min_match = min_match
        self.verbose = verbose
        self.batch_size = batch_size
        self.max_keypoints = max_keypoints

        if shot is None:
            from .shot import Shot

            shot = Shot(video, device=self.device)
        self.shot = shot

        w, h = self.video.size
        self._out_h = height
        self._out_w = max(8, int(round(w * height / h)))
        # collar time → row of the feature store; per row its valid count
        self._features: Dict[float, int] = {}
        self._n_valid: List[int] = []
        self._batches: List[Tuple[torch.Tensor, torch.Tensor]] = []
        self._store: Optional[Tuple[torch.Tensor, torch.Tensor]] = None

    # -- batched ORB over all collar frames ---------------------------------

    def _collar_times(self, shots: List[Segment]) -> List[float]:
        collar = 10.0 / self.video.frame_rate
        times = []
        for s in shots:
            times.append(s.end - collar)    # last frames of the shot
            times.append(s.start + collar)  # first frames of the shot
        # clamp into the video range and dedupe
        times = [min(max(t, self.video.start), self.video.end - 1e-6)
                 for t in times]
        return sorted(set(times))

    def _compute_features(self, shots: List[Segment]) -> None:
        times = [t for t in self._collar_times(shots)
                 if t not in self._features]
        for start in range(0, len(times), self.batch_size):
            chunk = times[start : start + self.batch_size]
            frames = np.stack([self.video(t) for t in chunk], axis=0)
            grays = ingest_gray_resize_first(
                torch.from_numpy(frames).to(self.device), self._out_h,
                self._out_w)
            _, valid, descs = detect_and_describe(
                grays, max_kp=self.max_keypoints)
            # {0, 1} descriptors kept as bytes: a quarter of the memory
            self._batches.append((descs.to(torch.uint8), valid))
            self._store = None
            for t, n in zip(chunk, valid.sum(dim=1).cpu().tolist()):
                self._features[t] = len(self._n_valid)
                self._n_valid.append(int(n))

    def _feature_store(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(descriptors [N, K, 256] uint8, valid [N, K]) of every row."""
        if self._store is None:
            self._store = (torch.cat([d for d, _ in self._batches]),
                           torch.cat([v for _, v in self._batches]))
            self._batches = [self._store]
        return self._store

    def _row_at(self, t: float) -> Optional[int]:
        t = min(max(t, self.video.start), self.video.end - 1e-6)
        return self._features.get(t)

    def _orb_at(self, t: float):
        """(descriptors [K, 256], valid [K]) of the collar frame at ``t``,
        or None when it was not computed."""
        row = self._row_at(t)
        if row is None:
            return None
        descs, valid = self._feature_store()
        return descs[row], valid[row]

    def _match(self, feat1, feat2) -> int:
        """Lowe-ratio match count (reference `thread.py:152-169`)."""
        if feat1 is None or feat2 is None:
            return 0
        desc1, valid1 = feat1
        desc2, valid2 = feat2
        if int(valid1.sum()) < 2 or int(valid2.sum()) < 2:
            return 0
        return count_ratio_matches(desc1, valid1, desc2, valid2)

    # -- graph construction -------------------------------------------------

    def _scorable_pairs(self, shots: List[Segment]):
        """Lookahead pairs whose two collar frames hold ≥ 2 keypoints, as
        (current, following, row1, row2)."""
        collar = 10.0 / self.video.frame_rate
        scorable = []
        for current, following in product_lookahead(shots, self.lookahead):
            r1 = self._row_at(current.end - collar)
            r2 = self._row_at(following.start + collar)
            if r1 is None or r2 is None:
                continue
            if self._n_valid[r1] < 2 or self._n_valid[r2] < 2:
                continue
            scorable.append((current, following, r1, r2))
        return scorable

    def _pair_counts(self, scorable) -> List[int]:
        """Match counts of the scorable pairs, one read per 64 pairs."""
        if not scorable:
            return []
        descs, valid = self._feature_store()
        rows = torch.tensor([[r1, r2] for _, _, r1, r2 in scorable],
                            dtype=torch.long).to(self.device)
        iterator = range(0, len(scorable), PAIRS_PER_BATCH)
        if self.verbose:
            from tqdm import tqdm

            iterator = tqdm(iterable=iterator, leave=True, mininterval=1.0,
                            unit="pair chunks", unit_scale=True)
        counts: List[int] = []
        for start in iterator:
            r1, r2 = rows[start : start + PAIRS_PER_BATCH].unbind(1)
            counts += batched_ratio_matches(descs[r1], valid[r1], descs[r2],
                                            valid[r2]).cpu().tolist()
        return counts

    def _threads_graph(self) -> Graph:
        shots = list(self.shot)
        self._compute_features(shots)

        graph = Graph()
        graph.add_nodes_from(shots)
        scorable = self._scorable_pairs(shots)
        for (current, following, _, _), n_matches in zip(
                scorable, self._pair_counts(scorable)):
            if n_matches > self.min_match:
                graph.add_edge(current, following)
        return graph

    def __call__(self) -> Annotation:
        graph = self._threads_graph()
        threads = [sorted(cc) for cc in graph.connected_components()]

        annotation = Annotation(uri=getattr(self.video, "filename", None))
        label_generator = string_generator()

        for thread in sorted(threads, key=lambda th: th[0]):
            label = next(label_generator)
            for shot in thread:
                annotation[shot] = label
        return annotation.smooth()

    def scenes(self, threads: Annotation) -> Annotation:
        """Group intertwined threads into scenes (reference
        `thread.py:224-249`)."""
        return scenes_from_threads(threads)


def scenes_from_threads(threads: Annotation) -> Annotation:
    """Scene grouping: biconnected components of the adjacency+threading
    graph with ≥ 3 shots share one label (reference `thread.py:224-249`).

    Needs only the thread annotation (host only, no device work).
    """
    g = Graph()
    for shot1, shot2 in pairwise(threads.itertracks()):
        g.add_edge(shot1, shot2)
    for label in threads.labels():
        for shot1, shot2 in pairwise(threads.subset([label]).itertracks()):
            g.add_edge(shot1, shot2)

    scenes = threads.copy()
    for shots in sorted(sorted(bc) for bc in g.biconnected_components()):
        if len(shots) < 3:
            continue
        common_label = scenes[shots[0]]
        for shot in shots:
            scenes[shot] = common_label
    return scenes
