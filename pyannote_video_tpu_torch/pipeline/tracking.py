"""Tracking-by-detection: batched DSST + on-device association, per shot.

Port of ``pyannote_video_tpu/pipeline/tracking.py``, with the reference
engine's outputs and defaults:

* ALL trackers of a shot live in fixed device slots and an entire
  directional pass — DSST updates, exact optimal association on device
  (``ops/dsst.py:_optimal_match``), tracker restarts and new-track
  spawning — is enqueued without one wait for the device
  (``ops/dsst.py:shot_scan``);
* detections run batched over the shot's detection frames
  (``models/detector.py:detect_batch``);
* the host reads back one packed array per pass and rebuilds track lists
  from the emitted (box, status, uid, detection-index) stream.

Track-building semantics replicate the reference graph construction: a
matched tracker closes with the detection point and the tracker restarted
from that detection *continues the same track*; forward and backward
passes are merged through shared detection nodes, per-timestamp points are
fused (``_fix``), and gaps below ``track_max_gap`` are bridged.
"""

from __future__ import annotations

import itertools
import warnings
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.graph import UnionFind
from ..io.video import Video
from ..ops import dsst
from ..ops.color import to_gray
from ..utils.device import DeviceLike, resolve_device

FORWARD = "forward"
BACKWARD = "backward"
DETECTION = "detection"

Box = Tuple[float, float, float, float]
Point = Tuple[float, Box, str]  # (t, box, status)


class _Track:
    """A track under construction: points + the detection nodes it owns."""

    __slots__ = ("points", "det_keys")

    def __init__(self):
        self.points: List[Point] = []
        self.det_keys: List[Tuple[int, int]] = []


def get_segment_generator(segmentation):
    """Time-driven segment-boundary generator (reference `tracking.py:44-58`)."""
    t = yield
    for segment in segmentation:
        T = segment.end
        while True:
            if T > t:
                t = yield
                continue
            t = yield T
            break


def get_min_max_t(track: Sequence[Point]) -> Tuple[float, float]:
    return (min(t for t, _, _ in track), max(t for t, _, _ in track))


class TrackingByDetection:
    """(Forward/backward) tracking by detection.

    Same constructor surface and defaults as the reference
    (`tracking.py:104-119`), plus ``device``.

    Parameters
    ----------
    detect_func : callable, optional
        Frame → iterable of (left, top, right, bottom).  When omitted, the
        packaged CNN face detector runs *batched* over detection frames
        (the fast path).  A custom function is honoured per frame for
        API compatibility.
    detect_smallest : int
        Smallest object (px) the detector can see (40 for the CNN window).
    detect_min_size : float
        Smallest object size as a fraction of video height; drives frame
        downscaling exactly like the reference (`tracking.py:388-400`).
    detect_every : float
        Seconds between detection frames (0 → every frame).
    track_min_confidence : float
        Kill trackers whose PSR confidence drops below this (default 10).
    track_min_overlap_ratio : float
        Overlap gate for association (default 0.3).
    track_max_gap : float
        Bridge gaps shorter than this (seconds).
    max_tracks : int
        Minimum device tracker slots per shot; grows automatically through
        the 16/32/64 slot buckets when a shot needs more (no detection is
        dropped below 64 simultaneous tracks).
    track_dup_containment : float
        Suppress spawning a duplicate parallel track when an unmatched
        detection's containment overlap with a surviving tracker exceeds
        this (extension: the reference spawns a second track for every
        gate-missing detection, `tracking.py:246-259`).
    device : str or torch.device, optional
        Where the scans and the packaged detector run: ``cuda`` unless
        ``"cpu"`` is asked for.
    """

    def __init__(self, detect_func: Optional[Callable] = None,
                 detect_smallest: int = 1,
                 detect_min_size: float = 0.0,
                 detect_every: float = 0.0,
                 track_min_confidence: float = 10.0,
                 track_min_overlap_ratio: float = 0.3,
                 track_max_gap: float = 0.0,
                 max_tracks: int = 16,
                 max_shot_frames: int = 2000,
                 track_dup_containment: float = 0.6,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.max_shot_frames = max_shot_frames
        self.detect_func = detect_func
        self.detect_smallest = detect_smallest
        self.detect_min_size = detect_min_size
        self.detect_every = detect_every
        self.track_min_confidence = track_min_confidence
        self.track_min_overlap_ratio = track_min_overlap_ratio
        self.track_max_gap = track_max_gap
        self.max_tracks = max_tracks
        self.track_dup_containment = track_dup_containment
        self._batch_detector = None

    # -- small host helpers -------------------------------------------------
    # Pure NumPy: these run per box-pair / per detection frame on the host;
    # a tensor formulation would pay device launches and a readback per
    # tiny comparison.

    @staticmethod
    def _gated_overlap_np(a: np.ndarray, b: np.ndarray,
                          min_ratio: float) -> np.ndarray:
        """Reference `_match` semantics (`tracking.py:129-134`) on host:
        dlib closed-interval overlap area, zeroed below the gate."""
        a = np.asarray(a, dtype=np.float64)
        b = np.asarray(b, dtype=np.float64)
        lt = np.maximum(a[:, None, :2], b[None, :, :2])
        rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
        wh = np.maximum(0.0, rb - lt + 1.0)
        inter = wh[..., 0] * wh[..., 1]
        disjoint = (rb[..., 0] < lt[..., 0]) | (rb[..., 1] < lt[..., 1])
        inter = np.where(disjoint, 0.0, inter)
        area_a = np.maximum(0.0, a[:, 2] - a[:, 0] + 1.0) * np.maximum(
            0.0, a[:, 3] - a[:, 1] + 1.0)
        area_b = np.maximum(0.0, b[:, 2] - b[:, 0] + 1.0) * np.maximum(
            0.0, b[:, 3] - b[:, 1] + 1.0)
        gate = ((inter >= min_ratio * area_a[:, None])
                & (inter >= min_ratio * area_b[None, :]))
        return np.where(gate, inter, 0.0)

    def _overlap(self, box1: Box, box2: Box) -> float:
        """Gated overlap area of two boxes (reference `_match`,
        `tracking.py:129-134`)."""
        m = self._gated_overlap_np(
            np.asarray([box1]), np.asarray([box2]),
            self.track_min_overlap_ratio,
        )
        return float(m[0, 0])

    # -- detection ----------------------------------------------------------

    def _detect_frames(self, frames: np.ndarray,
                       det_frame_idx: np.ndarray) -> Dict[int, List[Box]]:
        """Detections per detection-frame index, batched when possible."""
        out: Dict[int, List[Box]] = {}
        if self.detect_func is not None:
            for i in det_frame_idx:
                out[int(i)] = [tuple(map(float, b))
                               for b in self.detect_func(frames[i])]
            return out
        if self._batch_detector is None:
            from ..models.detector import FaceDetector

            self._batch_detector = FaceDetector(device=self.device)
        det_frames = frames[det_frame_idx]
        B = 16
        boxes_all: List[List[Box]] = []
        for s in range(0, len(det_frames), B):
            boxes_all.extend(self._batch_detector.detect_batch(det_frames[s:s + B]))
        for i, b in zip(det_frame_idx, boxes_all):
            out[int(i)] = b
        return out

    # -- one directional pass ----------------------------------------------

    _N_BUCKETS = (16, 32, 64)
    _GRAY_BLOCK = 256     # frames converted to gray per host→device copy

    @staticmethod
    def _bucket(n: int, buckets: Sequence[int]) -> int:
        for b in buckets:
            if b >= n:
                return b
        # beyond the listed buckets: next power of two
        return 1 << (n - 1).bit_length()

    def _track_passes(self, grays: torch.Tensor, ts: np.ndarray,
                      detections: Dict[int, List[Box]]
                      ) -> Tuple[List[_Track], List[_Track]]:
        """Both directional passes over a shot.

        Each pass (batched DSST steps, exact optimal association on
        device, tracker restarts, new-track spawning) is one call of
        ``ops/dsst.py:shot_scan``, which enqueues the whole pass and waits
        for nothing; the backward pass reads the same stack through
        reversed frame indices and sees the detections reversed.  The
        host reads back one packed [T, N, 8] array per pass and rebuilds
        per-direction track lists from the emitted (box, status, uid,
        det-index) stream.  The slot count is bucketed (16/32/64); a pass
        that drops detections for want of free slots is retried with the
        next slot bucket instead of losing them (the reference is
        unbounded, `tracking.py:246-259`).  The frame count is not padded:
        nothing here is compiled per shape.

        grays: [T, H, W] float32 tensor on ``self.device`` (time-ordered).
        detections: frame-index → boxes (in time order).
        """
        T = int(grays.shape[0])
        if T == 0:
            return [], []

        # detection tensors [T, D, 4] / [T, D]; the detection axis is
        # bucketed so a custom detect_func returning arbitrarily many boxes
        # per frame keeps to a few shapes
        max_det = max((len(v) for v in detections.values()), default=0)
        D = self._bucket(max(max_det, 1), (8, 16, 32, 64))
        det_boxes = np.zeros((T, D, 4), dtype=np.float32)
        det_valid = np.zeros((T, D), dtype=bool)
        for f, boxes in detections.items():
            for d, b in enumerate(boxes):
                det_boxes[f, d] = b
                det_valid[f, d] = True

        orders = {FORWARD: np.arange(T), BACKWARD: np.arange(T - 1, -1, -1)}
        frame_valid = np.ones((T,), dtype=bool)

        n_buckets = [b for b in self._N_BUCKETS if b >= self.max_tracks]
        if not n_buckets:
            n_buckets = [self.max_tracks]

        def dispatch(direction, n_slots):
            order = orders[direction]
            state = dsst.init_state(n_slots, self.device)
            uid0 = torch.full((n_slots,), -1, dtype=torch.long,
                              device=self.device)
            _, packed_dev, dropped_dev = dsst.shot_scan(
                state, uid0, 0, grays, frame_valid,
                det_boxes[order], det_valid[order],
                self.track_min_confidence,
                self.track_min_overlap_ratio,
                self.track_dup_containment,
                frame_index=order,
            )
            # ONE readback per pass: flattened pack + drop counts
            return torch.cat(
                [packed_dev.reshape(T, -1),
                 dropped_dev[:, None].to(torch.float32)], dim=1)

        # both directions are enqueued before either readback
        results = {}
        todo = {FORWARD: 0, BACKWARD: 0}
        while todo:
            launched = {d: (n_buckets[bi], dispatch(d, n_buckets[bi]))
                        for d, bi in todo.items()}
            for direction, (n_slots, flat_dev) in launched.items():
                flat = flat_dev.cpu().numpy()
                packed = flat[:, :-1].reshape(T, n_slots, dsst.PACK_WIDTH)
                n_dropped = int(flat[:, -1].sum())
                if n_dropped and n_slots != n_buckets[-1]:
                    todo[direction] += 1  # retry with more slots
                    continue
                if n_dropped:
                    warnings.warn(
                        f"more than {n_slots} simultaneous tracks; dropped "
                        f"{n_dropped} detections (raise max_tracks)"
                    )
                results[direction] = packed
                del todo[direction]

        out: List[List[_Track]] = []
        for direction in (FORWARD, BACKWARD):
            order = orders[direction]
            packed = results[direction]

            boxes_a = packed[:, :, dsst.PACK_BOX]
            status_a = packed[:, :, dsst.PACK_STATUS]
            uid_a = packed[:, :, dsst.PACK_UID].astype(np.int64)
            det_a = packed[:, :, dsst.PACK_DET].astype(np.int64)

            tracks: Dict[int, _Track] = {}
            for ti in range(T):
                f = int(order[ti])
                t = float(ts[f])
                for slot in np.nonzero(status_a[ti] > 0.5)[0]:
                    trk = tracks.setdefault(int(uid_a[ti, slot]), _Track())
                    box = tuple(float(v) for v in boxes_a[ti, slot])
                    if status_a[ti, slot] > 1.5:
                        trk.points.append((t, box, DETECTION))
                    else:
                        trk.points.append((t, box, direction))
                    if det_a[ti, slot] >= 0:
                        # detection node owned by this track — either a
                        # real detection point or an absorbed duplicate
                        # (links the fwd/bwd passes through the merge step)
                        trk.det_keys.append((f, int(det_a[ti, slot])))
            out.append([trk for trk in tracks.values() if trk.points])
        return out[0], out[1]

    # -- merge / fix / gap-fill (reference semantics) -----------------------

    def _merge_passes(self, fwd: List[_Track], bwd: List[_Track]) -> List[List[Point]]:
        """Union tracks sharing a detection node (reference CC step,
        `tracking.py:345-347`)."""
        all_tracks = fwd + bwd
        uf = UnionFind()
        owner: Dict[Tuple[int, int], int] = {}
        for i, trk in enumerate(all_tracks):
            uf.add(i)
            for key in trk.det_keys:
                if key in owner:
                    uf.union(i, owner[key])
                else:
                    owner[key] = i
        merged: Dict[object, List[Point]] = {}
        for i, trk in enumerate(all_tracks):
            merged.setdefault(uf.find(i), []).extend(trk.points)
        # a detection node shared by the forward and backward passes is ONE
        # graph node in the reference (`tracking.py:218,255`) — dedupe the
        # identical (t, box, status) tuples the two passes recorded
        return [sorted(set(points)) for points in merged.values()]

    def _fix(self, track: List[Point]) -> List[Point]:
        """Merge same-timestamp fwd/bwd points (reference `tracking.py:261-296`)."""
        fixed: List[Point] = []
        for t, group in itertools.groupby(sorted(track), key=lambda x: x[0]):
            group = list(group)
            error = False
            for (_, p1, _), (_, p2, _) in itertools.combinations(group, 2):
                if self._overlap(p1, p2) == 0.0:
                    error = True
                    break
            status = "+".join(
                sorted((s for _, _, s in group),
                       key=lambda s: {DETECTION: 2, FORWARD: 1, BACKWARD: 3}[s])
            )
            if error:
                status = "error({0})".format(status)
            pos = tuple(
                int(round(v))
                for v in np.mean(np.vstack([p for _, p, _ in group]), axis=0)
            )
            fixed.append((t, pos, status))
        return fixed

    def _fill_gaps(self, tracks: List[List[Point]]) -> List[List[Point]]:
        """Bridge short gaps between matching tracks (`tracking.py:298-329`)."""
        tracks = sorted(tracks, key=get_min_max_t)
        uf = UnionFind()
        for i in range(len(tracks)):
            uf.add(i)
        for i, j in itertools.combinations(range(len(tracks)), 2):
            ti = tracks[i][-1][0]
            tj = tracks[j][0][0]
            if (tj < ti) or (tj - ti > self.track_max_gap):
                continue
            if self._overlap(tracks[i][-1][1], tracks[j][0][1]):
                uf.union(i, j)
        merged = []
        for group in uf.groups():
            track = [pt for idx in sorted(group) for pt in tracks[idx]]
            merged.append(track)
        return merged

    def _normalize_track(self, track: List[Point], frame_width: int,
                         frame_height: int) -> List[Point]:
        """Pixel → frame-ratio coords (reference `tracking.py:364-372`)."""
        return [
            (t, (l / frame_width, tp / frame_height,
                 r / frame_width, b / frame_height), status)
            for (t, (l, tp, r, b), status) in track
        ]

    # -- shot processing ----------------------------------------------------

    def _process_shot(self, frames: np.ndarray, ts: np.ndarray,
                      fps: float) -> Iterator[List[Point]]:
        if len(frames) == 0:
            return
        if self.detect_every > 0.0:
            every = max(1, int(self.detect_every * fps))
        else:
            every = 1
        det_idx = np.arange(0, len(frames), every)
        detections = self._detect_frames(frames, det_idx)

        # gray in blocks, so the RGB shot never sits whole on the device
        grays = torch.cat([
            to_gray(torch.from_numpy(frames[i:i + self._GRAY_BLOCK])
                    .to(self.device))
            for i in range(0, len(frames), self._GRAY_BLOCK)])

        yield from self._process_shot_device(grays, ts, detections)

    def _process_shot_device(self, grays: torch.Tensor, ts: np.ndarray,
                             detections: Dict[int, List[Box]]
                             ) -> Iterator[List[Point]]:
        """Scan + merge a shot whose grays are ALREADY on the device."""
        if int(grays.shape[0]) == 0:
            return
        fwd, bwd = self._track_passes(grays, ts, detections)

        tracks = [self._fix(trk) for trk in self._merge_passes(fwd, bwd)]
        tracks = self._fill_gaps(tracks)
        for track in sorted(tracks, key=get_min_max_t):
            yield track

    def __call__(self, video: Video, segmentation) -> Iterator[List[Point]]:
        """Yield normalized tracks per shot (reference `tracking.py:374-434`)."""
        # downscale so the smallest requested face matches what the
        # detector can see (reference `tracking.py:388-400`)
        width, height = video.size
        ratio = 1.0
        if self.detect_min_size > 0.0:
            ratio = self.detect_smallest / (self.detect_min_size * height)
            ratio = min(1.0, ratio)
        old_frame_size = tuple(video.frame_size)
        frame_width = int(width * ratio)
        frame_height = int(height * ratio)
        video.frame_size = (frame_width, frame_height)

        segment_generator = get_segment_generator(segmentation)
        segment_generator.send(None)

        shot_frames: List[np.ndarray] = []
        shot_ts: List[float] = []
        fps = video.frame_rate

        try:
            for t, frame in video:
                segment = segment_generator.send(t)
                if segment:
                    for track in self._process_shot(
                        np.asarray(shot_frames), np.asarray(shot_ts), fps
                    ):
                        yield self._normalize_track(track, frame_width,
                                                    frame_height)
                    shot_frames, shot_ts = [], []
                shot_frames.append(frame)
                shot_ts.append(t)

                # memory cap: force-split pathological shots (the reference
                # caches unbounded shots in RAM, `tracking.py:420`); tracks
                # break at the split, like at a shot boundary
                if len(shot_frames) >= self.max_shot_frames:
                    warnings.warn(
                        f"shot exceeds {self.max_shot_frames} frames; "
                        "splitting for memory (tracks break at the split)"
                    )
                    for track in self._process_shot(
                        np.asarray(shot_frames), np.asarray(shot_ts), fps
                    ):
                        yield self._normalize_track(track, frame_width,
                                                    frame_height)
                    shot_frames, shot_ts = [], []

            for track in self._process_shot(
                np.asarray(shot_frames), np.asarray(shot_ts), fps
            ):
                yield self._normalize_track(track, frame_width, frame_height)
        finally:
            video.frame_size = old_frame_size
