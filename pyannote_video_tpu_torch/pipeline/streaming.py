"""The streaming engines of the CLI hot paths: track + extract.

Port of ``pyannote_video_tpu/pipeline/streaming.py``: the overlapped decode
→ transfer → compute architecture of ``io/stream.py`` under the user-facing
commands.

* frames come from ``Video.iterbatches``: the SAME time grid, frame
  selection and host downscale as the per-frame loop of
  ``pipeline/tracking.py``, so outputs are grid-identical;
* each batch is packed to planar YUV 4:2:0 on a pipeline thread (half the
  host→device bytes of RGB24) and shipped on a second thread, from pinned
  memory on a side stream, while the previous batch computes
  (``io/stream.py``: ``_Stage``, ``_Shipper``);
* gray frames and detection RGB are reconstructed ON DEVICE from the YUV
  planes (``ops/color.py``): the full-resolution RGB batch is never copied
  to the device;
* tracking state machinery is unchanged: shots are assembled from the
  streamed gray chunks and handed to the exact same fwd/bwd scan +
  merge/fix/gap code (``TrackingByDetection._process_shot_device``).

Per-leg accounting (``StreamLegs``) reports decode/pack/transfer/compute/
host seconds that add up to the measured wall time.

The JAX module pads a short last batch, the detection subset of a batch and
the faces of an extract dispatch to fixed sizes, to bound its compilations.
Nothing is compiled per shape here, the pinned ring takes a short batch as
a slice, and no frame's or face's result depends on its batch: none of the
three paddings is ported.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..io.stream import _Shipper, _Stage, pack_yuv420
from ..ops.color import yuv420_to_rgb, yuv_luma_to_gray
from ..utils.device import resolve_device

TRACK_BATCH = 64      # frames per streamed batch
EXTRACT_FACES = 64    # faces per extract dispatch


# ---------------------------------------------------------------------------
# per-leg accounting


@dataclass
class StreamLegs:
    """Leg seconds for one streaming CLI run.

    ``decode_s + pack_s`` happen on the packer thread, ``transfer_s`` on
    the shipper thread, ``dispatch_s + sync_s + host_s`` on the main
    thread; with overlap the wall is bounded below by the slowest of the
    three threads, and ``sum_s`` ≈ wall means no overlap happened.
    """

    frames: int = 0
    batches: int = 0
    bytes_shipped: int = 0
    decode_s: float = 0.0    # source read (Video.iterbatches pull)
    pack_s: float = 0.0      # RGB → I420
    transfer_s: float = 0.0  # pinned staging + copy + its completion
    feed_wait_s: float = 0.0  # main thread starved waiting for batches
    dispatch_s: float = 0.0  # main thread: enqueueing device work
    sync_s: float = 0.0      # main thread: device sync/readback
    scan_s: float = 0.0      # main thread: per-shot fwd/bwd scans (enqueue
                             # + packed readback) + merge/fix/gaps
    host_s: float = 0.0      # main thread: NMS, bookkeeping, file write
    wall_s: float = 0.0
    pinned_bytes: int = 0    # staging buffers the shipper held (CUDA only)

    def as_dict(self) -> dict:
        legs = {
            "frames": self.frames,
            "batches": self.batches,
            "shipped_gb": round(self.bytes_shipped / 1e9, 3),
            "wall_s": round(self.wall_s, 3),
            "fps": round(self.frames / self.wall_s, 1) if self.wall_s else 0,
            "decode_s": round(self.decode_s, 3),
            "pack_s": round(self.pack_s, 3),
            "transfer_s": round(self.transfer_s, 3),
            "feed_wait_s": round(self.feed_wait_s, 3),
            "dispatch_s": round(self.dispatch_s, 3),
            "sync_s": round(self.sync_s, 3),
            "scan_s": round(self.scan_s, 3),
            "host_s": round(self.host_s, 3),
        }
        main = (self.feed_wait_s + self.dispatch_s + self.sync_s
                + self.scan_s + self.host_s)
        legs["main_thread_s"] = round(main, 3)  # ≈ wall when main binds
        return legs


# ---------------------------------------------------------------------------
# shared batch plumbing


def _even(x: int) -> int:
    return x - (x % 2)


def _stream_batches(video, batch: int, legs: StreamLegs,
                    device: torch.device, depth: int = 2):
    """Decode → I420 pack → ship, each on its own thread.

    Yields ``(ts [n], (y, u, v) uint8 device tensors)``, ``n ≤ batch``;
    updates ``legs`` with the packer/shipper timings when iteration ends.
    """
    ship = _Shipper(device, depth)

    def do_pack(item):
        ts, frames = item
        return ts, pack_yuv420(frames)

    def do_put(item):
        ts, (y, u, v) = item
        legs.bytes_shipped += y.nbytes + u.nbytes + v.nbytes
        return ts, ship.put((y, u, v))

    packer = _Stage(video.iterbatches(batch), do_pack, depth)
    shipper = _Stage(packer, do_put, depth)
    try:
        for ts, shipped in shipper:
            yield ts, ship.take(shipped)
    finally:
        legs.decode_s += packer.pull_s
        legs.pack_s += packer.busy_s
        legs.transfer_s += shipper.busy_s
        legs.feed_wait_s += shipper.wait_s
        legs.pinned_bytes = ship.pinned_bytes


# ---------------------------------------------------------------------------
# track


def _shot_plan(video, segmentation, max_shot_frames: int, every: int):
    """Per-grid-frame shot ids and detection flags, computed up front.

    The per-shot engine discovers shot boundaries online through a
    generator (``pipeline/tracking.py:get_segment_generator``); here
    shot.json is a CLI input, so the whole plan — which shot each grid
    frame belongs to (including the ``max_shot_frames`` memory splits) and
    which frames sit on the shot-relative detection grid
    ``range(0, len(shot), every)`` — is known before the first frame
    decodes.  Returns ``(shot_id [n] int32, detect [n] bool, segment [n]
    int32)``; replaying the generator keeps the frame partition identical
    to the per-shot engine's.  ``segment`` maps each grid frame to the
    index of its originating segment in ``segmentation`` (a segment may
    split into several shot ids at the ``max_shot_frames`` memory cap, but
    every shot id's frames lie in exactly one segment): multi-worker
    sharding assigns work by this index (``cli/face_cli.py:track``).
    """
    from .tracking import get_segment_generator

    grid = video.timestamps()
    gen = get_segment_generator(segmentation)
    gen.send(None)
    shot_id = np.zeros(len(grid), dtype=np.int32)
    detect = np.zeros(len(grid), dtype=bool)
    segment = np.zeros(len(grid), dtype=np.int32)
    sid, rel, seg = 0, 0, 0
    for i, t in enumerate(grid):
        # a boundary firing on an empty shot (possible when segments are
        # shorter than a frame interval, or right after a memory split)
        # opens no new shot — the per-shot loop processes an empty frame
        # list and keeps going (but the segment index still advances:
        # the empty segment consumed a slot in the segmentation list)
        if gen.send(float(t)):
            seg += 1
            if rel:
                sid, rel = sid + 1, 0
        if rel >= max_shot_frames:
            sid, rel = sid + 1, 0
        shot_id[i] = sid
        detect[i] = rel % every == 0
        segment[i] = seg
        rel += 1
    return shot_id, detect, segment


class _ShotAssembler:
    """Accumulates per-batch device gray chunks into whole shots,
    following a precomputed per-frame shot-id plan.

    ``keep_sid`` (optional) restricts assembly to a subset of shot ids:
    frames of other shots are walked (the plan's shot boundaries still
    advance) but accumulate nothing: the multi-worker sharding path
    (``cli/face_cli.py:track``, ``--world``) drops the other workers'
    shots here so their gray slices are never concatenated or scanned.

    A kept slice is a view of its batch's gray tensor and keeps the whole
    batch alive until the shot is flushed: at most ``max_shot_frames`` plus
    one batch of float32 frames.
    """

    def __init__(self, shot_id: np.ndarray, keep_sid=None):
        self._shot_id = shot_id
        self._keep = keep_sid
        self._cur: Optional[int] = None
        self._chunks: List[torch.Tensor] = []  # device gray slices
        self._ts: List[float] = []
        self._dets: Dict[int, List] = {}       # shot-relative frame → boxes

    def _kept(self, sid: int) -> bool:
        return self._keep is None or sid in self._keep

    def _flush(self):
        if not self._ts:
            return None
        grays = (self._chunks[0] if len(self._chunks) == 1
                 else torch.cat(self._chunks, dim=0))
        shot = (grays, np.asarray(self._ts), self._dets)
        self._chunks, self._ts, self._dets = [], [], {}
        return shot

    def add_batch(self, base: int, ts: np.ndarray, n_valid: int, gray_dev,
                  det_by_local: Dict[int, List]) -> List[Tuple]:
        """Feed one batch (grid frames ``base .. base+n_valid``); returns
        completed (grays, ts, detections) shots."""
        out = []
        seg_start = 0
        for i in range(n_valid):
            sid = int(self._shot_id[base + i])
            if self._cur is None:
                self._cur = sid
            elif sid != self._cur:
                if self._kept(self._cur):
                    self._chunks.append(gray_dev[seg_start:i])
                shot = self._flush()
                if shot is not None:
                    out.append(shot)
                seg_start = i
                self._cur = sid
            if self._kept(sid):
                rel = len(self._ts)
                self._ts.append(float(ts[i]))
                if i in det_by_local:
                    self._dets[rel] = det_by_local[i]
        if seg_start < n_valid and self._kept(self._cur):
            self._chunks.append(gray_dev[seg_start:n_valid])
        return out

    def finish(self):
        shot = self._flush()
        return [shot] if shot is not None else []


def _gray_prog(y: torch.Tensor) -> torch.Tensor:
    """Luma plane [B, H, W] uint8 → the scans' gray, a new float32 tensor."""
    return yuv_luma_to_gray(y)


def _det_rgb_prog(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                  idx: torch.Tensor) -> torch.Tensor:
    """The detection frames ``idx`` (a device index tensor) of a batch as
    float32 RGB [n, H, W, 3]."""
    return yuv420_to_rgb(y.index_select(0, idx), u.index_select(0, idx),
                         v.index_select(0, idx))


def stream_tracks(engine, video, segmentation,
                  legs: Optional[StreamLegs] = None,
                  segment_filter=None) -> Iterator[List]:
    """Streaming counterpart of ``TrackingByDetection.__call__``.

    Yields normalized tracks per shot with identical semantics, on
    ``engine.device``; requires the packaged batched detector
    (``engine.detect_func is None``).

    ``segment_filter(i) -> bool`` (optional) restricts tracking to a
    subset of segments by their index in ``segmentation``: the
    multi-worker CLI passes ``i % world == rank``.  The full clip still
    decodes (the plan's frame grid must stay identical to a single-worker
    run so that sharded outputs merge to the same points), but unassigned
    shots are dropped before any detector or scan work.
    """
    if engine.detect_func is not None:
        raise ValueError("the streaming path uses the batched detector; a "
                         "custom detect_func runs through the per-shot engine")
    resolve_device(engine.device)
    return _stream_tracks(engine, video, segmentation,
                          StreamLegs() if legs is None else legs,
                          segment_filter)


def _stream_tracks(engine, video, segmentation, legs, segment_filter):
    from ..models.detector import FaceDetector

    device = engine.device
    if engine._batch_detector is None:
        engine._batch_detector = FaceDetector(device=device)
    detector = engine._batch_detector

    # downscale exactly like the per-shot engine (`tracking.py`) but
    # rounded to EVEN dims (YUV 4:2:0 chroma is 2×2-subsampled)
    width, height = video.size
    ratio = 1.0
    if engine.detect_min_size > 0.0:
        ratio = engine.detect_smallest / (engine.detect_min_size * height)
        ratio = min(1.0, ratio)
    old_frame_size = tuple(video.frame_size)
    fw, fh = _even(int(width * ratio)), _even(int(height * ratio))
    video.frame_size = (fw, fh)

    fps = video.frame_rate
    every = (max(1, int(engine.detect_every * fps))
             if engine.detect_every > 0.0 else 1)

    def tracks_of(shots):
        for grays_shot, ts_shot, dets_shot in shots:
            for track in engine._process_shot_device(
                    grays_shot, ts_shot, dets_shot):
                yield engine._normalize_track(track, fw, fh)

    t_wall = time.perf_counter()
    shot_id, det_flag, seg_of = _shot_plan(video, segmentation,
                                           engine.max_shot_frames, every)
    keep_sid = None
    if segment_filter is not None:
        keep_frame = np.fromiter((segment_filter(int(s)) for s in seg_of),
                                 dtype=bool, count=len(seg_of))
        det_flag = det_flag & keep_frame   # no detector work on dropped shots
        keep_sid = set(shot_id[keep_frame].tolist())
    assembler = _ShotAssembler(shot_id, keep_sid)
    base = 0
    try:
        for ts, (y, u, v) in _stream_batches(video, TRACK_BATCH, legs, device):
            n_valid = len(ts)
            td = time.perf_counter()
            gray = _gray_prog(y)
            det_local = np.nonzero(det_flag[base:base + n_valid])[0]
            scores = boxes = None
            if len(det_local):
                det_rgb = _det_rgb_prog(
                    y, u, v, torch.from_numpy(det_local).to(device))
                scores_d, boxes_d = detector.candidates(det_rgb)
                packed_d = torch.cat([scores_d[..., None], boxes_d], dim=-1)
                legs.dispatch_s += time.perf_counter() - td
                td = time.perf_counter()
                # the one read of the batch: scores and boxes together
                packed = packed_d.cpu().numpy()
                scores, boxes = packed[..., 0], packed[..., 1:]
                legs.sync_s += time.perf_counter() - td
            else:
                legs.dispatch_s += time.perf_counter() - td

            td = time.perf_counter()
            dets: Dict[int, List] = {
                int(i): detector.select(scores[k], boxes[k])
                for k, i in enumerate(det_local)
            }
            shots = assembler.add_batch(base, ts, n_valid, gray, dets)
            base += n_valid
            legs.frames += n_valid
            legs.batches += 1
            legs.host_s += time.perf_counter() - td
            td = time.perf_counter()
            yield from tracks_of(shots)
            legs.scan_s += time.perf_counter() - td
        td = time.perf_counter()
        yield from tracks_of(assembler.finish())
        legs.scan_s += time.perf_counter() - td
    finally:
        video.frame_size = old_frame_size
        legs.wall_s = time.perf_counter() - t_wall


# ---------------------------------------------------------------------------
# extract


@torch.no_grad()
def extract_prog(predictor, embedder, y: torch.Tensor, u: torch.Tensor,
                 v: torch.Tensor, fidx: torch.Tensor, boxes: torch.Tensor,
                 exact_chips: bool = False) -> torch.Tensor:
    """Landmarks, chips and embeddings of the faces ``(fidx, boxes)`` of one
    batch of planes, enqueued without a wait.  Returns [n, 68·2 + 128] on
    the device: each face's landmarks (pixels), then its embedding."""
    from ..models.chip import extract_chips_exact, extract_chips_yuv
    from ..models.landmarks import predict_crops

    gray = yuv_luma_to_gray(y)
    lms = predict_crops(predictor.params, gray, fidx, boxes)
    if exact_chips:
        chips = extract_chips_exact(yuv420_to_rgb(y, u, v), fidx, lms)
    else:
        chips = extract_chips_yuv(y, u, v, fidx, lms)
    embs = embedder.embed_device(chips)
    return torch.cat([lms.reshape(lms.shape[0], -1), embs], dim=1)


def stream_extract(video, points, predictor, embedder,
                   exact_chips: bool = False,
                   legs: Optional[StreamLegs] = None):
    """Streaming counterpart of the CLI's chunked ``extract`` loop.

    One sequential decode pass; faces are grouped by frame on the same
    time grid the track stage used; landmarks + chips + embeddings are
    enqueued per batch without a wait (``extract_prog``), with chips
    sampled straight from the YUV planes
    (``models/chip.py:extract_chips_yuv``: no full-resolution RGB on host
    or device), and come back in one read per ``EXTRACT_FACES`` faces.
    Runs on ``predictor.device``.  Yields ``(t, point, landmarks [68,2]
    px, embedding [128])`` in file order.
    """
    resolve_device(predictor.device)
    return _stream_extract(video, points, predictor, embedder, exact_chips,
                           StreamLegs() if legs is None else legs)


def _stream_extract(video, points, predictor, embedder, exact_chips, legs):
    from ..models.embedder import EMBED_DIM

    device = predictor.device
    frame_width, frame_height = video.frame_size
    # frame index on the iteration grid (`video(T)` reads
    # `read_at(_t_to_index(T))`, the identical rounding)
    by_index: Dict[int, List] = {}
    for p in points:
        by_index.setdefault(video._t_to_index(p.t), []).append(p)

    t_wall = time.perf_counter()
    batch_base = 0
    try:
        for ts, (y, u, v) in _stream_batches(video, TRACK_BATCH, legs, device):
            n_valid = len(ts)
            faces = [(i, p) for i in range(n_valid)
                     for p in by_index.get(batch_base + i, [])]
            batch_base += n_valid
            legs.frames += n_valid
            legs.batches += 1
            for s in range(0, len(faces), EXTRACT_FACES):
                chunk = faces[s:s + EXTRACT_FACES]
                td = time.perf_counter()
                fidx = torch.from_numpy(np.asarray(
                    [i for i, _ in chunk], dtype=np.int64)).to(device)
                boxes = torch.from_numpy(np.asarray(
                    [[p.left * frame_width, p.top * frame_height,
                      p.right * frame_width, p.bottom * frame_height]
                     for _, p in chunk], dtype=np.float32)).to(device)
                packed_d = extract_prog(predictor, embedder, y, u, v, fidx,
                                        boxes, exact_chips)
                legs.dispatch_s += time.perf_counter() - td
                td = time.perf_counter()
                packed = packed_d.cpu().numpy()       # the one read
                legs.sync_s += time.perf_counter() - td
                td = time.perf_counter()
                n_lm = packed.shape[1] - EMBED_DIM
                lms = packed[:, :n_lm].reshape(len(chunk), -1, 2)
                for (_, p), lm, e in zip(chunk, lms, packed[:, n_lm:]):
                    yield p.t, p, lm, e
                legs.host_s += time.perf_counter() - td
    finally:
        legs.wall_s = time.perf_counter() - t_wall
