"""Streaming end to end: decode → YUV420 staging → overlapped
host→device copies → back-to-back device programs.

Port of ``pyannote_video_tpu/io/stream.py``.  A feeder thread decodes video
frames and packs them to planar YUV 4:2:0 (half the bytes of RGB24, the
format codecs emit natively), a second thread ships the planes to the
device, the main thread keeps ``depth`` batches in flight there, and a
user-supplied ``compute(carry, ts, y, u, v) -> (carry, result)`` runs on
batch *k* while batch *k+1* transfers.  The carry threads tracker /
shot-boundary state across batch edges.

On a CUDA device the shipper (``_Shipper``) copies each batch into pinned
staging buffers that are allocated once, enqueues the copies on a side
stream, records an event behind them and waits for that event on its own
thread; the consumer's stream waits for the same event before its first
use of the planes.  Nothing falls back: without pinned memory or without a
card the shipper raises, and an error on a thread reaches the consumer.

Instrumentation: per-leg seconds (decode, pack, transfer-blocked,
compute-blocked) and wall time, so a bench can report pipelining
efficiency and the binding leg rather than a single opaque fps.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from ..ops.color import rgb_to_yuv420
from ..utils.device import DeviceLike, resolve_device


# ---------------------------------------------------------------------------
# host-side packing


def pack_yuv420(frames_rgb: np.ndarray) -> Tuple[np.ndarray, np.ndarray,
                                                 np.ndarray]:
    """RGB uint8 batch [B, H, W, 3] → planar (Y [B,H,W], U, V [B,H/2,W/2]).

    ONE convention on every machine, that of ``ops/color.py:rgb_to_yuv420``
    (limited-range BT.601, chroma as the 2×2 box average, rounded half to
    even), which ``ops/color.py:yuv420_to_rgb`` inverts.  The JAX package
    packs with OpenCV where it is installed, whose planes differ from
    these (luma by ±1, chroma by more on fine texture); the port never
    does, so the same video gives the same planes with or without OpenCV.
    """
    return rgb_to_yuv420(frames_rgb)


def video_yuv_batches(path: str, batch_size: int,
                      drop_last: bool = True) -> Iterator:
    """Decode a video file straight to pre-packed YUV420 batches.

    OpenCV decodes to BGR and packs each frame to I420 while it is still
    cache-hot (BGR→I420 directly, no intermediate RGB pass).  Yields
    ``(timestamps [B], (y [B,H,W], u, v [B,H/2,W/2]))`` for
    ``run_stream(..., pack=False)``.  The planes are OpenCV's, not
    ``pack_yuv420``'s.  Needs ``cv2``; raises ``ImportError`` without it.
    """
    import cv2

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise IOError(f"could not open {path}")
    fps = cap.get(cv2.CAP_PROP_FPS) or 25.0
    ys, us, vs, ts = [], [], [], []
    i = 0
    try:
        while True:
            ok, bgr = cap.read()
            if not ok:
                break
            H, W = bgr.shape[:2]
            i420 = cv2.cvtColor(bgr, cv2.COLOR_BGR2YUV_I420)
            ys.append(i420[:H])
            us.append(i420[H : H + H // 4].reshape(H // 2, W // 2))
            vs.append(i420[H + H // 4 :].reshape(H // 2, W // 2))
            ts.append(i / fps)
            i += 1
            if len(ys) == batch_size:
                yield (np.asarray(ts), (np.stack(ys), np.stack(us),
                                        np.stack(vs)))
                ys, us, vs, ts = [], [], [], []
        if ys and not drop_last:
            yield (np.asarray(ts), (np.stack(ys), np.stack(us),
                                    np.stack(vs)))
    finally:
        cap.release()


def write_yuv_file(path: str, batches: Iterable) -> int:
    """Dump YUV420 batches to a raw I420 stream file; returns frame count.

    Frame layout is ffmpeg's ``-pix_fmt yuv420p`` raw order (Y plane, then
    U, then V) so the file doubles as an ``ffmpeg -f rawvideo`` input.
    """
    n = 0
    with open(path, "wb") as fh:
        for _, (y, u, v) in batches:
            for b in range(y.shape[0]):
                fh.write(y[b].tobytes())
                fh.write(u[b].tobytes())
                fh.write(v[b].tobytes())
                n += 1
    return n


def yuv_file_batches(path: str, height: int, width: int, batch_size: int,
                     fps: float = 25.0, drop_last: bool = True) -> Iterator:
    """Read a raw I420 stream file as pre-packed YUV420 batches.

    The pre-decoded source: models a production decoder (multi-core ffmpeg
    ``-pix_fmt yuv420p`` pipe, a hardware decoder's output) handing planar
    frames to the ingest, so a streaming bench can separate the decode leg
    from the transfer/compute legs this package owns.  Yields
    ``(timestamps [B], (y [B,H,W], u, v [B,H/2,W/2]))`` for
    ``run_stream(..., pack=False)``.
    """
    ysz = height * width
    csz = (height // 2) * (width // 2)
    fsz = ysz + 2 * csz
    i = 0
    with open(path, "rb") as fh:
        while True:
            raw = np.fromfile(fh, dtype=np.uint8, count=fsz * batch_size)
            n = raw.size // fsz
            if n == 0:
                break
            if n < batch_size and drop_last:
                break
            raw = raw[: n * fsz].reshape(n, fsz)
            y = raw[:, :ysz].reshape(n, height, width)
            u = raw[:, ysz : ysz + csz].reshape(n, height // 2, width // 2)
            v = raw[:, ysz + csz :].reshape(n, height // 2, width // 2)
            ts = (np.arange(i, i + n)) / fps
            i += n
            yield ts, (y, u, v)
            if n < batch_size:
                break


# ---------------------------------------------------------------------------
# instrumentation


@dataclass
class StreamStats:
    """Per-leg accounting for one streaming run."""

    frames: int = 0
    batches: int = 0
    bytes_shipped: int = 0
    decode_s: float = 0.0      # packer thread: source read time
    pack_s: float = 0.0        # packer thread: RGB→YUV420 packing time
    transfer_s: float = 0.0    # shipper thread: staging + copy + completion
    feed_wait_s: float = 0.0   # main thread blocked waiting for batches
    compute_s: float = 0.0     # main thread blocked in dispatch+sync
    wall_s: float = 0.0
    legs: dict = field(default_factory=dict)  # isolated leg rates (optional)
    pinned_bytes: int = 0      # staging buffers the shipper held (CUDA only)

    @property
    def fps(self) -> float:
        return self.frames / self.wall_s if self.wall_s else 0.0

    @property
    def transfer_gbps(self) -> float:
        return (self.bytes_shipped / self.wall_s / 1e9) if self.wall_s else 0.0

    def as_dict(self) -> dict:
        d = {
            "frames": self.frames,
            "batches": self.batches,
            "wall_s": round(self.wall_s, 3),
            "fps": round(self.fps, 1),
            "shipped_gb": round(self.bytes_shipped / 1e9, 3),
            "decode_s": round(self.decode_s, 3),
            "pack_s": round(self.pack_s, 3),
            "transfer_s": round(self.transfer_s, 3),
            "feed_wait_s": round(self.feed_wait_s, 3),
            "compute_blocked_s": round(self.compute_s, 3),
        }
        if self.legs:
            d["legs"] = self.legs
        return d


# ---------------------------------------------------------------------------
# feeder threads


_SENTINEL = object()


class _Stage:
    """One pipeline stage: apply ``fn`` to upstream items on a thread.

    The bounded output queue gives backpressure: a stage never runs more
    than ``depth`` items ahead, so peak host memory is depth × batch bytes
    per stage.  Whatever the thread raises (a decoder's error, a CUDA
    error of the shipper) is kept and raised again in the consumer when it
    reaches the end of the queue.  The packer runs as torch CPU operations
    and the shipper waits in the CUDA runtime, both with the interpreter
    lock released, so decode, transfer and compute overlap.
    """

    def __init__(self, upstream: Iterable, fn: Callable, depth: int):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._fn = fn
        self._err: Optional[BaseException] = None
        self.pull_s = 0.0   # time spent in upstream next() (incl. waits)
        self.busy_s = 0.0   # time spent inside fn
        self.wait_s = 0.0   # consumer time blocked on this stage's queue
        self._thread = threading.Thread(
            target=self._run, args=(iter(upstream),), daemon=True)
        self._thread.start()

    def _run(self, it: Iterator) -> None:
        try:
            while True:
                t0 = time.perf_counter()
                try:
                    item = next(it)
                except StopIteration:
                    break
                t1 = time.perf_counter()
                out = self._fn(item)
                t2 = time.perf_counter()
                self.pull_s += t1 - t0
                self.busy_s += t2 - t1
                self._q.put(out)
        except BaseException as e:  # raised again in the consumer
            self._err = e
        finally:
            self._q.put(_SENTINEL)

    def __iter__(self):
        while True:
            t0 = time.perf_counter()
            item = self._q.get()
            self.wait_s += time.perf_counter() - t0
            if item is _SENTINEL:
                if self._err is not None:
                    raise self._err
                return
            yield item


class _Shipper:
    """Host planes → device tensors; the counterpart of ``jax.device_put``
    followed by a read back that forces the copy.

    ``put`` runs on the shipper's thread, ``take`` on the consumer's.  On a
    CUDA device ``put`` copies the planes into the next slot of a ring of
    ``depth + 1`` pinned staging buffers (allocated once, at the first
    batch's shape; a shorter batch uses a slice), enqueues the
    ``non_blocking`` copies on a side stream, records an event behind them
    and waits for it, so that the time spent in ``put`` is the transfer's.
    A slot is refilled only after its own event has completed.  The device
    tensors are allocated while the side stream is current and are used on
    the consumer's stream, so ``take`` marks each with ``record_stream``
    (the caching allocator then hands its memory out again only after the
    consumer's work on it) and makes the consumer's stream wait for the
    event.  On the CPU the planes are wrapped without a copy.
    """

    def __init__(self, device: torch.device, depth: int):
        self._slots: list = [None] * (depth + 1)
        self._next = 0
        if device.type == "cuda":
            if device.index is None:
                device = torch.device("cuda", torch.cuda.current_device())
            self._side = torch.cuda.Stream(device)
        self.device = device

    @property
    def pinned_bytes(self) -> int:
        return sum(b.numel() for slot in self._slots if slot is not None
                   for b in slot["buffers"])

    def _slot(self, planes):
        """The next ring slot, free to be refilled, fit to hold ``planes``."""
        k = self._next
        self._next = (k + 1) % len(self._slots)
        slot = self._slots[k]
        if slot is not None:
            slot["event"].synchronize()
        if slot is None or any(
                b.shape[1:] != p.shape[1:] or b.shape[0] < p.shape[0]
                for b, p in zip(slot["buffers"], planes)):
            buffers = [torch.empty(p.shape, dtype=torch.uint8, pin_memory=True)
                       for p in planes]
            if not all(b.is_pinned() for b in buffers):
                raise RuntimeError("the staging buffers are not pinned")
            slot = self._slots[k] = {"buffers": buffers,
                                     "event": torch.cuda.Event()}
        return slot

    def put(self, planes):
        """(y, u, v) uint8 numpy arrays → what ``take`` turns into tensors."""
        # a strided plane (a view into a file's frames) is taken as it is:
        # the copy into the pinned slot is the one pass over its bytes
        host = [torch.from_numpy(p) for p in planes]
        if self.device.type != "cuda":
            return [h.contiguous() for h in host], None
        torch.cuda.set_device(self.device)       # the device is per thread
        slot = self._slot(host)
        staged = [b[: p.shape[0]].copy_(p) for b, p in zip(slot["buffers"], host)]
        with torch.cuda.stream(self._side):
            dev = [s.to(self.device, non_blocking=True) for s in staged]
            slot["event"].record(self._side)
        slot["event"].synchronize()
        return dev, slot["event"]

    def take(self, shipped):
        """The planes as device tensors, safe to use on the current stream."""
        dev, event = shipped
        if event is not None:
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(event)
            for d in dev:
                d.record_stream(consumer)
        return tuple(dev)


def _first_tensor(res):
    """The first tensor of a nested result (tuples, lists, dicts)."""
    if isinstance(res, torch.Tensor):
        return res
    if isinstance(res, dict):
        res = list(res.values())
    if isinstance(res, (tuple, list)):
        for r in res:
            leaf = _first_tensor(r)
            if leaf is not None:
                return leaf
    return None


def _sync_first(res) -> float:
    """Force one result: read back one element of its first tensor."""
    return float(_first_tensor(res).reshape(-1)[0])


# ---------------------------------------------------------------------------
# the stream loop


def run_stream(batches: Iterable,
               compute: Callable,
               carry,
               depth: int = 2,
               pack: bool = True,
               sync: Optional[Callable] = None,
               device: DeviceLike = None) -> Tuple[object, list,
                                                   StreamStats]:
    """Drive ``compute`` over a stream of frame batches, overlapped.

    batches  iterable of ``(timestamps [B], frames [B, H, W, 3] uint8)``
             (or pre-packed ``(ts, (y, u, v))`` with ``pack=False``);
    compute  ``(carry, ts, y, u, v) -> (carry, result)``, y/u/v uint8
             tensors on the device: it must only enqueue device work and
             return device tensors (no blocking);
    carry    initial carry (e.g. ``(dsst.init_state(N), prev_gray)``);
    depth    device batches kept in flight (2 = classic double buffer);
    sync     optional ``result -> float`` forcing completion of one
             result (defaults to a 1-element readback of the first tensor);
    device   ``cuda`` unless ``"cpu"`` is asked for.

    Returns ``(final_carry, results, stats)``.  Three threads pipeline
    the legs (decode+pack, host→device transfer, compute+sync) so wall
    time approaches the slowest leg, not the sum.
    """
    device = resolve_device(device)
    stats = StreamStats()
    if sync is None:
        sync = _sync_first
    ship = _Shipper(device, depth)

    def do_pack(item):
        ts, frames = item
        planes = pack_yuv420(frames) if pack else frames
        return ts, planes

    def do_put(item):
        ts, (y, u, v) = item
        stats.bytes_shipped += y.nbytes + u.nbytes + v.nbytes
        return ts, ship.put((y, u, v)), int(y.shape[0])

    t_start = time.perf_counter()
    packer = _Stage(batches, do_pack, depth)
    shipper = _Stage(packer, do_put, depth)

    inflight: list = []   # dispatched, unsynced results
    results: list = []
    for ts, shipped, n in shipper:
        td0 = time.perf_counter()
        dy, du, dv = ship.take(shipped)
        carry, res = compute(carry, ts, dy, du, dv)
        stats.compute_s += time.perf_counter() - td0
        stats.frames += n
        stats.batches += 1
        inflight.append(res)
        if len(inflight) > depth:
            td0 = time.perf_counter()
            done = inflight.pop(0)
            sync(done)
            stats.compute_s += time.perf_counter() - td0
            results.append(done)
    for done in inflight:
        td0 = time.perf_counter()
        sync(done)
        stats.compute_s += time.perf_counter() - td0
        results.append(done)

    stats.wall_s = time.perf_counter() - t_start
    stats.decode_s = packer.pull_s    # upstream next() does the decode
    stats.pack_s = packer.busy_s
    stats.transfer_s = shipper.busy_s
    stats.feed_wait_s = shipper.wait_s
    stats.pinned_bytes = ship.pinned_bytes
    return carry, results, stats


# ---------------------------------------------------------------------------
# leg isolation + projection helpers (for a bench)


def isolate_legs(batches: list, compute: Callable, carry,
                 sync: Optional[Callable] = None, pack: bool = True,
                 device: DeviceLike = None) -> dict:
    """Measure each pipeline leg alone on a fixed in-RAM batch list of
    ``(timestamps, frames [B, H, W, 3] uint8)``, or of pre-packed
    ``(timestamps, (y, u, v))`` with ``pack=False`` (no pack leg then).

    Returns per-leg seconds for: pack (host; decode is the caller's
    source-specific cost), transfer (every batch through the shipper, its
    pinned staging included, each copy waited for), compute (inputs
    already on the device, one sync per batch).  The overlapped wall time
    from `run_stream` divided into these gives the pipelining efficiency:
    wall ≈ max(legs) is perfect overlap, wall ≈ sum(legs) is none.
    """
    device = resolve_device(device)
    if sync is None:
        sync = _sync_first

    t0 = time.perf_counter()
    packed = [(ts, pack_yuv420(frames) if pack else frames)
              for ts, frames in batches]
    t_pack = time.perf_counter() - t0

    # every batch stays on the device for the compute leg
    ship = _Shipper(device, depth=1)
    t0 = time.perf_counter()
    dev = [(ts, ship.take(ship.put(planes))) for ts, planes in packed]
    t_transfer = time.perf_counter() - t0

    t0 = time.perf_counter()
    c = carry
    for ts, (dy, du, dv) in dev:
        c, res = compute(c, ts, dy, du, dv)
        sync(res)
    t_compute = time.perf_counter() - t0

    n_frames = sum(int(y.shape[0]) for _, (y, _, _) in packed)
    gb = sum(y.nbytes + u.nbytes + v.nbytes
             for _, (y, u, v) in packed) / 1e9
    return {
        "pack_s": round(t_pack, 3),
        "transfer_s": round(t_transfer, 3),
        "compute_s": round(t_compute, 3),
        "pack_fps": round(n_frames / t_pack, 1) if pack else None,
        "transfer_fps": round(n_frames / t_transfer, 1),
        "transfer_gbps": round(gb / t_transfer, 5),
        "compute_fps": round(n_frames / t_compute, 1),
    }


def pipelining_efficiency(wall_s: float, leg_seconds: Iterable[float]
                          ) -> float:
    """1.0 = wall equals the slowest leg (perfect overlap); 0.0 = legs
    ran strictly serially (wall equals their sum)."""
    legs = [s for s in leg_seconds if s > 0]
    if not legs:
        return 1.0
    total, worst = sum(legs), max(legs)
    if total - worst <= 1e-9:
        return 1.0
    return max(0.0, min(1.0, (total - wall_s) / (total - worst)))


def project_fps(bytes_per_frame: float, compute_fps: float,
                link_gbps: float, decode_fps: Optional[float] = None
                ) -> float:
    """Sustained fps on a host whose device link runs at ``link_gbps``,
    assuming the measured compute rate and perfect overlap: min over the
    legs."""
    transfer_fps = link_gbps * 1e9 / bytes_per_frame
    legs = [compute_fps, transfer_fps]
    if decode_fps:
        legs.append(decode_fps)
    return min(legs)
