"""Device feeding: double-buffered host→device batch prefetch.

Port of ``pyannote_video_tpu/io/batch.py``.  The host→device transfer of
raw frame batches is a throughput floor if serialized with compute.
``prefetch_to_device`` keeps N batches in flight: while the device computes
on batch k, batch k+1 is already transferring, from pinned memory on a side
stream.  For the full three-thread streaming pipeline with YUV420 packing
and per-leg instrumentation, see `io/stream.py`.
"""

from __future__ import annotations

from collections import deque
from typing import Iterable, Iterator, Tuple

import numpy as np
import torch

from ..utils.device import DeviceLike, resolve_device


def _map_arrays(fn, item):
    """``fn`` applied to every numpy array in nested tuples, lists and
    dicts; anything else is passed through."""
    if isinstance(item, np.ndarray):
        return fn(item)
    if isinstance(item, (tuple, list)):
        return type(item)(_map_arrays(fn, x) for x in item)
    if isinstance(item, dict):
        return {k: _map_arrays(fn, v) for k, v in item.items()}
    return item


def prefetch_to_device(iterator: Iterable, size: int = 2,
                       device: DeviceLike = None) -> Iterator:
    """Yield items with up to `size` already on their way to the device.

    Items may be arrays or (timestamps, frames) tuples; numpy arrays inside
    become tensors on ``device`` (``cuda`` unless ``"cpu"`` is asked for).
    On a CUDA device each array is copied from pinned memory on a side
    stream, without a wait; the consumer's stream waits for an item's
    copies when the item is yielded, so its kernels may use the tensors at
    once.  The device is checked when this is called, not at the first item.
    """
    device = resolve_device(device)
    queue: deque = deque()
    side = torch.cuda.Stream(device) if device.type == "cuda" else None

    def put(item):
        if side is None:
            return _map_arrays(torch.from_numpy, item), None, []
        shipped = []

        def ship(x):
            shipped.append(torch.from_numpy(x).pin_memory().to(
                device, non_blocking=True))
            return shipped[-1]

        with torch.cuda.stream(side):
            out = _map_arrays(ship, item)
            event = torch.cuda.Event()
            event.record(side)
        return out, event, shipped

    def take(entry):
        out, event, shipped = entry
        if event is not None:
            consumer = torch.cuda.current_stream(device)
            consumer.wait_event(event)
            for t in shipped:     # allocated on the side stream, used here
                t.record_stream(consumer)
        return out

    def prefetched():
        it = iter(iterator)
        try:
            for _ in range(size):
                queue.append(put(next(it)))
        except StopIteration:
            pass
        while queue:
            out = take(queue.popleft())
            try:
                queue.append(put(next(it)))
            except StopIteration:
                pass
            yield out

    return prefetched()


def device_batches(video, batch_size: int, prefetch: int = 2,
                   device: DeviceLike = None,
                   **kwargs) -> Iterator[Tuple[np.ndarray, torch.Tensor]]:
    """Video → device-resident (timestamps, frames) batches, prefetched."""
    return prefetch_to_device(video.iterbatches(batch_size, **kwargs),
                              size=prefetch, device=device)
