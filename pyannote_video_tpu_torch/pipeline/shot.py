"""Shot boundary detection — batched displaced-frame difference.

Port of ``pyannote_video_tpu/pipeline/shot.py``: same constructor surface
``Shot(video, height=50, context=2.0, threshold=1.0)``, same output (an
iterable of ``Segment`` shots), same decision rule (median-filter
normalisation + threshold with consecutive-crossing suppression,
pyannote-video `structure/shot.py:119-147`).  Per frame chunk the device
converts and resizes the frames to gray (``ops/color.py``) and runs the
DFD kernel (``ops/dfd.py``) over the ``[T, h, w]`` stack.

Note: pyannote-video passes ``(height, w*height/h)`` as OpenCV's
``(width, height)`` dsize, so it actually produces *width*-50 frames
(`shot.py:62,73`).  Like the JAX package, this implements the intended
semantics (output height = ``height``); the DFD statistic is
orientation-agnostic so decisions are unaffected.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..core import Segment
from ..io.video import Video
from ..ops.color import ingest_gray
from ..ops.dfd import dfd_series
from ..ops.medfilt import medfilt1d
from ..utils.device import DeviceLike, resolve_device


class Shot:
    """Shot boundary detection based on displaced frame difference.

    Parameters
    ----------
    video : Video
    height : int, optional
        Frames are resized to this height before the DFD. Defaults to 50.
    context : float, optional
        Median filtering context in seconds. Defaults to 2.
    threshold : float, optional
        Normalised-DFD threshold. Defaults to 1.
    radius, block : int, optional
        Block-matching search radius / block size of the DFD kernel.
    batch_size : int, optional
        Frames per host→device chunk.
    method : str, optional
        Only ``"block"`` (the block-matching DFD) is ported.
    noise_floor : float, optional
        Additive floor of the median normalisation's denominator, in DFD
        units (``0.0`` restores the bare ``(y - med)/med`` rule).
    device : str or torch.device, optional
        Where the work runs; ``cuda`` unless ``"cpu"`` is asked for.
    """

    def __init__(self, video: Video, height: int = 50, context: float = 2.0,
                 threshold: float = 1.0, radius: int = 3, block: int = 5,
                 batch_size: int = 256, pad_mode: str = "reflect",
                 method: str = "block", subpixel: bool = True,
                 noise_floor: float = 1.0, device: DeviceLike = None):
        if method == "farneback":
            raise NotImplementedError(
                "method='farneback' is not ported to PyTorch yet "
                "(ROADMAP: 'Farneback shot method')")
        if method != "block":
            raise ValueError(f"unknown DFD method: {method}")
        self.device = resolve_device(device)
        self.video = video
        self.pad_mode = pad_mode
        self.subpixel = subpixel
        self.noise_floor = noise_floor
        self.method = method
        self.height = height
        self.context = context
        self.threshold = threshold
        self.radius = radius
        self.block = block
        self.batch_size = batch_size

        w, h = self.video.size
        self._out_h = height
        self._out_w = max(self.block, int(round(w * height / h)))

        # kernel size: odd, >= 3, ~ context/step (pyannote-video `shot.py:64-67`)
        kernel_size = self.context / self.video.step
        self._kernel_size = max(3, int(np.ceil(kernel_size) // 2 * 2 + 1))

    # -- device work --------------------------------------------------------

    def _dfd_device(self) -> Tuple[np.ndarray, Optional[torch.Tensor]]:
        """The DFD series over the whole video, chunked, kept on the device.

        Returns ``(timestamps, dfd)``; ``timestamps[i]`` is the time of the
        *second* frame of pair ``i`` (pyannote-video's ``iter_dfd``
        convention, `shot.py:101-117`).  The last gray frame of a chunk is
        carried into the next one, so the pair across a chunk edge counts.
        """
        ts_out: List[np.ndarray] = []
        dfd_out: List[torch.Tensor] = []
        carry: Optional[torch.Tensor] = None

        for ts, frames in self.video.iterbatches(self.batch_size):
            gray = ingest_gray(torch.from_numpy(frames).to(self.device),
                               self._out_h, self._out_w)
            if carry is not None:
                gray = torch.cat([carry[None], gray], dim=0)
                pair_ts = ts
            else:
                pair_ts = ts[1:]
            if gray.shape[0] >= 2:
                dfd_out.append(dfd_series(gray, radius=self.radius,
                                          block=self.block,
                                          subpixel=self.subpixel))
                ts_out.append(np.asarray(pair_ts))
            carry = gray[-1]

        if not dfd_out:
            return np.empty(0), None
        return np.concatenate(ts_out), torch.cat(dfd_out)

    def dfd_values(self) -> Tuple[np.ndarray, np.ndarray]:
        """``(timestamps, dfd)`` as host arrays (see ``_dfd_device``)."""
        ts, dfd = self._dfd_device()
        if dfd is None:
            return ts, np.empty(0)
        return ts, dfd.cpu().numpy()

    def iter_dfd(self) -> Iterator[Tuple[float, float]]:
        """Pairwise DFD as (t, value) pairs — pyannote-video's surface."""
        ts, dfd = self.dfd_values()
        for t, v in zip(ts, dfd):
            yield float(t), float(v)

    # -- decision rule (pyannote-video semantics, `shot.py:119-147`) --------

    def boundaries(self) -> Tuple[np.ndarray, np.ndarray]:
        """(timestamps, normalized DFD series) after median normalisation."""
        ts, dfd = self._dfd_device()
        if dfd is None:
            return ts, np.empty(0)
        filtered = medfilt1d(dfd, self._kernel_size, mode=self.pad_mode)
        y, filtered = dfd.cpu().numpy(), filtered.cpu().numpy()
        denom = filtered + self.noise_floor
        normalized = (y - filtered) / np.where(denom == 0.0, 1e-12, denom)
        return ts, normalized

    def __iter__(self) -> Iterator[Segment]:
        ts, normalized = self.boundaries()

        previous = self.video.start
        if len(normalized):
            # threshold with consecutive-crossing suppression; the `_i = 0`
            # initialisation (which also suppresses a crossing at index 1)
            # reproduces pyannote-video exactly (`shot.py:132-143`)
            _i = 0
            for i in np.where(normalized > self.threshold)[0]:
                if i == _i + 1:
                    _i = i
                    continue
                yield Segment(previous, float(ts[i]))
                previous = float(ts[i])
                _i = i

        last_segment = Segment(previous, self.video.end)
        if last_segment:
            yield last_segment
