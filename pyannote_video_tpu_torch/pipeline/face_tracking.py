"""Face tracking: binds the CNN detector to the tracking engine.

Port of ``pyannote_video_tpu/pipeline/face_tracking.py``: the reference's
``FaceTracking`` constructor surface and defaults, with ``detect_smallest``
the CNN window size (40 px).  No per-frame ``detect_func`` closure is
created — the engine runs the detector batched over detection frames
(``pipeline/tracking.py``).
"""

from __future__ import annotations

from ..models.detector import SMALLEST_FACE
from ..utils.device import DeviceLike
from .tracking import TrackingByDetection


class FaceTracking(TrackingByDetection):
    """Face tracking by detection (batched CNN detector + batched DSST)."""

    def __init__(self, detect_min_size: float = 0.0, detect_every: float = 0.0,
                 track_min_confidence: float = 10.0,
                 track_min_overlap_ratio: float = 0.3,
                 track_max_gap: float = 0.0, max_tracks: int = 16,
                 device: DeviceLike = None):
        super().__init__(
            detect_func=None,  # None → batched packaged detector
            detect_smallest=SMALLEST_FACE,
            detect_min_size=detect_min_size,
            detect_every=detect_every,
            track_min_confidence=track_min_confidence,
            track_min_overlap_ratio=track_min_overlap_ratio,
            track_max_gap=track_max_gap,
            max_tracks=max_tracks,
            device=device,
        )
