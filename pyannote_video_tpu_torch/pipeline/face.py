"""Face processing facade: detection + landmarks + embedding.

Port of ``pyannote_video_tpu/pipeline/face.py``, the surface of
``pyannote.video.Face`` (`face/face.py:38-132`): ``iterfaces``,
``get_landmarks``, ``get_embedding``, ``__call__``, backed by the port's
models instead of dlib.  These are single-face convenience methods; bulk
work goes through ``cli/face_cli.py:extract``.
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from ..utils.device import DeviceLike, resolve_device

SMALLEST_FACE = 40  # px — CNN detection window (dlib HOG used 36,
                    # reference `face/face.py:35`)


class BoundingBox:
    """dlib-rectangle-compatible box (``.left()`` etc. accessors,
    used by the reference's detect wrapper `face/tracking.py:41`)."""

    __slots__ = ("_l", "_t", "_r", "_b")

    def __init__(self, left: float, top: float, right: float, bottom: float):
        self._l, self._t, self._r, self._b = left, top, right, bottom

    def left(self) -> float:
        return self._l

    def top(self) -> float:
        return self._t

    def right(self) -> float:
        return self._r

    def bottom(self) -> float:
        return self._b

    def width(self) -> float:
        return self._r - self._l

    def height(self) -> float:
        return self._b - self._t

    def __iter__(self):
        return iter((self._l, self._t, self._r, self._b))

    def __repr__(self):
        return f"BoundingBox({self._l:.1f}, {self._t:.1f}, {self._r:.1f}, {self._b:.1f})"


class Landmarks:
    """dlib-shape-compatible landmark set (``.parts()`` / ``.part(i)``)."""

    def __init__(self, points: np.ndarray):
        self._points = np.asarray(points, dtype=np.float32)

    def parts(self) -> np.ndarray:
        return self._points

    def part(self, i: int) -> Tuple[float, float]:
        return tuple(self._points[i])

    def num_parts(self) -> int:
        return len(self._points)


class Face:
    """Face processing (detection + optional landmarks/embedding models).

    Parameters
    ----------
    landmarks : str, optional
        Path to a landmark-model .npz (ERT cascade).  Without it, landmarks
        fall back to the mean shape placed in the detection box.
    embedding : str, optional
        Path to an embedder .npz (defaults to packaged weights when
        embeddings are requested).
    detector : str, optional
        Path to a detector .npz (defaults to packaged weights).
    device : str or torch.device, optional
        ``cuda`` unless ``"cpu"`` is asked for.
    """

    def __init__(self, landmarks: Optional[str] = None,
                 embedding: Optional[str] = None,
                 detector: Optional[str] = None,
                 threshold: float = 0.0, upsample: int = 0,
                 device: DeviceLike = None):
        from ..models.detector import FaceDetector

        self.device = resolve_device(device)
        self.face_detector_ = FaceDetector(
            model_path=detector, threshold=threshold, upsample=upsample,
            device=self.device,
        )
        self._landmark_model = None
        if landmarks is not None:
            from ..models.landmarks import LandmarkPredictor

            self._landmark_model = LandmarkPredictor(landmarks,
                                                     device=self.device)
        self._embedder = None
        self._embedding_path = embedding

    # -- reference surface --------------------------------------------------

    def iterfaces(self, rgb: np.ndarray) -> Iterator[BoundingBox]:
        """Iterate over detected faces (`face/face.py:64-67`)."""
        for box in self.face_detector_(np.asarray(rgb)):
            yield BoundingBox(*box)

    def get_landmarks(self, rgb: np.ndarray, face: BoundingBox) -> Landmarks:
        box = np.asarray([list(face)], dtype=np.float32)
        if self._landmark_model is not None:
            pts = self._landmark_model.predict_batch(
                np.asarray(rgb)[None], np.asarray([0]), box
            )[0]
        else:
            from ..models.chip import box_to_landmarks

            pts = box_to_landmarks(torch.from_numpy(box)).numpy()[0]
        return Landmarks(pts)

    def get_embedding(self, rgb: np.ndarray, landmarks: Landmarks) -> np.ndarray:
        from ..models.chip import extract_chips

        if self._embedder is None:
            from ..models.embedder import FaceEmbedder

            self._embedder = FaceEmbedder(self._embedding_path or None,
                                          device=self.device)
        chips = extract_chips(
            torch.from_numpy(np.asarray(rgb)[None]).to(self.device),
            torch.zeros(1, dtype=torch.long, device=self.device),
            torch.from_numpy(landmarks.parts()[None]).to(self.device),
        )
        return self._embedder(chips)[0]

    def get_debug(self, image: np.ndarray, face: BoundingBox,
                  landmarks: Landmarks, size: int = 150) -> np.ndarray:
        """Face crop with landmarks overlaid (reference `face/face.py:78-87`;
        the reference referenced an undefined ``self.size`` — fixed here
        with an explicit ``size`` parameter)."""
        from ..utils.imops import bilinear_resize

        copy = np.array(image)
        h, w = copy.shape[:2]
        for x, y in np.asarray(landmarks.parts()):
            xi, yi = int(round(x)), int(round(y))
            if 0 <= yi < h and 0 <= xi < w:
                copy[max(0, yi - 1) : yi + 2, max(0, xi - 1) : xi + 2] = (
                    0, 255, 0,
                )
        top = max(0, int(face.top()))
        bottom = min(h, int(face.bottom()))
        left = max(0, int(face.left()))
        right = min(w, int(face.right()))
        crop = copy[top:bottom, left:right]
        return bilinear_resize(crop, size, size)

    def __call__(self, rgb, return_landmarks=False, return_embedding=False):
        """Iterate over faces with optional landmarks/embedding
        (`face/face.py:89-132`)."""
        for face in self.iterfaces(rgb):
            if not (return_landmarks or return_embedding):
                yield face
                continue
            result = (face,)
            landmarks = self.get_landmarks(rgb, face)
            if return_landmarks:
                result = result + (landmarks,)
            if return_embedding:
                result = result + (self.get_embedding(rgb, landmarks),)
            yield result
