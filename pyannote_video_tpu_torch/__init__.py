"""pyannote-video on PyTorch and CUDA: the port of ``pyannote_video_tpu``.

A second package beside the JAX one, which stays as the reference.  It
imports ``torch`` and numpy and nothing of JAX or of ``pyannote_video_tpu``
(the host-only modules it needs are copied here).  The layout mirrors the
JAX package (``core/``, ``io/``, ``ops/``, ``models/``, ``pipeline/``,
``cli/``, ``utils/``) so each module's counterpart is easy to find.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; without a card they raise instead of falling back.
"""

try:  # single source of truth: pyproject.toml [project] version
    from importlib.metadata import version as _pkg_version

    __version__ = _pkg_version("pyannote-video-tpu")
except Exception:  # not installed (running from a source checkout)
    import pathlib as _pathlib
    import re as _re

    try:
        _pyproject = (_pathlib.Path(__file__).resolve().parent.parent
                      / "pyproject.toml").read_text()
        __version__ = _re.search(
            r'^version\s*=\s*"([^"]+)"', _pyproject, _re.M
        ).group(1)
    except Exception:
        __version__ = "0.0.0+unknown"

from .core import Annotation, Segment, Timeline  # host-only, cheap

_LAZY = {
    "Video": ("pyannote_video_tpu_torch.io.video", "Video"),
    "Shot": ("pyannote_video_tpu_torch.pipeline.shot", "Shot"),
    "Thread": ("pyannote_video_tpu_torch.pipeline.thread", "Thread"),
    "FaceDetector": ("pyannote_video_tpu_torch.models.detector", "FaceDetector"),
    "TrackingByDetection": ("pyannote_video_tpu_torch.pipeline.tracking",
                            "TrackingByDetection"),
    "FaceTracking": ("pyannote_video_tpu_torch.pipeline.face_tracking",
                     "FaceTracking"),
    "FaceClustering": ("pyannote_video_tpu_torch.pipeline.clustering",
                       "FaceClustering"),
    "Face": ("pyannote_video_tpu_torch.pipeline.face", "Face"),
}

__all__ = ["__version__", "Annotation", "Segment", "Timeline"] + list(_LAZY)


def __getattr__(name):
    if name in _LAZY:
        import importlib

        module, attr = _LAZY[name]
        value = getattr(importlib.import_module(module), attr)
        globals()[name] = value
        return value
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
