"""Temporal structures: Segment, Timeline, Annotation.

Copy of ``pyannote_video_tpu/core/segment.py`` (the subset of
``pyannote.core`` that pyannote-video uses: `structure/shot.py:34`,
`structure/thread.py:34`, the CLIs), kept here so the port imports nothing
of the JAX package.  The JSON
(de)serialization schema matches ``pyannote.core.json`` bit-for-bit so files
produced by either implementation interoperate.

These are pure-host data structures: tiny, metadata-sized, never on the hot
path.  All heavy per-pixel / per-frame work lives in ``ops/`` and ``models/``.
"""

from __future__ import annotations

import itertools
import json as _json
import string
from dataclasses import dataclass
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

PYANNOTE_JSON = "pyannote"
PYANNOTE_JSON_CONTENT = "content"


@dataclass(frozen=True, order=True)
class Segment:
    """A time interval ``[start, end)`` in seconds.

    Mirrors ``pyannote.core.Segment`` semantics: ordering is by
    ``(start, end)``; truthiness is "has strictly positive duration"
    (used by the reference at `structure/shot.py:145-147`).
    """

    start: float = 0.0
    end: float = 0.0

    @property
    def duration(self) -> float:
        return self.end - self.start if self.end > self.start else 0.0

    @property
    def middle(self) -> float:
        return 0.5 * (self.start + self.end)

    def __bool__(self) -> bool:
        return self.end - self.start > 0

    def __and__(self, other: "Segment") -> "Segment":
        """Intersection (may be empty)."""
        start = max(self.start, other.start)
        end = min(self.end, other.end)
        return Segment(start, max(start, end)) if end > start else Segment(start, start)

    def intersects(self, other: "Segment") -> bool:
        return self.start < other.end and other.start < self.end

    def overlaps(self, t: float) -> bool:
        return self.start <= t <= self.end

    def __contains__(self, other: "Segment") -> bool:
        return self.start <= other.start and self.end >= other.end

    def __or__(self, other: "Segment") -> "Segment":
        """Union hull."""
        if not self:
            return other
        if not other:
            return self
        return Segment(min(self.start, other.start), max(self.end, other.end))

    def __str__(self) -> str:
        return f"[{self.start:.3f} --> {self.end:.3f}]"

    def for_json(self) -> dict:
        return {PYANNOTE_JSON: "Segment", "start": self.start, "end": self.end}

    @classmethod
    def from_json(cls, data) -> "Segment":
        if isinstance(data, Segment):
            return data
        return cls(start=data["start"], end=data["end"])


class Timeline:
    """Ordered collection of segments (duplicates removed, kept sorted).

    Mirrors the ``pyannote.core.Timeline`` surface used by the reference:
    construction from an iterable of segments
    (`scripts/pyannote-structure.py:68`), iteration, JSON round-trip.
    """

    def __init__(self, segments: Optional[Iterable[Segment]] = None, uri: Optional[str] = None):
        self.uri = uri
        self._segments: List[Segment] = sorted(set(segments or ()))

    def add(self, segment: Segment) -> "Timeline":
        if segment not in set(self._segments):
            self._segments = sorted(set(self._segments) | {segment})
        return self

    def __iter__(self) -> Iterator[Segment]:
        return iter(self._segments)

    def __len__(self) -> int:
        return len(self._segments)

    def __eq__(self, other) -> bool:
        return isinstance(other, Timeline) and self._segments == other._segments

    def __getitem__(self, i: int) -> Segment:
        return self._segments[i]

    def extent(self) -> Segment:
        if not self._segments:
            return Segment(0.0, 0.0)
        return Segment(min(s.start for s in self._segments), max(s.end for s in self._segments))

    def support(self) -> "Timeline":
        """Merge overlapping or contiguous segments."""
        merged: List[Segment] = []
        for s in self._segments:
            if merged and s.start <= merged[-1].end:
                merged[-1] = Segment(merged[-1].start, max(merged[-1].end, s.end))
            else:
                merged.append(s)
        return Timeline(merged, uri=self.uri)

    def for_json(self) -> dict:
        data = {
            PYANNOTE_JSON: "Timeline",
            PYANNOTE_JSON_CONTENT: [s.for_json() for s in self._segments],
        }
        if self.uri is not None:
            data["uri"] = self.uri
        return data

    @classmethod
    def from_json(cls, data: dict) -> "Timeline":
        segments = [Segment.from_json(s) for s in data[PYANNOTE_JSON_CONTENT]]
        return cls(segments, uri=data.get("uri"))


def string_generator() -> Iterator[str]:
    """'A', 'B', ..., 'Z', 'AA', 'AB', ... — label generator.

    Same sequence as ``pyannote.core.utils.generators.string_generator``
    used for thread labels (`structure/thread.py:214`).
    """
    for repeat in itertools.count(1):
        for letters in itertools.product(string.ascii_uppercase, repeat=repeat):
            yield "".join(letters)


class Annotation:
    """Segment × track → label mapping.

    Mirrors the ``pyannote.core.Annotation`` surface used by the reference:
    ``annotation[segment] = label`` (default track '_',
    `structure/thread.py:220`), ``get_timeline()``
    (`scripts/pyannote-face.py:257`), ``itertracks()``, ``labels()``,
    ``subset()``, ``smooth()``, ``copy()`` (`structure/thread.py:224-249`),
    two-arg ``annotation[segment, track] = label``
    (`face/clustering.py:80`).
    """

    DEFAULT_TRACK = "_"

    def __init__(self, uri: Optional[str] = None, modality: Optional[str] = None):
        self.uri = uri
        self.modality = modality
        # segment -> {track: label}; kept sorted on iteration
        self._tracks: Dict[Segment, Dict[object, object]] = {}

    # -- mutation ---------------------------------------------------------

    def __setitem__(self, key, label) -> None:
        if isinstance(key, tuple):
            segment, track = key
        else:
            segment, track = key, self.DEFAULT_TRACK
        self._tracks.setdefault(segment, {})[track] = label

    def __getitem__(self, key):
        if isinstance(key, tuple):
            segment, track = key
        else:
            segment, track = key, self.DEFAULT_TRACK
        return self._tracks[segment][track]

    def __delitem__(self, key) -> None:
        if isinstance(key, tuple):
            segment, track = key
            del self._tracks[segment][track]
            if not self._tracks[segment]:
                del self._tracks[segment]
        else:
            del self._tracks[key]

    def __contains__(self, segment: Segment) -> bool:
        return segment in self._tracks

    def __len__(self) -> int:
        return len(self._tracks)

    def __eq__(self, other) -> bool:
        return isinstance(other, Annotation) and dict(self._tracks) == dict(other._tracks)

    # -- iteration --------------------------------------------------------

    def segments(self) -> List[Segment]:
        return sorted(self._tracks)

    def itersegments(self) -> Iterator[Segment]:
        return iter(self.segments())

    def itertracks(self, yield_label: bool = False) -> Iterator[Tuple]:
        for segment in self.segments():
            for track in sorted(self._tracks[segment], key=str):
                if yield_label:
                    yield segment, track, self._tracks[segment][track]
                else:
                    yield segment, track

    def get_timeline(self) -> Timeline:
        return Timeline(self.segments(), uri=self.uri)

    def labels(self) -> List[object]:
        return sorted({l for tracks in self._tracks.values() for l in tracks.values()}, key=str)

    def label_timeline(self, label) -> Timeline:
        return Timeline(
            [s for s, tracks in self._tracks.items() if label in tracks.values()],
            uri=self.uri,
        )

    def subset(self, labels: Iterable[object]) -> "Annotation":
        labels = set(labels)
        sub = Annotation(uri=self.uri, modality=self.modality)
        for segment, track, label in self.itertracks(yield_label=True):
            if label in labels:
                sub[segment, track] = label
        return sub

    def copy(self) -> "Annotation":
        dup = Annotation(uri=self.uri, modality=self.modality)
        for segment, track, label in self.itertracks(yield_label=True):
            dup[segment, track] = label
        return dup

    def smooth(self) -> "Annotation":
        """Merge contiguous/overlapping same-label segments.

        Reference behaviour (`structure/thread.py:222`): thread annotations
        are smoothed so that consecutive shots of one thread collapse into
        a single segment per contiguous run.
        """
        smoothed = Annotation(uri=self.uri, modality=self.modality)
        for label in self.labels():
            for segment in self.label_timeline(label).support():
                smoothed[segment, self.DEFAULT_TRACK] = label
        return smoothed

    # -- JSON -------------------------------------------------------------

    def for_json(self) -> dict:
        content = [
            {"segment": s.for_json(), "track": t, "label": l}
            for s, t, l in self.itertracks(yield_label=True)
        ]
        data = {PYANNOTE_JSON: "Annotation", PYANNOTE_JSON_CONTENT: content}
        if self.uri is not None:
            data["uri"] = self.uri
        if self.modality is not None:
            data["modality"] = self.modality
        return data

    @classmethod
    def from_json(cls, data: dict) -> "Annotation":
        ann = cls(uri=data.get("uri"), modality=data.get("modality"))
        for item in data[PYANNOTE_JSON_CONTENT]:
            ann[Segment.from_json(item["segment"]), item["track"]] = item["label"]
        return ann


# -- pyannote.core.json-compatible module-level API -----------------------

_CLASSES = {"Segment": Segment, "Timeline": Timeline, "Annotation": Annotation}


def object_hook(data: dict):
    if PYANNOTE_JSON in data:
        cls = _CLASSES.get(data[PYANNOTE_JSON])
        if cls is not None:
            return cls.from_json(data)
    return data


def load(fp):
    """Load a Segment / Timeline / Annotation from a pyannote-JSON file.

    Applies ``object_hook`` bottom-up on every JSON object, matching
    ``pyannote.core.json.load``.
    """
    return _json.load(fp, object_hook=object_hook)


def loads(text: str):
    return _json.loads(text, object_hook=object_hook)


def dump(obj, fp) -> None:
    """Dump a Segment / Timeline / Annotation to a pyannote-JSON file."""
    _json.dump(obj.for_json(), fp)


def dumps(obj) -> str:
    return _json.dumps(obj.for_json())
