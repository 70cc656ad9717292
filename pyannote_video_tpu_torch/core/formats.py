"""Whitespace file formats for tracking / landmarks / embeddings / labels.

Bit-compatible with the reference's stage-file contracts:

* tracking file — one line per (t, track-id, bbox, status), template
  ``{t:.3f} {identifier:d} {left:.3f} {top:.3f} {right:.3f} {bottom:.3f}
  {status:s}`` (`scripts/pyannote-face.py:116-118,261-269`);
* landmarks file — ``{t:.3f} {id:d}`` + 68 × ``' {x:.5f} {y:.5f}'``
  normalized coords (`scripts/pyannote-face.py:299-305`);
* embeddings file — ``{t:.3f} {id:d}`` + 128 × ``' {x:.5f}'``
  (`scripts/pyannote-face.py:307-311`, parsed back by
  `face/clustering.py:70-74`);
* labels file — ``{id:d} {label:s}`` (`scripts/pyannote-face.py:391-397`).

These files ARE the reference's checkpoint/resume scheme (SURVEY §5): each
stage writes one and the next stage reads it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, List, Sequence, TextIO, Tuple

import numpy as np

FACE_TEMPLATE = (
    "{t:.3f} {identifier:d} "
    "{left:.3f} {top:.3f} {right:.3f} {bottom:.3f} "
    "{status:s}\n"
)


@dataclass
class TrackPoint:
    """One tracking-file row: normalized bbox at time t for a track."""

    t: float
    identifier: int
    left: float
    top: float
    right: float
    bottom: float
    status: str


def write_track_point(fp: TextIO, point: TrackPoint) -> None:
    fp.write(
        FACE_TEMPLATE.format(
            t=point.t,
            identifier=point.identifier,
            left=point.left,
            top=point.top,
            right=point.right,
            bottom=point.bottom,
            status=point.status,
        )
    )


def read_tracking(path: str) -> List[TrackPoint]:
    """Parse a tracking file (same columns as `pyannote-face.py:125`)."""
    points: List[TrackPoint] = []
    with open(path, "r") as fp:
        for line in fp:
            fields = line.split()
            if not fields:
                continue
            t, identifier, left, top, right, bottom, status = fields
            points.append(
                TrackPoint(
                    t=float(t),
                    identifier=int(identifier),
                    left=float(left),
                    top=float(top),
                    right=float(right),
                    bottom=float(bottom),
                    status=status,
                )
            )
    return points


def iter_tracking_by_time(
    points: Sequence[TrackPoint],
) -> Iterator[Tuple[float, List[TrackPoint]]]:
    """Group tracking rows by timestamp, sorted by time (stable within t).

    Mirrors the coroutine alignment in `pyannote-face.py:121-175`: the
    extract/demo stages consume *all* faces at a given file timestamp when
    the video timestamp reaches it.
    """
    ordered = sorted(points, key=lambda p: p.t)
    group: List[TrackPoint] = []
    current_t = None
    for p in ordered:
        if current_t is None or p.t == current_t:
            group.append(p)
            current_t = p.t
        else:
            yield current_t, group
            group = [p]
            current_t = p.t
    if group:
        yield current_t, group


def write_landmarks_line(
    fp: TextIO, t: float, identifier: int, points_norm: np.ndarray
) -> None:
    """One landmarks row: 68 (or n) normalized (x, y) pairs."""
    fp.write("{t:.3f} {identifier:d}".format(t=t, identifier=identifier))
    for x, y in np.asarray(points_norm).reshape(-1, 2):
        fp.write(" {x:.5f} {y:.5f}".format(x=float(x), y=float(y)))
    fp.write("\n")


def read_landmarks(path: str) -> List[Tuple[float, int, np.ndarray]]:
    """Parse a landmarks file → list of (t, id, (n_points, 2) array)."""
    rows: List[Tuple[float, int, np.ndarray]] = []
    with open(path, "r") as fp:
        for line in fp:
            fields = line.split()
            if not fields:
                continue
            t = float(fields[0])
            identifier = int(fields[1])
            coords = np.asarray([float(v) for v in fields[2:]], dtype=np.float32)
            rows.append((t, identifier, coords.reshape(-1, 2)))
    return rows


def write_embedding_line(
    fp: TextIO, t: float, identifier: int, embedding: np.ndarray
) -> None:
    """One embeddings row: 128 values, '%.5f' each."""
    fp.write("{t:.3f} {identifier:d}".format(t=t, identifier=identifier))
    for x in np.asarray(embedding).ravel():
        fp.write(" {x:.5f}".format(x=float(x)))
    fp.write("\n")


def read_embeddings(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Parse an embeddings file → (times, track_ids, (n, d) embeddings).

    Same columns the reference loads with pandas for clustering
    (`face/clustering.py:70-74`).
    """
    times: List[float] = []
    tracks: List[int] = []
    vectors: List[List[float]] = []
    with open(path, "r") as fp:
        for line in fp:
            fields = line.split()
            if not fields:
                continue
            times.append(float(fields[0]))
            tracks.append(int(fields[1]))
            vectors.append([float(v) for v in fields[2:]])
    return (
        np.asarray(times, dtype=np.float64),
        np.asarray(tracks, dtype=np.int64),
        np.asarray(vectors, dtype=np.float64),
    )


def read_labels(path: str) -> Dict[int, str]:
    """Parse a label file: ``{identifier:d} {label:s}`` per line
    (`scripts/pyannote-face.py:391-397`)."""
    labels: Dict[int, str] = {}
    with open(path, "r") as fp:
        for line in fp:
            fields = line.strip().split()
            if not fields:
                continue
            labels[int(fields[0])] = fields[1]
    return labels


def write_labels(path: str, labels: Dict[int, str]) -> None:
    with open(path, "w") as fp:
        for identifier in sorted(labels):
            fp.write("{i:d} {l:s}\n".format(i=identifier, l=labels[identifier]))
