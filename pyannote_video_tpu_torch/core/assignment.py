"""Hungarian (Kuhn–Munkres) assignment, own host implementation.

Replaces the reference's pure-Python ``munkres`` dependency
(`tracking.py:35,121,172`).  Problem sizes are tiny (#trackers × #detections
per frame, typically < 10), so an O(n³) host implementation is the right
tool — no device round-trip.

Implementation: Jonker–Volgenant-style shortest augmenting path on a padded
square cost matrix.  Cross-checked against ``scipy.optimize.
linear_sum_assignment`` in tests (scipy is used only in tests).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def hungarian(cost: np.ndarray) -> List[Tuple[int, int]]:
    """Minimum-cost one-to-one assignment on a square cost matrix.

    Parameters
    ----------
    cost : (n, n) array
        Cost matrix (the reference builds ``max(overlap) - overlap``,
        `tracking.py:172`).

    Returns
    -------
    list of (row, col) pairs, one per row — same contract as
    ``munkres.Munkres().compute``.
    """
    cost = np.asarray(cost, dtype=np.float64)
    if cost.ndim != 2 or cost.shape[0] != cost.shape[1]:
        raise ValueError(f"hungarian expects a square matrix, got {cost.shape}")
    n = cost.shape[0]
    if n == 0:
        return []

    # Shortest augmenting path (Jonker-Volgenant). 1-indexed helpers.
    INF = np.inf
    u = np.zeros(n + 1)
    v = np.zeros(n + 1)
    p = np.zeros(n + 1, dtype=np.int64)  # p[j] = row assigned to column j
    way = np.zeros(n + 1, dtype=np.int64)

    for i in range(1, n + 1):
        p[0] = i
        j0 = 0
        minv = np.full(n + 1, INF)
        used = np.zeros(n + 1, dtype=bool)
        while True:
            used[j0] = True
            i0 = p[j0]
            delta = INF
            j1 = -1
            for j in range(1, n + 1):
                if used[j]:
                    continue
                cur = cost[i0 - 1, j - 1] - u[i0] - v[j]
                if cur < minv[j]:
                    minv[j] = cur
                    way[j] = j0
                if minv[j] < delta:
                    delta = minv[j]
                    j1 = j
            for j in range(n + 1):
                if used[j]:
                    u[p[j]] += delta
                    v[j] -= delta
                else:
                    minv[j] -= delta
            j0 = j1
            if p[j0] == 0:
                break
        while j0 != 0:
            j1 = way[j0]
            p[j0] = p[j1]
            j0 = j1

    result = [(int(p[j]) - 1, j - 1) for j in range(1, n + 1)]
    result.sort()
    return result


def associate_by_overlap(
    overlap: np.ndarray, n_rows: int, n_cols: int
) -> List[Tuple[int, int]]:
    """Maximum-overlap one-to-one matching, reference semantics.

    The reference pads the overlap matrix to square with zeros, runs
    Hungarian on ``max(overlap) - overlap`` and keeps pairs with positive
    overlap inside the real (unpadded) range (`tracking.py:159-182`).

    Parameters
    ----------
    overlap : (n, n) array
        Square zero-padded overlap-area matrix.
    n_rows, n_cols : int
        Actual number of trackers / detections.

    Returns
    -------
    list of (row, col) with row < n_rows, col < n_cols, overlap > 0.
    """
    mapping = hungarian(np.max(overlap) - overlap)
    return [
        (t, d)
        for t, d in mapping
        if t < n_rows and d < n_cols and overlap[t, d] > 0.0
    ]
