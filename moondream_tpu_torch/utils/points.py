"""Point-set utilities: the port's copy of `moondream_tpu.utils.points`
(tests/test_torch_host.py holds the two equal).

`remove_outlier_points` is a kNN-median filter over a pairwise-distance
matrix, used by accuracy-mode gaze averaging.
"""

from __future__ import annotations

import numpy as np


def remove_outlier_points(points_tuples, k_nearest: int = 2, threshold: float = 2.0):
    points = np.asarray(points_tuples, dtype=np.float64)
    n = len(points)
    if n == 0:
        return []

    diff = points[:, None, :] - points[None, :, :]
    dist = np.sqrt(np.sum(diff * diff, axis=-1))

    k = min(k_nearest, n - 1)
    if k <= 0:
        return list(points_tuples)
    neighbor = np.partition(dist, k, axis=1)[:, :k]
    avg = neighbor.mean(axis=1)
    mask = avg <= threshold * np.median(avg)
    return [t for t, m in zip(points_tuples, mask) if m]
