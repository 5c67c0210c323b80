"""Host-side point ops of the port.

Port of ``knn_broadcast_labels`` from ``doda_tpu/ops/pointops.py``; the
rest of that module (device kNN, ball query, interpolation, clustering)
is not ported yet.
"""

from __future__ import annotations

import numpy as np


def knn_broadcast_labels(xyz_sub, labels_sub, xyz_all):
    """1-NN label broadcast from a subsampled scene to full resolution —
    the eval/pseudo-label path for cropped or downsampled scenes
    (ref: model/unet.py:135-145 via pointops.knnquery(1, ...)), on the
    native grid-hash NN (``native/host_ops.nn1``)."""
    from ..native import host_ops
    idx = host_ops.nn1(np.asarray(xyz_sub, np.float32),
                       np.asarray(xyz_all, np.float32), cell=0.1)
    return np.asarray(labels_sub)[idx]
