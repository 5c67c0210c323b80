"""Segmentation metrics: per-class intersection/union/target histograms.

Port of ``intersection_and_union`` from ``doda_tpu/utils/metrics.py``
(ref ``intersectionAndUnionGPU``, util/common_utils.py:233-256).
"""

from __future__ import annotations

import torch


def intersection_and_union(preds: torch.Tensor, labels: torch.Tensor,
                           n_classes: int, ignore_label: int = 255):
    """preds/labels int; returns (intersection, union, target) (K,).

    Ignored positions are excluded from all three."""
    valid = labels != ignore_label
    p = torch.where(valid, preds, n_classes).reshape(-1).long()
    lab = torch.where(valid, labels, n_classes).reshape(-1).long()
    inter = torch.where(p == lab, p, n_classes)
    k = n_classes + 1
    area_inter = torch.bincount(inter, minlength=k)[:n_classes]
    area_p = torch.bincount(p, minlength=k)[:n_classes]
    area_l = torch.bincount(lab, minlength=k)[:n_classes]
    return area_inter, area_p + area_l - area_inter, area_l
