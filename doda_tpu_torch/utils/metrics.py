"""Segmentation metrics: per-class intersection/union/target histograms.

Port of ``doda_tpu/utils/metrics.py``: ``intersection_and_union`` (ref
``intersectionAndUnionGPU``, util/common_utils.py:233-256) on torch
tensors; the host-side ``AverageMeter`` and ``calc_metrics`` that the
CLIs accumulate the histograms in (ref util/common_utils.py:41-56,
259-265).
"""

from __future__ import annotations

import numpy as np
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


class AverageMeter:
    """Running value/avg/sum/count (ref: util/common_utils.py:41-56)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0
        self.avg = 0
        self.sum = 0
        self.count = 0

    def update(self, val, n=1):
        self.val = val
        self.sum = self.sum + val * n
        self.count += n
        self.avg = self.sum / self.count if self.count else 0.0


def calc_metrics(intersection_sum, union_sum, target_sum):
    """(mIoU, mAcc, allAcc, iou_class, acc_class)
    (ref: util/common_utils.py:259-265)."""
    iou_class = intersection_sum / (union_sum + 1e-10)
    acc_class = intersection_sum / (target_sum + 1e-10)
    miou = float(np.mean(iou_class))
    macc = float(np.mean(acc_class))
    allacc = float(np.sum(intersection_sum) / (np.sum(target_sum) + 1e-10))
    return miou, macc, allacc, iou_class, acc_class
