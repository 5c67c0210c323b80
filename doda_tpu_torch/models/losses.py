"""Segmentation loss: masked cross-entropy.

Port of ``cross_entropy`` from ``doda_tpu/models/losses.py`` (ref:
model/unet.py:107-113, util/loss_utils.py:9-15). Ignored and padded points
stay in the tensors and are neutralized by masking.
"""

from __future__ import annotations

import torch


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  ignore_label: int = 255,
                  sample_weight: torch.Tensor | None = None):
    """Mean CE over non-ignored points.

    logits (N, C), labels (N,) int. With ``sample_weight`` the mean is
    sum(w * ce) / (sum(w) + 1e-9) (ref: model/unet.py:169-172).
    Returns (loss, valid_count)."""
    n_classes = logits.shape[-1]
    valid = labels != ignore_label
    safe = labels.clamp(0, n_classes - 1).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, safe[..., None])[..., 0]
    nll = torch.where(valid, nll, 0.0)
    if sample_weight is not None:
        w = torch.where(valid, sample_weight.float(), 0.0)
        return (nll * w).sum() / (w.sum() + 1e-9), valid.sum()
    count = valid.sum().clamp(min=1)
    return nll.sum() / count, valid.sum()
