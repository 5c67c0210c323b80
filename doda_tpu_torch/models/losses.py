"""Segmentation losses: masked cross-entropy and Lovász-softmax.

Port of ``doda_tpu/models/losses.py`` (ref: model/unet.py:107-113,
util/loss_utils.py:9-15, util/lovasz_loss.py:129-173). Ignored and padded
points stay in the tensors and are neutralized by masking; for Lovász,
invalid entries get error -1 so that the descending sort puts them after
every valid entry, where their clamped error contributes zero.
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


def _lovasz_grad(gt_sorted: torch.Tensor) -> torch.Tensor:
    """Gradient of the Lovász extension w.r.t. the sorted errors, per
    column of (N, C) (ref: util/lovasz_loss.py:14-26)."""
    gts = gt_sorted.sum(0, keepdim=True)
    intersection = gts - gt_sorted.cumsum(0)
    union = gts + (1.0 - gt_sorted).cumsum(0)
    jaccard = 1.0 - intersection / union.clamp(min=1e-9)
    return torch.cat([jaccard[:1], jaccard[1:] - jaccard[:-1]])


def lovasz_softmax(logits: torch.Tensor, labels: torch.Tensor,
                   ignore_label: int = 255) -> torch.Tensor:
    """Multi-class Lovász-softmax over the classes present in the labels
    (ref: util/lovasz_loss.py:129-173 with classes='present')."""
    n_classes = logits.shape[-1]
    valid = labels != ignore_label
    probas = torch.softmax(logits.float(), dim=-1)
    classes = torch.arange(n_classes, device=logits.device)
    fg = ((labels[:, None] == classes) & valid[:, None]).float()   # (N, C)
    errors = torch.where(valid[:, None], (fg - probas).abs(), -1.0)
    errors_sorted, order = torch.sort(errors, dim=0, descending=True,
                                      stable=True)
    grad = _lovasz_grad(fg.gather(0, order))
    losses = (errors_sorted.clamp(min=0.0) * grad).sum(0)
    present = (fg.sum(0) > 0).float()
    return (losses * present).sum() / present.sum().clamp(min=1.0)


def soft_cross_entropy(logits: torch.Tensor, soft_labels: torch.Tensor,
                       valid: torch.Tensor | None = None) -> torch.Tensor:
    """CE against soft target distributions (the SOFT_LABEL branch, ref:
    model/unet.py:174-194). soft_labels (N, C) rows sum to 1; rows that
    sum to 0 carry no label unless ``valid`` says otherwise."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    per_point = -(soft_labels * logp).sum(-1)
    if valid is None:
        valid = soft_labels.sum(-1) > 0
    per_point = torch.where(valid, per_point, 0.0)
    return per_point.sum() / valid.sum().clamp(min=1)


def soft_to_hard_labels(soft_labels: torch.Tensor,
                        uniform: torch.Tensor | None = None,
                        generator: torch.Generator | None = None,
                        ignore_label: int = 255) -> torch.Tensor:
    """Sample hard labels from soft distributions (the convert_to_hard
    path, ref: model/unet.py:179-182) by inverting the cumulative sums at
    one uniform draw per row. ``uniform`` (..., 1) in [0, 1) is that draw;
    without it, it is drawn from ``generator``, which must then be given."""
    n_classes = soft_labels.shape[-1]
    if uniform is None:
        if generator is None:
            raise ValueError('soft_to_hard_labels needs the uniform draw '
                             'or a torch.Generator to make it')
        uniform = torch.rand(soft_labels.shape[:-1] + (1,),
                             generator=generator, device=soft_labels.device)
    cum = soft_labels.cumsum(-1)
    hard = n_classes - (cum > uniform).sum(-1)
    empty = soft_labels.sum(-1) <= 0
    return torch.where(empty, ignore_label, hard.clamp(0, n_classes - 1))


def build_criterion(cfg):
    """Loss factory keyed by OPTIMIZATION.loss (ref: model/unet.py:107-113):
    criterion(logits (N, C), labels (N,), weight=None) -> scalar."""
    kind = cfg.OPTIMIZATION.get('loss', 'cross_entropy')
    ignore = cfg.DATA_CONFIG.DATA_CLASS.ignore_label
    if kind == 'cross_entropy':
        return lambda logits, labels, w=None: cross_entropy(
            logits, labels, ignore, w)[0]
    if kind == 'lovasz':
        return lambda logits, labels, w=None: lovasz_softmax(
            logits, labels, ignore)
    raise NotImplementedError(kind)
