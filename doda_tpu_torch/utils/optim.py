"""Optimizer factory and learning-rate schedules over ``torch.optim``.

Port of ``doda_tpu/utils/optim.py``: SGD(momentum, weight_decay) / Adam /
AdamW selected by ``OPTIMIZATION.optim`` (ref: util/common_utils.py:196-215)
and step / poly / cos schedules applied per iteration (ref:
util/common_utils.py:154-193). The schedules are plain functions of the
epoch and iteration; the train step sets their value on the optimizer.
"""

from __future__ import annotations

import math

import torch


def step_lr(base_lr, epoch, step_epoch, multiplier=0.1, clip=1e-6):
    """Decay by ``multiplier`` every ``step_epoch`` epochs
    (ref: util/common_utils.py:154-158)."""
    return max(base_lr * multiplier ** (epoch // step_epoch), clip)


def poly_lr(base_lr, curr_iter, max_iter, power=0.9):
    """(ref: util/common_utils.py:161-165)"""
    frac = min(max(curr_iter / max_iter, 0.0), 1.0)
    return base_lr * (1.0 - frac) ** power


def cos_lr(base_lr, curr_iter, max_iter, warm_iter=0, hold_base_iter=0):
    """(ref: util/common_utils.py:168-172)"""
    t = (curr_iter - warm_iter - hold_base_iter) / (
        max_iter - warm_iter - hold_base_iter)
    return 0.5 * base_lr * (1.0 + math.cos(math.pi * t))


def make_lr_fn(optim_cfg, total_epochs, iters_per_epoch):
    """lr(epoch, it) matching ref ``adjust_lr``
    (util/common_utils.py:175-193): step uses (epoch - 1) // step_epoch;
    poly/cos use epoch * iters + it + 1."""
    decay = optim_cfg.lr_decay
    base = optim_cfg.base_lr
    if decay == 'step':
        return lambda epoch, it: step_lr(
            base, epoch - 1, optim_cfg.step_epoch,
            optim_cfg.get('multiplier', 0.1))
    max_iter = total_epochs * iters_per_epoch
    if decay == 'poly':
        return lambda epoch, it: poly_lr(
            base, epoch * iters_per_epoch + it + 1, max_iter)
    if decay == 'cos':
        return lambda epoch, it: cos_lr(
            base, epoch * iters_per_epoch + it + 1, max_iter)
    raise NotImplementedError(decay)


def build_optimizer(optim_cfg, params) -> torch.optim.Optimizer:
    """The optimizer of ``OPTIMIZATION.optim`` over ``params``, starting at
    ``base_lr``. The updates equal the JAX package's optax chains: decayed
    weights added to the gradient before SGD's momentum trace is torch's
    SGD with ``weight_decay`` and no dampening; optax's Adam and AdamW take
    no weight decay from the config, and AdamW's own default there is 1e-4
    (torch's is 1e-2), so it is passed explicitly."""
    kind = optim_cfg.get('optim', 'sgd')
    lr = optim_cfg.base_lr
    if kind == 'sgd':
        return torch.optim.SGD(
            params, lr=lr, momentum=optim_cfg.get('momentum', 0.9),
            weight_decay=optim_cfg.get('weight_decay', 0.0), dampening=0.0)
    if kind == 'adam':
        return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    if kind == 'adamw':
        return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999),
                                 eps=1e-8, weight_decay=1e-4)
    raise NotImplementedError(kind)
