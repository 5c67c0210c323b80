"""Masked batch normalization with optional per-domain statistics.

Port of ``doda_tpu/models/norm.py``. In eval mode the running mean and
variance normalize; in train mode (``module.train()``) the statistics of
the masked cells of the batch do, and the running statistics move towards
them. Under DSNorm (ref: model/dsnorm.py:12-84) the running statistics
have one row per domain, selected by ``domain``.

Layout: x is wide-lane ``(rows, 64*C)`` with ``mask`` the ``(rows, 64)``
cell occupancy; outputs are re-masked so inactive cells stay zero.
"""

from __future__ import annotations

import torch
from torch import nn

from ..parallel import collectives


class MaskedBatchNorm(nn.Module):
    """BatchNorm over masked cells; eps 1e-4, momentum 0.1 (ref:
    model/unet.py:28). torch BN semantics: the biased batch variance
    normalizes, the unbiased one feeds the running statistics.

    Buffers ``mean``/``var`` are (n_domains, C) with n_domains 2 under
    DSNorm; parameters ``scale``/``bias`` are (C,), as in the JAX tree,
    and absent with ``affine=False``."""

    def __init__(self, features: int, eps: float = 1e-4,
                 momentum: float = 0.1, dsnorm: bool = False,
                 affine: bool = True):
        super().__init__()
        self.features = features
        self.eps = eps
        self.momentum = momentum
        self.dsnorm = dsnorm
        self.affine = affine
        n_domains = 2 if dsnorm else 1
        self.register_buffer('mean', torch.zeros(n_domains, features))
        self.register_buffer('var', torch.ones(n_domains, features))
        if affine:
            self.scale = nn.Parameter(torch.ones(features))
            self.bias = nn.Parameter(torch.zeros(features))

    def _batch_stats(self, x3: torch.Tensor, mask: torch.Tensor, d: int):
        """Float32 mean and biased variance over the masked cells, as
        ``var = max(E[x^2] - mean^2, 0)``; moves the running statistics of
        domain ``d`` in place (they are no part of the autograd graph).
        In a process group the masked sums and the count are summed over
        the ranks, gradient included, so the statistics are those of the
        whole batch (SyncBN; the JAX package's sharded jit reduces them
        the same way)."""
        xm = torch.where(mask[:, :, None], x3, 0).float()
        c = self.features
        sums = collectives.sum_with_grad(torch.cat([
            xm.sum((0, 1)), (xm * xm).sum((0, 1)),
            mask.sum().float().reshape(1)]))
        count = sums[2 * c].clamp(min=1.0)
        mean = sums[:c] / count
        var = (sums[c:2 * c] / count - mean * mean).clamp(min=0.0)
        with torch.no_grad():
            unbiased = var * count / (count - 1.0).clamp(min=1.0)
            mom = self.momentum
            self.mean[d] = (1 - mom) * self.mean[d] + mom * mean
            self.var[d] = (1 - mom) * self.var[d] + mom * unbiased
        return mean, var

    def forward(self, x: torch.Tensor, mask: torch.Tensor, domain: int = 0,
                fold: bool = False):
        """With ``fold=True`` returns the effective per-channel float32
        ``(scale, bias)`` instead of applying them; in train mode the
        running statistics move either way."""
        rows, c = x.shape[0], self.features
        x3 = x.reshape(rows, -1, c)
        d = domain if self.dsnorm else 0
        if self.training:
            mean, var = self._batch_stats(x3, mask, d)
        else:
            mean, var = self.mean[d], self.var[d]
        rs = torch.rsqrt(var + self.eps)
        scale_eff, bias_eff = rs, -mean * rs
        if self.affine:
            scale_eff = rs * self.scale
            bias_eff = self.bias - mean * rs * self.scale
        if fold:
            return scale_eff, bias_eff
        # applied in the activation dtype, scale/bias rounded once
        y = x3 * scale_eff.to(x.dtype) + bias_eff.to(x.dtype)
        return torch.where(mask[:, :, None], y, 0).reshape(x.shape)
