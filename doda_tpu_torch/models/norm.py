"""Masked batch normalization with optional per-domain statistics (eval).

Port of ``doda_tpu/models/norm.py`` for evaluation: the running mean and
variance normalize, with one row of statistics per domain under DSNorm
(ref: model/dsnorm.py:12-84) selected by ``domain``. Training-mode
statistics are not part of this port yet.

Layout: x is wide-lane ``(rows, 64*C)`` with ``mask`` the ``(rows, 64)``
cell occupancy; outputs are re-masked so inactive cells stay zero.
"""

from __future__ import annotations

import torch
from torch import nn


class MaskedBatchNorm(nn.Module):
    """BatchNorm over masked cells; eps 1e-4 (ref: model/unet.py:28).

    Buffers ``mean``/``var`` are (n_domains, C) with n_domains 2 under
    DSNorm; parameters ``scale``/``bias`` are (C,), as in the JAX tree."""

    def __init__(self, features: int, eps: float = 1e-4,
                 dsnorm: bool = False):
        super().__init__()
        self.features = features
        self.eps = eps
        self.dsnorm = dsnorm
        n_domains = 2 if dsnorm else 1
        self.register_buffer('mean', torch.zeros(n_domains, features))
        self.register_buffer('var', torch.ones(n_domains, features))
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor, mask: torch.Tensor, domain: int = 0,
                fold: bool = False):
        """With ``fold=True`` returns the effective per-channel float32
        ``(scale, bias)`` instead of applying them."""
        if self.training:
            raise NotImplementedError(
                'MaskedBatchNorm: training-mode statistics are not ported; '
                'call .eval() on the model')
        d = domain if self.dsnorm else 0
        rs = torch.rsqrt(self.var[d] + self.eps)
        scale_eff = rs * self.scale
        bias_eff = self.bias - self.mean[d] * rs * self.scale
        if fold:
            return scale_eff, bias_eff
        # applied in the activation dtype, scale/bias rounded once
        rows, c = x.shape[0], self.features
        y = x.reshape(rows, -1, c) * scale_eff.to(x.dtype) \
            + bias_eff.to(x.dtype)
        return torch.where(mask[:, :, None], y, 0).reshape(x.shape)
