"""The SparseConvNet U-Net of DODA (CVMI-Lab/DODA model/unet.py and
model/unet_block.py) at voxel level, in plain PyTorch, float32, TF32 off.

  point features -> mean over each voxel's points -> input subm conv
  (3^3, no norm) -> U-block per level l (width p = mid * (l + 1)):
      block_reps x residual block (BN -> ReLU -> subm conv, twice,
      + identity, or a 1x1 conv where the width changes)
      below the last level: BN -> ReLU -> 2^3 stride-2 conv -> U-block of
      level l + 1 -> BN -> ReLU -> 2^3 inverse conv -> concat with the
      blocks' output (2p) -> block_reps x residual block (2p -> p first)
  -> BN -> ReLU -> each point takes its voxel's features -> linear head.

BN normalizes with the running statistics in eval; in training with the
batch's statistics over the active voxels (biased variance), and the
running ones move by momentum 0.1 towards them (unbiased variance);
eps 1e-4. Under DSNorm each norm keeps one row of running statistics a
domain, picked by the batch's domain. A subm conv is a cross-correlation
over the 27 neighbours (kernel (27, cin, cout), raster dx, dy, dz) that
are active; the stride-2 conv sums each voxel's features through the
kernel row of its octant into its parent; the inverse conv gives each
voxel its parent's features through that row. Nothing is capped, padded
or bricked: every active voxel is one row.

Parameters and statistics are named as the program's state dict names
them (``names``), so that the benchmark hands one set of tensors to both.
``quant='fp8'`` rounds each conv's and the head's inputs and weights to
float8 e4m3 (one scale a tensor, its largest magnitude at 448) before the
product: the control that a bf16 program must beat; ``quant='bf16'``
rounds them to bf16, a witness of what bf16 operands alone cost.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .plan import Plan

EPS = 1e-4
MOMENTUM = 0.1
E4M3_MAX = 448.0


def strict_float32() -> None:
    """Float32 products in float32: no TF32 anywhere."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision('highest')


strict_float32()


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x + (x.detach().to(torch.bfloat16).float() - x.detach())


def _fp8(x: torch.Tensor) -> torch.Tensor:
    scale = x.detach().abs().amax().clamp(min=1e-30) / E4M3_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (q - x.detach())


class Net:
    """The net of a configuration's sizes (keys of the config file:
    in_channel, mid_channel, num_levels, block_reps, n_classes, dsnorm)."""

    def __init__(self, sizes: dict, quant: str | None = None):
        self.cin = int(sizes['in_channel'])
        self.mid = int(sizes['mid_channel'])
        self.levels = int(sizes['num_levels'])
        self.reps = int(sizes['block_reps'])
        self.classes = int(sizes['n_classes'])
        self.domains = 2 if sizes['dsnorm'] else 1
        rounding = {None: lambda t: t, 'fp8': _fp8, 'bf16': _bf16}
        if quant not in rounding:
            raise ValueError(f'quant {quant!r}')
        self.q = rounding[quant]

    # -- names -------------------------------------------------------------

    def _norm_names(self, out, name, c):
        out[f'{name}.scale'] = (c,)
        out[f'{name}.bias'] = (c,)
        out[f'{name}.mean'] = (self.domains, c)
        out[f'{name}.var'] = (self.domains, c)

    def _block_names(self, out, name, cin, cout):
        if cin != cout:
            out[f'{name}.i_kernel'] = (cin, cout)
        self._norm_names(out, f'{name}.MaskedBatchNorm_0', cin)
        out[f'{name}.kernel1'] = (27, cin, cout)
        self._norm_names(out, f'{name}.MaskedBatchNorm_1', cout)
        out[f'{name}.kernel2'] = (27, cout, cout)

    def names(self) -> dict:
        """Every parameter and statistic: name -> shape."""
        out = {'input_kernel': (27, self.cin, self.mid)}
        for lvl in range(self.levels):
            pre = 'unet.' + 'u.' * lvl
            p = self.mid * (lvl + 1)
            for i in range(self.reps):
                self._block_names(out, f'{pre}block{i}', p, p)
            if lvl == self.levels - 1:
                continue
            p2 = p + self.mid
            self._norm_names(out, f'{pre}conv_norm', p)
            out[f'{pre}down_kernel'] = (8, p, p2)
            self._norm_names(out, f'{pre}deconv_norm', p2)
            out[f'{pre}up_kernel'] = (8, p2, p)
            for i in range(self.reps):
                self._block_names(out, f'{pre}tail{i}', 2 * p if i == 0
                                  else p, p)
        self._norm_names(out, 'output_norm', self.mid)
        out['linear.weight'] = (self.classes, self.mid)
        out['linear.bias'] = (self.classes,)
        return out

    @staticmethod
    def is_stat(name: str) -> bool:
        return name.endswith('.mean') or name.endswith('.var')

    # -- layers ------------------------------------------------------------

    def _subm(self, x, lv, w):
        w = self.q(w)
        xp = torch.cat([self.q(x), x.new_zeros(1, x.shape[1])])
        out = None
        for k in range(27):
            y = xp.index_select(0, lv.nbr[:, k]) @ w[k]
            out = y if out is None else out + y
        return out

    def _down(self, x, parents, parity, n_parent, w):
        w, x = self.q(w), self.q(x)
        out = x.new_zeros(n_parent, w.shape[2])
        for k in range(8):
            rows = torch.nonzero(parity == k).reshape(-1)
            out = out.index_add(0, parents[rows], x[rows] @ w[k])
        return out

    def _up(self, x, parents, parity, w):
        w, x = self.q(w), self.q(x)
        out = x.new_zeros(parents.shape[0], w.shape[2])
        for k in range(8):
            rows = torch.nonzero(parity == k).reshape(-1)
            out = out.index_add(0, rows, x[parents[rows]] @ w[k])
        return out

    def _norm(self, x, t, name, domain, state):
        d = domain if self.domains > 1 else 0
        if state['train']:
            mean = x.mean(0)
            var = x.var(0, unbiased=False)
            with torch.no_grad():
                n = x.shape[0]
                st = state['stats']
                keep = 1 - MOMENTUM
                m_new = st[f'{name}.mean'].clone()
                v_new = st[f'{name}.var'].clone()
                m_new[d] = keep * m_new[d] + MOMENTUM * mean
                v_new[d] = keep * v_new[d] + MOMENTUM * var * n / max(n - 1,
                                                                     1)
                st[f'{name}.mean'], st[f'{name}.var'] = m_new, v_new
        else:
            mean, var = t[f'{name}.mean'][d], t[f'{name}.var'][d]
        return (x - mean) * torch.rsqrt(var + EPS) * t[f'{name}.scale'] \
            + t[f'{name}.bias']

    def _block(self, x, t, name, lv, domain, state):
        if f'{name}.i_kernel' in t:
            identity = self.q(x) @ self.q(t[f'{name}.i_kernel'])
        else:
            identity = x
        h = F.relu(self._norm(x, t, f'{name}.MaskedBatchNorm_0', domain,
                              state))
        h = self._subm(h, lv, t[f'{name}.kernel1'])
        h = F.relu(self._norm(h, t, f'{name}.MaskedBatchNorm_1', domain,
                              state))
        h = self._subm(h, lv, t[f'{name}.kernel2'])
        return h + identity

    def _ublock(self, x, t, plan: Plan, lvl, domain, state):
        pre = 'unet.' + 'u.' * lvl
        lv = plan.levels[lvl]
        for i in range(self.reps):
            x = self._block(x, t, f'{pre}block{i}', lv, domain, state)
        if lvl == self.levels - 1:
            return x
        identity = x
        h = F.relu(self._norm(x, t, f'{pre}conv_norm', domain, state))
        h = self._down(h, plan.parents[lvl], plan.parity[lvl],
                       len(plan.levels[lvl + 1].keys), t[f'{pre}down_kernel'])
        h = self._ublock(h, t, plan, lvl + 1, domain, state)
        h = F.relu(self._norm(h, t, f'{pre}deconv_norm', domain, state))
        h = self._up(h, plan.parents[lvl], plan.parity[lvl],
                     t[f'{pre}up_kernel'])
        x = torch.cat([identity, h], 1)
        for i in range(self.reps):
            x = self._block(x, t, f'{pre}tail{i}', lv, domain, state)
        return x

    def forward(self, t: dict, plan: Plan, feats: torch.Tensor,
                domain: int = 0, stats: dict | None = None) -> torch.Tensor:
        """Logits (valid points, classes) of the batch whose plan is
        ``plan``; feats (B, N, C). With ``stats`` (a dict of the running
        statistics, replaced in it as they move) the norms run in training
        mode; without, in eval mode from ``t``'s statistics."""
        state = {'train': stats is not None, 'stats': stats}
        pf = feats.reshape(-1, feats.shape[-1])[plan.points].float()
        n0 = len(plan.levels[0].keys)
        sums = pf.new_zeros(n0, pf.shape[1]).index_add(0, plan.point_voxel,
                                                       pf)
        count = pf.new_zeros(n0).index_add(0, plan.point_voxel,
                                           pf.new_ones(len(pf)))
        x = sums / count[:, None]
        x = self._subm(x, plan.levels[0], t['input_kernel'])
        x = self._ublock(x, t, plan, 0, domain, state)
        h = F.relu(self._norm(x, t, 'output_norm', domain, state))
        out = h[plan.point_voxel]
        return self.q(out) @ self.q(t['linear.weight']).T + t['linear.bias']


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  ignore: int) -> torch.Tensor:
    """The mean over the labelled points."""
    keep = labels != ignore
    return F.cross_entropy(logits[keep], labels[keep].long())
