"""Offset-convention wrappers over the point ops.

Port of ``doda_tpu/ops/pointops_offsets.py``: the flat "concatenated scenes
+ offsets" surface of the reference's three wrapper variants
(``lib/pointops2/functions/{pointops2,pointops,pointops_ablation}.py``)
over the per-scene ops of ``pointops.py``. Offsets are host values (numpy
or Python ints, as the reference's launches read ``offset[i].item()``):
either cumulative segment ends (length b) or the same with a leading 0
(length b+1); a leading 0 tells them apart, or pass ``leading_zero=``.
Each segment runs through the core ops and the returned indices are
global into the flat arrays. Arrays given as numpy go to ``device``, the
card unless the caller asks for the CPU; tensors stay where they are.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import resolve_device
from . import pointops as core

__all__ = ['furthestsampling', 'knnquery', 'grouping', 'queryandgroup',
           'subtraction', 'aggregation', 'interpolation', 'interpolation2']


def _spans(offset, leading_zero=None):
    """Offsets (either convention) -> [(start, end), ...] host ints."""
    off = np.asarray(torch.as_tensor(offset).cpu()).astype(np.int64).tolist()
    if leading_zero is None:
        leading_zero = bool(off and off[0] == 0)
    ends = off[1:] if leading_zero else off
    starts = [0] + ends[:-1]
    return list(zip(starts, ends))


def _on(a, device):
    if isinstance(a, torch.Tensor):
        return a
    return torch.as_tensor(np.asarray(a), device=resolve_device(device))


def furthestsampling(xyz, offset, new_offset, leading_zero=None,
                     device="cuda"):
    """FPS per segment -> (m_total,) int32 global indices
    (ref pointops.py:56-73 / pointops2.py:34-50)."""
    xyz = _on(xyz, device)
    out = []
    for (s, e), (ns, ne) in zip(_spans(offset, leading_zero),
                                _spans(new_offset, leading_zero)):
        out.append(core.furthest_point_sampling(xyz[s:e], ne - ns) + s)
    return torch.cat(out).to(torch.int32)


def knnquery(nsample, xyz, new_xyz, offset, new_offset, leading_zero=None,
             device="cuda"):
    """Per-segment kNN -> (idx (m, nsample) global int32, dist (m, nsample)
    euclidean; the reference sqrt()s its kernel's dist2, pointops2.py:66).
    A segment with fewer than ``nsample`` points repeats its nearest
    neighbour in the missing columns."""
    xyz = _on(xyz, device)
    new_xyz = xyz if new_xyz is None else _on(new_xyz, device)
    idx_out, dist_out = [], []
    for (s, e), (ns, ne) in zip(_spans(offset, leading_zero),
                                _spans(new_offset, leading_zero)):
        k = min(nsample, e - s)
        idx, dist = core.knn(k, new_xyz[ns:ne], xyz[s:e])
        idx = idx + s
        if k < nsample:
            idx = torch.cat([idx, idx[:, :1].expand(-1, nsample - k)], 1)
            dist = torch.cat([dist, dist[:, :1].expand(-1, nsample - k)], 1)
        idx_out.append(idx)
        dist_out.append(dist)
    return (torch.cat(idx_out).to(torch.int32),
            torch.cat(dist_out).to(torch.float32))


def grouping(input, idx, device="cuda"):
    """(n, c) gathered by global (m, nsample) -> (m, nsample, c); the
    backward is autograd's (ref pointops.py:94-122)."""
    return _on(input, device)[_on(idx, device).long()]


def queryandgroup(nsample, xyz, new_xyz, feat, idx, offset, new_offset,
                  use_xyz=True, relative=True, return_grouped_xyz=False,
                  leading_zero=None, device="cuda"):
    """kNN + gather + optional coordinate-difference concat. The default
    return is pointops2.py:103-123's (new_feat); ``return_grouped_xyz``
    the legacy tuple (pointops.py:125-146); ``relative=False`` the
    ablation's absolute grouped coordinates (pointops_ablation.py:79-101)."""
    xyz = _on(xyz, device)
    new_xyz = xyz if new_xyz is None else _on(new_xyz, device)
    feat = _on(feat, device)
    if idx is None:
        idx, _ = knnquery(nsample, xyz, new_xyz, offset, new_offset,
                          leading_zero)
    idx = _on(idx, device).long()
    grouped_xyz = xyz[idx]                          # (m, nsample, 3)
    shifted = grouped_xyz - new_xyz[:, None, :] if relative else grouped_xyz
    grouped_feat = feat[idx]                        # (m, nsample, c)
    new_feat = (torch.cat([shifted, grouped_feat], -1) if use_xyz
                else grouped_feat)
    return (new_feat, grouped_xyz) if return_grouped_xyz else new_feat


# the (n, c) x (n, c) x global idx forms are offset-free in the reference
# too (pointops.py:148-206): the core ops apply as they are
subtraction = core.subtraction
aggregation = core.aggregation


def interpolation(xyz, new_xyz, feat, offset, new_offset, k=3,
                  leading_zero=None, device="cuda"):
    """k-NN inverse-distance feature propagation per segment
    (ref pointops.py:209-223): w ~ 1/(d + 1e-8), d euclidean."""
    xyz, new_xyz = _on(xyz, device), _on(new_xyz, device)
    idx, dist = knnquery(k, xyz, new_xyz, offset, new_offset, leading_zero)
    w = 1.0 / (dist + 1e-8)
    w = w / w.sum(-1, keepdim=True)
    return (_on(feat, device)[idx.long()] * w[..., None]).sum(1)


# the reference's Interpolation.apply ("interpolation2") differs from
# interpolation() only in having a backward, which autograd gives both
interpolation2 = interpolation
