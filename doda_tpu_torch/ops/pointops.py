"""Point-cloud op set: kNN, FPS, grouping, interpolation, clustering.

Port of ``doda_tpu/ops/pointops.py``, the counterparts of the reference's
two CUDA extensions (``lib/pointops2`` and ``lib/pointgroup_ops``) in plain
PyTorch: no function here reaches a Pallas kernel in the JAX package, so
none has a kernel here. Each runs on the device of its inputs.

Semantics follow the JAX package: per-scene arrays with validity masks
(batch with a loop or the offset wrappers of ``pointops_offsets.py``);
pairwise squared distances as |q|^2 + |b|^2 - 2 q.b; queries in chunks
that bound the (chunk, N) distance tile; ties broken towards the lower
index (stable sorts, first argmax); BFS clustering as label propagation
to a fixpoint; segment reductions from offsets.

Rounding. The JAX package's XLA sums the three products of a dot product
or a squared norm as a chain of fused multiply-adds, x first. ``_dot3``
does the same (each fused step exact in float64, rounded once to
float32), so squared distances, and with them the neighbour order of
near-ties, are the same bits on the CPU, on the card and in the JAX
package. A plain float32 sum differs from it by up to 4e-5 in a distance.
"""

from __future__ import annotations

import numpy as np
import torch

_BIG = 1e10


def _dot3(a, b):
    """sum_i a[..., i] * b[..., i] over the last dim of 3, as the chain
    fma(a2, b2, fma(a1, b1, a0 * b0)) rounded to float32 at each step
    (a float32 product is exact in float64)."""
    a, b = a.double(), b.double()
    acc = (a[..., 0] * b[..., 0]).float().double()
    acc = (a[..., 1] * b[..., 1] + acc).float().double()
    return (a[..., 2] * b[..., 2] + acc).float()


def _sq_dists(queries, base, base_valid):
    """(M, 3) x (N, 3) -> (M, N) squared distances; invalid -> _BIG."""
    qn = _dot3(queries, queries)[:, None]
    bn = _dot3(base, base)[None, :]
    cross = _dot3(queries[:, None, :], base[None, :, :])
    d = qn + bn - 2.0 * cross
    return torch.where(base_valid[None, :], d.clamp(min=0.0), _BIG)


def _chunks(m: int, chunk: int):
    return [slice(i, min(i + chunk, m)) for i in range(0, m, chunk)]


def knn(k: int, queries, base, query_valid=None, base_valid=None,
        chunk: int = 512):
    """k nearest neighbours of each query among the valid base points.

    Returns (idx (M, k) int32, dist (M, k) float32, euclidean), nearest
    first, the lower index first among equal distances; invalid queries
    get index 0 (ref knnquery, pointops2.py:54-69)."""
    m, n = queries.shape[0], base.shape[0]
    if base_valid is None:
        base_valid = torch.ones(n, dtype=torch.bool, device=base.device)
    idx, dist = [], []
    for sl in _chunks(m, chunk):
        d = _sq_dists(queries[sl], base, base_valid)
        dk, ik = torch.sort(d, dim=1, stable=True)
        idx.append(ik[:, :k].to(torch.int32))
        dist.append(dk[:, :k].clamp(min=0.0).sqrt())
    if not idx:
        return (queries.new_zeros((0, k), dtype=torch.int32),
                queries.new_zeros((0, k)))
    idx, dist = torch.cat(idx), torch.cat(dist)
    if query_valid is not None:
        idx = torch.where(query_valid[:, None], idx, 0)
    return idx, dist


def furthest_point_sampling(xyz, m: int, valid=None):
    """Iterative farthest point sampling from index 0 (ref
    sampling_cuda_kernel.cu:15-131). Returns (m,) int32 indices."""
    n = xyz.shape[0]
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=xyz.device)
    dists = torch.where(valid, _BIG, -1.0).to(xyz.dtype)
    sel = torch.zeros(m, dtype=torch.int64, device=xyz.device)
    for i in range(1, m):
        diff = xyz - xyz[sel[i - 1]]
        d = _dot3(diff, diff)
        dists = torch.minimum(dists, torch.where(valid, d, -1.0))
        sel[i] = torch.argmax(dists)
    return sel.to(torch.int32)


def grouping(feats, idx):
    """Gather (n, c) by (m, nsample) -> (m, nsample, c)
    (ref grouping_cuda_kernel.cu:5-40); its backward is autograd's."""
    return feats[idx.long()]


def interpolation(xyz_src, xyz_dst, feats_src, k: int = 3, src_valid=None):
    """k-NN inverse-distance-weighted feature propagation (ref
    interpolation_cuda_kernel.cu:5-48): w ~ 1/(d + 1e-8), normalized, d
    euclidean (ref pointops2.py:192-194)."""
    idx, dist = knn(k, xyz_dst, xyz_src, base_valid=src_valid)
    w = 1.0 / (dist + 1e-8)
    w = w / w.sum(-1, keepdim=True)
    return (feats_src[idx.long()] * w[..., None]).sum(1)


def subtraction(feats1, feats2, idx):
    """(n, c), (n, c), (n, nsample) -> (n, nsample, c) pairwise
    differences (ref subtraction_cuda_kernel.cu:5-45)."""
    return feats1[:, None, :] - feats2[idx.long()]


def aggregation(input_feats, position_feats, weight, idx):
    """out_i = sum_s (input[idx[i, s]] + position[i, s]) * weight[i, s],
    each weight channel shared by c / w_c feature channels (ref
    aggregation_cuda_kernel.cu:5-53)."""
    n, nsample, c = position_feats.shape
    w_c = weight.shape[-1]
    g = (input_feats[idx.long()] + position_feats).reshape(
        n, nsample, w_c, c // w_c)
    return (g * weight[..., None]).reshape(n, nsample, c).sum(1)


def ballquery(xyz, radius, nsample: int, valid=None, new_xyz=None,
              chunk: int = 512):
    """Up to ``nsample`` neighbour ids within ``radius`` of each point,
    nearest first (ref bfs_cluster.cu:15-63 ballquery_batch_p).
    Returns (idx (M, nsample) int32 padded with -1, cnt (M,) int32)."""
    if new_xyz is None:
        new_xyz = xyz
    n = xyz.shape[0]
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=xyz.device)
    r2 = radius * radius
    idx, cnt = [], []
    for sl in _chunks(new_xyz.shape[0], chunk):
        d = _sq_dists(new_xyz[sl], xyz, valid)
        key = torch.where(d <= r2, d, _BIG)
        dk, ik = torch.sort(key, dim=1, stable=True)
        dk, ik = dk[:, :nsample], ik[:, :nsample]
        if dk.shape[1] < nsample:          # fewer points than nsample
            pad = nsample - dk.shape[1]
            dk = torch.cat([dk, dk.new_full((dk.shape[0], pad), _BIG)], 1)
            ik = torch.cat([ik, ik.new_zeros((ik.shape[0], pad))], 1)
        ok = dk < _BIG
        idx.append(torch.where(ok, ik, -1).to(torch.int32))
        cnt.append(ok.sum(-1).to(torch.int32))
    return torch.cat(idx), torch.cat(cnt)


def bfs_cluster(nbr_idx, same_group, valid, max_iters: int = 64):
    """Connected components over a neighbour graph as label propagation:
    every point starts as its own cluster, each round takes the least
    label over its neighbours of the same group and jumps through the
    representatives, until nothing changes or ``max_iters`` rounds (ref
    bfs_cluster.cpp:28-75). Returns (N,) int32 ids, -1 where invalid.

    nbr_idx: (N, nsample) int32 from ``ballquery`` (-1 padded);
    same_group: (N,) int group key, edges join equal keys only."""
    n = nbr_idx.shape[0]
    dev = nbr_idx.device
    nbr = nbr_idx.long()
    labels = torch.where(valid, torch.arange(n, device=dev), n)
    safe_nbr = torch.where(nbr >= 0, nbr, n)
    key = torch.where(valid, same_group.long(), -1)
    key_p = torch.cat([key, key.new_full((1,), -2)])
    edge_ok = (key_p[safe_nbr] == key[:, None]) & (nbr >= 0)
    for _ in range(max_iters):
        lp = torch.cat([labels, labels.new_full((1,), n)])
        nbr_lab = torch.where(edge_ok, lp[safe_nbr], n)
        new = torch.minimum(labels, nbr_lab.min(-1).values)
        new = torch.minimum(new, lp[new.clamp(max=n - 1)])
        changed = bool((new != labels).any())
        labels = new
        if not changed:
            break
    return torch.where(valid, labels, -1).to(torch.int32)


def _segment_ids_from_offsets(offsets, n):
    """offsets (S+1,) -> (n,) segment id of each row (past the last
    offset: S, the null segment)."""
    rows = torch.arange(n, device=offsets.device, dtype=offsets.dtype)
    return torch.searchsorted(offsets[1:].contiguous(), rows, right=True)


def _segment_reduce(feats, offsets, reduce, init):
    s = offsets.shape[0] - 1
    ids = _segment_ids_from_offsets(offsets, feats.shape[0])
    out = feats.new_full((s + 1, feats.shape[1]), init)
    out.scatter_reduce_(0, ids[:, None].expand_as(feats), feats, reduce)
    return out[:s]


def sec_mean(feats, offsets):
    """Per-segment mean (ref sec_mean.cu:12-43): feats (n, c),
    offsets (S+1,) -> (S, c)."""
    total = _segment_reduce(feats, offsets, 'sum', 0.0)
    cnt = (offsets[1:] - offsets[:-1]).to(feats.dtype)
    return total / cnt.clamp(min=1)[:, None]


def sec_min(feats, offsets):
    """(ref sec_mean.cu:46-75); an empty segment gives +inf."""
    return _segment_reduce(feats, offsets, 'amin', float('inf'))


def sec_max(feats, offsets):
    """(ref sec_mean.cu:78-110); an empty segment gives -inf."""
    return _segment_reduce(feats, offsets, 'amax', float('-inf'))


def roipool(feats, proposal_ids, n_proposals: int):
    """Per-proposal channelwise max-pool (ref roipool.cu:12-58):
    feats (n, c), proposal_ids (n,) (-1 = none) -> (P, c), 0 for an empty
    proposal. The gradient reaches the maximal rows (autograd's
    scatter-reduce backward, the reference's scatter)."""
    ids = torch.where(proposal_ids >= 0, proposal_ids.long(), n_proposals)
    out = feats.new_full((n_proposals + 1, feats.shape[1]), float('-inf'))
    out = out.scatter_reduce(0, ids[:, None].expand_as(feats), feats,
                             'amax')[:n_proposals]
    return torch.where(torch.isfinite(out), out, 0.0)


def get_iou(proposal_ids, instance_labels, n_proposals: int,
            n_instances: int):
    """Proposal-vs-instance IoU matrix (ref get_iou.cu:12-43) from one-hot
    intersection counts."""
    def one_hot(ids, n):
        ids = torch.where(ids >= 0, ids.long(), n)
        return torch.nn.functional.one_hot(ids, n + 1)[:, :n].float()

    p = one_hot(proposal_ids, n_proposals)
    g = one_hot(instance_labels, n_instances)
    inter = p.T @ g
    union = p.sum(0)[:, None] + g.sum(0)[None, :] - inter
    return inter / union.clamp(min=1.0)


# ---------------------------------------------------------------------------
# host-side helpers
# ---------------------------------------------------------------------------

def knn_broadcast_labels(xyz_sub, labels_sub, xyz_all):
    """1-NN label broadcast from a subsampled scene to full resolution —
    the eval/pseudo-label path for cropped or downsampled scenes
    (ref: model/unet.py:135-145 via pointops.knnquery(1, ...)), on the
    native grid-hash NN (``native/host_ops.nn1``)."""
    from ..native import host_ops
    idx = host_ops.nn1(np.asarray(xyz_sub, np.float32),
                       np.asarray(xyz_all, np.float32), cell=0.1)
    return np.asarray(labels_sub)[idx]
