"""Submanifold sparse 3D U-Net on the wide-lane brick engine.

Port of ``doda_tpu/models/unet.py``. Architecture as the reference
(7-level U-Net with residual blocks, ref: model/unet.py:15-69 and
model/unet_block.py:10-100):

  input SubMConv3 (no norm) ->
  UBlock([m, 2m, ..., 7m]) with per level:
    block_reps x ResidualBlock (pre-activation: BN -> ReLU -> SubMConv3 x2
                                + identity/1x1 shortcut)
    stride-2 SparseConv3d down, recurse, SparseInverseConv3d up,
    skip-concat, block_reps x tail ResidualBlock (first one 2p -> p)
  -> BN + ReLU -> voxel->point gather -> Linear head (bias).

Index structures are built once per batch by ``build_level_plan``; the
scenes of a batch are flattened into the row dimension with one null id
per table (``flatten_plan``). Module attribute names follow the flax
parameter tree so that ``utils/convert.py`` is a tree walk.

``sm_max_cin`` picks the subm-conv kernel per conv (``bricks2d.uses_sm``):
0 sends every conv to K1 ``banded_conv``; 32, the JAX package's
``DODA_SM=shallow``, sends the convs with cin <= 32 (levels 0 and 1 of the
mid-16 flagship) to K2 ``banded_conv_sm``. The convs left to K1 run its
fused version (``banded_conv_fused``, from the activation and the level's
rulebook) in bf16 wherever cin and cout are multiples of 8, and the
assembled version otherwise (``bricks2d.subm_route``). In train mode
(``model.train()``) the norms use batch statistics and every conv carries
its own backward (``ops/bricks2d.py``).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch
from torch import nn

from ..ops.bricks import (CELLS, BrickGrid, brickify,
                          build_brick_downsample, build_brick_rulebook,
                          cell_feats_2d)
from ..ops.bricks2d import (conv1x1_2d, down_conv2_2d, halo_index, sm_index,
                            subm_conv3_2d, subm_route, up_conv2_2d, uses_sm)
from ..utils.device import resolve_device
from .norm import MaskedBatchNorm


class LevelPlan(NamedTuple):
    """Per-batch index structures; every tensor has a leading scene dim.

    grid0 : BrickGrid at level 0 (holds the point <-> cell maps)
    occs  : tuple of (Batch, cap_l, 64) bool
    nbrs  : tuple of (Batch, cap_l, 27) int32
    downs : tuple of BrickDown between level l and l+1
    """

    grid0: BrickGrid
    occs: tuple
    nbrs: tuple
    downs: tuple


def default_brick_caps(b_cap0: int, num_levels: int,
                       floor: int = 64) -> tuple:
    """Capacity schedule matched to surface geometry (see the JAX
    package's ``default_brick_caps``): level 1 gets 0.4*b0, levels 2-3
    divide by 5, the tail by 4, rounded up to 128 rows. Overflowing
    bricks fall into the null slot and are dropped."""
    def r128(v):
        return max((v + 127) // 128 * 128, floor)

    caps = [max(b_cap0, floor)]
    c = b_cap0 * 2 // 5
    for lvl in range(1, num_levels):
        caps.append(r128(c))
        c //= 5 if lvl <= 2 else 4
    return tuple(caps)


def _scene_plan(coords, valid, b_caps):
    grid0 = brickify(coords, valid, b_caps[0])
    occs = [grid0.occ]
    nbrs = [build_brick_rulebook(grid0.table)]
    downs = []
    table, occ = grid0.table, grid0.occ
    for cap in b_caps[1:]:
        ds = build_brick_downsample(table, occ, cap)
        downs.append(ds)
        table, occ = ds.parent, ds.parent_occ
        occs.append(occ)
        nbrs.append(build_brick_rulebook(table))
    return LevelPlan(grid0=grid0, occs=tuple(occs), nbrs=tuple(nbrs),
                     downs=tuple(downs))


def _stack(items):
    """Stack a list of equal-structured tuples of tensors along dim 0."""
    first = items[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(items)
    fields = [_stack([it[i] for it in items]) for i in range(len(first))]
    return type(first)(*fields) if hasattr(first, '_fields') \
        else tuple(fields)


def build_level_plan(coords, valid, b_caps: Sequence[int],
                     device="cuda") -> LevelPlan:
    """Batched plan: coords (Batch, N, 3) voxel coords, valid (Batch, N)."""
    dev = resolve_device(device)
    coords = torch.as_tensor(coords, device=dev).to(torch.int32)
    valid = torch.as_tensor(valid, device=dev).to(torch.bool)
    return _stack([_scene_plan(coords[s], valid[s], tuple(b_caps))
                   for s in range(coords.shape[0])])


# ---------------------------------------------------------------------------
# scene flattening: (Batch, cap, ...) index tables -> flat rows with a
# single global null id per table (null == n_rows)
# ---------------------------------------------------------------------------

class FlatLevel(NamedTuple):
    occ: torch.Tensor     # (Batch*cap, 64) bool
    nbr: torch.Tensor     # (Batch*cap, 27) int32, null == Batch*cap
    halo: torch.Tensor    # (Batch*cap, 216) int32 from halo_index(nbr)
    sm: torch.Tensor | None = None   # (Batch*cap, 176) from sm_index(nbr),
    #                                  only where the level has a K2 conv


class FlatDown(NamedTuple):
    child_parent: torch.Tensor     # (Batch*cap_l,), null == Batch*cap_{l+1}
    parity: torch.Tensor           # (Batch*cap_l,)
    parent_children: torch.Tensor  # (Batch*cap_{l+1}, 8), null == Batch*cap_l


def _flat_ids(ids: torch.Tensor, cap: int) -> torch.Tensor:
    """(Batch, n, ...) per-scene ids (null == cap) -> flat global ids."""
    bt = ids.shape[0]
    offs = torch.arange(bt, dtype=torch.int32, device=ids.device) * cap
    offs = offs.reshape((bt,) + (1,) * (ids.dim() - 1))
    flat = torch.where(ids >= cap, bt * cap, ids + offs)
    return flat.reshape((-1,) + tuple(ids.shape[2:])).to(torch.int32)


def flatten_plan(plan: LevelPlan, sm_levels=()):
    """Batched LevelPlan -> per-level flat tables for the 2D engine; the
    levels listed in ``sm_levels`` also get their source-major index."""
    levels, downs = [], []
    for lvl, (occ, nbr) in enumerate(zip(plan.occs, plan.nbrs)):
        flat_nbr = _flat_ids(nbr, occ.shape[1])
        levels.append(FlatLevel(
            occ=occ.reshape(-1, CELLS), nbr=flat_nbr,
            halo=halo_index(flat_nbr),
            sm=sm_index(flat_nbr) if lvl in sm_levels else None))
    for lvl, ds in enumerate(plan.downs):
        cap_c = plan.occs[lvl].shape[1]
        cap_p = plan.occs[lvl + 1].shape[1]
        downs.append(FlatDown(
            child_parent=_flat_ids(ds.child_parent, cap_p),
            parity=ds.parity.reshape(-1),
            parent_children=_flat_ids(ds.parent_children, cap_c)))
    return levels, downs


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

def _conv_param(*shape) -> nn.Parameter:
    """Kaiming-uniform over fan_in = K * Cin (torch/spconv default)."""
    fan_in = shape[0] * shape[1] if len(shape) == 3 else shape[0]
    bound = (1.0 / fan_in) ** 0.5
    return nn.Parameter(torch.empty(shape).uniform_(-bound, bound))


class ResidualBlock(nn.Module):
    """Pre-activation residual block (ref: model/unet_block.py:10-38)."""

    def __init__(self, cin: int, cout: int, dsnorm: bool = False,
                 dtype=torch.bfloat16, sm_max_cin: int = 0):
        super().__init__()
        self.dtype, self.sm_max_cin = dtype, sm_max_cin
        if cin != cout:
            self.i_kernel = _conv_param(cin, cout)
        self.MaskedBatchNorm_0 = MaskedBatchNorm(cin, dsnorm=dsnorm)
        self.kernel1 = _conv_param(27, cin, cout)
        self.MaskedBatchNorm_1 = MaskedBatchNorm(cout, dsnorm=dsnorm)
        self.kernel2 = _conv_param(27, cout, cout)

    def forward(self, x, lv: FlatLevel, domain):
        if hasattr(self, 'i_kernel'):
            identity = conv1x1_2d(x, lv.occ, self.i_kernel, self.dtype)
        else:
            identity = x
        h = torch.relu(self.MaskedBatchNorm_0(x, lv.occ, domain))
        h = subm_conv3_2d(h, lv.occ, lv.halo, self.kernel1, self.dtype,
                          lv.sm, self.sm_max_cin, lv.nbr)
        h = torch.relu(self.MaskedBatchNorm_1(h, lv.occ, domain))
        h = subm_conv3_2d(h, lv.occ, lv.halo, self.kernel2, self.dtype,
                          lv.sm, self.sm_max_cin, lv.nbr)
        return h + identity


class VGGBlock(nn.Module):
    """BN -> ReLU -> SubMConv3 (ref: model/unet_block.py:41-52)."""

    def __init__(self, cin: int, cout: int, dsnorm: bool = False,
                 dtype=torch.bfloat16, sm_max_cin: int = 0):
        super().__init__()
        self.dtype, self.sm_max_cin = dtype, sm_max_cin
        self.MaskedBatchNorm_0 = MaskedBatchNorm(cin, dsnorm=dsnorm)
        self.kernel = _conv_param(27, cin, cout)

    def forward(self, x, lv: FlatLevel, domain):
        h = torch.relu(self.MaskedBatchNorm_0(x, lv.occ, domain))
        return subm_conv3_2d(h, lv.occ, lv.halo, self.kernel, self.dtype,
                             lv.sm, self.sm_max_cin, lv.nbr)


def _concat_channels(a: torch.Tensor, b: torch.Tensor, ca: int,
                     cb: int) -> torch.Tensor:
    """Per-cell channel concat of two (rows, 64*C) tensors."""
    rows = a.shape[0]
    return torch.cat([a.reshape(rows, CELLS, ca), b.reshape(rows, CELLS, cb)],
                     dim=2).reshape(rows, CELLS * (ca + cb))


class UBlock(nn.Module):
    """Recursive U-stage (ref: model/unet_block.py:55-100)."""

    def __init__(self, planes: tuple, block_reps: int = 2,
                 residual: bool = True, dsnorm: bool = False,
                 dtype=torch.bfloat16, sm_max_cin: int = 0):
        super().__init__()
        self.planes, self.block_reps, self.dtype = planes, block_reps, dtype
        block = ResidualBlock if residual else VGGBlock
        p = planes[0]
        for i in range(block_reps):
            setattr(self, f'block{i}', block(p, p, dsnorm, dtype, sm_max_cin))
        if len(planes) == 1:
            return
        self.conv_norm = MaskedBatchNorm(p, dsnorm=dsnorm)
        self.down_kernel = _conv_param(8, p, planes[1])
        self.u = UBlock(planes[1:], block_reps, residual, dsnorm, dtype,
                        sm_max_cin)
        self.deconv_norm = MaskedBatchNorm(planes[1], dsnorm=dsnorm)
        self.up_kernel = _conv_param(8, planes[1], p)
        for i in range(block_reps):
            setattr(self, f'tail{i}',
                    block(2 * p if i == 0 else p, p, dsnorm, dtype,
                          sm_max_cin))

    def forward(self, x, levels, downs, level: int, domain):
        p = self.planes[0]
        lv = levels[level]
        for i in range(self.block_reps):
            x = getattr(self, f'block{i}')(x, lv, domain)
        if len(self.planes) == 1:
            return x
        identity = x
        occ_p = levels[level + 1].occ
        h = torch.relu(self.conv_norm(x, lv.occ, domain))
        h = down_conv2_2d(h, occ_p, downs[level], self.down_kernel,
                          self.dtype)
        h = self.u(h, levels, downs, level + 1, domain)
        h = torch.relu(self.deconv_norm(h, occ_p, domain))
        h = up_conv2_2d(h, lv.occ, downs[level], self.up_kernel, self.dtype)
        x = _concat_channels(identity, h, p, p)   # skip-concat (2p)
        for i in range(self.block_reps):
            x = getattr(self, f'tail{i}')(x, lv, domain)
        return x


class SparseConvNet(nn.Module):
    """The full backbone + linear head (ref: model/unet.py:15-69)."""

    def __init__(self, in_channel: int = 3, mid_channel: int = 16,
                 n_classes: int = 20, block_reps: int = 2,
                 block_residual: bool = True, num_levels: int = 7,
                 dsnorm: bool = False, dtype=torch.bfloat16,
                 sm_max_cin: int = 0):
        super().__init__()
        self.in_channel, self.mid_channel = in_channel, mid_channel
        self.num_levels, self.dtype = num_levels, dtype
        self.sm_max_cin = sm_max_cin
        m = mid_channel
        self.input_kernel = _conv_param(27, in_channel, m)
        planes = tuple(m * (i + 1) for i in range(num_levels))
        # a level's convs are p -> p and 2p -> p (plus the input conv at
        # level 0); their backwards run the flipped shapes p -> p, p -> 2p
        self.sm_levels = tuple(
            lvl for lvl, p in enumerate(planes)
            if any(uses_sm(a, b, sm_max_cin) for a, b in
                   ((p, p), (2 * p, p), (p, 2 * p),
                    (in_channel, m) if lvl == 0 else (p, p))))
        self.unet = UBlock(planes, block_reps, block_residual, dsnorm, dtype,
                           sm_max_cin)
        self.output_norm = MaskedBatchNorm(m, dsnorm=dsnorm)
        self.linear = nn.Linear(m, n_classes)

    def subm_routes(self, backward: bool = False) -> dict:
        """Kernel launches of the subm convs by ``bricks2d.subm_route``,
        from the parameter shapes: every (27, cin, cout) kernel runs one
        forward conv on (cin, cout); with ``backward`` the dx convs are
        counted instead, on the flipped shape (cout, cin), except the input
        conv's, whose input needs no gradient."""
        counts = {'sm': 0, 'fused': 0, 'assembled': 0}
        for name, p in self.named_parameters():
            if p.dim() != 3 or p.shape[0] != 27:
                continue
            _, cin, cout = p.shape
            if not backward:
                counts[subm_route(cin, cout, self.dtype,
                                  self.sm_max_cin)] += 1
            elif name != 'input_kernel':
                counts[subm_route(cout, cin, self.dtype,
                                  self.sm_max_cin)] += 1
        return counts

    def forward(self, point_feats: torch.Tensor, plan: LevelPlan,
                domain: int = 0) -> torch.Tensor:
        """point_feats (Batch, N, Cin) -> logits (Batch, N, classes), f32.

        The voxel (mean) reduction happens here, as in the fused
        pointgroup_ops.voxelization call at ref model/unet.py:91."""
        m = self.mid_channel
        bt, n = point_feats.shape[:2]
        cap0 = plan.grid0.occ.shape[1]
        levels, downs = flatten_plan(plan, self.sm_levels)

        # flat cell id of every point across the batch, null = rows*64
        gidx = plan.grid0.flat_index()
        miss = gidx >= cap0 * CELLS
        offs = torch.arange(bt, device=gidx.device)[:, None] * (cap0 * CELLS)
        flat = torch.where(miss, bt * cap0 * CELLS, gidx + offs).reshape(-1)

        x = cell_feats_2d(point_feats.reshape(bt * n, -1), flat, bt * cap0)
        x = subm_conv3_2d(x.to(self.dtype), levels[0].occ, levels[0].halo,
                          self.input_kernel, self.dtype, levels[0].sm,
                          self.sm_max_cin, levels[0].nbr)
        x = self.unet(x, levels, downs, 0, domain)

        # output norm folded past the voxel -> point gather (f32 affine)
        o_scale, o_bias = self.output_norm(x, levels[0].occ, domain,
                                           fold=True)
        cells = x.reshape(bt * cap0 * CELLS, m)
        gathered = cells.index_select(0, flat.clamp(max=cells.shape[0] - 1))
        gathered = gathered.reshape(bt, n, m).float()
        out_feats = torch.where(miss[..., None], 0,
                                torch.relu(gathered * o_scale + o_bias))
        return self.linear(out_feats)
