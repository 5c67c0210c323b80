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
mid-16 flagship) to K2 ``banded_conv_sm_taps``. The convs left to K1 run
its fused version (``banded_conv_fused``, from the activation and the
level's rulebook) in bf16 wherever cin and cout are multiples of 8, its
narrow-input version (``banded_conv_narrow``) on the bf16 cin = 3 input
conv, its float32 version (``banded_conv_f32``, from the activation and
the rulebook too) on every float32 conv, and the assembled version on the
bf16 widths that neither bf16 kernel takes (``bricks2d.subm_route``). In
train mode (``model.train()``) the norms use batch statistics and every
conv carries its own backward (``ops/bricks2d.py``).

``fuse_norm`` is the counterpart of the JAX package's ``DODA_FUSE_NORM=1``
(off by default, as there): every norm in front of a conv returns its
folded (scale, bias) and the conv applies relu(x*scale + bias) and the
cell mask itself (``subm_conv3_norm_2d``, ``down_conv2_norm_2d``,
``up_conv2_norm_2d``). On the fused route that happens inside K1 as it
stages the halo, so the normalized activation is never written. The
parameters and their names are the same either way. In train mode the
folded scale and bias come from the batch statistics, so their gradients
flow back through the statistics to x.

``conv_engine`` is the counterpart of the JAX package's ``DODA_CONV`` and
``deep_xla_rows`` of its ``DODA_DEEP_XLA`` (``_fsubm``); both are
arguments here, never environment variables. '2d' (the default) runs every
subm conv on ``bricks2d.subm_conv3_2d`` and its kernels; 'slab' runs the
subm convs of the levels that carry slab maps (``SLAB_LEVELS``: levels 0
and 1) on ``slabs.subm_conv3_slab`` and the rest as '2d'; 'xla' runs every
subm conv on the concat-assembly engine ``bricks.subm_conv3_v2``, and
'oracle' on the shell-gather oracle ``bricks.subm_conv3``. Under '2d' and
'slab', a level with no more flat rows than ``deep_xla_rows`` (0: none)
takes ``subm_conv3_v2`` for the convs it would give '2d'. The engines
other than '2d' are plain PyTorch (gathers, ``torch.matmul`` and
``F.conv3d``) and launch no kernel. The down and up convs stay on
``bricks2d`` under every engine. The fused norm engine applies where the
JAX package's ``_fuse_norm_ok`` lets it: on '2d', and under 'slab' at the
levels without slab maps; elsewhere the blocks run unfused. The JAX
package's blocks rebuild their ``FlatLevel`` without its slab maps, so
there ``DODA_CONV=slab`` reaches the input conv alone; here it reaches
every subm conv of levels 0 and 1. The engines agree to float32
rounding, so the logits do too.

``remat`` is the memory policy of the blocks (``block{i}``, ``tail{i}``),
the counterpart of the JAX package's ``DODA_REMAT`` (``remat_policy``):
'off' (the default here) keeps every intermediate for the backward;
'all' keeps a block's input alone and replays its forward in the
backward; 'dots' (the JAX package's default) also keeps the outputs of
its products (``PRODUCTS``: each subm conv's, on whichever route or
engine, and the 1x1 shortcut's matmul), so the replay recomputes the
norms, ReLUs, masks and the residual add but launches no conv; 'mixN' is
'all' below level N and 'dots' from it. The input conv, the down and up
convs with their norms, the skip concat and the head are never replayed.
The replay holds the norms' running statistics (``running_stats_held``),
so a step moves them once under every policy; results equal 'off''s.

``brick`` is the brick side, the counterpart of the JAX package's
``DODA_BRICK`` (4 by default, as there): ``build_level_plan(...,
brick=s)`` builds the plan in bricks of s^3 cells and the net reads s
from the plan's occupancy; a plan of another side than the net's raises.
The parameters do not depend on it, so one set of weights runs at every
side. K1's kernels and K2's (``sm_max_cin > 0``) run at sides 2 and 4.
"""

from __future__ import annotations

import contextlib
import functools
import re
from typing import NamedTuple, Sequence

import torch
from torch import nn
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts,
                                    noop_context_fn, set_checkpoint_early_stop)

from ..ops.bricks import (BrickGrid, brickify, build_brick_downsample,
                          build_brick_rulebook, cell_feats_2d, geometry,
                          side_of, subm_conv3, subm_conv3_v2)
from ..ops.banded_conv import occ_words
from ..ops.bricks2d import (conv1x1_2d, down_conv2_2d, down_conv2_norm_2d,
                            halo_index, sm_index, subm_conv3_2d,
                            subm_conv3_norm_2d, subm_route, up_conv2_2d,
                            up_conv2_norm_2d, uses_sm)
from ..ops.slabs import (SlabMaps, build_slab_maps, flatten_slab,
                         subm_conv3_slab)
from ..utils.device import resolve_device
from .norm import MaskedBatchNorm, running_stats_held

CONV_ENGINES = ('2d', 'slab', 'xla', 'oracle')

# the ops whose outputs a block keeps under 'dots' (the JAX package's
# dots_with_no_batch_dims_saveable): the subm conv's product on every
# kernel route, the 1x1 shortcut's and the slab engine's matmuls, and the
# other engines' convolutions
PRODUCTS = (torch.ops.doda_torch.subm_conv3_product.default,
            torch.ops.aten.mm.default, torch.ops.aten.convolution.default)

# Levels whose subm convs run on the slab engine under conv_engine='slab':
# the JAX package measured occupied-slice fractions of 43% at level 0, 57%
# at level 1 and ~95% deeper on ScanNet-shaped scenes.
SLAB_LEVELS = 2


class LevelPlan(NamedTuple):
    """Per-batch index structures; every tensor has a leading scene dim.

    grid0 : BrickGrid at level 0 (holds the point <-> cell maps)
    occs  : tuple of (Batch, cap_l, s^3) bool, s the brick side
    nbrs  : tuple of (Batch, cap_l, 27) int32
    downs : tuple of BrickDown between level l and l+1
    slabs : tuple of SlabMaps for the levels < SLAB_LEVELS, or () where
            the plan was built without them
    """

    grid0: BrickGrid
    occs: tuple
    nbrs: tuple
    downs: tuple
    slabs: tuple = ()


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


def default_slab_caps(b_caps, floor: int = 64) -> tuple:
    """Occupied-slice capacity of each slab level: 2.25x the brick cap at
    level 0 and 3x at level 1 (the JAX package measured 1.71 and 2.27
    occupied slices a brick of 4), rounded up to 128 rows. Slices past
    the cap are dropped, as overflowing bricks are."""
    ratios = (9, 12)   # quarters of a brick: 2.25x, 3x
    caps = []
    for lvl in range(min(SLAB_LEVELS, len(b_caps))):
        cap = b_caps[lvl] * ratios[min(lvl, len(ratios) - 1)] // 4
        caps.append(max((cap + 127) // 128 * 128, floor))
    return tuple(caps)


def _scene_plan(coords, valid, b_caps, slabs=False, brick: int = 4):
    grid0 = brickify(coords, valid, b_caps[0], brick)
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
    slab = tuple(build_slab_maps(occs[lvl], nbrs[lvl], cap) for lvl, cap in
                 enumerate(default_slab_caps(b_caps))) if slabs else ()
    return LevelPlan(grid0=grid0, occs=tuple(occs), nbrs=tuple(nbrs),
                     downs=tuple(downs), slabs=slab)


def _stack(items):
    """Stack a list of equal-structured tuples of tensors along dim 0."""
    first = items[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(items)
    fields = [_stack([it[i] for it in items]) for i in range(len(first))]
    return type(first)(*fields) if hasattr(first, '_fields') \
        else tuple(fields)


def build_level_plan(coords, valid, b_caps: Sequence[int],
                     device="cuda", slabs: bool = False,
                     brick: int = 4) -> LevelPlan:
    """Batched plan: coords (Batch, N, 3) voxel coords, valid (Batch, N),
    in bricks of side ``brick``, with ``b_caps[l]`` bricks at level l.
    ``slabs`` also builds the slab maps of the levels < SLAB_LEVELS, which
    only ``conv_engine='slab'`` reads."""
    dev = resolve_device(device)
    coords = torch.as_tensor(coords, device=dev).to(torch.int32)
    valid = torch.as_tensor(valid, device=dev).to(torch.bool)
    return _stack([_scene_plan(coords[s], valid[s], tuple(b_caps), slabs,
                               brick)
                   for s in range(coords.shape[0])])


# ---------------------------------------------------------------------------
# scene flattening: (Batch, cap, ...) index tables -> flat rows with a
# single global null id per table (null == n_rows)
# ---------------------------------------------------------------------------

class FlatLevel(NamedTuple):
    occ: torch.Tensor     # (Batch*cap, s^3) bool
    nbr: torch.Tensor     # (Batch*cap, 27) int32, null == Batch*cap
    halo: torch.Tensor    # (Batch*cap, (s+2)^3) int32 from halo_index(nbr)
    sm: torch.Tensor | None = None   # (Batch*cap, 176) from sm_index(nbr),
    #                                  only where the level has a K2 conv
    occw: torch.Tensor | None = None  # (Batch*cap,) int64 occ_words(occ),
    #                                   only under fuse_norm
    slab: SlabMaps | None = None     # flat slab maps, where the plan has them


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


def flatten_plan(plan: LevelPlan, sm_levels=(), words: bool = False):
    """Batched LevelPlan -> per-level flat tables for the 2D engine; the
    levels listed in ``sm_levels`` also get their source-major index, and
    with ``words`` every level its occupancy words (the prologue K1's)."""
    levels, downs = [], []
    side = side_of(plan.occs[0].shape[-1])
    for lvl, (occ, nbr) in enumerate(zip(plan.occs, plan.nbrs)):
        flat_nbr = _flat_ids(nbr, occ.shape[1])
        flat_occ = occ.reshape(-1, occ.shape[-1])
        slab = None
        if lvl < len(plan.slabs):
            sm_ = plan.slabs[lvl]
            slab = flatten_slab(sm_, sm_.row2slice.shape[1], occ.shape[1])
        levels.append(FlatLevel(
            occ=flat_occ, nbr=flat_nbr, halo=halo_index(flat_nbr, side),
            sm=sm_index(flat_nbr, side) if lvl in sm_levels else None,
            occw=occ_words(flat_occ) if words else None, slab=slab))
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


def subm_engine(conv_engine: str, has_slab: bool, rows: int,
                deep_xla_rows: int) -> str:
    """The engine of a subm conv (the JAX package's ``_fsubm``) at a level
    of ``rows`` flat rows, with or without slab maps: '2d', 'slab', 'xla'
    or 'oracle'. ``deep_xla_rows`` 0 sends no level to 'xla'."""
    if conv_engine == 'slab' and has_slab:
        return 'slab'
    if conv_engine in ('2d', 'slab'):
        return 'xla' if 0 < deep_xla_rows and rows <= deep_xla_rows \
            else '2d'
    return conv_engine


def fuse_norm_ok(conv_engine: str, has_slab: bool) -> bool:
    """Whether ``fuse_norm`` folds a norm into the conv behind it (the JAX
    package's ``_fuse_norm_ok``): on '2d', and under 'slab' at a level
    without slab maps."""
    return conv_engine == '2d' or (conv_engine == 'slab' and not has_slab)


def remat_policy(remat: str, level: int) -> str:
    """What the blocks at ``level`` keep for the backward under the memory
    policy ``remat`` (the JAX package's ``_remat_policy`` and ``UBlock``,
    with ``DODA_REMAT`` as an argument): 'off' (everything), 'all' (the
    block's input alone; the backward replays the forward) or 'dots' (the
    input and the outputs of ``PRODUCTS``; the replay recomputes the
    rest). ``remat`` is 'off', 'dots', 'all' or 'mixN', which is 'all'
    at the levels below N and 'dots' from N on ('mix' is 'mix2');
    anything else raises ValueError."""
    if remat in ('off', 'dots', 'all'):
        return remat
    mix = re.fullmatch(r'mix(\d*)', remat) if isinstance(remat, str) \
        else None
    if mix is None:
        raise ValueError(f"remat {remat!r} is none of 'off', 'dots', 'all', "
                         "'mix', 'mixN'")
    return 'all' if level < int(mix.group(1) or 2) else 'dots'


def _checkpointed(block, x, lv, domain, policy: str):
    """``block(x, lv, domain)`` under non-reentrant activation
    checkpointing: the backward replays the whole forward (no early stop,
    so every conv of the block runs again under 'all'), with the block's
    running statistics held; under 'dots' the outputs of ``PRODUCTS`` are
    kept and handed back in the replay."""
    calls = []

    def run(x):
        replay = running_stats_held(block) if calls \
            else contextlib.nullcontext()
        calls.append(None)
        with replay:
            return block(x, lv, domain)

    context_fn = functools.partial(create_selective_checkpoint_contexts,
                                   list(PRODUCTS)) \
        if policy == 'dots' else noop_context_fn
    with set_checkpoint_early_stop(False):
        return checkpoint(run, x, use_reentrant=False, context_fn=context_fn,
                          preserve_rng_state=False)


def _fsubm(x2, lv: FlatLevel, w, dtype, sm_max_cin: int, conv_engine: str,
           deep_xla_rows: int):
    """The subm conv of x2 (rows, s^3*cin) on the engine ``subm_engine``
    picks; (rows, s^3*cout) in x2.dtype, masked."""
    engine = subm_engine(conv_engine, lv.slab is not None, x2.shape[0],
                         deep_xla_rows)
    if engine == '2d':
        return subm_conv3_2d(x2, lv.occ, lv.halo, w, dtype, lv.sm,
                             sm_max_cin, lv.nbr)
    if engine == 'slab':
        return subm_conv3_slab(x2, lv.slab, w, dtype)
    rows = x2.shape[0]
    conv = subm_conv3_v2 if engine == 'xla' else subm_conv3
    out = conv(x2.reshape(rows, lv.occ.shape[1], -1), lv.occ, lv.nbr, w,
               dtype)
    return out.reshape(rows, -1).to(x2.dtype)


class _NormSubm(nn.Module):
    """What the blocks share: BN -> ReLU -> SubMConv3, unfused (on the
    engine ``subm_engine`` picks) or through ``subm_conv3_norm_2d``."""

    def __init__(self, dtype, sm_max_cin: int, fuse_norm: bool,
                 conv_engine: str = '2d', deep_xla_rows: int = 0):
        super().__init__()
        self.dtype, self.sm_max_cin = dtype, sm_max_cin
        self.fuse_norm = fuse_norm
        self.conv_engine, self.deep_xla_rows = conv_engine, deep_xla_rows

    def norm_conv(self, norm, kernel, x, lv: FlatLevel, domain):
        if self.fuse_norm and fuse_norm_ok(self.conv_engine,
                                           lv.slab is not None):
            s, b = norm(x, lv.occ, domain, fold=True)
            return subm_conv3_norm_2d(x, lv.occ, lv.halo, kernel, s, b,
                                      self.dtype, lv.sm, self.sm_max_cin,
                                      lv.nbr, lv.occw)
        h = torch.relu(norm(x, lv.occ, domain))
        return _fsubm(h, lv, kernel, self.dtype, self.sm_max_cin,
                      self.conv_engine, self.deep_xla_rows)


class ResidualBlock(_NormSubm):
    """Pre-activation residual block (ref: model/unet_block.py:10-38)."""

    def __init__(self, cin: int, cout: int, dsnorm: bool = False,
                 dtype=torch.bfloat16, sm_max_cin: int = 0,
                 fuse_norm: bool = False, conv_engine: str = '2d',
                 deep_xla_rows: int = 0):
        super().__init__(dtype, sm_max_cin, fuse_norm, conv_engine,
                         deep_xla_rows)
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
        h = self.norm_conv(self.MaskedBatchNorm_0, self.kernel1, x, lv,
                           domain)
        h = self.norm_conv(self.MaskedBatchNorm_1, self.kernel2, h, lv,
                           domain)
        return h + identity


class VGGBlock(_NormSubm):
    """BN -> ReLU -> SubMConv3 (ref: model/unet_block.py:41-52)."""

    def __init__(self, cin: int, cout: int, dsnorm: bool = False,
                 dtype=torch.bfloat16, sm_max_cin: int = 0,
                 fuse_norm: bool = False, conv_engine: str = '2d',
                 deep_xla_rows: int = 0):
        super().__init__(dtype, sm_max_cin, fuse_norm, conv_engine,
                         deep_xla_rows)
        self.MaskedBatchNorm_0 = MaskedBatchNorm(cin, dsnorm=dsnorm)
        self.kernel = _conv_param(27, cin, cout)

    def forward(self, x, lv: FlatLevel, domain):
        return self.norm_conv(self.MaskedBatchNorm_0, self.kernel, x, lv,
                              domain)


def _concat_channels(a: torch.Tensor, b: torch.Tensor, ca: int,
                     cb: int) -> torch.Tensor:
    """Per-cell channel concat of two (rows, cells*C) tensors."""
    rows, cells = a.shape[0], a.shape[1] // ca
    return torch.cat([a.reshape(rows, cells, ca), b.reshape(rows, cells, cb)],
                     dim=2).reshape(rows, cells * (ca + cb))


class UBlock(nn.Module):
    """Recursive U-stage (ref: model/unet_block.py:55-100)."""

    def __init__(self, planes: tuple, block_reps: int = 2,
                 residual: bool = True, dsnorm: bool = False,
                 dtype=torch.bfloat16, sm_max_cin: int = 0,
                 fuse_norm: bool = False, conv_engine: str = '2d',
                 deep_xla_rows: int = 0, remat: str = 'off'):
        super().__init__()
        self.planes, self.block_reps, self.dtype = planes, block_reps, dtype
        self.fuse_norm, self.conv_engine = fuse_norm, conv_engine
        self.remat = remat
        block = ResidualBlock if residual else VGGBlock
        kw = dict(dsnorm=dsnorm, dtype=dtype, sm_max_cin=sm_max_cin,
                  fuse_norm=fuse_norm, conv_engine=conv_engine,
                  deep_xla_rows=deep_xla_rows)
        p = planes[0]
        for i in range(block_reps):
            setattr(self, f'block{i}', block(p, p, **kw))
        if len(planes) == 1:
            return
        self.conv_norm = MaskedBatchNorm(p, dsnorm=dsnorm)
        self.down_kernel = _conv_param(8, p, planes[1])
        self.u = UBlock(planes[1:], block_reps, residual, remat=remat, **kw)
        self.deconv_norm = MaskedBatchNorm(planes[1], dsnorm=dsnorm)
        self.up_kernel = _conv_param(8, planes[1], p)
        for i in range(block_reps):
            setattr(self, f'tail{i}', block(2 * p if i == 0 else p, p, **kw))

    def _block(self, name, x, lv: FlatLevel, level: int, domain):
        """Block ``name`` under the memory policy of its level; in eval
        mode and without grad every policy runs it plainly."""
        block = getattr(self, name)
        policy = remat_policy(self.remat, level)
        if policy == 'off' or not (self.training and torch.is_grad_enabled()):
            return block(x, lv, domain)
        return _checkpointed(block, x, lv, domain, policy)

    def forward(self, x, levels, downs, level: int, domain):
        p = self.planes[0]
        lv = levels[level]
        for i in range(self.block_reps):
            x = self._block(f'block{i}', x, lv, level, domain)
        if len(self.planes) == 1:
            return x
        identity = x
        occ_p = levels[level + 1].occ
        fused = self.fuse_norm and fuse_norm_ok(self.conv_engine,
                                                lv.slab is not None)
        if fused:
            s, b = self.conv_norm(x, lv.occ, domain, fold=True)
            h = down_conv2_norm_2d(x, lv.occ, occ_p, downs[level],
                                   self.down_kernel, s, b, self.dtype)
        else:
            h = torch.relu(self.conv_norm(x, lv.occ, domain))
            h = down_conv2_2d(h, occ_p, downs[level], self.down_kernel,
                              self.dtype)
        h = self.u(h, levels, downs, level + 1, domain)
        if fused:
            s, b = self.deconv_norm(h, occ_p, domain, fold=True)
            h = up_conv2_norm_2d(h, occ_p, lv.occ, downs[level],
                                 self.up_kernel, s, b, self.dtype)
        else:
            h = torch.relu(self.deconv_norm(h, occ_p, domain))
            h = up_conv2_2d(h, lv.occ, downs[level], self.up_kernel,
                            self.dtype)
        x = _concat_channels(identity, h, p, p)   # skip-concat (2p)
        for i in range(self.block_reps):
            x = self._block(f'tail{i}', x, lv, level, domain)
        return x


class SparseConvNet(nn.Module):
    """The full backbone + linear head (ref: model/unet.py:15-69)."""

    def __init__(self, in_channel: int = 3, mid_channel: int = 16,
                 n_classes: int = 20, block_reps: int = 2,
                 block_residual: bool = True, num_levels: int = 7,
                 dsnorm: bool = False, dtype=torch.bfloat16,
                 sm_max_cin: int = 0, fuse_norm: bool = False,
                 conv_engine: str = '2d', deep_xla_rows: int = 0,
                 remat: str = 'off', brick: int = 4):
        super().__init__()
        if conv_engine not in CONV_ENGINES:
            raise ValueError(f'conv_engine {conv_engine!r} is none of '
                             f'{CONV_ENGINES}')
        remat_policy(remat, 0)                  # raises on a bad policy
        self.brick = geometry(brick).side       # raises on an odd side
        self.remat = remat
        self.in_channel, self.mid_channel = in_channel, mid_channel
        self.num_levels, self.dtype = num_levels, dtype
        self.sm_max_cin, self.fuse_norm = sm_max_cin, fuse_norm
        self.conv_engine, self.deep_xla_rows = conv_engine, deep_xla_rows
        m = mid_channel
        self.input_kernel = _conv_param(27, in_channel, m)
        planes = tuple(m * (i + 1) for i in range(num_levels))
        # a level's convs are p -> p and 2p -> p (plus the input conv at
        # level 0); their backwards run the flipped shapes p -> p, p -> 2p
        self.sm_levels = tuple(
            lvl for lvl, p in enumerate(planes)
            if any(uses_sm(a, b, sm_max_cin, brick) for a, b in
                   ((p, p), (2 * p, p), (p, 2 * p),
                    (in_channel, m) if lvl == 0 else (p, p))))
        self.unet = UBlock(planes, block_reps, block_residual, dsnorm, dtype,
                           sm_max_cin, fuse_norm, conv_engine, deep_xla_rows,
                           remat)
        self.output_norm = MaskedBatchNorm(m, dsnorm=dsnorm)
        self.linear = nn.Linear(m, n_classes)

    def subm_routes(self, backward: bool = False, level_rows=None) -> dict:
        """Kernel launches of the subm convs by ``bricks2d.subm_route``,
        from the parameter shapes: every (27, cin, cout) kernel runs one
        forward conv on (cin, cout); with ``backward`` the dx convs are
        counted instead, on the flipped shape (cout, cin), except the input
        conv's, whose input needs no gradient. Under ``fuse_norm`` a block
        conv's forward on the fused route is a launch of K1's prologue
        variant, counted under 'prologue' (the dx convs take none). The
        convs that ``conv_engine`` or ``deep_xla_rows`` send to another
        engine launch no kernel; they are counted under the engine's name
        ('slab', 'xla', 'oracle'), forward and backward alike. Under
        ``deep_xla_rows`` the count needs ``level_rows``, the flat rows
        (scenes x brick cap) of each level. With ``backward``, the replay of
        ``remat`` counts too: a block conv at a level that ``remat_policy``
        gives 'all' adds one launch of its forward route; one at a 'dots'
        level adds none on '2d' (its product comes back from the kept
        outputs), but a call of another engine's conv function, which
        runs again around its kept products."""
        counts = {'sm': 0, 'fused': 0, 'narrow': 0, 'f32': 0,
                  'assembled': 0}
        if self.fuse_norm:
            counts['prologue'] = 0
        if self.conv_engine != '2d':
            counts[self.conv_engine] = 0
        if self.deep_xla_rows:
            if level_rows is None:
                raise ValueError('deep_xla_rows routes by the rows of each '
                                 'level: pass level_rows')
            counts['xla'] = 0
        for name, p in self.named_parameters():
            if p.dim() != 3 or p.shape[0] != 27:
                continue
            _, cin, cout = p.shape
            lvl = name.split('.').count('u')
            has_slab = self.conv_engine == 'slab' and lvl < SLAB_LEVELS
            if self.fuse_norm and name != 'input_kernel' \
                    and fuse_norm_ok(self.conv_engine, has_slab):
                engine = '2d'
            else:
                engine = subm_engine(
                    self.conv_engine, has_slab,
                    level_rows[lvl] if self.deep_xla_rows else 0,
                    self.deep_xla_rows)
            if engine != '2d':
                fwd = bwd = engine
            else:
                fwd = subm_route(cin, cout, self.dtype, self.sm_max_cin,
                                 self.brick)
                if self.fuse_norm and fwd == 'fused' \
                        and name != 'input_kernel':
                    fwd = 'prologue'
                bwd = subm_route(cout, cin, self.dtype, self.sm_max_cin,
                                 self.brick)
            if not backward:
                counts[fwd] += 1
                continue
            if name == 'input_kernel':   # no dx, and outside every block
                continue
            counts[bwd] += 1
            policy = remat_policy(self.remat, lvl)
            if policy == 'all' or (policy == 'dots' and engine != '2d'):
                counts[fwd] += 1
        return counts

    def forward(self, point_feats: torch.Tensor, plan: LevelPlan,
                domain: int = 0, return_mid_feat: bool = False):
        """point_feats (Batch, N, Cin) -> logits (Batch, N, classes), f32;
        with ``return_mid_feat`` (out_feats (Batch, N, mid), logits), the
        point features in front of the head.

        The voxel (mean) reduction happens here, as in the fused
        pointgroup_ops.voxelization call at ref model/unet.py:91."""
        if self.conv_engine == 'slab' and not plan.slabs:
            raise ValueError("conv_engine='slab' needs a plan built with "
                             'slabs=True')
        cells = plan.grid0.occ.shape[-1]
        if cells != self.brick ** 3:
            raise ValueError(f'a plan of bricks of {cells} cells for a net '
                             f'of brick side {self.brick}: build it with '
                             f'build_level_plan(..., brick={self.brick})')
        m = self.mid_channel
        bt, n = point_feats.shape[:2]
        cap0 = plan.grid0.occ.shape[1]
        levels, downs = flatten_plan(plan, self.sm_levels, self.fuse_norm)

        # flat cell id of every point across the batch, null = rows*cells
        gidx = plan.grid0.flat_index()
        miss = gidx >= cap0 * cells
        offs = torch.arange(bt, device=gidx.device)[:, None] * (cap0 * cells)
        flat = torch.where(miss, bt * cap0 * cells, gidx + offs).reshape(-1)

        x = cell_feats_2d(point_feats.reshape(bt * n, -1), flat, bt * cap0,
                          cells=cells)
        x = _fsubm(x.to(self.dtype), levels[0], self.input_kernel,
                   self.dtype, self.sm_max_cin, self.conv_engine,
                   self.deep_xla_rows)
        x = self.unet(x, levels, downs, 0, domain)

        # output norm folded past the voxel -> point gather (f32 affine)
        o_scale, o_bias = self.output_norm(x, levels[0].occ, domain,
                                           fold=True)
        vox = x.reshape(bt * cap0 * cells, m)
        gathered = vox.index_select(0, flat.clamp(max=vox.shape[0] - 1))
        gathered = gathered.reshape(bt, n, m).float()
        out_feats = torch.where(miss[..., None], 0,
                                torch.relu(gathered * o_scale + o_bias))
        logits = self.linear(out_feats)
        return (out_feats, logits) if return_mid_feat else logits
