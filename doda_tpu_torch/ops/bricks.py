"""Dense s^3 bricks over the sparse voxel set (one scene).

Port of ``doda_tpu/ops/bricks.py``. The plan-building half: points are
deduplicated into bricks of side s (``brickify``), each brick gets its 27
neighbour bricks (``build_brick_rulebook``) and each level is linked to the
next coarser one by a stride-2 map (``build_brick_downsample``). Cell
``x*s*s + y*s + z`` of a brick is one voxel; activations are wide-lane
``(bricks, s^3*C)`` tensors that are zero at inactive cells.

The side is the JAX package's ``DODA_BRICK``, here an argument of
``brickify`` (default 4, the JAX package's default); every other function
reads it from the widths it is given (``side_of``: an occupancy of side^3
cells). ``geometry(side)`` holds the numbers a side fixes. The module
names ``BRICK``, ``CELLS``, ``_H`` and ``WINDOWS`` are side 4's.

The 3D brick convs, on ``(bricks, s^3, C)`` features: the shell-gather
oracle ``subm_conv3`` and the concat-assembly engine ``subm_conv3_v2``
each assemble every brick's (s+2)^3 halo, the first from the facing
faces, edges and corners of its 26 neighbours (``_shell_layout``), the
second from a piece-major table of boundary cells (``extract_pieces``),
and convolve it with one dense ``F.conv3d`` (VALID, a cross-correlation,
as ``lax.conv_general_dilated`` is). Neither shares the halo tables of
``bricks2d`` (``halo_index``), so each is an independent reference for the
kernels' indexing. ``down_conv2`` and ``up_conv2`` are the stride-2 oracles,
with the JAX package's custom VJPs as ``torch.autograd.Function``s.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from .coords import CoordTable, pad_rows, unique_coords_packed
from .sparse import build_subm_rulebook

@dataclasses.dataclass(frozen=True)
class BrickGeometry:
    """What the brick side fixes (the JAX package's module constants of
    ``bricks.py``, ``bricks2d.py`` and ``slabs.py`` at ``DODA_BRICK``);
    the static tables that derive from it are the ``lru_cache``d
    functions of those modules, keyed by side."""

    side: int            # BRICK
    cells: int           # CELLS = side^3 cells a brick
    half: int            # _H = side // 2, the downsampled brick side
    windows: int         # WINDOWS = half^3 stride-2 outputs a brick
    halo_side: int       # side + 2
    plane: int           # halo_side^2 cells a halo x-plane
    halo_cells: int      # halo_side^3 cells a brick's halo
    slice_cells: int     # side^2 cells an x-slice (OUTP, slabs' SLICE)


@functools.lru_cache(maxsize=None)
def geometry(side: int = 4) -> BrickGeometry:
    """The geometry of bricks of ``side`` (any even side >= 2: the
    stride-2 map needs side // 2 windows an axis); ValueError else."""
    if not isinstance(side, int) or side < 2 or side % 2:
        raise ValueError(f'brick side {side!r}: need an even side >= 2')
    h = side // 2
    return BrickGeometry(side=side, cells=side ** 3, half=h, windows=h ** 3,
                         halo_side=side + 2, plane=(side + 2) ** 2,
                         halo_cells=(side + 2) ** 3,
                         slice_cells=side * side)


def side_of(cells: int) -> int:
    """The brick side whose bricks hold ``cells`` cells (an occupancy's
    width); ValueError where that is no cube of an even side."""
    side = round(cells ** (1 / 3))
    if side ** 3 != cells:
        raise ValueError(f'{cells} cells a brick is no cube of a side')
    return geometry(side).side


BRICK = 4
CELLS = BRICK ** 3
_H = BRICK // 2             # downsampled brick side
WINDOWS = _H ** 3           # stride-2 output positions per brick


class BrickGrid(NamedTuple):
    table: CoordTable       # brick coords; table.p2v maps point -> brick
    occ: torch.Tensor       # (b_cap, side^3) bool active cells
    p2c: torch.Tensor       # (N,) int32 cell of each point

    @property
    def b_cap(self) -> int:
        return self.occ.shape[-2]

    def flat_index(self) -> torch.Tensor:
        """Point -> flat cell id in [0, b_cap*cells]; null ->
        b_cap*cells."""
        cells = self.occ.shape[-1]
        p2b = self.table.p2v
        idx = p2b * cells + self.p2c
        return torch.where(p2b >= self.b_cap, self.b_cap * cells, idx)


def brickify(coords: torch.Tensor, valid: torch.Tensor,
             b_cap: int, brick: int = BRICK) -> BrickGrid:
    """Voxel coords (N, 3) -> brick table + cell occupancy, in bricks of
    side ``brick``."""
    g = geometry(brick)
    cell_xyz = coords % brick
    cell = (cell_xyz[:, 0] * (brick * brick) + cell_xyz[:, 1] * brick
            + cell_xyz[:, 2])
    cell = torch.where(valid, cell, 0).to(torch.int32)
    table = unique_coords_packed(torch.div(coords, brick,
                                           rounding_mode='floor'),
                                 valid, b_cap)
    occ = torch.zeros((b_cap + 1, g.cells), dtype=torch.bool,
                      device=coords.device)
    occ[table.p2v.long(), cell.long()] = True     # misses land in row b_cap
    return BrickGrid(table=table, occ=occ[:b_cap], p2c=cell)


def cell_feats_2d(feats: torch.Tensor, flat: torch.Tensor, rows: int,
                  mode: int = 4, cells: int = CELLS) -> torch.Tensor:
    """Reduce point features into cells: (N, C) -> (rows, cells*C).

    ``flat`` holds each point's flat cell id, ``rows*cells`` for none
    (``cells`` a brick: side^3). mode 4 = mean, 3 = sum (ref
    voxelize.cu:10-31). Sums run in float32 with ``index_add_``; cells no
    point reaches stay exactly zero."""
    if mode not in (3, 4):
        raise NotImplementedError(f'brick voxel mode {mode}')
    n_seg = rows * cells
    c = feats.shape[-1]
    flat = flat.long()
    f32 = feats.to(torch.float32)
    total = f32.new_zeros((n_seg + 1, c)).index_add_(0, flat, f32)[:n_seg]
    if mode == 4:
        count = f32.new_zeros(n_seg + 1).index_add_(
            0, flat, f32.new_ones(flat.shape[0]))[:n_seg]
        total = total / count.clamp(min=1.0)[:, None]
    return total.reshape(rows, cells * c).to(feats.dtype)


def brick_feats_2d(feats: torch.Tensor, grid: BrickGrid,
                   mode: int = 4) -> torch.Tensor:
    """``cell_feats_2d`` over one scene's grid: (N, C) -> (b_cap,
    cells*C)."""
    return cell_feats_2d(feats, grid.flat_index(), grid.b_cap, mode,
                         grid.occ.shape[-1])


def brick_feats(feats: torch.Tensor, grid: BrickGrid,
                mode: int = 4) -> torch.Tensor:
    """(N, C) -> (b_cap, cells, C): mode 4 the mean over each cell, 3 the
    sum."""
    return brick_feats_2d(feats, grid, mode).reshape(
        grid.b_cap, grid.occ.shape[-1], -1)


def unbrick_feats(bfeats: torch.Tensor, grid: BrickGrid) -> torch.Tensor:
    """Cell features back to points (voxel -> point gather, ref
    model/unet.py:62): (b_cap, cells, C) -> (N, C), zero at null points."""
    return pad_rows(bfeats.reshape(-1, bfeats.shape[-1]))[
        grid.flat_index().long()]


def build_brick_rulebook(table: CoordTable) -> torch.Tensor:
    """(b_cap, 27) neighbour-brick ids (shared by every conv of a level)."""
    return build_subm_rulebook(table, 3, packed=True)


@functools.lru_cache(maxsize=None)
def _parity_cell_map(side: int = BRICK) -> np.ndarray:
    """(8 parities, windows positions) -> parent cell id.

    A child brick with coord parity (rx, ry, rz) writes its (side/2)^3
    downsampled block into the parent-brick sub-cube at corner
    (rx, ry, rz) * side/2."""
    g = geometry(side)
    h = g.half
    m = np.zeros((8, g.windows), np.int64)
    for pr in range(8):
        rx, ry, rz = pr >> 2 & 1, pr >> 1 & 1, pr & 1
        for p in range(g.windows):
            i, j, k = p // (h * h), p // h % h, p % h
            m[pr, p] = ((rx * h + i) * side * side
                        + (ry * h + j) * side + (rz * h + k))
    return m


_PARITY_CELLS = _parity_cell_map()


class BrickDown(NamedTuple):
    """Stride-2 link between a level and the next coarser one.

    parent          : CoordTable of coarse brick coords (p_cap rows)
    parent_occ      : (p_cap, cells) bool
    child_parent    : (b_cap,) int32 parent of each child (null = p_cap)
    parity          : (b_cap,) int32 child octant in its parent,
                      rx*4 + ry*2 + rz
    parent_children : (p_cap, 8) int32 child per octant (null = b_cap)
    """

    parent: CoordTable
    parent_occ: torch.Tensor
    child_parent: torch.Tensor
    parity: torch.Tensor
    parent_children: torch.Tensor


def build_brick_downsample(table: CoordTable, occ: torch.Tensor,
                           p_cap: int) -> BrickDown:
    dev = occ.device
    valid = table.valid
    parent = unique_coords_packed(torch.div(table.coords, 2,
                                            rounding_mode='floor'),
                                  valid, p_cap)
    child_parent = parent.p2v
    c = table.coords
    parity = (c[:, 0] & 1) * 4 + (c[:, 1] & 1) * 2 + (c[:, 2] & 1)
    parity = torch.where(valid, parity, 0).to(torch.int32)
    g = geometry(side_of(occ.shape[-1]))
    target_cells = torch.as_tensor(_parity_cell_map(g.side),
                                   device=dev)[parity.long()]

    # parent cell active iff any fine cell of its 2^3 window is active;
    # cell = hi * 2 + lo per axis -> (x_hi, y_hi, z_hi, x_lo, y_lo, z_lo)
    b_cap, h = occ.shape[0], g.half
    occ2 = occ.reshape(b_cap, h, 2, h, 2, h, 2).permute(
        0, 1, 3, 5, 2, 4, 6).reshape(b_cap, g.windows, 8).any(-1)
    hits = torch.zeros((p_cap + 1, g.cells), dtype=torch.int32, device=dev)
    rows = child_parent.long()[:, None].expand(-1, g.windows)
    hits.index_put_((rows, target_cells),
                    (occ2 & valid[:, None]).to(torch.int32), accumulate=True)

    pc = torch.full((p_cap + 1, 8), b_cap, dtype=torch.int32, device=dev)
    row = torch.where(valid & (child_parent < p_cap), child_parent, p_cap)
    pc[row.long(), parity.long()] = torch.arange(b_cap, dtype=torch.int32,
                                                 device=dev)
    return BrickDown(parent=parent, parent_occ=hits[:p_cap] > 0,
                     child_parent=child_parent, parity=parity,
                     parent_children=pc[:p_cap])


# ---------------------------------------------------------------------------
# 3D submanifold convs: halo assembly + one dense conv
# ---------------------------------------------------------------------------

H = BRICK + 2               # halo side (side 4's)
CONV_CHUNK = 32768          # bricks per F.conv3d call (bounds the halo's
#                             transient memory, as the JAX package's chunks
#                             do; at level 0 of a batch of 4 a bf16 halo of
#                             cin 32 is 2.3 GB)

_OFFS3 = [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
          for dz in (-1, 0, 1)]


def _axis_range(d: int, side: int = BRICK):
    """Source cells along one axis contributed to a neighbour at offset d."""
    if d == -1:
        return [side - 1]
    if d == 0:
        return list(range(side))
    return [0]


@functools.lru_cache(maxsize=None)
def _shell_layout(c: int, side: int = BRICK):
    """Static maps for the exact shell-gather halo of bricks of ``side``.

    Returns (piece_cols, halo_perm):
    * piece_cols: (offset index o, column array) for the 26 neighbour
      directions: the columns of a brick's flat (side^3*c) row that
      direction o needs (its facing face, edge or corner);
    * halo_perm: columns into concat([center, gathered pieces...], axis=1)
      building the flat (side+2)^3 * c halo.
    """
    g = geometry(side)
    hs = g.halo_side
    piece_cols = []
    piece_start = {}
    start = g.cells * c  # the concat buffer begins with the center brick
    for o, (dx, dy, dz) in enumerate(_OFFS3):
        if (dx, dy, dz) == (0, 0, 0):
            continue
        cells = [x * side * side + y * side + z
                 for x in _axis_range(dx, side)
                 for y in _axis_range(dy, side)
                 for z in _axis_range(dz, side)]
        cols = (np.asarray(cells, np.int64)[:, None] * c
                + np.arange(c, dtype=np.int64)).reshape(-1)
        piece_cols.append((o, cols))
        piece_start[o] = start
        start += len(cols)

    def split(h):
        if h == 0:
            return -1, side - 1
        if h <= side:
            return 0, h - 1
        return 1, 0

    hp = np.zeros((hs, hs, hs, c), np.int64)
    for hx in range(hs):
        dx, sx = split(hx)
        for hy in range(hs):
            dy, sy = split(hy)
            for hz in range(hs):
                dz, sz = split(hz)
                if (dx, dy, dz) == (0, 0, 0):
                    base = (sx * side * side + sy * side + sz) * c
                else:
                    o = ((dx + 1) * 3 + (dy + 1)) * 3 + (dz + 1)
                    rx, ry, rz = (_axis_range(dx, side),
                                  _axis_range(dy, side),
                                  _axis_range(dz, side))
                    pos = (rx.index(sx) * len(ry) * len(rz)
                           + ry.index(sy) * len(rz) + rz.index(sz))
                    base = piece_start[o] + pos * c
                hp[hx, hy, hz] = base + np.arange(c)
    return piece_cols, hp.reshape(-1)


def _conv_halo(halo: torch.Tensor, weights: torch.Tensor,
               compute_dtype) -> torch.Tensor:
    """(B, s+2, s+2, s+2, cin) halos -> (B, s^3, cout) float32: the dense
    3^3 conv in compute_dtype. weights (27, cin, cout) raster (dx, dy, dz)
    are the DHWIO kernel of the JAX package; F.conv3d takes them as (cout,
    cin, 3, 3, 3) and the halo channels-last, as a permuted view."""
    cin, cout = weights.shape[1], weights.shape[2]
    w = weights.reshape(3, 3, 3, cin, cout).permute(4, 3, 0, 1, 2)
    out = F.conv3d(halo.to(compute_dtype).permute(0, 4, 1, 2, 3),
                   w.to(compute_dtype))
    cells = (halo.shape[1] - 2) ** 3
    return out.permute(0, 2, 3, 4, 1).reshape(-1, cells, cout).float()


def _by_chunks(fn, rows: int) -> torch.Tensor:
    """fn(slice) over row chunks of CONV_CHUNK, concatenated."""
    return torch.cat([fn(slice(i, i + CONV_CHUNK))
                      for i in range(0, max(rows, 1), CONV_CHUNK)])


def _shell_pieces(bfeats: torch.Tensor, compute_dtype):
    """The center rows and the 26 compact shell tables, each with a zero
    row for the null id."""
    b_cap, cells, cin = bfeats.shape
    x2 = bfeats.to(compute_dtype).reshape(b_cap, cells * cin)
    piece_cols, _ = _shell_layout(cin, side_of(cells))
    return pad_rows(x2), [
        pad_rows(x2[:, torch.as_tensor(cols, device=x2.device)])
        for _, cols in piece_cols]


def _shell_assemble(x2p, pieces, nbr: torch.Tensor, cin: int, side: int):
    piece_cols, halo_perm = _shell_layout(cin, side)
    nbr = nbr.long()
    parts = [x2p[nbr[:, 13]]]           # center == the brick's own row
    parts += [p[nbr[:, o]] for p, (o, _) in zip(pieces, piece_cols)]
    perm = torch.as_tensor(halo_perm, device=nbr.device)
    hs = side + 2
    return torch.cat(parts, dim=1)[:, perm].reshape(-1, hs, hs, hs, cin)


def shell_halo(bfeats: torch.Tensor, nbr: torch.Tensor,
               compute_dtype=torch.bfloat16) -> torch.Tensor:
    """The oracle's assembled halos of every brick: (B, s+2, s+2, s+2,
    cin)."""
    return _shell_assemble(*_shell_pieces(bfeats, compute_dtype), nbr,
                           bfeats.shape[-1], side_of(bfeats.shape[1]))


def subm_conv3(bfeats: torch.Tensor, occ: torch.Tensor, nbr: torch.Tensor,
               weights: torch.Tensor,
               compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Submanifold 3^3 conv on bricks: shell-gather halo + dense conv.

    bfeats  (B, s^3, cin) — zero at inactive cells
    occ     (B, s^3) bool; nbr (B, 27) rulebook, null id == B
    weights (27, cin, cout) raster (dx, dy, dz)
    returns (B, s^3, cout) float32, masked to active cells

    Each neighbour direction contributes only its facing face, edge or
    corner cells (26 small row gathers). Differentiable through autograd
    (the JAX function has no custom VJP)."""
    cin, side = bfeats.shape[-1], side_of(bfeats.shape[1])
    x2p, pieces = _shell_pieces(bfeats, compute_dtype)
    out = _by_chunks(lambda sl: _conv_halo(
        _shell_assemble(x2p, pieces, nbr[sl], cin, side), weights,
        compute_dtype), nbr.shape[0])
    return torch.where(occ[..., None], out, 0.0)


def _src_tgt_slices(d: int, side: int = BRICK):
    """Per-axis (source cells in the neighbour, halo target cells)."""
    if d == -1:
        return slice(side - 1, side), slice(0, 1)
    if d == 0:
        return slice(0, side), slice(1, side + 1)
    return slice(0, 1), slice(side + 1, side + 2)


@functools.lru_cache(maxsize=None)
def _piece_plan(side: int = BRICK):
    """Static plan: per direction (offset index, source slices, halo
    target slices, start in the piece-major table, cell count)."""
    geometry(side)
    plan = []
    start = 0
    for o, (dx, dy, dz) in enumerate(_OFFS3):
        if (dx, dy, dz) == (0, 0, 0):
            continue
        (sx, tx), (sy, ty), (sz, tz) = (_src_tgt_slices(dx, side),
                                        _src_tgt_slices(dy, side),
                                        _src_tgt_slices(dz, side))
        n = ((sx.stop - sx.start) * (sy.stop - sy.start)
             * (sz.stop - sz.start))
        plan.append((o, (sx, sy, sz), (tx, ty, tz), start, n))
        start += n
    return tuple(plan), start   # 152 piece cells at side 4, 56 at 2


def extract_pieces(x4: torch.Tensor) -> torch.Tensor:
    """(B, s, s, s, C) -> (B, pieces, C): boundary cells, piece-major (152
    at side 4); the cells that direction-o neighbours read from a brick
    are the rows [start_o, start_o + n_o)."""
    plan, _ = _piece_plan(x4.shape[1])
    return torch.cat([x4[:, sx, sy, sz].reshape(x4.shape[0], -1,
                                                x4.shape[-1])
                      for _, (sx, sy, sz), _, _, _ in plan], dim=1)


def _concat_assemble(x4: torch.Tensor, tab: torch.Tensor,
                     nbr: torch.Tensor) -> torch.Tensor:
    """Halos (B, s+2, s+2, s+2, cin) of x4's bricks by concatenation:
    each direction's piece gathered from the padded piece table ``tab``."""
    plan, _ = _piece_plan(x4.shape[1])
    cin = x4.shape[-1]
    nbr = nbr.long()
    parts = {(0, 0, 0): x4}
    for o, (sx, sy, sz), _, st, n in plan:
        shape = (-1, sx.stop - sx.start, sy.stop - sy.start,
                 sz.stop - sz.start, cin)
        parts[_OFFS3[o]] = tab[:, st:st + n][nbr[:, o]].reshape(shape)

    def xrow(dx):
        return torch.cat([torch.cat([parts[(dx, dy, dz)] for dz in (-1, 0, 1)],
                                    dim=3) for dy in (-1, 0, 1)], dim=2)

    return torch.cat([xrow(-1), xrow(0), xrow(1)], dim=1)


def subm_conv3_v2(bfeats: torch.Tensor, occ: torch.Tensor,
                  nbr: torch.Tensor, weights: torch.Tensor,
                  compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Submanifold 3^3 conv, concat-assembly engine (the JAX package's
    ``DODA_CONV=xla`` and ``DODA_DEEP_XLA`` route): boundary cells
    extracted once into a piece-major table, one row gather per
    direction, the halo built by concatenation, one dense conv. Same
    signature and semantics as ``subm_conv3``."""
    b_cap, cells, cin = bfeats.shape
    side = side_of(cells)
    x4 = bfeats.to(compute_dtype).reshape(b_cap, side, side, side, cin)
    tab = pad_rows(extract_pieces(x4))
    out = _by_chunks(lambda sl: _conv_halo(
        _concat_assemble(x4[sl], tab, nbr[sl]), weights, compute_dtype),
        b_cap)
    return torch.where(occ[..., None], out, 0.0)


# ---------------------------------------------------------------------------
# stride-2 down/up oracles between brick levels
# ---------------------------------------------------------------------------

def down_maps(ds: BrickDown):
    """The JAX ``BrickDown``'s ``target_cells`` (b_cap, windows): the
    parent cell of each child window, and ``parent_src`` (p_cap, cells):
    the flat child window slot (child * windows + w) feeding each parent
    cell, b_cap * windows for none. Derived from child_parent and parity
    where an oracle asks, so the plan does not carry them."""
    dev = ds.parity.device
    p_cap, b_cap = ds.parent_occ.shape[0], ds.child_parent.shape[0]
    g = geometry(side_of(ds.parent_occ.shape[-1]))
    cells, windows = g.cells, g.windows
    target = torch.as_tensor(_parity_cell_map(g.side),
                             device=dev)[ds.parity.long()]
    cp = ds.child_parent.long()[:, None]
    flat = torch.where(cp < p_cap, cp * cells + target, p_cap * cells)
    inv = torch.full((p_cap * cells + 1,), b_cap * windows,
                     dtype=torch.int32, device=dev)
    inv[flat.reshape(-1)] = torch.arange(b_cap * windows, dtype=torch.int32,
                                         device=dev)
    return (target.to(torch.int32),
            inv[:p_cap * cells].reshape(p_cap, cells))


def _down_im2col(bfeats: torch.Tensor, compute_dtype) -> torch.Tensor:
    """(B, s^3, cin) -> (B*windows, 8*cin) k2s2 window rows."""
    b_cap, cells, cin = bfeats.shape
    g = geometry(side_of(cells))
    h = g.half
    x = bfeats.to(compute_dtype).reshape(b_cap, h, 2, h, 2, h, 2, cin)
    return x.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(b_cap * g.windows,
                                                     8 * cin)


def _down_uncol(dx_col: torch.Tensor, b_cap: int, cin: int,
                side: int) -> torch.Tensor:
    """Transpose of ``_down_im2col`` (a relayout, so exact)."""
    g = geometry(side)
    h = g.half
    x = dx_col.reshape(b_cap, h, h, h, 2, 2, 2, cin)
    return x.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(b_cap, g.cells, cin)


def _gather_child(g: torch.Tensor, child_parent: torch.Tensor,
                  target: torch.Tensor) -> torch.Tensor:
    """g (P, cells, C) -> (B, windows, C): each child window reads its
    parent cell."""
    p_cap, cells, c = g.shape
    flat = (child_parent.long()[:, None] * cells + target).clamp(
        max=p_cap * cells)
    return pad_rows(g.reshape(-1, c))[flat]


class _DownConv3(torch.autograd.Function):
    """``down_conv2`` and its custom VJP (``_down_conv2_bwd``): gathers
    both ways."""

    @staticmethod
    def forward(ctx, bfeats, weights, parent_occ, child_parent, target,
                parent_src, compute_dtype):
        ctx.save_for_backward(bfeats, weights, parent_occ, child_parent,
                              target)
        ctx.compute_dtype = compute_dtype
        cin, cout = weights.shape[1], weights.shape[2]
        x = _down_im2col(bfeats, compute_dtype)
        w = weights.reshape(8 * cin, cout).to(compute_dtype)
        child_out = (x @ w).float()
        pf = pad_rows(child_out)[parent_src.long()]
        return torch.where(parent_occ[..., None], pf, 0.0)

    @staticmethod
    def backward(ctx, g):
        bfeats, weights, parent_occ, child_parent, target = ctx.saved_tensors
        cd = ctx.compute_dtype
        b_cap, cells, cin = bfeats.shape
        geo = geometry(side_of(cells))
        cout = weights.shape[-1]
        g = torch.where(parent_occ[..., None], g, 0.0)
        g_child = _gather_child(g, child_parent, target).to(cd).reshape(
            b_cap * geo.windows, cout)
        w = weights.reshape(8 * cin, cout).to(cd)
        dx = _down_uncol((g_child @ w.T).float(), b_cap, cin, geo.side)
        dw = (_down_im2col(bfeats, cd).T @ g_child).reshape(8, cin, cout)
        return (dx.to(bfeats.dtype), dw.to(weights.dtype), None, None, None,
                None, None)


def down_conv2(bfeats: torch.Tensor, ds: BrickDown, weights: torch.Tensor,
               compute_dtype=torch.bfloat16) -> torch.Tensor:
    """SparseConv3d(k=2, s=2) on bricks: (B, s^3, cin) -> (P, s^3, cout)
    float32, masked to the parents' cells. weights (8, cin, cout) by fine
    offset dx*4 + dy*2 + dz."""
    target, parent_src = down_maps(ds)
    return _DownConv3.apply(bfeats, weights, ds.parent_occ, ds.child_parent,
                            target, parent_src, compute_dtype)


class _UpConv3(torch.autograd.Function):
    """``up_conv2`` and its custom VJP (``_up_conv2_bwd``)."""

    @staticmethod
    def forward(ctx, parent_feats, weights, occ, parent_occ, child_parent,
                target, parent_src, compute_dtype):
        ctx.save_for_backward(parent_feats, weights, occ, parent_occ,
                              child_parent, target, parent_src)
        ctx.compute_dtype = compute_dtype
        cin, cout = parent_feats.shape[-1], weights.shape[-1]
        b_cap = child_parent.shape[0]
        geo = geometry(side_of(occ.shape[-1]))
        h = geo.half
        corner = _gather_child(parent_feats, child_parent, target).to(
            compute_dtype)
        # out[(xh xl)(yh yl)(zh zl)] = corner[xh, yh, zh] @ W[xl*4+yl*2+zl]
        w = weights.permute(1, 0, 2).reshape(cin, 8 * cout)
        out8 = (corner.reshape(b_cap * geo.windows, cin)
                @ w.to(compute_dtype))
        out8 = out8.float().reshape(b_cap, h, h, h, 2, 2, 2, cout)
        out = out8.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(b_cap, geo.cells,
                                                           cout)
        return torch.where(occ[..., None], out, 0.0)

    @staticmethod
    def backward(ctx, g):
        (parent_feats, weights, occ, parent_occ, child_parent, target,
         parent_src) = ctx.saved_tensors
        cd = ctx.compute_dtype
        cin, cout = parent_feats.shape[-1], weights.shape[-1]
        b_cap = child_parent.shape[0]
        geo = geometry(side_of(occ.shape[-1]))
        h = geo.half
        g = torch.where(occ[..., None], g, 0.0)
        g8 = g.reshape(b_cap, h, 2, h, 2, h, 2, cout).permute(
            0, 1, 3, 5, 2, 4, 6, 7).reshape(b_cap * geo.windows,
                                            8 * cout).to(cd)
        w = weights.permute(1, 0, 2).reshape(cin, 8 * cout).to(cd)
        dcorner = (g8 @ w.T).float()
        # children -> parents through the inverse map (a gather)
        dpf = pad_rows(dcorner)[parent_src.long()]
        dpf = torch.where(parent_occ[..., None], dpf, 0.0)
        corner = _gather_child(parent_feats, child_parent, target).to(cd)
        dw8 = corner.reshape(b_cap * geo.windows, cin).T @ g8
        dw = dw8.reshape(cin, 8, cout).permute(1, 0, 2)
        return (dpf.to(parent_feats.dtype), dw.to(weights.dtype), None,
                None, None, None, None, None)


def up_conv2(parent_feats: torch.Tensor, occ: torch.Tensor, ds: BrickDown,
             weights: torch.Tensor,
             compute_dtype=torch.bfloat16) -> torch.Tensor:
    """SparseInverseConv3d(k=2) on bricks, the inverse of ``down_conv2``:
    (P, s^3, cin) -> (B, s^3, cout) float32; each fine cell reads its
    covering parent cell through W[its offset]. ``occ`` is the children's
    occupancy."""
    target, parent_src = down_maps(ds)
    return _UpConv3.apply(parent_feats, weights, occ, ds.parent_occ,
                          ds.child_parent, target, parent_src,
                          compute_dtype)
