"""Dense 4^3 bricks over the sparse voxel set (one scene).

Port of the plan-building half of ``doda_tpu/ops/bricks.py``: points are
deduplicated into 4x4x4 bricks (``brickify``), each brick gets its 27
neighbour bricks (``build_brick_rulebook``) and each level is linked to the
next coarser one by a stride-2 map (``build_brick_downsample``). Cell
``x*16 + y*4 + z`` of a brick is one voxel; activations are wide-lane
``(bricks, 64*C)`` tensors that are zero at inactive cells.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .coords import CoordTable, unique_coords_packed
from .sparse import build_subm_rulebook

BRICK = 4
CELLS = BRICK ** 3
_H = BRICK // 2             # downsampled brick side
WINDOWS = _H ** 3           # stride-2 output positions per brick


class BrickGrid(NamedTuple):
    table: CoordTable       # brick coords; table.p2v maps point -> brick
    occ: torch.Tensor       # (b_cap, 64) bool active cells
    p2c: torch.Tensor       # (N,) int32 cell of each point

    @property
    def b_cap(self) -> int:
        return self.occ.shape[-2]

    def flat_index(self) -> torch.Tensor:
        """Point -> flat cell id in [0, b_cap*64]; null -> b_cap*64."""
        p2b = self.table.p2v
        idx = p2b * CELLS + self.p2c
        return torch.where(p2b >= self.b_cap, self.b_cap * CELLS, idx)


def brickify(coords: torch.Tensor, valid: torch.Tensor,
             b_cap: int) -> BrickGrid:
    """Voxel coords (N, 3) -> brick table + cell occupancy."""
    cell_xyz = coords % BRICK
    cell = (cell_xyz[:, 0] * (BRICK * BRICK) + cell_xyz[:, 1] * BRICK
            + cell_xyz[:, 2])
    cell = torch.where(valid, cell, 0).to(torch.int32)
    table = unique_coords_packed(torch.div(coords, BRICK,
                                           rounding_mode='floor'),
                                 valid, b_cap)
    occ = torch.zeros((b_cap + 1, CELLS), dtype=torch.bool,
                      device=coords.device)
    occ[table.p2v.long(), cell.long()] = True     # misses land in row b_cap
    return BrickGrid(table=table, occ=occ[:b_cap], p2c=cell)


def cell_feats_2d(feats: torch.Tensor, flat: torch.Tensor, rows: int,
                  mode: int = 4) -> torch.Tensor:
    """Reduce point features into cells: (N, C) -> (rows, 64*C).

    ``flat`` holds each point's flat cell id, ``rows*64`` for none. mode
    4 = mean, 3 = sum (ref voxelize.cu:10-31). Sums run in float32 with
    ``index_add_``; cells no point reaches stay exactly zero."""
    if mode not in (3, 4):
        raise NotImplementedError(f'brick voxel mode {mode}')
    n_seg = rows * CELLS
    c = feats.shape[-1]
    flat = flat.long()
    f32 = feats.to(torch.float32)
    total = f32.new_zeros((n_seg + 1, c)).index_add_(0, flat, f32)[:n_seg]
    if mode == 4:
        count = f32.new_zeros(n_seg + 1).index_add_(
            0, flat, f32.new_ones(flat.shape[0]))[:n_seg]
        total = total / count.clamp(min=1.0)[:, None]
    return total.reshape(rows, CELLS * c).to(feats.dtype)


def brick_feats_2d(feats: torch.Tensor, grid: BrickGrid,
                   mode: int = 4) -> torch.Tensor:
    """``cell_feats_2d`` over one scene's grid: (N, C) -> (b_cap, 64*C)."""
    return cell_feats_2d(feats, grid.flat_index(), grid.b_cap, mode)


def build_brick_rulebook(table: CoordTable) -> torch.Tensor:
    """(b_cap, 27) neighbour-brick ids (shared by every conv of a level)."""
    return build_subm_rulebook(table, 3)


def _parity_cell_map() -> np.ndarray:
    """(8 parities, WINDOWS positions) -> parent cell id.

    A child brick with coord parity (rx, ry, rz) writes its (BRICK/2)^3
    downsampled block into the parent-brick sub-cube at corner
    (rx, ry, rz) * BRICK/2."""
    m = np.zeros((8, WINDOWS), np.int64)
    for pr in range(8):
        rx, ry, rz = pr >> 2 & 1, pr >> 1 & 1, pr & 1
        for p in range(WINDOWS):
            i, j, k = p // (_H * _H), p // _H % _H, p % _H
            m[pr, p] = ((rx * _H + i) * BRICK * BRICK
                        + (ry * _H + j) * BRICK + (rz * _H + k))
    return m


_PARITY_CELLS = _parity_cell_map()


class BrickDown(NamedTuple):
    """Stride-2 link between a level and the next coarser one.

    parent          : CoordTable of coarse brick coords (p_cap rows)
    parent_occ      : (p_cap, 64) bool
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
    target_cells = torch.as_tensor(_PARITY_CELLS, device=dev)[parity.long()]

    # parent cell active iff any fine cell of its 2^3 window is active;
    # cell = hi * 2 + lo per axis -> (x_hi, y_hi, z_hi, x_lo, y_lo, z_lo)
    b_cap = occ.shape[0]
    occ2 = occ.reshape(b_cap, _H, 2, _H, 2, _H, 2).permute(
        0, 1, 3, 5, 2, 4, 6).reshape(b_cap, WINDOWS, 8).any(-1)
    hits = torch.zeros((p_cap + 1, CELLS), dtype=torch.int32, device=dev)
    rows = child_parent.long()[:, None].expand(-1, WINDOWS)
    hits.index_put_((rows, target_cells),
                    (occ2 & valid[:, None]).to(torch.int32), accumulate=True)

    pc = torch.full((p_cap + 1, 8), b_cap, dtype=torch.int32, device=dev)
    row = torch.where(valid & (child_parent < p_cap), child_parent, p_cap)
    pc[row.long(), parity.long()] = torch.arange(b_cap, dtype=torch.int32,
                                                 device=dev)
    return BrickDown(parent=parent, parent_occ=hits[:p_cap] > 0,
                     child_parent=child_parent, parity=parity,
                     parent_children=pc[:p_cap])
