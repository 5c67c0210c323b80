"""Wide-lane brick engine: the convolutions of the U-Net on (rows, 64*C).

Port of the forward half of ``doda_tpu/ops/bricks2d.py``. Activations are
``(rows, 64*C)`` with the channels of cell ``x*16 + y*4 + z`` at lanes
``[cell*C, (cell+1)*C)``; tables are flattened across the batch and the
null id of a table equals its row count.

The submanifold 3^3 conv is a banded 1-D conv along the brick's x-slices:
each brick gets six halo planes (x = -1, 0..3, +4), each a 6x6 (y', z')
raster of cells (36*C lanes), and output slice x is
``sum_j plane[x + j] @ wb[j]`` with the banded weights of
``banded_weights``. That product is kernel K1 (``banded_conv``).

Assembly differs from the JAX package by design. There, TPU gathers want
wide rows, so the planes are stitched from lane slices of boundary-cell
pieces (``_yz_piece_plan``, ``extract_tab_yz``, ``_plane_blocks``,
``_xplane_blocks``). Here every one of the 6*36 halo cells of a brick is
(neighbour direction, cell) by geometry alone, so a level's ``halo_index``
maps each to a flat cell row once, and every conv of the level assembles
its planes with one row gather. The x-planes take all nine (dx, *, *)
neighbours, so a diagonal brick counts even when the face x-neighbour is
absent. The planes equal ``_assemble_p6(pm=False)`` of the JAX package
exactly (tests/test_torch_banded_conv.py).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .banded_conv import banded_conv
from .bricks import BRICK, CELLS, _H, WINDOWS

H = BRICK + 2
PLANE = H * H               # 36 cells per halo plane
OUTP = BRICK * BRICK        # 16 output cells per x-slice


def dir3_index(dx: int, dy: int, dz: int) -> int:
    """Column of the (rows, 27) rulebook for offset (dx, dy, dz)."""
    return ((dx + 1) * 3 + (dy + 1)) * 3 + (dz + 1)


def _cell(x: int, y: int, z: int) -> int:
    return x * BRICK * BRICK + y * BRICK + z


@functools.lru_cache(maxsize=None)
def _halo_map():
    """(rulebook column, cell) of each of the 6*36 halo cells, in
    (x', y', z') raster order: plane x' = 0..5 holds brick x = x' - 1."""
    def split(h):
        d = -1 if h < 0 else (1 if h >= BRICK else 0)
        return d, h % BRICK

    cols, cells = [], []
    for hx in range(-1, BRICK + 1):
        for hy in range(-1, BRICK + 1):
            for hz in range(-1, BRICK + 1):
                (dx, cx), (dy, cy), (dz, cz) = split(hx), split(hy), split(hz)
                cols.append(dir3_index(dx, dy, dz))
                cells.append(_cell(cx, cy, cz))
    return np.asarray(cols, np.int64), np.asarray(cells, np.int64)


def halo_index(nbr: torch.Tensor) -> torch.Tensor:
    """(rows, 27) rulebook -> (rows, 216) int32 flat cell ids of the six
    halo planes; absent neighbours -> rows*64, the zero row that
    ``_assemble_p6`` appends."""
    rows = nbr.shape[0]
    cols, cells = (torch.as_tensor(a, device=nbr.device)
                   for a in _halo_map())
    src = nbr[:, cols].long()
    flat = torch.where(src < rows, src * CELLS + cells, rows * CELLS)
    return flat.to(torch.int32)


def _assemble_p6(x2: torch.Tensor, halo: torch.Tensor,
                 compute_dtype) -> torch.Tensor:
    """(rows, 64*cin) -> (rows, 6, 36*cin) halo planes in compute_dtype."""
    rows, lanes = x2.shape
    cin = lanes // CELLS
    x = x2.to(compute_dtype).reshape(rows * CELLS, cin)
    x = torch.cat([x, x.new_zeros(1, cin)])
    return x.index_select(0, halo.reshape(-1)).reshape(rows, 6, PLANE * cin)


@functools.lru_cache(maxsize=None)
def _band_np():
    """One-hot map (3, 36, 16, 27): tap k of output cell (y, z) reads
    plane cell (y + dy + 1, z + dz + 1) of plane x + i."""
    m = np.zeros((3, PLANE, OUTP, 27), np.float32)
    for i in range(3):
        for y in range(BRICK):
            for z in range(BRICK):
                for dy in (-1, 0, 1):
                    for dz in (-1, 0, 1):
                        yh, zh = y + dy + 1, z + dz + 1
                        k = i * 9 + (dy + 1) * 3 + (dz + 1)
                        m[i, yh * H + zh, y * BRICK + z, k] = 1.0
    return m


@functools.lru_cache(maxsize=None)
def _band_nonzero():
    return tuple(np.nonzero(_band_np()))


def banded_weights(w: torch.Tensor) -> torch.Tensor:
    """(27, cin, cout) raster (dx, dy, dz) -> (3, 36*cin, 16*cout).

    Placement only (no arithmetic), so it is exact in any dtype."""
    cin, cout = w.shape[1], w.shape[2]
    i, q, r, k = (torch.as_tensor(a, device=w.device)
                  for a in _band_nonzero())
    wb = w.new_zeros((3, PLANE, cin, OUTP, cout))
    wb[i, q, :, r, :] = w[k]
    return wb.reshape(3, PLANE * cin, OUTP * cout)


def _mask(out: torch.Tensor, occ: torch.Tensor, c: int) -> torch.Tensor:
    """Zero the lanes of inactive cells of a (rows, 64*c) tensor."""
    rows = out.shape[0]
    return torch.where(occ[:, :, None], out.reshape(rows, CELLS, c),
                       0).reshape(rows, CELLS * c)


def subm_conv3_2d(x2: torch.Tensor, occ: torch.Tensor, halo: torch.Tensor,
                  weights: torch.Tensor,
                  compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Submanifold 3^3 conv on wide-lane bricks.

    x2      (rows, 64*cin) — zero at inactive cells
    occ     (rows, 64) bool
    halo    (rows, 216) from ``halo_index`` of the level's rulebook
    weights (27, cin, cout) raster (dx, dy, dz)
    returns (rows, 64*cout) in x2.dtype, masked to active cells
    """
    rows6 = _assemble_p6(x2, halo, compute_dtype)
    wb = banded_weights(weights.to(compute_dtype))
    out = banded_conv(rows6, wb, x2.dtype)
    return _mask(out, occ, weights.shape[2])


# ---------------------------------------------------------------------------
# stride-2 down / up sampling (k=2, s=2), octant-major cell permutes
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _wo_cells():
    """Cell ids in (window, offset) order: w=(xh,yh,zh), o=(xl,yl,zl)."""
    return tuple(_cell(xh * 2 + xl, yh * 2 + yl, zh * 2 + zl)
                 for xh in range(_H) for yh in range(_H) for zh in range(_H)
                 for xl in range(2) for yl in range(2) for zl in range(2))


@functools.lru_cache(maxsize=None)
def _ow_cells():
    """Cell ids in (octant, window) order — parent-side raster."""
    return tuple(_cell(rx * _H + xh, ry * _H + yh, rz * _H + zh)
                 for rx in range(2) for ry in range(2) for rz in range(2)
                 for xh in range(_H) for yh in range(_H) for zh in range(_H))


@functools.lru_cache(maxsize=None)
def _inv(cells):
    """Inverse permutation of a 64-cell order."""
    inv = [0] * CELLS
    for pos, c in enumerate(cells):
        inv[c] = pos
    return tuple(inv)


def _lane_permute(x2: torch.Tensor, cells, c: int) -> torch.Tensor:
    """Reorder the 64 cell blocks of (rows, 64*c) lanes."""
    rows = x2.shape[0]
    idx = torch.as_tensor(cells, device=x2.device)
    return x2.reshape(rows, CELLS, c).index_select(1, idx).reshape(
        rows, CELLS * c)


def _gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows of ``table`` at ``idx``; idx == len(table) gives a zero row."""
    padded = torch.cat([table, table.new_zeros(1, table.shape[1])])
    return padded.index_select(0, idx.reshape(-1).long())


def _children_gather(vals: torch.Tensor, parent_children: torch.Tensor,
                     ) -> torch.Tensor:
    """(B, wC) child rows -> (P, 8*wC) octant-major parent assembly."""
    p = parent_children.shape[0]
    return _gather_rows(vals, parent_children).reshape(p, -1)


def _octant_gather(par_ow: torch.Tensor, child_parent: torch.Tensor,
                   parity: torch.Tensor, width: int) -> torch.Tensor:
    """(P, 64C) octant-major parent rows -> (B, 8C) per-child octant."""
    p = par_ow.shape[0]
    idx = torch.where(child_parent < p, child_parent * 8 + parity, p * 8)
    return _gather_rows(par_ow.reshape(p * 8, width), idx)


def down_conv2_2d(x2: torch.Tensor, occ_p: torch.Tensor, down,
                  weights: torch.Tensor,
                  compute_dtype=torch.bfloat16) -> torch.Tensor:
    """SparseConv3d(k=2, s=2): (B, 64*cin) children -> (P, 64*cout).

    ``down`` carries the flat maps child_parent (B,), parity (B,) and
    parent_children (P, 8); nulls are the respective row counts.
    weights (8, cin, cout), offset-major (xl*4 + yl*2 + zl)."""
    b, lanes = x2.shape
    cin = lanes // CELLS
    cout = weights.shape[-1]
    x = _lane_permute(x2.to(compute_dtype), _wo_cells(), cin)
    w = weights.reshape(8 * cin, cout).to(compute_dtype)
    child_out = (x.reshape(b * WINDOWS, 8 * cin) @ w).reshape(
        b, WINDOWS * cout)
    pow_ = _children_gather(child_out, down.parent_children)
    p_raster = _lane_permute(pow_, _inv(_ow_cells()), cout).to(x2.dtype)
    return _mask(p_raster, occ_p, cout)


def up_conv2_2d(p2: torch.Tensor, occ_c: torch.Tensor, down,
                weights: torch.Tensor,
                compute_dtype=torch.bfloat16) -> torch.Tensor:
    """SparseInverseConv3d(k=2): (P, 64*cin) parents -> (B, 64*cout).

    Each child reads the 8 parent cells of its octant through W[offset]."""
    cin = p2.shape[1] // CELLS
    cout = weights.shape[-1]
    b = down.child_parent.shape[0]
    par_ow = _lane_permute(p2.to(compute_dtype), _ow_cells(), cin)
    corner = _octant_gather(par_ow, down.child_parent, down.parity,
                            WINDOWS * cin)
    # W[o, c, :] -> (cin, 8*cout) so out lanes come back (o, cout)
    w = weights.permute(1, 0, 2).reshape(cin, 8 * cout).to(compute_dtype)
    out8 = (corner.reshape(b * WINDOWS, cin) @ w).reshape(
        b, WINDOWS * 8 * cout)
    out = _lane_permute(out8, _inv(_wo_cells()), cout).to(p2.dtype)
    return _mask(out, occ_c, cout)


def conv1x1_2d(x2: torch.Tensor, occ: torch.Tensor, weights: torch.Tensor,
               compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Per-cell channel mix (the residual shortcut's 1x1)."""
    rows = x2.shape[0]
    cin, cout = weights.shape
    out = (x2.to(compute_dtype).reshape(rows * CELLS, cin)
           @ weights.to(compute_dtype)).reshape(rows, CELLS * cout)
    return _mask(out.to(x2.dtype), occ, cout)
