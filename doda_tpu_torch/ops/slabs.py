"""Slice-compacted window conv: the slab engine for levels 0 and 1.

Port of ``doda_tpu/ops/slabs.py`` (the JAX package's ``DODA_CONV=slab``).
The submanifold conv runs on occupied brick x-slices only:

  rows    (S, 16*C)   one row per occupied x-slice (cells y*4+z raster)
  tab     (S, 20*C)   each row's boundary cells facing the 8 (dy, dz) dirs
  window  (S, 108*C)  the slice's 3x6x6 halo window, from 27 row gathers
                      (one per source slice: 3 x-shifted center slices and
                      24 in-plane piece runs)
  out     (S, 16*Co)  two y-split products: outputs y in {0, 1} read window
                      Y in -1..2 (72C lanes), y in {2, 3} read Y in 1..4

The sources come straight from the 27-neighbour brick rulebook, through
slice maps of their own (``build_slab_maps``), so the halo is built by
another route than ``bricks2d.halo_index``. Tables are flattened across
the batch; the null row id is S (the null slice id B*4); gathers clamp and
mask, never pad. The products are plain ``torch.matmul`` (the JAX engine
multiplies with ``jnp.dot``, outside any Pallas kernel).

The widths above are brick side 4's. At side s a slice holds s^2 cells,
the table 4s + 4, the window 3(s+2)^2, and the y-split at s/2 reads
window rows -1..s/2 and s/2-1..s; the side comes from the occupancy's
width (``build_slab_maps``) or the maps' (every other function). The JAX
package's slab engine hard-codes side 4's window rows, so it holds only
there; the port's follows the side.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from .bricks import BRICK, geometry, side_of
from .bricks2d import _contract_rows, _flip_weights

SLICE = BRICK * BRICK        # 16 cells per x-slice, (y, z) raster z-minor
WIN = 3 * (BRICK + 2) ** 2   # 108 window cells per output slice
_OFFS2 = [(dy, dz) for dy in (-1, 0, 1) for dz in (-1, 0, 1)
          if (dy, dz) != (0, 0)]


def dir3(dx: int, dy: int, dz: int) -> int:
    return ((dx + 1) * 3 + (dy + 1)) * 3 + (dz + 1)


# ---------------------------------------------------------------------------
# static layout tables (copies of the JAX package's)
# ---------------------------------------------------------------------------

def _slice_side(slice_cells: int) -> int:
    """The brick side of slices of ``slice_cells`` = side^2 cells."""
    return side_of(round(slice_cells ** 0.5) ** 3)


@functools.lru_cache(maxsize=None)
def _tab_layout(side: int = BRICK):
    """Boundary-cell table layout: per (dy, dz) dir, (start, cells). The
    (-1, 0) piece is the y=s-1 row (cells 12..15 at side 4), (1, 0) the
    y=0 row, (0, +-1) the z-edge column stored contiguously, corners
    single cells.
    """
    geometry(side)
    lay = {}
    start = 0
    for dy, dz in _OFFS2:
        ys = [side - 1] if dy == -1 else (list(range(side)) if dy == 0
                                          else [0])
        zs = [side - 1] if dz == -1 else (list(range(side)) if dz == 0
                                          else [0])
        cells = [y * side + z for y in ys for z in zs]
        lay[(dy, dz)] = (start, tuple(cells))
        start += len(cells)
    return lay, start            # start == 4s + 4: 20 at side 4


def _runs(cells):
    runs = []
    for c in cells:
        if runs and runs[-1][0] + runs[-1][1] == c:
            runs[-1] = (runs[-1][0], runs[-1][1] + 1)
        else:
            runs.append((c, 1))
    return runs


@functools.lru_cache(maxsize=None)
def _window_layout(side: int = BRICK):
    """Window lane layout: [Y=-1..s][j=-1..1][3 Z-parts] (54 blocks at
    side 4) of (source offset o27, kind, lane0 cell, cells): 'act' lanes
    read the source's activation row, 'tab' lanes its boundary table row.
    Window cell (Y+1)*3(s+2) + (j+1)*(s+2) + (Z+1) holds in-plane position
    (Y, Z) of the plane shifted by j."""
    lay, _ = _tab_layout(side)
    blocks = []
    for Y in range(-1, side + 1):
        dy = -1 if Y == -1 else (1 if Y == side else 0)
        for j in (-1, 0, 1):
            st, cells = lay[(dy, -1)]
            pos = 0 if len(cells) == 1 else Y
            blocks.append((dir3(j, dy, -1), 'tab', st + pos, 1))
            if dy == 0:
                blocks.append((dir3(j, 0, 0), 'act', Y * side, side))
            else:
                st, cells = lay[(dy, 0)]
                blocks.append((dir3(j, dy, 0), 'tab', st, side))
            st, cells = lay[(dy, 1)]
            pos = 0 if len(cells) == 1 else Y
            blocks.append((dir3(j, dy, 1), 'tab', st + pos, 1))
    return tuple(blocks)


@functools.lru_cache(maxsize=None)
def _window_np(side: int = BRICK):
    """One-hot map (3(s+2)^2, s^2, 27) ((WIN, SLICE, 27) at side 4) from
    window cells to stencil taps."""
    g = geometry(side)
    hs = g.halo_side
    m = np.zeros((3 * g.plane, g.slice_cells, 27), np.float32)
    for Y in range(-1, side + 1):
        for j in (-1, 0, 1):
            for Z in range(-1, side + 1):
                wi = (Y + 1) * 3 * hs + (j + 1) * hs + (Z + 1)
                for y in range(side):
                    for z in range(side):
                        if abs(Y - y) <= 1 and abs(Z - z) <= 1:
                            m[wi, y * side + z,
                              dir3(j, Y - y, Z - z)] = 1.0
    return m


def window_weights(w: torch.Tensor, side: int = BRICK) -> torch.Tensor:
    """(27, cin, cout) raster (dx, dy, dz) -> (3(s+2)^2*cin, s^2*cout)
    ((WIN*cin, SLICE*cout) at side 4); placement only, so exact in any
    dtype."""
    g = geometry(side)
    cin, cout = w.shape[1], w.shape[2]
    m = torch.as_tensor(_window_np(side), dtype=w.dtype, device=w.device)
    return torch.einsum('wsk,kio->wiso', m, w).reshape(
        3 * g.plane * cin, g.slice_cells * cout)


# ---------------------------------------------------------------------------
# plan: slice compaction maps (one scene)
# ---------------------------------------------------------------------------

class SlabMaps(NamedTuple):
    """Per-level slice compaction (flat across the batch after
    ``flatten_slab``: null row == S, null slice == B4).

    slice2row : (B4,) int32   brick-slice id b*s + xl -> compact row
    row2slice : (S,) int32    inverse (invalid rows -> B4)
    srow      : (S, 27) int32 source row per window direction o27: the
                compact row of slice (nbr[b, dir3(J, dy, dz)], xl'), with
                xl' = (xl + dx) % s and J the brick hop
    occ_cells : (S, s^2) bool active cells of each row's slice
    """

    slice2row: torch.Tensor
    row2slice: torch.Tensor
    srow: torch.Tensor
    occ_cells: torch.Tensor


def build_slab_maps(occ: torch.Tensor, nbr: torch.Tensor,
                    s_cap: int) -> SlabMaps:
    """occ (B, s^3) bool, nbr (B, 27) int32 (null == B) -> SlabMaps.

    Occupied slices beyond ``s_cap`` fall into the null row: their outputs
    and contributions drop, as overflowing bricks do; the capacity must
    clear the real count (``models.unet.default_slab_caps``)."""
    dev = occ.device
    g = geometry(side_of(occ.shape[1]))
    side = g.side
    b_cap = occ.shape[0]
    b4 = b_cap * side
    occ_s = occ.reshape(b4, g.slice_cells)
    s_occ = occ_s.any(-1)
    rows = torch.cumsum(s_occ, 0, dtype=torch.int32) - 1
    ok = s_occ & (rows < s_cap)
    slice2row = torch.where(ok, rows, s_cap).to(torch.int32)

    row2slice = torch.full((s_cap + 1,), b4, dtype=torch.int32, device=dev)
    row2slice[slice2row.long()] = torch.arange(b4, dtype=torch.int32,
                                               device=dev)
    row2slice = row2slice[:s_cap]        # row s_cap took the dropped writes

    valid = row2slice < b4
    sid_c = row2slice.clamp(max=b4 - 1).long()
    b_id = sid_c // side
    xl = sid_c % side
    cols = []
    for dx in (-1, 0, 1):
        xl2 = xl + dx
        jhop = torch.where(xl2 < 0, 0, torch.where(xl2 >= side, 2, 1))
        xl2 = xl2 % side
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                src_b = nbr[b_id, jhop * 9 + (dy + 1) * 3 + (dz + 1)].long()
                src_slice = torch.where(valid & (src_b < b_cap),
                                        src_b * side + xl2, b4)
                srw = torch.where(src_slice < b4,
                                  slice2row[src_slice.clamp(max=b4 - 1)],
                                  s_cap)
                cols.append(srw.to(torch.int32))
    occ_cells = occ_s[sid_c] & valid[:, None]
    return SlabMaps(slice2row=slice2row, row2slice=row2slice,
                    srow=torch.stack(cols, dim=1), occ_cells=occ_cells)


def flatten_slab(maps: SlabMaps, s_cap: int, b_cap: int) -> SlabMaps:
    """Batched SlabMaps (leading scene dim) -> flat tables with global
    null ids."""
    bt = maps.row2slice.shape[0]
    slice_cells = maps.occ_cells.shape[-1]
    b4 = b_cap * _slice_side(slice_cells)

    def flat(ids, cap):
        offs = torch.arange(bt, dtype=torch.int32, device=ids.device) * cap
        offs = offs.reshape((bt,) + (1,) * (ids.dim() - 1))
        out = torch.where(ids >= cap, bt * cap, ids + offs)
        return out.reshape((-1,) + tuple(ids.shape[2:])).to(torch.int32)

    return SlabMaps(slice2row=flat(maps.slice2row, s_cap),
                    row2slice=flat(maps.row2slice, b4),
                    srow=flat(maps.srow, s_cap),
                    occ_cells=maps.occ_cells.reshape(-1, slice_cells))


# ---------------------------------------------------------------------------
# the conv
# ---------------------------------------------------------------------------

def _null_gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows of ``table`` at ``idx``; idx >= len(table) gives zeros."""
    n = table.shape[0]
    g = table[idx.long().clamp(max=n - 1)]
    return torch.where((idx < n)[:, None], g, 0)


def _build_tab(act: torch.Tensor, cin: int, side: int) -> torch.Tensor:
    """(S, s^2 C) -> (S, (4s+4)C) boundary cells ((S, 16C) -> (S, 20C) at
    side 4), piece-major lane concat."""
    lay, _ = _tab_layout(side)
    return torch.cat([act[:, c0 * cin:(c0 + ln) * cin]
                      for d in _OFFS2 for c0, ln in _runs(list(lay[d][1]))],
                     dim=1)


def _build_window(act: torch.Tensor, slab: SlabMaps,
                  cin: int) -> torch.Tensor:
    """Assemble (S, 3(s+2)^2 C) windows ((S, 108C) at side 4): 27 source
    gathers, then the block concat."""
    side = _slice_side(slab.occ_cells.shape[-1])
    tab = _build_tab(act, cin, side)
    lay, _ = _tab_layout(side)

    def piece(o):
        rem = o % 9
        return lay[(rem // 3 - 1, rem % 3 - 1)]

    gathered = {}                       # one gather per source, of the
    for o, kind, _, _ in _window_layout(side):  # lanes it supplies
        if (o, kind) in gathered:
            continue
        if kind == 'act':
            src = act
        else:
            st, cells = piece(o)
            src = tab[:, st * cin:(st + len(cells)) * cin]
        gathered[(o, kind)] = _null_gather(src, slab.srow[:, o])
    parts = []
    for o, kind, lane0, ln in _window_layout(side):
        local = lane0 if kind == 'act' else lane0 - piece(o)[0]
        parts.append(gathered[(o, kind)][:, local * cin:(local + ln) * cin])
    return torch.cat(parts, dim=1)


def _split(side: int, cin: int, cout: int):
    """The y-split's lane bounds: (k, lo, half) with outputs y < s/2 (lanes
    [0, half)) reading window lanes [0, k) and the rest [lo, end):
    (72C, 36C, 8Co) at side 4."""
    row = 3 * (side + 2) * cin             # one window row Y
    return ((side // 2 + 2) * row, (side // 2) * row,
            (side * side // 2) * cout)


def _slab_raw(act: torch.Tensor, slab: SlabMaps, weights: torch.Tensor,
              compute_dtype) -> torch.Tensor:
    """The two y-split products over contiguous window lane ranges: the
    one-hot (108C, 16Co) weight is zero outside [0, 72C) x [0, 8Co) and
    [36C, 108C) x [8Co, 16Co) (side 4's; ``_split``), so slicing it drops
    those FLOPs exactly."""
    side = _slice_side(slab.occ_cells.shape[-1])
    cin, cout = weights.shape[1], weights.shape[2]
    wf = window_weights(weights.to(compute_dtype), side)
    win = _build_window(act.to(compute_dtype), slab, cin)
    k, lo, half = _split(side, cin, cout)
    return torch.cat([win[:, :k] @ wf[:k, :half],
                      win[:, lo:] @ wf[lo:, half:]], dim=1)


class _SlabConv(torch.autograd.Function):
    """``subm_conv3_slab`` and its custom VJP (``_slab_bwd``)."""

    @staticmethod
    def forward(ctx, x2, weights, slab_t, compute_dtype):
        slab = SlabMaps(*slab_t)
        ctx.save_for_backward(x2, weights, *slab)
        ctx.compute_dtype = compute_dtype
        sc = slab.occ_cells.shape[-1]
        side = _slice_side(sc)
        b4 = x2.shape[0] * side
        cin, cout = weights.shape[1], weights.shape[2]
        act = _null_gather(x2.reshape(b4, sc * cin), slab.row2slice)
        out = _slab_raw(act, slab, weights, compute_dtype)
        out = torch.where(slab.occ_cells.repeat_interleave(cout, dim=1),
                          out, 0)
        full = _null_gather(out, slab.slice2row)       # (B4, s^2*cout)
        return full.reshape(x2.shape[0], side * sc * cout).to(x2.dtype)

    @staticmethod
    def backward(ctx, g):
        x2, weights, *maps = ctx.saved_tensors
        slab = SlabMaps(*maps)
        cd = ctx.compute_dtype
        sc = slab.occ_cells.shape[-1]
        side = _slice_side(sc)
        b4 = x2.shape[0] * side
        cin, cout = weights.shape[1], weights.shape[2]
        g_rows = _null_gather(g.reshape(b4, sc * cout), slab.row2slice)
        g_rows = torch.where(slab.occ_cells.repeat_interleave(cout, dim=1),
                             g_rows, 0)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            # the transpose stencil through the same maps (srow is
            # symmetric: srow[s, o] == s' <=> srow[s', 26 - o] == s)
            dx_rows = _slab_raw(g_rows, slab, _flip_weights(weights), cd)
            dx = _null_gather(dx_rows, slab.slice2row).reshape(
                x2.shape).to(x2.dtype)
        if ctx.needs_input_grad[1]:
            # re-assemble the window, contract against the split cotangent
            act = _null_gather(x2.reshape(b4, sc * cin),
                               slab.row2slice).to(cd)
            win = _build_window(act, slab, cin)
            gc = g_rows.to(cd)
            k, lo, half = _split(side, cin, cout)
            nwin = 3 * (side + 2) ** 2
            dwf = win.new_zeros((nwin * cin, sc * cout), dtype=torch.float32)
            dwf[:k, :half] += _contract_rows(win[:, :k], gc[:, :half])
            dwf[lo:, half:] += _contract_rows(win[:, lo:], gc[:, half:])
            m = torch.as_tensor(_window_np(side), device=dwf.device)
            dw = torch.einsum('wsk,wiso->kio', m,
                              dwf.reshape(nwin, cin, sc, cout))
            dw = dw.to(weights.dtype)
        return dx, dw, None, None


def subm_conv3_slab(x2: torch.Tensor, slab: SlabMaps, weights: torch.Tensor,
                    compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Submanifold 3^3 conv on slice-compacted rows.

    x2      (B, s^3*cin) wide-lane bricks — zero at inactive cells
    slab    SlabMaps (flat)
    weights (27, cin, cout) raster (dx, dy, dz)
    returns (B, s^3*cout) in x2.dtype, masked to active cells

    The backward is the JAX package's custom VJP: dx is the same windowed
    conv with the flipped, transposed stencil, dW contracts re-assembled
    windows with the cotangent. dx is computed at compacted (occupied)
    slices only and is zero at the cells of unoccupied slices, where the
    dense transpose is not. That is exact in the model: x is always a
    masked producer's output (norms and convs re-mask inactive cells to
    zero), so the chain rule zeroes those components anyway. dW is exact
    (active cells live in compacted rows only)."""
    return _SlabConv.apply(x2, weights, tuple(slab), compute_dtype)
