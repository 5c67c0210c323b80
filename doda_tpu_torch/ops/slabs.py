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
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from .bricks import BRICK, CELLS
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

@functools.lru_cache(maxsize=None)
def _tab_layout():
    """Boundary-cell table layout: per (dy, dz) dir, (start, cells). The
    (-1, 0) piece is the y=3 row (cells 12..15), (1, 0) the y=0 row,
    (0, +-1) the z-edge column stored contiguously, corners single cells.
    """
    lay = {}
    start = 0
    for dy, dz in _OFFS2:
        ys = [BRICK - 1] if dy == -1 else (list(range(BRICK)) if dy == 0
                                           else [0])
        zs = [BRICK - 1] if dz == -1 else (list(range(BRICK)) if dz == 0
                                           else [0])
        cells = [y * BRICK + z for y in ys for z in zs]
        lay[(dy, dz)] = (start, tuple(cells))
        start += len(cells)
    return lay, start            # start == 20


def _runs(cells):
    runs = []
    for c in cells:
        if runs and runs[-1][0] + runs[-1][1] == c:
            runs[-1] = (runs[-1][0], runs[-1][1] + 1)
        else:
            runs.append((c, 1))
    return runs


@functools.lru_cache(maxsize=None)
def _window_layout():
    """Window lane layout: [Y=-1..4][j=-1..1][3 Z-parts] = 54 blocks of
    (source offset o27, kind, lane0 cell, cells): 'act' lanes read the
    source's activation row, 'tab' lanes its boundary table row. Window
    cell (Y+1)*18 + (j+1)*6 + (Z+1) holds in-plane position (Y, Z) of the
    plane shifted by j."""
    lay, _ = _tab_layout()
    blocks = []
    for Y in range(-1, BRICK + 1):
        dy = -1 if Y == -1 else (1 if Y == BRICK else 0)
        for j in (-1, 0, 1):
            st, cells = lay[(dy, -1)]
            pos = 0 if len(cells) == 1 else Y
            blocks.append((dir3(j, dy, -1), 'tab', st + pos, 1))
            if dy == 0:
                blocks.append((dir3(j, 0, 0), 'act', Y * BRICK, BRICK))
            else:
                st, cells = lay[(dy, 0)]
                blocks.append((dir3(j, dy, 0), 'tab', st, BRICK))
            st, cells = lay[(dy, 1)]
            pos = 0 if len(cells) == 1 else Y
            blocks.append((dir3(j, dy, 1), 'tab', st + pos, 1))
    return tuple(blocks)


@functools.lru_cache(maxsize=None)
def _window_np():
    """One-hot map (WIN, SLICE, 27) from window cells to stencil taps."""
    m = np.zeros((WIN, SLICE, 27), np.float32)
    for Y in range(-1, BRICK + 1):
        for j in (-1, 0, 1):
            for Z in range(-1, BRICK + 1):
                wi = (Y + 1) * 18 + (j + 1) * 6 + (Z + 1)
                for y in range(BRICK):
                    for z in range(BRICK):
                        if abs(Y - y) <= 1 and abs(Z - z) <= 1:
                            m[wi, y * BRICK + z,
                              dir3(j, Y - y, Z - z)] = 1.0
    return m


def window_weights(w: torch.Tensor) -> torch.Tensor:
    """(27, cin, cout) raster (dx, dy, dz) -> (WIN*cin, SLICE*cout);
    placement only, so exact in any dtype."""
    cin, cout = w.shape[1], w.shape[2]
    m = torch.as_tensor(_window_np(), dtype=w.dtype, device=w.device)
    return torch.einsum('wsk,kio->wiso', m, w).reshape(WIN * cin,
                                                       SLICE * cout)


# ---------------------------------------------------------------------------
# plan: slice compaction maps (one scene)
# ---------------------------------------------------------------------------

class SlabMaps(NamedTuple):
    """Per-level slice compaction (flat across the batch after
    ``flatten_slab``: null row == S, null slice == B4).

    slice2row : (B4,) int32   brick-slice id b*4 + xl -> compact row
    row2slice : (S,) int32    inverse (invalid rows -> B4)
    srow      : (S, 27) int32 source row per window direction o27: the
                compact row of slice (nbr[b, dir3(J, dy, dz)], xl'), with
                xl' = (xl + dx) % 4 and J the brick hop
    occ_cells : (S, SLICE) bool active cells of each row's slice
    """

    slice2row: torch.Tensor
    row2slice: torch.Tensor
    srow: torch.Tensor
    occ_cells: torch.Tensor


def build_slab_maps(occ: torch.Tensor, nbr: torch.Tensor,
                    s_cap: int) -> SlabMaps:
    """occ (B, 64) bool, nbr (B, 27) int32 (null == B) -> SlabMaps.

    Occupied slices beyond ``s_cap`` fall into the null row: their outputs
    and contributions drop, as overflowing bricks do; the capacity must
    clear the real count (``models.unet.default_slab_caps``)."""
    dev = occ.device
    b_cap = occ.shape[0]
    b4 = b_cap * BRICK
    occ_s = occ.reshape(b4, SLICE)
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
    b_id = sid_c // BRICK
    xl = sid_c % BRICK
    cols = []
    for dx in (-1, 0, 1):
        xl2 = xl + dx
        jhop = torch.where(xl2 < 0, 0, torch.where(xl2 >= BRICK, 2, 1))
        xl2 = xl2 % BRICK
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                src_b = nbr[b_id, jhop * 9 + (dy + 1) * 3 + (dz + 1)].long()
                src_slice = torch.where(valid & (src_b < b_cap),
                                        src_b * BRICK + xl2, b4)
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
    b4 = b_cap * BRICK

    def flat(ids, cap):
        offs = torch.arange(bt, dtype=torch.int32, device=ids.device) * cap
        offs = offs.reshape((bt,) + (1,) * (ids.dim() - 1))
        out = torch.where(ids >= cap, bt * cap, ids + offs)
        return out.reshape((-1,) + tuple(ids.shape[2:])).to(torch.int32)

    return SlabMaps(slice2row=flat(maps.slice2row, s_cap),
                    row2slice=flat(maps.row2slice, b4),
                    srow=flat(maps.srow, s_cap),
                    occ_cells=maps.occ_cells.reshape(-1, SLICE))


# ---------------------------------------------------------------------------
# the conv
# ---------------------------------------------------------------------------

def _null_gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows of ``table`` at ``idx``; idx >= len(table) gives zeros."""
    n = table.shape[0]
    g = table[idx.long().clamp(max=n - 1)]
    return torch.where((idx < n)[:, None], g, 0)


def _build_tab(act: torch.Tensor, cin: int) -> torch.Tensor:
    """(S, 16C) -> (S, 20C) boundary cells, piece-major lane concat."""
    lay, _ = _tab_layout()
    return torch.cat([act[:, c0 * cin:(c0 + ln) * cin]
                      for d in _OFFS2 for c0, ln in _runs(list(lay[d][1]))],
                     dim=1)


def _build_window(act: torch.Tensor, slab: SlabMaps,
                  cin: int) -> torch.Tensor:
    """Assemble (S, 108C) windows: 27 source gathers, then the 54-block
    concat."""
    tab = _build_tab(act, cin)
    lay, _ = _tab_layout()

    def piece(o):
        rem = o % 9
        return lay[(rem // 3 - 1, rem % 3 - 1)]

    gathered = {}                       # one gather per source, of the
    for o, kind, _, _ in _window_layout():  # lanes it supplies
        if (o, kind) in gathered:
            continue
        if kind == 'act':
            src = act
        else:
            st, cells = piece(o)
            src = tab[:, st * cin:(st + len(cells)) * cin]
        gathered[(o, kind)] = _null_gather(src, slab.srow[:, o])
    parts = []
    for o, kind, lane0, ln in _window_layout():
        local = lane0 if kind == 'act' else lane0 - piece(o)[0]
        parts.append(gathered[(o, kind)][:, local * cin:(local + ln) * cin])
    return torch.cat(parts, dim=1)


def _slab_raw(act: torch.Tensor, slab: SlabMaps, weights: torch.Tensor,
              compute_dtype) -> torch.Tensor:
    """The two y-split products over contiguous window lane ranges: the
    one-hot (108C, 16Co) weight is zero outside [0, 72C) x [0, 8Co) and
    [36C, 108C) x [8Co, 16Co), so slicing it drops those FLOPs exactly."""
    cin, cout = weights.shape[1], weights.shape[2]
    wf = window_weights(weights.to(compute_dtype))
    win = _build_window(act.to(compute_dtype), slab, cin)
    k, half = 72 * cin, (SLICE // 2) * cout
    return torch.cat([win[:, :k] @ wf[:k, :half],
                      win[:, 36 * cin:] @ wf[36 * cin:, half:]], dim=1)


class _SlabConv(torch.autograd.Function):
    """``subm_conv3_slab`` and its custom VJP (``_slab_bwd``)."""

    @staticmethod
    def forward(ctx, x2, weights, slab_t, compute_dtype):
        slab = SlabMaps(*slab_t)
        ctx.save_for_backward(x2, weights, *slab)
        ctx.compute_dtype = compute_dtype
        b4 = x2.shape[0] * BRICK
        cin, cout = weights.shape[1], weights.shape[2]
        act = _null_gather(x2.reshape(b4, SLICE * cin), slab.row2slice)
        out = _slab_raw(act, slab, weights, compute_dtype)
        out = torch.where(slab.occ_cells.repeat_interleave(cout, dim=1),
                          out, 0)
        full = _null_gather(out, slab.slice2row)       # (B4, 16*cout)
        return full.reshape(x2.shape[0], CELLS * cout).to(x2.dtype)

    @staticmethod
    def backward(ctx, g):
        x2, weights, *maps = ctx.saved_tensors
        slab = SlabMaps(*maps)
        cd = ctx.compute_dtype
        b4 = x2.shape[0] * BRICK
        cin, cout = weights.shape[1], weights.shape[2]
        g_rows = _null_gather(g.reshape(b4, SLICE * cout), slab.row2slice)
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
            act = _null_gather(x2.reshape(b4, SLICE * cin),
                               slab.row2slice).to(cd)
            win = _build_window(act, slab, cin)
            gc = g_rows.to(cd)
            k, half = 72 * cin, (SLICE // 2) * cout
            dwf = win.new_zeros((WIN * cin, SLICE * cout), dtype=torch.float32)
            dwf[:k, :half] += _contract_rows(win[:, :k], gc[:, :half])
            dwf[36 * cin:, half:] += _contract_rows(win[:, 36 * cin:],
                                                    gc[:, half:])
            m = torch.as_tensor(_window_np(), device=dwf.device)
            dw = torch.einsum('wsk,wiso->kio', m,
                              dwf.reshape(WIN, cin, SLICE, cout))
            dw = dw.to(weights.dtype)
        return dx, dw, None, None


def subm_conv3_slab(x2: torch.Tensor, slab: SlabMaps, weights: torch.Tensor,
                    compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Submanifold 3^3 conv on slice-compacted rows.

    x2      (B, 64*cin) wide-lane bricks — zero at inactive cells
    slab    SlabMaps (flat)
    weights (27, cin, cout) raster (dx, dy, dz)
    returns (B, 64*cout) in x2.dtype, masked to active cells

    The backward is the JAX package's custom VJP: dx is the same windowed
    conv with the flipped, transposed stencil, dW contracts re-assembled
    windows with the cotangent. dx is computed at compacted (occupied)
    slices only and is zero at the cells of unoccupied slices, where the
    dense transpose is not. That is exact in the model: x is always a
    masked producer's output (norms and convs re-mask inactive cells to
    zero), so the chain rule zeroes those components anyway. dW is exact
    (active cells live in compacted rows only)."""
    return _SlabConv.apply(x2, weights, tuple(slab), compute_dtype)
