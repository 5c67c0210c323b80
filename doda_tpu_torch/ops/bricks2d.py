"""Wide-lane brick engine: the convolutions of the U-Net on (rows, 64*C).

Port of ``doda_tpu/ops/bricks2d.py``, forward and backward. Activations are
``(rows, 64*C)`` with the channels of cell ``x*16 + y*4 + z`` at lanes
``[cell*C, (cell+1)*C)``; tables are flattened across the batch and the
null id of a table equals its row count. That is side 4, the default; at a
brick side s (``bricks.geometry``) a row holds s^3 cells, a brick has s+2
halo planes of (s+2)^2 cells and s output x-slices of s^2 cells, and every
function here reads s from the widths of its operands (the occupancy's s^3,
the halo table's (s+2)^3) or, where none tells, takes ``side``. The
numbers below are side 4's.

The submanifold 3^3 conv is a banded 1-D conv along the brick's x-slices:
each brick gets six halo planes (x = -1, 0..3, +4), each a 6x6 (y', z')
raster of cells (36*C lanes), and output slice x is
``sum_j plane[x + j] @ wb[j]`` with the banded weights of
``banded_weights``. That product is kernel K1 (``banded_conv_plain`` in
plain PyTorch; no kernel of the port reads the planes). Kernel
K2 (``banded_conv_sm``) computes the same conv "source-major", from the
brick's own activation plus only the halo cells around it
(``_assemble_sm``), so the four centre planes never reach device memory;
it runs as ``banded_conv_sm_taps``, which takes the raster weights and
multiplies only the taps (no ``sm_weights``), in bf16 and in float32.
``subm_conv3_2d`` picks the kernel per conv from ``sm_max_cin``
(``uses_sm``), the counterpart of the JAX package's ``DODA_SM`` switch.
Every other bf16 conv with channel counts in multiples of 8
(``uses_fused``) runs K1's second version, ``banded_conv_fused``, which
takes the activation and the rulebook and assembles the halo inside the
kernel: no planes, no banded weights. A bf16 conv of 1 to 7 input
channels (``uses_narrow``: the cin = 3 input conv) runs its narrow-input
version, ``banded_conv_narrow``, from the activation and the rulebook
too. Every other bf16 width takes the route 'padded'
(``banded_conv_padded``): the fused (or narrow) version on operands
zero-padded to multiples of 8 channels, the output sliced back. Every
float32 conv that K2 does not take, of any width, runs
``banded_conv_f32`` (the route 'f32'), from the activation and the
rulebook as well, on the CUDA cores. The halo planes below remain for the
dW product.

Assembly differs from the JAX package by design. There, TPU gathers want
wide rows, so the planes are stitched from lane slices of boundary-cell
pieces (``_yz_piece_plan``, ``extract_tab_yz``, ``_plane_blocks``,
``_xplane_blocks``). Here every one of the 6*36 halo cells of a brick is
(neighbour direction, cell) by geometry alone, so a level's ``halo_index``
maps each to a flat cell row once, and every conv of the level assembles
its planes with one row gather. The x-planes take all nine (dx, *, *)
neighbours, so a diagonal brick counts even when the face x-neighbour is
absent. The planes equal ``_assemble_p6(pm=False)`` of the JAX package
exactly (tests/test_torch_banded_conv.py), and the source-major operands
equal its ``_assemble_sm`` (tests/test_torch_sm.py).

Backward. As in the JAX package every conv is a ``torch.autograd.Function``
whose backward is gathers and matrix products only, never a scatter-add:
dx of a subm conv is the same conv on the flipped stencil
(``_flip_weights``) of the masked cotangent, through whichever kernel the
flipped shape selects, and dW contracts the re-assembled halo planes with
the cotangent. The functions save x2 and the index tables, not the
assembled windows.

Fused norm + ReLU prologue (``subm_conv3_norm_2d``, ``down_conv2_norm_2d``,
``up_conv2_norm_2d``; the JAX package's ``DODA_FUSE_NORM`` engine). A conv
takes the folded per-channel (scale, bias) of the batch norm in front of it
and reads ``where(occ, relu(x*scale + bias), 0)`` (``_apply_pro``) in
place of x, so the normalized activation is never written. On the fused
route the prologue runs inside K1 where it stages the halo; on the other
routes and in the down/up convs ``pro_full`` applies it
once up front, as the JAX package does for its source-major engines. The
backward runs dh through the plain conv's dx kernel, then the prologue's
backward in one pass: dx = dh*scale*relu'*occ, and dscale and dbias
summed over rows and cells; dW contracts the prologue's planes.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from .banded_conv import (NARROW_MAX_CIN, banded_conv_f32,
                          banded_conv_fused, banded_conv_narrow,
                          banded_conv_padded, occ_words)
from .banded_conv_sm import banded_conv_sm_taps
from .bricks import BRICK, geometry, side_of

H = BRICK + 2
PLANE = H * H               # 36 cells per halo plane
OUTP = BRICK * BRICK        # 16 output cells per x-slice


def halo_side_of(halo_cells: int) -> int:
    """The brick side whose halo holds ``halo_cells`` = (side+2)^3 cells
    (a ``halo_index`` table's width)."""
    hs = round(halo_cells ** (1 / 3))
    if hs ** 3 != halo_cells:
        raise ValueError(f'{halo_cells} halo cells is no cube of a side')
    return geometry(hs - 2).side


def dir3_index(dx: int, dy: int, dz: int) -> int:
    """Column of the (rows, 27) rulebook for offset (dx, dy, dz)."""
    return ((dx + 1) * 3 + (dy + 1)) * 3 + (dz + 1)


def _cell(x: int, y: int, z: int, side: int = BRICK) -> int:
    return x * side * side + y * side + z


@functools.lru_cache(maxsize=None)
def _halo_map(side: int = BRICK):
    """(rulebook column, cell) of each of the (s+2)^3 halo cells (6*36 at
    side 4), in (x', y', z') raster order: plane x' = 0..s+1 holds brick
    x = x' - 1."""
    geometry(side)

    def split(h):
        d = -1 if h < 0 else (1 if h >= side else 0)
        return d, h % side

    cols, cells = [], []
    for hx in range(-1, side + 1):
        for hy in range(-1, side + 1):
            for hz in range(-1, side + 1):
                (dx, cx), (dy, cy), (dz, cz) = split(hx), split(hy), split(hz)
                cols.append(dir3_index(dx, dy, dz))
                cells.append(_cell(cx, cy, cz, side))
    return np.asarray(cols, np.int64), np.asarray(cells, np.int64)


def halo_index(nbr: torch.Tensor, side: int = BRICK) -> torch.Tensor:
    """(rows, 27) rulebook -> (rows, (s+2)^3) int32 flat cell ids of the
    s+2 halo planes of bricks of ``side`` s (216 at side 4); absent
    neighbours -> rows*s^3, the zero row that ``_assemble_p6`` appends."""
    rows, cells_ = nbr.shape[0], geometry(side).cells
    cols, cells = (torch.as_tensor(a, device=nbr.device)
                   for a in _halo_map(side))
    src = nbr[:, cols].long()
    flat = torch.where(src < rows, src * cells_ + cells, rows * cells_)
    return flat.to(torch.int32)


# ---------------------------------------------------------------------------
# the fused norm + ReLU prologue
# ---------------------------------------------------------------------------

def _apply_pro(val: torch.Tensor, mask: torch.Tensor, pro, cin: int,
               compute_dtype) -> torch.Tensor:
    """val (rows, n*cin), mask (rows, n) bool ->
    where(mask, relu(val*scale + bias), 0), channel-tiled, in
    compute_dtype: float32 arithmetic on the compute_dtype-rounded value,
    scale and bias (a multiply, then an add), rounded once."""
    scale, bias = pro[0], pro[1]
    rows, n = mask.shape
    y = val.to(compute_dtype).to(torch.float32, copy=True)  # val intact
    y = y.reshape(rows, n, cin).mul_(scale.to(compute_dtype).float())
    y.add_(bias.to(compute_dtype).float()).relu_()
    y = y.to(compute_dtype).masked_fill_(~mask[:, :, None], 0)
    return y.reshape(rows, n * cin)


def pro_full(x2: torch.Tensor, pro, cin: int, compute_dtype) -> torch.Tensor:
    """Materialized where(occ, relu(x*scale + bias), 0) of (rows, 64*cin),
    ``pro = (scale, bias, occ)``: for the convs that take a normalized
    activation."""
    return _apply_pro(x2, pro[2], pro, cin, compute_dtype)


def _pro_backward(x2, h, scale, dh, compute_dtype):
    """The prologue's backward in one pass, from its output h (``pro_full``
    of x2) and the cotangent dh of h: dx = dh*scale*relu'*occ in x2's
    dtype (relu'*occ is h > 0, the forward's own signs; the float32
    product of two compute_dtype values rounded once), and float32
    dscale = sum dh*relu'*occ*x and dbias = sum dh*relu'*occ over rows
    and cells (float32 accumulation of the exact products)."""
    cin = scale.shape[0]
    live = h.reshape(-1, cin) > 0
    dh_live = torch.where(live, dh.reshape(-1, cin).to(compute_dtype), 0)
    dx = (dh_live * scale.to(compute_dtype)).reshape(x2.shape).to(x2.dtype)
    xc = x2.to(compute_dtype).reshape(-1, cin)
    dscale = _contract_rows(dh_live, xc).diagonal()
    dbias = dh_live.sum(0, dtype=torch.float32)
    return dx, dscale.to(scale.dtype), dbias.to(scale.dtype)


def _assemble_p6(x2: torch.Tensor, halo: torch.Tensor, compute_dtype,
                 pro=None) -> torch.Tensor:
    """(rows, s^3*cin) -> (rows, s+2, (s+2)^2*cin) halo planes in
    compute_dtype ((rows, 6, 36*cin) at side 4; s from the width of
    ``halo``).

    ``pro = (scale, bias, occ)``: the planes of the prologue's output, the
    gather of ``pro_full`` (an absent neighbour's cells are zero either
    way)."""
    g = geometry(halo_side_of(halo.shape[1]))
    rows, lanes = x2.shape
    cin = lanes // g.cells
    if pro is not None:
        x2 = pro_full(x2, pro, cin, compute_dtype)
    x = x2.to(compute_dtype).reshape(rows * g.cells, cin)
    x = torch.cat([x, x.new_zeros(1, cin)])
    return x.index_select(0, halo.reshape(-1)).reshape(rows, g.halo_side,
                                                       g.plane * cin)


@functools.lru_cache(maxsize=None)
def _band_np(side: int = BRICK):
    """One-hot map (3, (s+2)^2, s^2, 27) ((3, 36, 16, 27) at side 4): tap
    k of output cell (y, z) reads plane cell (y + dy + 1, z + dz + 1) of
    plane x + i."""
    g = geometry(side)
    m = np.zeros((3, g.plane, g.slice_cells, 27), np.float32)
    for i in range(3):
        for y in range(side):
            for z in range(side):
                for dy in (-1, 0, 1):
                    for dz in (-1, 0, 1):
                        yh, zh = y + dy + 1, z + dz + 1
                        k = i * 9 + (dy + 1) * 3 + (dz + 1)
                        m[i, yh * g.halo_side + zh, y * side + z, k] = 1.0
    return m


@functools.lru_cache(maxsize=None)
def _band_nonzero(side: int = BRICK):
    return tuple(np.nonzero(_band_np(side)))


@functools.lru_cache(maxsize=None)
def _band_by_tap(side: int = BRICK):
    """``_band_nonzero``'s (plane, plane cell, slice cell) entries grouped
    by tap: three (27, s^2) arrays, row k the s^2 band cells tap k was
    placed at (each output cell of a slice reads each tap once)."""
    i, q, r, k = _band_nonzero(side)
    order = np.argsort(k, kind='stable')
    per_tap = side * side
    assert np.array_equal(np.bincount(k, minlength=27),
                          np.full(27, per_tap)), 'a tap off the band'
    return tuple(a[order].reshape(27, per_tap) for a in (i, q, r))


def banded_weights(w: torch.Tensor, side: int = BRICK) -> torch.Tensor:
    """(27, cin, cout) raster (dx, dy, dz) -> (3, (s+2)^2*cin, s^2*cout)
    at brick side s ((3, 36*cin, 16*cout) at side 4).

    Placement only (no arithmetic), so it is exact in any dtype."""
    g = geometry(side)
    cin, cout = w.shape[1], w.shape[2]
    i, q, r, k = (torch.as_tensor(a, device=w.device)
                  for a in _band_nonzero(side))
    wb = w.new_zeros((3, g.plane, cin, g.slice_cells, cout))
    wb[i, q, :, r, :] = w[k]
    return wb.reshape(3, g.plane * cin, g.slice_cells * cout)


def _mask(out: torch.Tensor, occ: torch.Tensor, c: int) -> torch.Tensor:
    """Zero the lanes of inactive cells of a (rows, cells*c) tensor."""
    rows, cells = occ.shape
    return torch.where(occ[:, :, None], out.reshape(rows, cells, c),
                       0).reshape(rows, cells * c)


# ---------------------------------------------------------------------------
# source-major operands and weights (kernel K2)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _sm_layout(side: int = BRICK):
    """K2's operand layout at brick side s: (in-plane halo positions of
    one x-slice in gyz order, cells of a padded gyz x-run, cells of a
    padded x-plane, cells gathered a brick). The positions are the four
    s-cell edge runs (z-1, z+1, y-1, y+1), then the four corners; runs are
    padded by 4 cells (20 -> 24 at side 4, zero weights) and x-planes by 4
    (36 -> 40), as in the JAX package, so the two packages' operands and
    weights are interchangeable."""
    g = geometry(side)
    r = range(side)
    h_list = ([(y, -1) for y in r] + [(y, side) for y in r]
              + [(-1, z) for z in r] + [(side, z) for z in r]
              + [(-1, -1), (-1, side), (side, -1), (side, side)])
    run, xpad = len(h_list) + 4, g.plane + 4
    return tuple(h_list), run, xpad, side * run + 2 * xpad


_H_LIST, RUN, XPAD, SM_CELLS = _sm_layout()   # side 4: 24, 40 and 176


@functools.lru_cache(maxsize=None)
def _sm_cols(side: int = BRICK):
    """Column of ``halo_index`` for each source-major cell (176 at side 4),
    -1 for the zero padding: [gyz s x run | gxm xpad | gxp xpad]."""
    g = geometry(side)
    h_list, _, _, _ = _sm_layout(side)
    cols = []
    for x in range(side):
        cols += [(x + 1) * g.plane + (hy + 1) * g.halo_side + (hz + 1)
                 for hy, hz in h_list] + [-1] * 4
    for plane in (0, side + 1):
        cols += [plane * g.plane + q for q in range(g.plane)] + [-1] * 4
    return np.asarray(cols, np.int64)


def sm_index(nbr: torch.Tensor, side: int = BRICK) -> torch.Tensor:
    """(rows, 27) rulebook -> (rows, 176) int32 flat cell ids of the
    source-major operands (side 4; ``_sm_layout``'s count at another
    side); absent neighbours and padding -> rows*s^3."""
    rows = nbr.shape[0]
    cols = torch.as_tensor(_sm_cols(side), device=nbr.device)
    picked = halo_index(nbr, side)[:, cols.clamp(min=0)]
    return torch.where(cols >= 0, picked,
                       rows * geometry(side).cells).to(torch.int32)


def _assemble_sm(x2: torch.Tensor, sm: torch.Tensor, compute_dtype,
                 side: int = BRICK):
    """(rows, s^3*cin) -> (x, gyz (rows, 96*cin), gxm, gxp (rows, 40*cin))
    in compute_dtype (side 4's widths), with one row gather; gyz, gxm and
    gxp are column slices of the gathered (rows, 176*cin) buffer (unit
    inner stride)."""
    _, run, xpad, sm_cells = _sm_layout(side)
    ncell = geometry(side).cells
    rows, lanes = x2.shape
    cin = lanes // ncell
    x = x2.to(compute_dtype)
    cells = torch.cat([x.reshape(rows * ncell, cin), x.new_zeros(1, cin)])
    g = cells.index_select(0, sm.reshape(-1)).reshape(rows, sm_cells * cin)
    a, b = side * run * cin, (side * run + xpad) * cin
    return x, g[:, :a], g[:, a:b], g[:, b:]


def sm_weights(w: torch.Tensor, side: int = BRICK):
    """(27, cin, cout) -> wc (3, 16cin, 16cout), wh (3, 24cin, 16cout),
    wx (2, 40cin, 16cout) at side 4 (``_sm_layout``'s widths at another
    side): rows of the banded weights selected and zero-padded to match
    the operands of ``_assemble_sm``. Placement only, so the products are
    the rows6 form's, term for term."""
    g = geometry(side)
    h_list, _, _, _ = _sm_layout(side)
    cin = w.shape[1]
    wb = banded_weights(w, side)
    n = wb.shape[2]
    wb4 = wb.reshape(3, g.plane, cin, n)
    idx_c = torch.as_tensor([(cy + 1) * g.halo_side + (cz + 1)
                             for cy in range(side) for cz in range(side)],
                            device=w.device)
    idx_h = torch.as_tensor([(hy + 1) * g.halo_side + (hz + 1)
                             for hy, hz in h_list], device=w.device)
    wc = wb4[:, idx_c].reshape(3, g.slice_cells * cin, n)
    wh = torch.cat([wb4[:, idx_h].reshape(3, len(h_list) * cin, n),
                    wb.new_zeros(3, 4 * cin, n)], dim=1)
    wx = torch.cat([torch.stack([wb[0], wb[2]]),
                    wb.new_zeros(2, 4 * cin, n)], dim=1)
    return wc, wh, wx


def uses_sm(cin: int, cout: int, sm_max_cin: int, side: int = BRICK) -> bool:
    """Whether a (cin -> cout) subm conv at brick side ``side`` runs on K2:
    the JAX package's ``DODA_SM=shallow`` rule with ``sm_max_cin`` for
    ``DODA_SM_MAXC`` (0 = K1 everywhere). K2 tiles its weights, so there is
    no size test. The rule is the same at every side: K2's kernels are
    built for sides 2 and 4, and its wrappers refuse another side on the
    card, naming it."""
    return cin <= sm_max_cin and cin % 16 == 0 and cout % 8 == 0


def uses_fused(cin: int, cout: int, dtype) -> bool:
    """Whether a (cin -> cout) subm conv that ``uses_sm`` leaves to K1 runs
    its fused version: bf16 operands whose cells are whole 16-byte units
    (cin % 8 == 0) and whose outputs are whole n8 tiles (cout % 8 == 0).
    That is every conv of the flagship but the cin = 3 input conv; float32
    operands take the route 'f32' (``subm_route``)."""
    return dtype == torch.bfloat16 and cin % 8 == 0 and cout % 8 == 0


def uses_narrow(cin: int, cout: int, dtype) -> bool:
    """Whether a (cin -> cout) subm conv that the fused K1 does not take
    runs K1's narrow-input version: bf16 operands of 1 to
    ``NARROW_MAX_CIN`` channels, whole n8 output tiles (cout % 8 == 0).
    That is the flagship's cin = 3 input conv."""
    return dtype == torch.bfloat16 and 1 <= cin <= NARROW_MAX_CIN \
        and cout % 8 == 0


def subm_route(cin: int, cout: int, dtype, sm_max_cin: int,
               side: int = BRICK) -> str:
    """The kernel a (cin -> cout) subm conv runs at brick side ``side``:
    'sm' (K2, bf16 or float32), 'f32' (K1 in float32 from activation and
    rulebook, any width), 'fused' (K1 in bf16 from activation and
    rulebook), 'narrow' (the same for cin < 8) or 'padded' (either of
    those two on operands zero-padded to multiples of 8 channels: the bf16
    widths that neither takes as they are). The routes are the same at
    every side; each kernel's wrapper refuses a side it is not built
    for."""
    if uses_sm(cin, cout, sm_max_cin, side):
        return 'sm'
    if uses_fused(cin, cout, dtype):
        return 'fused'
    if dtype == torch.float32:
        return 'f32'
    return 'narrow' if uses_narrow(cin, cout, dtype) else 'padded'


# ---------------------------------------------------------------------------
# the submanifold conv and its backward
# ---------------------------------------------------------------------------

def _flip_weights(w: torch.Tensor) -> torch.Tensor:
    """w'[k] = w[26-k]^T: the transpose stencil (offsets negate)."""
    return w.flip(0).transpose(1, 2)


def _subm_raw(x2, sm, weights, compute_dtype, sm_max_cin, nbr=None,
              pro=None, occw=None):
    """Assembly + conv core, unmasked (the backward's dx must keep the
    gradient at inactive cells; masked producers upstream zero it).

    ``pro = (scale, bias, occ)``: the conv of the prologue's output. The
    fused route runs it inside K1, from the occupancy words ``occw``
    (made from occ where not given); the other routes apply ``pro_full``
    once up front, as the JAX package's source-major engines do."""
    cin, cout = weights.shape[1], weights.shape[2]
    side = side_of(x2.shape[1] // cin)
    w = weights.to(compute_dtype)
    route = subm_route(cin, cout, compute_dtype, sm_max_cin, side)
    out_dtype = x2.dtype
    if pro is not None and route != 'fused':
        x2 = pro_full(x2, pro, cin, compute_dtype).to(out_dtype)
        pro = None
    if route == 'sm':
        if sm is None:
            raise ValueError(f'subm conv {cin}->{cout} selects K2 '
                             f'(sm_max_cin={sm_max_cin}) but the level has '
                             'no sm_index table')
        ops = _assemble_sm(x2, sm, compute_dtype, side)
        return banded_conv_sm_taps(*ops, w.contiguous(), x2.dtype)
    if nbr is None:
        raise ValueError(f'subm conv {cin}->{cout} in {compute_dtype} '
                         f'selects the {route} K1 but was given no '
                         'rulebook (nbr)')
    if route == 'f32':
        return banded_conv_f32(x2.to(compute_dtype).contiguous(), nbr,
                               w.contiguous(), out_dtype)
    if route == 'narrow':
        return banded_conv_narrow(x2.to(compute_dtype), nbr, w.contiguous(),
                                  out_dtype)
    if route == 'padded':
        return banded_conv_padded(x2.to(compute_dtype), nbr, w.contiguous(),
                                  out_dtype)
    if pro is not None:
        pro = (pro[0], pro[1], occ_words(pro[2]) if occw is None else occw)
    return banded_conv_fused(x2.to(compute_dtype), nbr, w.contiguous(),
                             out_dtype, pro)


def _contract_rows(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a^T @ b over the shared leading rows, (R, K) x (R, N) -> float32
    (K, N).

    The JAX package accumulates its weight gradients in float32
    (``preferred_element_type``); a bf16 ``torch.matmul`` would round its
    result to bf16 before the band fold sums it. On the card bf16 operands
    therefore go through ``torch.mm(..., out_dtype=torch.float32)``: the
    tensor cores multiply bf16 and both accumulate and return float32. On
    the CPU, which has no such product, they are widened first (bf16
    products are exact in float32, so the result is the same sum)."""
    if a.dtype == torch.float32:
        return a.T @ b
    if a.is_cuda:
        return torch.mm(a.T, b, out_dtype=torch.float32)
    return a.float().T @ b.float()


def _dwb_to_dw(dwb: torch.Tensor, cin: int, cout: int,
               side: int = BRICK) -> torch.Tensor:
    """Banded dW (3, (s+2)^2*cin, s^2*cout) -> raster (27, cin, cout): the
    sum over the band cells each tap was placed at by
    ``banded_weights``, in a fixed order (a gather of each tap's s^2
    entries and a sum over them, as the JAX package's 0/1 band einsum
    sums in a fixed order; no atomics)."""
    g = geometry(side)
    i, q, r = (torch.as_tensor(a, device=dwb.device)
               for a in _band_by_tap(side))
    d5 = dwb.reshape(3, g.plane, cin, g.slice_cells, cout)
    return d5[i, q, :, r, :].sum(1)


def _subm_dw(rows6: torch.Tensor, g: torch.Tensor, compute_dtype, cin: int,
             cout: int) -> torch.Tensor:
    """Raster float32 dW (27, cin, cout) from the conv input's halo planes
    (rows, s+2, K) and the masked cotangent. Planes x..x+2 of a brick are
    one contiguous run of 3K lanes, so output slice x contributes one
    (3K, N) product to the three taps at once."""
    b, planes, k = rows6.shape
    side = planes - 2
    n = side * side * cout
    g4 = g.to(compute_dtype).reshape(b, side, n)
    dwb = sum(_contract_rows(
        rows6.as_strided((b, 3 * k), (planes * k, 1),
                         rows6.storage_offset() + x * k),
        g4[:, x]) for x in range(side))
    return _dwb_to_dw(dwb.reshape(3, k, n), cin, cout, side)


@torch.library.custom_op('doda_torch::subm_conv3_product', mutates_args=())
def subm_conv3_product(x2: torch.Tensor, weights: torch.Tensor,
                       sm: Optional[torch.Tensor],
                       nbr: Optional[torch.Tensor],
                       scale: Optional[torch.Tensor],
                       bias: Optional[torch.Tensor],
                       occ: Optional[torch.Tensor],
                       occw: Optional[torch.Tensor],
                       compute_dtype: torch.dtype,
                       sm_max_cin: int) -> torch.Tensor:
    """The forward product of a subm conv (``_subm_raw``; with ``scale``
    the prologue's conv of ``(scale, bias, occ)``) as one dispatcher op.

    The kernels are bound with ``ctypes``, which the dispatcher cannot
    see; as an op, the product is visible to selective activation
    checkpointing, which saves its output under the U-Net's ``'dots'``
    memory policy and hands it back in the replay in place of a launch
    (``models/unet.py``). The autograd Functions below call it in their
    forward only, so it needs no autograd formula of its own."""
    if scale is None:
        return _subm_raw(x2, sm, weights, compute_dtype, sm_max_cin, nbr)
    return _subm_raw(x2, sm, weights, compute_dtype, sm_max_cin, nbr,
                     (scale, bias, occ), occw)


@subm_conv3_product.register_fake
def _(x2, weights, *_):
    cells = x2.shape[1] // weights.shape[1]
    return x2.new_empty(x2.shape[0], cells * weights.shape[2])


class _SubmConv(torch.autograd.Function):
    """Port of ``subm_conv3_2d``'s custom VJP (``_subm2d_bwd``)."""

    @staticmethod
    def forward(ctx, x2, weights, occ, halo, sm, compute_dtype, sm_max_cin,
                nbr):
        ctx.save_for_backward(x2, weights, occ, halo, sm, nbr)
        ctx.compute_dtype, ctx.sm_max_cin = compute_dtype, sm_max_cin
        out = subm_conv3_product(x2, weights, sm, nbr, None, None, None,
                                 None, compute_dtype, sm_max_cin)
        return _mask(out, occ, weights.shape[2])

    @staticmethod
    def backward(ctx, g):
        x2, weights, occ, halo, sm, nbr = ctx.saved_tensors
        cd = ctx.compute_dtype
        cin, cout = weights.shape[1], weights.shape[2]
        g = _mask(g, occ, cout)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            # the conv of the cotangent with the transpose stencil, through
            # the kernel that the flipped shape (cout -> cin) selects
            dx = _subm_raw(g, sm, _flip_weights(weights), cd,
                           ctx.sm_max_cin, nbr).to(x2.dtype)
        if ctx.needs_input_grad[1]:
            dw = _subm_dw(_assemble_p6(x2, halo, cd), g, cd, cin,
                          cout).to(weights.dtype)
        return dx, dw, None, None, None, None, None, None


def subm_conv3_2d(x2: torch.Tensor, occ: torch.Tensor, halo: torch.Tensor,
                  weights: torch.Tensor, compute_dtype=torch.bfloat16,
                  sm: torch.Tensor | None = None,
                  sm_max_cin: int = 0,
                  nbr: torch.Tensor | None = None) -> torch.Tensor:
    """Submanifold 3^3 conv on wide-lane bricks.

    x2      (rows, 64*cin) — zero at inactive cells
    occ     (rows, 64) bool
    halo    (rows, 216) from ``halo_index`` of the level's rulebook
    weights (27, cin, cout) raster (dx, dy, dz)
    sm      (rows, 176) from ``sm_index``, needed where ``uses_sm`` picks
            K2 for this conv or for its backward's flipped shape
    nbr     (rows, 27) int32 rulebook, null id == rows, needed wherever
            ``subm_route`` picks K1 (forward or flipped shape)
    returns (rows, 64*cout) in x2.dtype, masked to active cells
    """
    return _SubmConv.apply(x2, weights, occ, halo, sm, compute_dtype,
                           sm_max_cin, nbr)


class _SubmConvNorm(torch.autograd.Function):
    """Port of ``subm_conv3_norm_2d``'s custom VJP (``_subm_norm_bwd``)."""

    @staticmethod
    def forward(ctx, x2, weights, scale, bias, occ, halo, sm, compute_dtype,
                sm_max_cin, nbr, occw):
        ctx.save_for_backward(x2, weights, scale, bias, occ, halo, sm, nbr)
        ctx.compute_dtype, ctx.sm_max_cin = compute_dtype, sm_max_cin
        out = subm_conv3_product(x2, weights, sm, nbr, scale, bias,
                                 occ, occw, compute_dtype, sm_max_cin)
        return _mask(out, occ, weights.shape[2])

    @staticmethod
    def backward(ctx, g):
        x2, weights, scale, bias, occ, halo, sm, nbr = ctx.saved_tensors
        cd = ctx.compute_dtype
        cin, cout = weights.shape[1], weights.shape[2]
        g = _mask(g, occ, cout)
        dx = dw = ds = db = None
        h = pro_full(x2, (scale, bias, occ), cin, cd)
        if any(ctx.needs_input_grad[i] for i in (0, 2, 3)):
            # the cotangent of the prologue's output through the plain
            # conv's dx kernel, then the prologue's backward
            dh = _subm_raw(g, sm, _flip_weights(weights), cd,
                           ctx.sm_max_cin, nbr)
            dx, ds, db = _pro_backward(x2, h, scale, dh, cd)
        if ctx.needs_input_grad[1]:
            dw = _subm_dw(_assemble_p6(h, halo, cd), g, cd, cin,
                          cout).to(weights.dtype)
        return dx, dw, ds, db, None, None, None, None, None, None, None


def subm_conv3_norm_2d(x2: torch.Tensor, occ: torch.Tensor,
                       halo: torch.Tensor, weights: torch.Tensor,
                       scale: torch.Tensor, bias: torch.Tensor,
                       compute_dtype=torch.bfloat16,
                       sm: torch.Tensor | None = None, sm_max_cin: int = 0,
                       nbr: torch.Tensor | None = None,
                       occw: torch.Tensor | None = None) -> torch.Tensor:
    """``subm_conv3_2d(where(occ, relu(x2*scale + bias), 0))`` with the
    per-channel (cin,) scale and bias of a folded batch norm, without
    materializing the normalized activation on the fused route. ``occw``
    (rows,) int64 is ``occ_words(occ)``, made once per level; other
    arguments as ``subm_conv3_2d``. Differentiable in x2, weights, scale
    and bias."""
    return _SubmConvNorm.apply(x2, weights, scale, bias, occ, halo, sm,
                               compute_dtype, sm_max_cin, nbr, occw)


# ---------------------------------------------------------------------------
# stride-2 down / up sampling (k=2, s=2), octant-major cell permutes
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _wo_cells(side: int = BRICK):
    """Cell ids in (window, offset) order: w=(xh,yh,zh), o=(xl,yl,zl)."""
    h = geometry(side).half
    return tuple(_cell(xh * 2 + xl, yh * 2 + yl, zh * 2 + zl, side)
                 for xh in range(h) for yh in range(h) for zh in range(h)
                 for xl in range(2) for yl in range(2) for zl in range(2))


@functools.lru_cache(maxsize=None)
def _ow_cells(side: int = BRICK):
    """Cell ids in (octant, window) order — parent-side raster."""
    h = geometry(side).half
    return tuple(_cell(rx * h + xh, ry * h + yh, rz * h + zh, side)
                 for rx in range(2) for ry in range(2) for rz in range(2)
                 for xh in range(h) for yh in range(h) for zh in range(h))


@functools.lru_cache(maxsize=None)
def _inv(cells):
    """Inverse permutation of a cell order."""
    inv = [0] * len(cells)
    for pos, c in enumerate(cells):
        inv[c] = pos
    return tuple(inv)


def _lane_permute(x2: torch.Tensor, cells, c: int) -> torch.Tensor:
    """Reorder the cell blocks of (rows, cells*c) lanes."""
    rows, n = x2.shape[0], len(cells)
    idx = torch.as_tensor(cells, device=x2.device)
    return x2.reshape(rows, n, c).index_select(1, idx).reshape(rows, n * c)


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


def _down_apply(x, weights, parent_children, occ_p, compute_dtype,
                out_dtype):
    """The stride-2 down conv of x (B, s^3*cin), already in compute_dtype
    -> (P, s^3*cout) in out_dtype, masked to the parents' cells."""
    geo = geometry(side_of(occ_p.shape[1]))
    b, lanes = x.shape
    cin = lanes // geo.cells
    cout = weights.shape[-1]
    x = _lane_permute(x, _wo_cells(geo.side), cin)
    w = weights.reshape(8 * cin, cout).to(compute_dtype)
    child_out = (x.reshape(b * geo.windows, 8 * cin) @ w).reshape(
        b, geo.windows * cout)
    pow_ = _children_gather(child_out, parent_children)
    p_raster = _lane_permute(pow_, _inv(_ow_cells(geo.side)),
                             cout).to(out_dtype)
    return _mask(p_raster, occ_p, cout)


def _down_grads(x, weights, g, occ_p, child_parent, parity, compute_dtype,
                need_dx, need_dw):
    """(dx in compute_dtype, float32 dW) of ``_down_apply`` at its input x
    (B, s^3*cin) in compute_dtype, from the output's cotangent g."""
    geo = geometry(side_of(occ_p.shape[1]))
    b, lanes = x.shape
    cin = lanes // geo.cells
    cout = weights.shape[-1]
    g = _mask(g, occ_p, cout).to(compute_dtype)
    g_ow = _lane_permute(g, _ow_cells(geo.side), cout)
    gc_rows = _octant_gather(g_ow, child_parent, parity,
                             geo.windows * cout).reshape(b * geo.windows,
                                                         cout)
    dx = dw = None
    if need_dx:
        w = weights.reshape(8 * cin, cout).to(compute_dtype)
        dx_wo = (gc_rows @ w.T).reshape(b, geo.cells * cin)
        dx = _lane_permute(dx_wo, _inv(_wo_cells(geo.side)), cin)
    if need_dw:
        xw = _lane_permute(x, _wo_cells(geo.side), cin)
        dw = _contract_rows(xw.reshape(b * geo.windows, 8 * cin), gc_rows)
        dw = dw.reshape(8, cin, cout)
    return dx, dw


class _DownConv(torch.autograd.Function):
    """Port of ``down_conv2_2d`` and ``_down2d_bwd``."""

    @staticmethod
    def forward(ctx, x2, weights, occ_p, child_parent, parity,
                parent_children, compute_dtype):
        ctx.save_for_backward(x2, weights, occ_p, child_parent, parity)
        ctx.compute_dtype = compute_dtype
        return _down_apply(x2.to(compute_dtype), weights, parent_children,
                           occ_p, compute_dtype, x2.dtype)

    @staticmethod
    def backward(ctx, g):
        x2, weights, occ_p, child_parent, parity = ctx.saved_tensors
        dx, dw = _down_grads(x2.to(ctx.compute_dtype), weights, g, occ_p,
                             child_parent, parity, ctx.compute_dtype,
                             *ctx.needs_input_grad[:2])
        return (None if dx is None else dx.to(x2.dtype),
                None if dw is None else dw.to(weights.dtype),
                None, None, None, None, None)


def down_conv2_2d(x2: torch.Tensor, occ_p: torch.Tensor, down,
                  weights: torch.Tensor,
                  compute_dtype=torch.bfloat16) -> torch.Tensor:
    """SparseConv3d(k=2, s=2): (B, s^3*cin) children -> (P, s^3*cout).

    ``down`` carries the flat maps child_parent (B,), parity (B,) and
    parent_children (P, 8); nulls are the respective row counts.
    weights (8, cin, cout), offset-major (xl*4 + yl*2 + zl)."""
    return _DownConv.apply(x2, weights, occ_p, down.child_parent,
                           down.parity, down.parent_children, compute_dtype)


class _DownConvNorm(torch.autograd.Function):
    """Port of ``down_conv2_norm_2d`` and ``_downn_bwd``: the prologue on
    the children, applied once up front."""

    @staticmethod
    def forward(ctx, x2, weights, scale, bias, occ_c, occ_p, child_parent,
                parity, parent_children, compute_dtype):
        ctx.save_for_backward(x2, weights, scale, bias, occ_c, occ_p,
                              child_parent, parity)
        ctx.compute_dtype = compute_dtype
        cin = x2.shape[1] // occ_c.shape[1]
        h = pro_full(x2, (scale, bias, occ_c), cin, compute_dtype)
        return _down_apply(h, weights, parent_children, occ_p,
                           compute_dtype, x2.dtype)

    @staticmethod
    def backward(ctx, g):
        (x2, weights, scale, bias, occ_c, occ_p, child_parent,
         parity) = ctx.saved_tensors
        cd = ctx.compute_dtype
        need_dw = ctx.needs_input_grad[1]
        h = pro_full(x2, (scale, bias, occ_c), x2.shape[1] // occ_c.shape[1],
                     cd)
        dh, dw = _down_grads(h, weights, g, occ_p, child_parent, parity, cd,
                             True, need_dw)
        dx, ds, db = _pro_backward(x2, h, scale, dh, cd)
        return (dx, None if dw is None else dw.to(weights.dtype), ds, db,
                None, None, None, None, None, None)


def down_conv2_norm_2d(x2: torch.Tensor, occ_c: torch.Tensor,
                       occ_p: torch.Tensor, down, weights: torch.Tensor,
                       scale: torch.Tensor, bias: torch.Tensor,
                       compute_dtype=torch.bfloat16) -> torch.Tensor:
    """``down_conv2_2d`` of where(occ_c, relu(x2*scale + bias), 0): occ_c
    is the children's cell mask, occ_p the parents' output mask."""
    return _DownConvNorm.apply(x2, weights, scale, bias, occ_c, occ_p,
                               down.child_parent, down.parity,
                               down.parent_children, compute_dtype)


def _up_corner(p, child_parent, parity, side: int = BRICK):
    """(P, s^3*cin) parents -> (B, windows*cin): each child's octant."""
    geo = geometry(side)
    cin = p.shape[1] // geo.cells
    par_ow = _lane_permute(p, _ow_cells(side), cin)
    return _octant_gather(par_ow, child_parent, parity, geo.windows * cin)


def _up_apply(p, weights, child_parent, parity, occ_c, compute_dtype,
              out_dtype):
    """The stride-2 up conv of p (P, s^3*cin), already in compute_dtype
    -> (B, s^3*cout) in out_dtype, masked to the children's cells."""
    geo = geometry(side_of(occ_c.shape[1]))
    cin = p.shape[1] // geo.cells
    cout = weights.shape[-1]
    b = child_parent.shape[0]
    corner = _up_corner(p, child_parent, parity, geo.side)
    # W[o, c, :] -> (cin, 8*cout) so out lanes come back (o, cout)
    w = weights.permute(1, 0, 2).reshape(cin, 8 * cout).to(compute_dtype)
    out8 = (corner.reshape(b * geo.windows, cin) @ w).reshape(
        b, geo.windows * 8 * cout)
    out = _lane_permute(out8, _inv(_wo_cells(geo.side)),
                        cout).to(out_dtype)
    return _mask(out, occ_c, cout)


def _up_grads(p, weights, g, occ_c, child_parent, parity, parent_children,
              compute_dtype, need_dp, need_dw):
    """(dp in compute_dtype, float32 dW) of ``_up_apply`` at its input p
    (P, s^3*cin) in compute_dtype, from the output's cotangent g."""
    geo = geometry(side_of(occ_c.shape[1]))
    cin = p.shape[1] // geo.cells
    cout = weights.shape[-1]
    b = child_parent.shape[0]
    g = _mask(g, occ_c, cout).to(compute_dtype)
    g_rows = _lane_permute(g, _wo_cells(geo.side), cout).reshape(
        b * geo.windows, 8 * cout)
    dp = dw = None
    if need_dp:
        w = weights.permute(1, 0, 2).reshape(cin, 8 * cout).to(compute_dtype)
        dcorner = (g_rows @ w.T).reshape(b, geo.windows * cin)
        dp_ow = _children_gather(dcorner, parent_children)
        dp = _lane_permute(dp_ow, _inv(_ow_cells(geo.side)), cin)
    if need_dw:
        corner = _up_corner(p, child_parent, parity, geo.side)
        dw8 = _contract_rows(corner.reshape(b * geo.windows, cin), g_rows)
        dw = dw8.reshape(cin, 8, cout).permute(1, 0, 2)
    return dp, dw


class _UpConv(torch.autograd.Function):
    """Port of ``up_conv2_2d`` and ``_up2d_bwd``."""

    @staticmethod
    def forward(ctx, p2, weights, occ_c, child_parent, parity,
                parent_children, compute_dtype):
        ctx.save_for_backward(p2, weights, occ_c, child_parent, parity,
                              parent_children)
        ctx.compute_dtype = compute_dtype
        return _up_apply(p2.to(compute_dtype), weights, child_parent, parity,
                         occ_c, compute_dtype, p2.dtype)

    @staticmethod
    def backward(ctx, g):
        (p2, weights, occ_c, child_parent, parity,
         parent_children) = ctx.saved_tensors
        dp, dw = _up_grads(p2.to(ctx.compute_dtype), weights, g, occ_c,
                           child_parent, parity, parent_children,
                           ctx.compute_dtype, *ctx.needs_input_grad[:2])
        return (None if dp is None else dp.to(p2.dtype),
                None if dw is None else dw.to(weights.dtype),
                None, None, None, None, None)


def up_conv2_2d(p2: torch.Tensor, occ_c: torch.Tensor, down,
                weights: torch.Tensor,
                compute_dtype=torch.bfloat16) -> torch.Tensor:
    """SparseInverseConv3d(k=2): (P, s^3*cin) parents -> (B, s^3*cout).

    Each child reads the 8 parent cells of its octant through W[offset]."""
    return _UpConv.apply(p2, weights, occ_c, down.child_parent, down.parity,
                         down.parent_children, compute_dtype)


class _UpConvNorm(torch.autograd.Function):
    """Port of ``up_conv2_norm_2d`` and ``_upn_bwd``: the prologue on the
    parents, applied once up front."""

    @staticmethod
    def forward(ctx, p2, weights, scale, bias, occ_p, occ_c, child_parent,
                parity, parent_children, compute_dtype):
        ctx.save_for_backward(p2, weights, scale, bias, occ_p, occ_c,
                              child_parent, parity, parent_children)
        ctx.compute_dtype = compute_dtype
        h = pro_full(p2, (scale, bias, occ_p), p2.shape[1] // occ_p.shape[1],
                     compute_dtype)
        return _up_apply(h, weights, child_parent, parity, occ_c,
                         compute_dtype, p2.dtype)

    @staticmethod
    def backward(ctx, g):
        (p2, weights, scale, bias, occ_p, occ_c, child_parent, parity,
         parent_children) = ctx.saved_tensors
        cd = ctx.compute_dtype
        h = pro_full(p2, (scale, bias, occ_p), p2.shape[1] // occ_p.shape[1],
                     cd)
        dh, dw = _up_grads(h, weights, g, occ_c, child_parent, parity,
                           parent_children, cd, True,
                           ctx.needs_input_grad[1])
        dp, ds, db = _pro_backward(p2, h, scale, dh, cd)
        return (dp, None if dw is None else dw.to(weights.dtype), ds, db,
                None, None, None, None, None, None)


def up_conv2_norm_2d(p2: torch.Tensor, occ_p: torch.Tensor,
                     occ_c: torch.Tensor, down, weights: torch.Tensor,
                     scale: torch.Tensor, bias: torch.Tensor,
                     compute_dtype=torch.bfloat16) -> torch.Tensor:
    """``up_conv2_2d`` of where(occ_p, relu(p2*scale + bias), 0): occ_p is
    the parents' cell mask, occ_c the children's output mask."""
    return _UpConvNorm.apply(p2, weights, scale, bias, occ_p, occ_c,
                             down.child_parent, down.parity,
                             down.parent_children, compute_dtype)


def conv1x1_2d(x2: torch.Tensor, occ: torch.Tensor, weights: torch.Tensor,
               compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Per-cell channel mix (the residual shortcut's 1x1); its backward is
    autograd's (two matmuls and the mask, no gather)."""
    rows, cells = occ.shape
    cin, cout = weights.shape
    out = (x2.to(compute_dtype).reshape(rows * cells, cin)
           @ weights.to(compute_dtype)).reshape(rows, cells * cout)
    return _mask(out.to(x2.dtype), occ, cout)
