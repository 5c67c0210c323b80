"""Wide-lane brick engine: the convolutions of the U-Net on (rows, 64*C).

Port of ``doda_tpu/ops/bricks2d.py``, forward and backward. Activations are
``(rows, 64*C)`` with the channels of cell ``x*16 + y*4 + z`` at lanes
``[cell*C, (cell+1)*C)``; tables are flattened across the batch and the
null id of a table equals its row count.

The submanifold 3^3 conv is a banded 1-D conv along the brick's x-slices:
each brick gets six halo planes (x = -1, 0..3, +4), each a 6x6 (y', z')
raster of cells (36*C lanes), and output slice x is
``sum_j plane[x + j] @ wb[j]`` with the banded weights of
``banded_weights``. That product is kernel K1 (``banded_conv``). Kernel
K2 (``banded_conv_sm``) computes the same conv "source-major", from the
brick's own activation plus only the halo cells around it
(``_assemble_sm``), so the four centre planes never reach device memory;
in bf16 it runs its second version, ``banded_conv_sm_taps``, which takes
the raster weights and multiplies only the taps (no ``sm_weights``).
``subm_conv3_2d`` picks the kernel per conv from ``sm_max_cin``
(``uses_sm``), the counterpart of the JAX package's ``DODA_SM`` switch.
Every other bf16 conv with channel counts in multiples of 8
(``uses_fused``) runs K1's second version, ``banded_conv_fused``, which
takes the activation and the rulebook and assembles the halo inside the
kernel: no planes, no banded weights. A bf16 conv of 1 to 7 input
channels (``uses_narrow``: the cin = 3 input conv) runs its narrow-input
version, ``banded_conv_narrow``, from the activation and the rulebook
too. The assembled route below remains for float32 operands, the shapes
neither kernel takes and the dW product.

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
route the prologue runs inside K1 where it stages the halo; on the 'sm'
and 'assembled' routes and in the down/up convs ``pro_full`` applies it
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

from .banded_conv import (NARROW_MAX_CIN, banded_conv, banded_conv_fused,
                          banded_conv_narrow, occ_words)
from .banded_conv_sm import banded_conv_sm, banded_conv_sm_taps
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
    """(rows, 64*cin) -> (rows, 6, 36*cin) halo planes in compute_dtype.

    ``pro = (scale, bias, occ)``: the planes of the prologue's output, the
    gather of ``pro_full`` (an absent neighbour's cells are zero either
    way)."""
    rows, lanes = x2.shape
    cin = lanes // CELLS
    if pro is not None:
        x2 = pro_full(x2, pro, cin, compute_dtype)
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


# ---------------------------------------------------------------------------
# source-major operands and weights (kernel K2)
# ---------------------------------------------------------------------------

# in-plane halo positions of one x-slice in gyz order: the four 4-cell edge
# runs (z-1, z+1, y-1, y+1), then the four corners; runs are padded from 20
# to 24 cells (zero weights) and x-planes from 36 to 40, as in the JAX
# package, so the two packages' operands and weights are interchangeable.
_R = range(BRICK)
_H_LIST = ([(y, -1) for y in _R] + [(y, BRICK) for y in _R]
           + [(-1, z) for z in _R] + [(BRICK, z) for z in _R]
           + [(-1, -1), (-1, BRICK), (BRICK, -1), (BRICK, BRICK)])
RUN = len(_H_LIST) + 4          # 24 cells per padded x-run of gyz
XPAD = PLANE + 4                # x-plane rows padded 36 -> 40 cells
SM_CELLS = BRICK * RUN + 2 * XPAD   # 176 gathered cells per brick


@functools.lru_cache(maxsize=None)
def _sm_cols():
    """Column of ``halo_index`` for each of the 176 source-major cells, -1
    for the zero padding: [gyz 4 x 24 | gxm 40 | gxp 40]."""
    cols = []
    for x in range(BRICK):
        cols += [(x + 1) * PLANE + (hy + 1) * H + (hz + 1)
                 for hy, hz in _H_LIST] + [-1] * 4
    for plane in (0, BRICK + 1):
        cols += [plane * PLANE + q for q in range(PLANE)] + [-1] * 4
    return np.asarray(cols, np.int64)


def sm_index(nbr: torch.Tensor) -> torch.Tensor:
    """(rows, 27) rulebook -> (rows, 176) int32 flat cell ids of the
    source-major operands; absent neighbours and padding -> rows*64."""
    rows = nbr.shape[0]
    cols = torch.as_tensor(_sm_cols(), device=nbr.device)
    picked = halo_index(nbr)[:, cols.clamp(min=0)]
    return torch.where(cols >= 0, picked, rows * CELLS).to(torch.int32)


def _assemble_sm(x2: torch.Tensor, sm: torch.Tensor, compute_dtype):
    """(rows, 64*cin) -> (x, gyz (rows, 96*cin), gxm, gxp (rows, 40*cin))
    in compute_dtype, with one row gather; gyz, gxm and gxp are column
    slices of the gathered (rows, 176*cin) buffer (unit inner stride)."""
    rows, lanes = x2.shape
    cin = lanes // CELLS
    x = x2.to(compute_dtype)
    cells = torch.cat([x.reshape(rows * CELLS, cin), x.new_zeros(1, cin)])
    g = cells.index_select(0, sm.reshape(-1)).reshape(rows, SM_CELLS * cin)
    a, b = BRICK * RUN * cin, (BRICK * RUN + XPAD) * cin
    return x, g[:, :a], g[:, a:b], g[:, b:]


def sm_weights(w: torch.Tensor):
    """(27, cin, cout) -> wc (3, 16cin, 16cout), wh (3, 24cin, 16cout),
    wx (2, 40cin, 16cout): rows of the banded weights selected and
    zero-padded to match the operands of ``_assemble_sm``. Placement only,
    so the products are the rows6 form's, term for term."""
    cin = w.shape[1]
    wb = banded_weights(w)
    n = wb.shape[2]
    wb4 = wb.reshape(3, PLANE, cin, n)
    idx_c = torch.as_tensor([(cy + 1) * H + (cz + 1) for cy in range(BRICK)
                             for cz in range(BRICK)], device=w.device)
    idx_h = torch.as_tensor([(hy + 1) * H + (hz + 1) for hy, hz in _H_LIST],
                            device=w.device)
    wc = wb4[:, idx_c].reshape(3, OUTP * cin, n)
    wh = torch.cat([wb4[:, idx_h].reshape(3, len(_H_LIST) * cin, n),
                    wb.new_zeros(3, 4 * cin, n)], dim=1)
    wx = torch.cat([torch.stack([wb[0], wb[2]]),
                    wb.new_zeros(2, 4 * cin, n)], dim=1)
    return wc, wh, wx


def uses_sm(cin: int, cout: int, sm_max_cin: int) -> bool:
    """Whether a (cin -> cout) subm conv runs on K2: the JAX package's
    ``DODA_SM=shallow`` rule with ``sm_max_cin`` for ``DODA_SM_MAXC``
    (0 = K1 everywhere). K2 tiles its weights, so there is no size test."""
    return cin <= sm_max_cin and cin % 16 == 0 and cout % 8 == 0


def uses_fused(cin: int, cout: int, dtype) -> bool:
    """Whether a (cin -> cout) subm conv that ``uses_sm`` leaves to K1 runs
    its fused version: bf16 operands whose cells are whole 16-byte units
    (cin % 8 == 0) and whose outputs are whole n8 tiles (cout % 8 == 0).
    That is every conv of the flagship but the cin = 3 input conv; float32
    operands keep the exact CUDA-core path of the assembled route."""
    return dtype == torch.bfloat16 and cin % 8 == 0 and cout % 8 == 0


def uses_narrow(cin: int, cout: int, dtype) -> bool:
    """Whether a (cin -> cout) subm conv that the fused K1 does not take
    runs K1's narrow-input version: bf16 operands of 1 to
    ``NARROW_MAX_CIN`` channels, whole n8 output tiles (cout % 8 == 0).
    That is the flagship's cin = 3 input conv."""
    return dtype == torch.bfloat16 and 1 <= cin <= NARROW_MAX_CIN \
        and cout % 8 == 0


def subm_route(cin: int, cout: int, dtype, sm_max_cin: int) -> str:
    """The kernel a (cin -> cout) subm conv runs: 'sm' (K2), 'fused' (K1
    from activation and rulebook), 'narrow' (the same for cin < 8) or
    'assembled' (K1 on halo planes)."""
    if uses_sm(cin, cout, sm_max_cin):
        return 'sm'
    if uses_fused(cin, cout, dtype):
        return 'fused'
    return 'narrow' if uses_narrow(cin, cout, dtype) else 'assembled'


# ---------------------------------------------------------------------------
# the submanifold conv and its backward
# ---------------------------------------------------------------------------

def _flip_weights(w: torch.Tensor) -> torch.Tensor:
    """w'[k] = w[26-k]^T: the transpose stencil (offsets negate)."""
    return w.flip(0).transpose(1, 2)


def _subm_raw(x2, halo, sm, weights, compute_dtype, sm_max_cin, nbr=None,
              pro=None, occw=None):
    """Assembly + conv core, unmasked (the backward's dx must keep the
    gradient at inactive cells; masked producers upstream zero it).

    ``pro = (scale, bias, occ)``: the conv of the prologue's output. The
    fused route runs it inside K1, from the occupancy words ``occw``
    (made from occ where not given); the other routes apply ``pro_full``
    once up front, as the JAX package's source-major engines do."""
    cin, cout = weights.shape[1], weights.shape[2]
    w = weights.to(compute_dtype)
    route = subm_route(cin, cout, compute_dtype, sm_max_cin)
    out_dtype = x2.dtype
    if pro is not None and route != 'fused':
        x2 = pro_full(x2, pro, cin, compute_dtype).to(out_dtype)
        pro = None
    if route == 'sm':
        if sm is None:
            raise ValueError(f'subm conv {cin}->{cout} selects K2 '
                             f'(sm_max_cin={sm_max_cin}) but the level has '
                             'no sm_index table')
        ops = _assemble_sm(x2, sm, compute_dtype)
        if compute_dtype == torch.bfloat16:
            # K2's second version: raster weights, the taps only
            return banded_conv_sm_taps(*ops, w.contiguous(), x2.dtype)
        return banded_conv_sm(*ops, *sm_weights(w), x2.dtype)
    if route in ('fused', 'narrow') and nbr is None:
        raise ValueError(f'subm conv {cin}->{cout} in {compute_dtype} '
                         f'selects the {route} K1 but was given no '
                         'rulebook (nbr)')
    if route == 'narrow':
        return banded_conv_narrow(x2.to(compute_dtype), nbr, w.contiguous(),
                                  out_dtype)
    if route == 'fused':
        if pro is not None:
            pro = (pro[0], pro[1],
                   occ_words(pro[2]) if occw is None else occw)
        return banded_conv_fused(x2.to(compute_dtype), nbr, w.contiguous(),
                                 out_dtype, pro)
    return banded_conv(_assemble_p6(x2, halo, compute_dtype),
                       banded_weights(w), out_dtype)


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


def _dwb_to_dw(dwb: torch.Tensor, cin: int, cout: int) -> torch.Tensor:
    """Banded dW (3, 36*cin, 16*cout) -> raster (27, cin, cout): the sum
    over the band cells each tap was placed at by ``banded_weights``."""
    i, q, r, k = (torch.as_tensor(a, device=dwb.device)
                  for a in _band_nonzero())
    d5 = dwb.reshape(3, PLANE, cin, OUTP, cout)
    return dwb.new_zeros(27, cin, cout).index_add_(0, k, d5[i, q, :, r, :])


def _subm_dw(rows6: torch.Tensor, g: torch.Tensor, compute_dtype, cin: int,
             cout: int) -> torch.Tensor:
    """Raster float32 dW (27, cin, cout) from the conv input's halo planes
    and the masked cotangent. Planes x..x+2 of a brick are one contiguous
    run of 3K lanes, so output slice x contributes one (3K, N) product to
    the three taps at once."""
    b, _, k = rows6.shape
    g4 = g.to(compute_dtype).reshape(b, BRICK, OUTP * cout)
    dwb = sum(_contract_rows(
        rows6.as_strided((b, 3 * k), (6 * k, 1),
                         rows6.storage_offset() + x * k),
        g4[:, x]) for x in range(BRICK))
    return _dwb_to_dw(dwb.reshape(3, k, OUTP * cout), cin, cout)


@torch.library.custom_op('doda_torch::subm_conv3_product', mutates_args=())
def subm_conv3_product(x2: torch.Tensor, weights: torch.Tensor,
                       halo: torch.Tensor, sm: Optional[torch.Tensor],
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
        return _subm_raw(x2, halo, sm, weights, compute_dtype, sm_max_cin,
                         nbr)
    return _subm_raw(x2, halo, sm, weights, compute_dtype, sm_max_cin, nbr,
                     (scale, bias, occ), occw)


@subm_conv3_product.register_fake
def _(x2, weights, *_):
    return x2.new_empty(x2.shape[0], CELLS * weights.shape[2])


class _SubmConv(torch.autograd.Function):
    """Port of ``subm_conv3_2d``'s custom VJP (``_subm2d_bwd``)."""

    @staticmethod
    def forward(ctx, x2, weights, occ, halo, sm, compute_dtype, sm_max_cin,
                nbr):
        ctx.save_for_backward(x2, weights, occ, halo, sm, nbr)
        ctx.compute_dtype, ctx.sm_max_cin = compute_dtype, sm_max_cin
        out = subm_conv3_product(x2, weights, halo, sm, nbr, None, None,
                                 None, None, compute_dtype, sm_max_cin)
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
            dx = _subm_raw(g, halo, sm, _flip_weights(weights), cd,
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
    nbr     (rows, 27) int32 rulebook, null id == rows, needed where
            ``uses_fused`` or ``uses_narrow`` picks a K1 that takes it
            (forward or flipped shape)
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
        out = subm_conv3_product(x2, weights, halo, sm, nbr, scale, bias,
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
            dh = _subm_raw(g, halo, sm, _flip_weights(weights), cd,
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


def _down_apply(x, weights, parent_children, occ_p, compute_dtype,
                out_dtype):
    """The stride-2 down conv of x (B, 64*cin), already in compute_dtype
    -> (P, 64*cout) in out_dtype, masked to the parents' cells."""
    b, lanes = x.shape
    cin = lanes // CELLS
    cout = weights.shape[-1]
    x = _lane_permute(x, _wo_cells(), cin)
    w = weights.reshape(8 * cin, cout).to(compute_dtype)
    child_out = (x.reshape(b * WINDOWS, 8 * cin) @ w).reshape(
        b, WINDOWS * cout)
    pow_ = _children_gather(child_out, parent_children)
    p_raster = _lane_permute(pow_, _inv(_ow_cells()), cout).to(out_dtype)
    return _mask(p_raster, occ_p, cout)


def _down_grads(x, weights, g, occ_p, child_parent, parity, compute_dtype,
                need_dx, need_dw):
    """(dx in compute_dtype, float32 dW) of ``_down_apply`` at its input x
    (B, 64*cin) in compute_dtype, from the output's cotangent g."""
    b, lanes = x.shape
    cin = lanes // CELLS
    cout = weights.shape[-1]
    g = _mask(g, occ_p, cout).to(compute_dtype)
    g_ow = _lane_permute(g, _ow_cells(), cout)
    gc_rows = _octant_gather(g_ow, child_parent, parity,
                             WINDOWS * cout).reshape(b * WINDOWS, cout)
    dx = dw = None
    if need_dx:
        w = weights.reshape(8 * cin, cout).to(compute_dtype)
        dx_wo = (gc_rows @ w.T).reshape(b, CELLS * cin)
        dx = _lane_permute(dx_wo, _inv(_wo_cells()), cin)
    if need_dw:
        xw = _lane_permute(x, _wo_cells(), cin)
        dw = _contract_rows(xw.reshape(b * WINDOWS, 8 * cin), gc_rows)
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
    """SparseConv3d(k=2, s=2): (B, 64*cin) children -> (P, 64*cout).

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
        cin = x2.shape[1] // CELLS
        h = pro_full(x2, (scale, bias, occ_c), cin, compute_dtype)
        return _down_apply(h, weights, parent_children, occ_p,
                           compute_dtype, x2.dtype)

    @staticmethod
    def backward(ctx, g):
        (x2, weights, scale, bias, occ_c, occ_p, child_parent,
         parity) = ctx.saved_tensors
        cd = ctx.compute_dtype
        need_dw = ctx.needs_input_grad[1]
        h = pro_full(x2, (scale, bias, occ_c), x2.shape[1] // CELLS, cd)
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


def _up_corner(p, child_parent, parity):
    """(P, 64*cin) parents -> (B, 8*cin): each child's octant."""
    cin = p.shape[1] // CELLS
    par_ow = _lane_permute(p, _ow_cells(), cin)
    return _octant_gather(par_ow, child_parent, parity, WINDOWS * cin)


def _up_apply(p, weights, child_parent, parity, occ_c, compute_dtype,
              out_dtype):
    """The stride-2 up conv of p (P, 64*cin), already in compute_dtype
    -> (B, 64*cout) in out_dtype, masked to the children's cells."""
    cin = p.shape[1] // CELLS
    cout = weights.shape[-1]
    b = child_parent.shape[0]
    corner = _up_corner(p, child_parent, parity)
    # W[o, c, :] -> (cin, 8*cout) so out lanes come back (o, cout)
    w = weights.permute(1, 0, 2).reshape(cin, 8 * cout).to(compute_dtype)
    out8 = (corner.reshape(b * WINDOWS, cin) @ w).reshape(
        b, WINDOWS * 8 * cout)
    out = _lane_permute(out8, _inv(_wo_cells()), cout).to(out_dtype)
    return _mask(out, occ_c, cout)


def _up_grads(p, weights, g, occ_c, child_parent, parity, parent_children,
              compute_dtype, need_dp, need_dw):
    """(dp in compute_dtype, float32 dW) of ``_up_apply`` at its input p
    (P, 64*cin) in compute_dtype, from the output's cotangent g."""
    cin = p.shape[1] // CELLS
    cout = weights.shape[-1]
    b = child_parent.shape[0]
    g = _mask(g, occ_c, cout).to(compute_dtype)
    g_rows = _lane_permute(g, _wo_cells(), cout).reshape(
        b * WINDOWS, 8 * cout)
    dp = dw = None
    if need_dp:
        w = weights.permute(1, 0, 2).reshape(cin, 8 * cout).to(compute_dtype)
        dcorner = (g_rows @ w.T).reshape(b, WINDOWS * cin)
        dp_ow = _children_gather(dcorner, parent_children)
        dp = _lane_permute(dp_ow, _inv(_ow_cells()), cin)
    if need_dw:
        corner = _up_corner(p, child_parent, parity)
        dw8 = _contract_rows(corner.reshape(b * WINDOWS, cin), g_rows)
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
    """SparseInverseConv3d(k=2): (P, 64*cin) parents -> (B, 64*cout).

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
        h = pro_full(p2, (scale, bias, occ_p), p2.shape[1] // CELLS,
                     compute_dtype)
        return _up_apply(h, weights, child_parent, parity, occ_c,
                         compute_dtype, p2.dtype)

    @staticmethod
    def backward(ctx, g):
        (p2, weights, scale, bias, occ_p, occ_c, child_parent, parity,
         parent_children) = ctx.saved_tensors
        cd = ctx.compute_dtype
        h = pro_full(p2, (scale, bias, occ_p), p2.shape[1] // CELLS, cd)
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
    rows = x2.shape[0]
    cin, cout = weights.shape
    out = (x2.to(compute_dtype).reshape(rows * CELLS, cin)
           @ weights.to(compute_dtype)).reshape(rows, CELLS * cout)
    return _mask(out.to(x2.dtype), occ, cout)
