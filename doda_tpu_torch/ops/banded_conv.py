"""Kernel K1: the banded 3-tap submanifold conv over six halo planes.

Port of ``doda_tpu/ops/pallas_banded.py::banded_conv``. For rows6
(B, 6, 36*cin) — the six halo planes x = -1, 0..3, +4 of each brick — and
banded weights wb (3, 36*cin, 16*cout) it computes

    out[:, x*16*cout:(x+1)*16*cout] = sum_{j<3} rows6[:, x + j] @ wb[j]

for x = 0..3, unmasked, accumulating in float32. On CUDA tensors this is
the hand-written kernel of ``csrc/banded_conv.cu``, for bf16 operands (a
float32 call raises, naming ``banded_conv_f32``); on CPU tensors it is
``banded_conv_plain``. There is no other path.

``banded_conv_fused`` is the kernel's second version
(``csrc/banded_conv_fused.cu``): the same conv from the activation x2
(rows, 64*cin), the rulebook nbr (rows, 27) and the raster weights
w (27, cin, cout). It assembles each brick's halo in shared memory and
multiplies only the taps, so neither the planes nor the banded weights are
built. Its plain version is the first route on plain PyTorch:
``banded_conv_plain(_assemble_p6(x2, halo_index(nbr)), banded_weights(w))``.

``banded_conv_narrow`` (``csrc/subm_conv_narrow.cu``) is the same conv
from the activation and the rulebook for an input of 1 to 7 channels (the
cin = 3 input conv), whose cells are not whole 16-byte units: it stages
each brick's halo through registers and multiplies the taps of an implicit
im2col tile. Its plain version is the fused version's.

``banded_conv_f32`` (``csrc/subm_conv_f32.cu``) is the same conv from the
activation and the rulebook on float32 operands, for every cin and cout:
the taps only, from the raster weights, as float32 FMAs on the CUDA cores
(no TF32), so no float32 conv reads halo planes. Its plain version is the
fused version's.

With ``pro=(scale, bias, occw)`` the fused version is the prologue variant
of the fused norm + ReLU engine: the conv reads
``where(occ, relu(x2*scale + bias), 0)`` in place of x2, applied to each
halo cell where the kernel stages it; ``occw`` holds one 64-bit
occupancy word a brick (``occ_words``). Its plain version applies
``bricks2d.pro_full`` first.

The shapes above are brick side 4's. At side s a brick has s^3 cells,
s+2 halo planes of (s+2)^2 cells and s output x-slices of s^2 cells
(rows6 (B, s+2, (s+2)^2*cin), wb (3, (s+2)^2*cin, s^2*cout), x2 (rows,
s^3*cin)); each wrapper reads s from its operands' widths. The plain
versions take any even side; the kernels are built for ``KERNEL_SIDES``
(2 and 4, a template parameter of each source), and a CUDA call at another
side raises ValueError.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
KERNEL_SIDES = (2, 4)       # the brick sides each K1 source is built for


def kernel_side(name: str, cells: int, sides=KERNEL_SIDES) -> int:
    """The brick side of a kernel call on bricks of ``cells`` cells;
    ValueError, naming the side and the kernel, where the kernel is not
    built for it (the plain version takes any even side, on the CPU)."""
    from .bricks import side_of
    side = side_of(cells)
    if side not in sides:
        raise ValueError(f'{name}: brick side {side} has no kernel (built '
                         f'for sides {sides}); run it at one of those '
                         'sides, or on the CPU')
    return side


def banded_conv_plain(rows6: torch.Tensor, wb: torch.Tensor,
                      out_dtype) -> torch.Tensor:
    """The same function as 3*s float32 matmuls (12 at side 4), cast once
    to out_dtype."""
    r, w = rows6.float(), wb.float()
    outs = [r[:, x] @ w[0] + r[:, x + 1] @ w[1] + r[:, x + 2] @ w[2]
            for x in range(rows6.shape[1] - 2)]
    return torch.cat(outs, dim=1).to(out_dtype)


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.load('banded_conv').doda_banded_conv
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(rows6: torch.Tensor, wb: torch.Tensor, out_dtype) -> None:
    if rows6.device.type != 'cuda' or wb.device != rows6.device:
        raise ValueError(f'banded_conv: rows6 on {rows6.device} and wb on '
                         f'{wb.device}; both must be on one CUDA device')
    if rows6.dtype != torch.bfloat16 or wb.dtype != rows6.dtype:
        raise ValueError(f'banded_conv: operands {rows6.dtype}/{wb.dtype}; '
                         'the kernel takes bfloat16 (float32 convs run '
                         'banded_conv_f32 from the activation and the '
                         'rulebook)')
    if out_dtype not in _DTYPE_CODES:
        raise ValueError(f'banded_conv: out_dtype {out_dtype} unsupported')
    if rows6.dim() != 3 or wb.dim() != 3 \
            or wb.shape[0] != 3 or wb.shape[1] != rows6.shape[2] \
            or wb.shape[2] % 8:
        raise ValueError(f'banded_conv: shapes {tuple(rows6.shape)} and '
                         f'{tuple(wb.shape)}; need (B, s+2, K) and (3, K, '
                         'N) with N a multiple of 8')
    if not (rows6.is_contiguous() and wb.is_contiguous()):
        raise ValueError('banded_conv: operands must be contiguous')
    if wb.data_ptr() % 16:
        raise ValueError('banded_conv: wb must be 16-byte aligned')


def banded_conv(rows6: torch.Tensor, wb: torch.Tensor,
                out_dtype) -> torch.Tensor:
    """rows6 (B, 6, 36*cin), wb (3, 36*cin, 16*cout) -> (B, 64*cout) at
    side 4; (B, s+2, (s+2)^2*cin), (3, (s+2)^2*cin, s^2*cout) -> (B,
    s^3*cout) at side s."""
    if rows6.device.type == 'cpu' and wb.device.type == 'cpu':
        return banded_conv_plain(rows6, wb, out_dtype)
    if rows6.dim() == 3:
        kernel_side('banded_conv', max(rows6.shape[1] - 2, 0) ** 3)
    _check(rows6, wb, out_dtype)
    side = rows6.shape[1] - 2
    b, _, k = rows6.shape
    n = wb.shape[2]
    out = torch.empty((b, side * n), dtype=out_dtype, device=rows6.device)
    err = _entry()(rows6.data_ptr(), wb.data_ptr(), out.data_ptr(), b, k, n,
                   side, _DTYPE_CODES[rows6.dtype], _DTYPE_CODES[out_dtype],
                   torch.cuda.current_stream(rows6.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f'banded_conv: kernel launch failed with CUDA '
                           f'error {err}')
    banded_conv.launches += 1
    return out


banded_conv.launches = 0


# ---------------------------------------------------------------------------
# the fused version: activation + rulebook in, conv out
# ---------------------------------------------------------------------------

def occ_words(occ: torch.Tensor) -> torch.Tensor:
    """(rows, cells) bool cell occupancy (cells = side^3 <= 64) -> (rows,)
    int64, bit c = cell c (bit 63 is the sign bit: the words are the
    kernel's uint64; a side-2 brick uses bits 0-7)."""
    cells = occ.shape[1]
    one = torch.ones(cells, dtype=torch.int64, device=occ.device)
    bits = one.bitwise_left_shift(torch.arange(cells, device=occ.device))
    return torch.where(occ, bits, 0).sum(1)


def occ_from_words(occw: torch.Tensor, cells: int = 64) -> torch.Tensor:
    """The inverse of ``occ_words``: (rows,) int64 -> (rows, cells)
    bool."""
    shift = torch.arange(cells, device=occw.device)
    return (occw[:, None].bitwise_right_shift(shift) & 1).bool()


def banded_conv_fused_plain(x2: torch.Tensor, nbr: torch.Tensor,
                            w: torch.Tensor, out_dtype,
                            pro=None) -> torch.Tensor:
    """The assembled route on plain PyTorch: halo planes by one gather,
    banded weights, 12 float32 matmuls; with ``pro=(scale, bias, occw)``
    the planes of ``pro_full`` of x2 (the prologue in float32, rounded
    once to the operands' dtype)."""
    from . import bricks, bricks2d
    cells = x2.shape[1] // w.shape[1]
    side = bricks.side_of(cells)
    if pro is not None:
        pro = (pro[0], pro[1], occ_from_words(pro[2], cells))
    rows6 = bricks2d._assemble_p6(x2, bricks2d.halo_index(nbr, side),
                                  w.dtype, pro)
    return banded_conv_plain(rows6, bricks2d.banded_weights(w, side),
                             out_dtype)


@functools.lru_cache(maxsize=None)
def _fused_lib():
    lib = _build.load('banded_conv_fused')
    lib.doda_banded_conv_fused.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p]
    lib.doda_banded_conv_fused.restype = ctypes.c_int
    lib.doda_banded_conv_fused_smem.argtypes = [ctypes.c_int, ctypes.c_int,
                                                ctypes.c_int, ctypes.c_int]
    lib.doda_banded_conv_fused_smem.restype = ctypes.c_int
    return lib


def fused_smem_bytes(cin: int, cout: int, pro: bool = False,
                     side: int = 4) -> int:
    """Dynamic shared memory of one fused launch at (cin, cout) on bricks
    of ``side``."""
    return _fused_lib().doda_banded_conv_fused_smem(cin, cout, int(pro),
                                                    side)


def _check_cuda(name, x2, nbr, w, out_dtype,
                dtype=torch.bfloat16) -> None:
    """What a kernel from the activation and the rulebook takes: operands
    of ``dtype`` and the rulebook on one CUDA device, contiguous."""
    if x2.device.type != 'cuda' or nbr.device != x2.device \
            or w.device != x2.device:
        raise ValueError(f'{name}: x2 on {x2.device}, nbr on {nbr.device}, '
                         f'w on {w.device}; all must be on one CUDA device')
    if x2.dtype != dtype or w.dtype != dtype:
        raise ValueError(f'{name}: operands {x2.dtype}/{w.dtype}; both '
                         f'must be {str(dtype)[6:]}')
    if out_dtype not in _DTYPE_CODES:
        raise ValueError(f'{name}: out_dtype {out_dtype} unsupported')
    if not (x2.is_contiguous() and nbr.is_contiguous()
            and w.is_contiguous()):
        raise ValueError(f'{name}: operands must be contiguous')


def _check_nbr(name, x2, nbr) -> None:
    if nbr.dtype != torch.int32 or nbr.dim() != 2 or nbr.shape[1] != 27 \
            or x2.dim() != 2 or nbr.shape[0] != x2.shape[0]:
        raise ValueError(f'{name}: nbr {nbr.dtype} {tuple(nbr.shape)} for '
                         f'x2 {tuple(x2.shape)}; need int32 (rows, 27)')


def _check_fused(x2, nbr, w, out_dtype) -> None:
    _check_cuda('banded_conv_fused', x2, nbr, w, out_dtype)
    _check_nbr('banded_conv_fused', x2, nbr)
    if w.dim() != 3 or w.shape[0] != 27 or w.shape[1] % 8 or w.shape[2] % 8 \
            or x2.shape[1] % w.shape[1]:
        raise ValueError(f'banded_conv_fused: x2 {tuple(x2.shape)} and w '
                         f'{tuple(w.shape)}; need (rows, cells*cin) and '
                         '(27, cin, cout) with cin and cout multiples of 8')
    if x2.data_ptr() % 16 or w.data_ptr() % 16 or nbr.data_ptr() % 4:
        raise ValueError('banded_conv_fused: x2 and w must be 16-byte '
                         'aligned')


def _check_pro(pro, x2, cin):
    scale, bias, occw = pro
    for name, t in (('scale', scale), ('bias', bias)):
        if t.device != x2.device or t.dtype != torch.bfloat16 \
                or t.shape != (cin,) or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError(f'banded_conv_fused: {name} {t.dtype} '
                             f'{tuple(t.shape)} on {t.device}; need a '
                             f'contiguous 16-byte aligned bf16 ({cin},) on '
                             f'{x2.device}')
    if occw.device != x2.device or occw.dtype != torch.int64 \
            or occw.shape != (x2.shape[0],) or not occw.is_contiguous():
        raise ValueError(f'banded_conv_fused: occw {occw.dtype} '
                         f'{tuple(occw.shape)}; need int64 (rows,) from '
                         'occ_words')


def banded_conv_fused(x2: torch.Tensor, nbr: torch.Tensor, w: torch.Tensor,
                      out_dtype, pro=None) -> torch.Tensor:
    """x2 (rows, cells*cin), nbr (rows, 27) int32 with null id == rows,
    w (27, cin, cout) -> (rows, cells*cout), unmasked; cells = s^3 for
    bricks of side s. ``pro=(scale, bias, occw)`` runs the prologue
    variant; it counts its launches in ``banded_conv_fused.pro_launches``,
    the plain conv in ``.launches``."""
    if all(t.device.type == 'cpu' for t in (x2, nbr, w)):
        return banded_conv_fused_plain(x2, nbr, w, out_dtype, pro)
    cells = x2.shape[-1] // w.shape[1] if w.dim() == 3 and w.shape[1] else 0
    side = kernel_side('banded_conv_fused', cells)
    _check_fused(x2, nbr, w, out_dtype)
    rows, cin, cout = x2.shape[0], w.shape[1], w.shape[2]
    ptrs = (None, None, None)
    if pro is not None:
        pro = (pro[0].to(torch.bfloat16).contiguous(),
               pro[1].to(torch.bfloat16).contiguous(), pro[2])
        _check_pro(pro, x2, cin)
        ptrs = tuple(t.data_ptr() for t in pro)
    out = torch.empty((rows, side ** 3 * cout), dtype=out_dtype,
                      device=x2.device)
    if rows == 0:
        return out
    err = _fused_lib().doda_banded_conv_fused(
        x2.data_ptr(), nbr.data_ptr(), w.data_ptr(), out.data_ptr(), rows,
        cin, cout, _DTYPE_CODES[out_dtype], side, *ptrs,
        torch.cuda.current_stream(x2.device).cuda_stream)
    if err != 0:
        raise RuntimeError('banded_conv_fused: kernel launch failed with '
                           f'CUDA error {err}')
    if pro is None:
        banded_conv_fused.launches += 1
    else:
        banded_conv_fused.pro_launches += 1
    return out


banded_conv_fused.launches = 0
banded_conv_fused.pro_launches = 0


# ---------------------------------------------------------------------------
# float32: activation + rulebook in, conv out, on the CUDA cores
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _f32_lib():
    lib = _build.load('subm_conv_f32')
    lib.doda_subm_conv_f32.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]
    lib.doda_subm_conv_f32.restype = ctypes.c_int
    lib.doda_subm_conv_f32_smem.argtypes = [ctypes.c_int] * 3
    lib.doda_subm_conv_f32_smem.restype = ctypes.c_int
    return lib


def f32_smem_bytes(cin: int, cout: int, side: int = 4) -> int:
    """Dynamic shared memory of one ``banded_conv_f32`` launch at (cin,
    cout) on bricks of ``side``."""
    return _f32_lib().doda_subm_conv_f32_smem(cin, cout, side)


def _check_f32(x2, nbr, w, out_dtype) -> None:
    name = 'banded_conv_f32'
    _check_nbr(name, x2, nbr)
    if w.dim() != 3 or w.shape[0] != 27 or w.shape[1] == 0 \
            or w.shape[2] == 0 or x2.shape[1] % w.shape[1]:
        raise ValueError(f'{name}: x2 {tuple(x2.shape)} and w '
                         f'{tuple(w.shape)}; need (rows, cells*cin) and '
                         '(27, cin, cout)')
    _check_cuda(name, x2, nbr, w, out_dtype, torch.float32)


def banded_conv_f32(x2: torch.Tensor, nbr: torch.Tensor, w: torch.Tensor,
                    out_dtype) -> torch.Tensor:
    """x2 (rows, cells*cin) float32, nbr (rows, 27) int32 with null id ==
    rows, w (27, cin, cout) float32 -> (rows, cells*cout), unmasked (cells
    = s^3 for bricks of side s), for any cin and cout: the fused version's
    function in float32."""
    if all(t.device.type == 'cpu' for t in (x2, nbr, w)):
        return banded_conv_fused_plain(x2, nbr, w, out_dtype)
    _check_f32(x2, nbr, w, out_dtype)
    rows, cin, cout = x2.shape[0], w.shape[1], w.shape[2]
    side = kernel_side('banded_conv_f32', x2.shape[1] // cin)
    out = torch.empty((rows, side ** 3 * cout), dtype=out_dtype,
                      device=x2.device)
    if rows == 0:
        return out
    err = _f32_lib().doda_subm_conv_f32(
        x2.data_ptr(), nbr.data_ptr(), w.data_ptr(), out.data_ptr(), rows,
        cin, cout, _DTYPE_CODES[out_dtype], side,
        torch.cuda.current_stream(x2.device).cuda_stream)
    if err != 0:
        raise RuntimeError('banded_conv_f32: kernel launch failed with CUDA '
                           f'error {err}')
    banded_conv_f32.launches += 1
    return out


banded_conv_f32.launches = 0


# ---------------------------------------------------------------------------
# the narrow-input version: cin < 8, activation + rulebook in, conv out
# ---------------------------------------------------------------------------

NARROW_MAX_CIN = 7          # MAX_CIN of csrc/subm_conv_narrow.cu


@functools.lru_cache(maxsize=None)
def _narrow_lib():
    lib = _build.load('subm_conv_narrow')
    lib.doda_subm_conv_narrow.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]
    lib.doda_subm_conv_narrow.restype = ctypes.c_int
    return lib


def _check_narrow_shapes(x2, nbr, w) -> None:
    _check_nbr('banded_conv_narrow', x2, nbr)
    if w.dim() != 3 or w.shape[0] != 27 \
            or not 1 <= w.shape[1] <= NARROW_MAX_CIN or w.shape[2] % 8 \
            or x2.shape[1] % w.shape[1]:
        raise ValueError(f'banded_conv_narrow: x2 {tuple(x2.shape)} and w '
                         f'{tuple(w.shape)}; need (rows, cells*cin) and '
                         f'(27, cin, cout) with 1 <= cin <= {NARROW_MAX_CIN} '
                         'and cout a multiple of 8')


def banded_conv_narrow(x2: torch.Tensor, nbr: torch.Tensor, w: torch.Tensor,
                       out_dtype) -> torch.Tensor:
    """x2 (rows, cells*cin) with 1 <= cin <= ``NARROW_MAX_CIN``, nbr
    (rows, 27) int32 with null id == rows, w (27, cin, cout) with cout % 8
    == 0 -> (rows, cells*cout), unmasked (cells = s^3 for bricks of side
    s): the fused version's function for inputs too narrow for its 16-byte
    cells. The shapes are checked on every device; the plain version runs
    only for CPU tensors."""
    _check_narrow_shapes(x2, nbr, w)
    if all(t.device.type == 'cpu' for t in (x2, nbr, w)):
        return banded_conv_fused_plain(x2, nbr, w, out_dtype)
    rows, cin, cout = x2.shape[0], w.shape[1], w.shape[2]
    side = kernel_side('banded_conv_narrow', x2.shape[1] // cin)
    _check_cuda('banded_conv_narrow', x2, nbr, w, out_dtype)
    out = torch.empty((rows, side ** 3 * cout), dtype=out_dtype,
                      device=x2.device)
    if rows == 0:
        return out
    err = _narrow_lib().doda_subm_conv_narrow(
        x2.data_ptr(), nbr.data_ptr(), w.data_ptr(), out.data_ptr(), rows,
        cin, cout, _DTYPE_CODES[out_dtype], side,
        torch.cuda.current_stream(x2.device).cuda_stream)
    if err != 0:
        raise RuntimeError('banded_conv_narrow: kernel launch failed with '
                           f'CUDA error {err}')
    banded_conv_narrow.launches += 1
    return out


banded_conv_narrow.launches = 0
