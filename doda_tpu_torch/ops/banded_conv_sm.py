"""Kernel K2: the source-major banded submanifold conv.

Port of ``doda_tpu/ops/pallas_sm.py::banded_conv_sm``. The operands are a
brick's own activation x (B, 64*cin) and only the halo around it: gyz
(B, 96*cin), per x-slice the 20 in-plane halo cells padded to 24, and the
two x-halo planes gxm/gxp (B, 40*cin), 36 cells padded to 40. With the
weights of ``bricks2d.sm_weights`` — wc (3, 16cin, 16cout), wh
(3, 24cin, 16cout), wx (2, 40cin, 16cout) — output x-slice ``xr`` is

    sum over taps i < 3, cx = xr + i - 1:
        gxm @ wx[0]                                     if cx == -1
        gxp @ wx[1]                                     if cx == 4
        x[:, cx*16cin:(cx+1)*16cin] @ wc[i]
          + gyz[:, cx*24cin:(cx+1)*24cin] @ wh[i]       otherwise

unmasked, accumulating in float32; the result is (B, 64*cout). It needs
cin % 16 == 0 and cout % 8 == 0. On CUDA tensors this is the hand-written
kernel of ``csrc/banded_conv_sm.cu``, for float32 operands; on CPU tensors
it is ``banded_conv_sm_plain``. There is no other path.

``banded_conv_sm_taps`` is the kernel's second version
(``csrc/banded_conv_sm_taps.cu``): the same function of the same operands
in bf16, from the raster weights w (27, cin, cout). It multiplies only the
27 taps of each output cell, so no ``sm_weights`` are built. Its plain
version is the first one on ``sm_weights(w)``. The bf16 route of
``bricks2d`` takes it at every cin; float32 operands keep the first
version, and bf16 operands on the card are refused by the first.

The widths above are brick side 4's. At side s the operands are those of
``bricks2d._assemble_sm`` (``bricks2d._sm_layout(s)``: s slices of s^2
cells, gyz runs of 4s+4 cells padded to 4s+8, x-planes of (s+2)^2 cells
padded by 4; at side 2: x 8, gyz 32, gxm/gxp 20 cells a row) and the
output has s^3*cout columns. The plain versions take any even side; both
kernels are built for ``SM_SIDES``, and a CUDA call at another side
raises ValueError naming it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .banded_conv import kernel_side

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
SM_SIDES = (2, 4)          # the brick sides K2's kernels are built for


def sm_widths(side: int):
    """Cells a row of K2's operands x, gyz and gxm/gxp at brick ``side``,
    padding included (64, 96, 40 at side 4; 8, 32, 20 at side 2)."""
    from .bricks2d import _sm_layout
    _, run, xpad, _ = _sm_layout(side)
    return side ** 3, side * run, xpad


def banded_conv_sm_plain(x, gyz, gxm, gxp, wc, wh, wx,
                         out_dtype) -> torch.Tensor:
    """The same function as float32 matmuls on operand slices (the
    arithmetic of the JAX package's ``_sm_xla``), cast once to out_dtype."""
    x, gyz, gxm, gxp, wc, wh, wx = (t.float() for t in
                                    (x, gyz, gxm, gxp, wc, wh, wx))
    k16, k24 = wc.shape[1], wh.shape[1]
    slices = x.shape[1] // k16          # the brick side
    outs = []
    for xr in range(slices):
        acc = 0
        for i in range(3):
            cx = xr + i - 1
            if cx == -1:
                acc = acc + gxm @ wx[0]
            elif cx == slices:
                acc = acc + gxp @ wx[1]
            else:
                acc = acc + x[:, cx * k16:(cx + 1) * k16] @ wc[i] \
                    + gyz[:, cx * k24:(cx + 1) * k24] @ wh[i]
        outs.append(acc)
    return torch.cat(outs, dim=1).to(out_dtype)


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.load('banded_conv_sm').doda_banded_conv_sm
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong] * 4    # operands
                   + [ctypes.c_void_p] * 4                     # wc wh wx out
                   + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,  # B cin N
                      ctypes.c_int, ctypes.c_int,               # side dtype
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(x, gyz, gxm, gxp, wc, wh, wx, out_dtype, side) -> None:
    tensors = (x, gyz, gxm, gxp, wc, wh, wx)
    if any(t.device.type != 'cuda' or t.device != x.device for t in tensors):
        raise ValueError('banded_conv_sm: operands on '
                         f'{[str(t.device) for t in tensors]}; all must be '
                         'on one CUDA device')
    if any(t.dtype != torch.float32 for t in tensors):
        raise ValueError('banded_conv_sm: operands '
                         f'{[str(t.dtype) for t in tensors]}; the kernel '
                         'takes float32 (bf16 operands run '
                         'banded_conv_sm_taps on raster weights)')
    if out_dtype not in _DTYPE_CODES:
        raise ValueError(f'banded_conv_sm: out_dtype {out_dtype} '
                         'unsupported')
    cx, cg, cp = sm_widths(side)
    sl = side * side
    if x.dim() != 2 or x.shape[1] % (cx * 16):
        raise ValueError(f'banded_conv_sm: x {tuple(x.shape)}; need '
                         f'(B, {cx}*cin) with cin a multiple of 16')
    b, cin = x.shape[0], x.shape[1] // cx
    n = wc.shape[2] if wc.dim() == 3 else 0
    want = {'gyz': (b, cg * cin), 'gxm': (b, cp * cin),
            'gxp': (b, cp * cin), 'wc': (3, sl * cin, n),
            'wh': (3, cg // side * cin, n), 'wx': (2, cp * cin, n)}
    got = {'gyz': gyz, 'gxm': gxm, 'gxp': gxp, 'wc': wc, 'wh': wh, 'wx': wx}
    for name, shape in want.items():
        if tuple(got[name].shape) != shape:
            raise ValueError(f'banded_conv_sm: {name} '
                             f'{tuple(got[name].shape)}, need {shape}')
    if n == 0 or n % (8 * sl):
        raise ValueError(f'banded_conv_sm: {sl}*cout = {n}; cout must be a '
                         'positive multiple of 8')
    for name, t in (('x', x), ('gyz', gyz), ('gxm', gxm), ('gxp', gxp)):
        # rows may be strided (column slices of one gathered buffer)
        if t.stride(1) != 1 or t.stride(0) % 8 or t.data_ptr() % 16:
            raise ValueError(f'banded_conv_sm: {name} needs unit inner '
                             'stride, a row stride that is a multiple of 8 '
                             'and 16-byte alignment')
    for name, t in (('wc', wc), ('wh', wh), ('wx', wx)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f'banded_conv_sm: {name} must be contiguous '
                             'and 16-byte aligned')


def banded_conv_sm(x, gyz, gxm, gxp, wc, wh, wx, out_dtype) -> torch.Tensor:
    """x (B, 64cin), gyz (B, 96cin), gxm/gxp (B, 40cin) and the weights of
    ``bricks2d.sm_weights`` -> (B, 64*cout), unmasked (side 4's widths;
    ``_sm_layout``'s at side s)."""
    tensors = (x, gyz, gxm, gxp, wc, wh, wx)
    if all(t.device.type == 'cpu' for t in tensors):
        return banded_conv_sm_plain(*tensors, out_dtype)
    if wc.dim() != 3 or wc.shape[1] == 0:
        raise ValueError(f'banded_conv_sm: wc {tuple(wc.shape)}; need (3, '
                         's^2*cin, s^2*cout)')
    side = kernel_side('banded_conv_sm', (x.shape[1] // wc.shape[1]) ** 3,
                       SM_SIDES)
    _check(*tensors, out_dtype, side)
    b = x.shape[0]
    cin, n = x.shape[1] // side ** 3, wc.shape[2]
    out = torch.empty((b, side * n), dtype=out_dtype, device=x.device)
    if b == 0:
        return out
    err = _entry()(x.data_ptr(), x.stride(0), gyz.data_ptr(), gyz.stride(0),
                   gxm.data_ptr(), gxm.stride(0), gxp.data_ptr(),
                   gxp.stride(0), wc.data_ptr(), wh.data_ptr(),
                   wx.data_ptr(), out.data_ptr(), b, cin, n, side,
                   _DTYPE_CODES[out_dtype],
                   torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError('banded_conv_sm: kernel launch failed with CUDA '
                           f'error {err}')
    banded_conv_sm.launches += 1
    return out


banded_conv_sm.launches = 0


# ---------------------------------------------------------------------------
# the second version: raster weights, the taps only
# ---------------------------------------------------------------------------

def banded_conv_sm_taps_plain(x, gyz, gxm, gxp, w, out_dtype) -> torch.Tensor:
    """The first version's plain arithmetic on ``sm_weights(w)``."""
    from .bricks import side_of
    from .bricks2d import sm_weights
    side = side_of(x.shape[1] // w.shape[1])
    return banded_conv_sm_plain(x, gyz, gxm, gxp, *sm_weights(w, side),
                                out_dtype)


@functools.lru_cache(maxsize=None)
def _taps_lib():
    lib = _build.load('banded_conv_sm_taps')
    lib.doda_banded_conv_sm_taps.argtypes = (
        [ctypes.c_void_p, ctypes.c_longlong] * 4             # operands
        + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,  # w out B
           ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # side
           ctypes.c_void_p])
    lib.doda_banded_conv_sm_taps.restype = ctypes.c_int
    lib.doda_banded_conv_sm_taps_smem.argtypes = [ctypes.c_int] * 2
    lib.doda_banded_conv_sm_taps_smem.restype = ctypes.c_int
    return lib


def sm_taps_smem_bytes(cin: int, side: int = 4) -> int:
    """Dynamic shared memory of one ``banded_conv_sm_taps`` launch on
    bricks of ``side``."""
    return _taps_lib().doda_banded_conv_sm_taps_smem(cin, side)


def _check_taps(x, gyz, gxm, gxp, w, out_dtype, side) -> None:
    tensors = (x, gyz, gxm, gxp, w)
    if any(t.device.type != 'cuda' or t.device != x.device for t in tensors):
        raise ValueError('banded_conv_sm_taps: operands on '
                         f'{[str(t.device) for t in tensors]}; all must be '
                         'on one CUDA device')
    if any(t.dtype != torch.bfloat16 for t in tensors):
        raise ValueError('banded_conv_sm_taps: operands '
                         f'{[str(t.dtype) for t in tensors]}; all must be '
                         'bfloat16')
    if out_dtype not in _DTYPE_CODES:
        raise ValueError(f'banded_conv_sm_taps: out_dtype {out_dtype} '
                         'unsupported')
    cx, cg, cp = sm_widths(side)
    if x.dim() != 2 or w.dim() != 3 or w.shape[0] != 27 \
            or w.shape[1] % 16 or w.shape[2] % 8 or w.shape[2] == 0 \
            or x.shape[1] != cx * w.shape[1]:
        raise ValueError(f'banded_conv_sm_taps: x {tuple(x.shape)}, w '
                         f'{tuple(w.shape)}; need (B, {cx}*cin) and (27, '
                         'cin, cout) with cin a multiple of 16, cout of 8')
    b, cin = x.shape[0], w.shape[1]
    for name, t, cells in (('gyz', gyz, cg), ('gxm', gxm, cp),
                           ('gxp', gxp, cp)):
        if tuple(t.shape) != (b, cells * cin):
            raise ValueError(f'banded_conv_sm_taps: {name} '
                             f'{tuple(t.shape)}, need {(b, cells * cin)}')
    for name, t in (('x', x), ('gyz', gyz), ('gxm', gxm), ('gxp', gxp)):
        # TMA: unit inner stride, row strides in 16-byte multiples, bases
        # 16-byte aligned (column slices of one gathered buffer qualify)
        if t.stride(1) != 1 or t.stride(0) % 8 or t.data_ptr() % 16:
            raise ValueError(f'banded_conv_sm_taps: {name} needs unit inner '
                             'stride, a row stride that is a multiple of 8 '
                             'and 16-byte alignment')
    if not w.is_contiguous() or w.data_ptr() % 16:
        raise ValueError('banded_conv_sm_taps: w must be contiguous and '
                         '16-byte aligned')


def banded_conv_sm_taps(x, gyz, gxm, gxp, w, out_dtype) -> torch.Tensor:
    """x (B, 64cin), gyz (B, 96cin), gxm/gxp (B, 40cin) bf16 and raster
    weights w (27, cin, cout) -> (B, 64*cout), unmasked (side 4's widths;
    ``_sm_layout``'s at side s)."""
    tensors = (x, gyz, gxm, gxp, w)
    if all(t.device.type == 'cpu' for t in tensors):
        return banded_conv_sm_taps_plain(*tensors, out_dtype)
    side = 4
    if w.dim() == 3 and w.shape[1]:
        side = kernel_side('banded_conv_sm_taps', x.shape[1] // w.shape[1],
                           SM_SIDES)
    _check_taps(*tensors, out_dtype, side)
    b, cout = x.shape[0], w.shape[2]
    out = torch.empty((b, side ** 3 * cout), dtype=out_dtype,
                      device=x.device)
    if b == 0:
        return out
    err = _taps_lib().doda_banded_conv_sm_taps(
        x.data_ptr(), x.stride(0), gyz.data_ptr(), gyz.stride(0),
        gxm.data_ptr(), gxm.stride(0), gxp.data_ptr(), gxp.stride(0),
        w.data_ptr(), out.data_ptr(), b, w.shape[1], cout, side,
        _DTYPE_CODES[out_dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError('banded_conv_sm_taps: kernel launch failed with '
                           f'error {err} (CUDA runtime; 1000 + CUresult '
                           'where a tensor map was refused)')
    banded_conv_sm_taps.launches += 1
    return out


banded_conv_sm_taps.launches = 0
