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
cin % 16 == 0 and cout % 8 == 0. ``banded_conv_sm`` on CPU tensors is the
plain version of that function, ``banded_conv_sm_plain``, which the tests
hold to the Pallas kernel; its kernel, the first version, is deleted, and
a call on CUDA tensors raises, naming ``banded_conv_sm_taps``.

``banded_conv_sm_taps`` is the kernel (``csrc/banded_conv_sm_taps.cu``):
the same function of the same operands from the raster weights w (27,
cin, cout). It multiplies only the 27 taps of each output cell, so no
``sm_weights`` are built: bf16 operands on the tensor cores
(``sm_taps_tc``), float32 operands as float32 FMAs on the CUDA cores
(``sm_taps_f32``). Its plain version is ``banded_conv_sm_plain`` on
``sm_weights(w)``. The 'sm' route of ``bricks2d`` takes it at every cin, in
both dtypes; the bf16 kernel's launches count in
``banded_conv_sm_taps.launches``, the float32 one's in
``banded_conv_sm_taps.f32_launches``.

The widths above are brick side 4's. At side s the operands are those of
``bricks2d._assemble_sm`` (``bricks2d._sm_layout(s)``: s slices of s^2
cells, gyz runs of 4s+4 cells padded to 4s+8, x-planes of (s+2)^2 cells
padded by 4; at side 2: x 8, gyz 32, gxm/gxp 20 cells a row) and the
output has s^3*cout columns. The plain versions take any even side; the
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


def banded_conv_sm(x, gyz, gxm, gxp, wc, wh, wx, out_dtype) -> torch.Tensor:
    """x (B, 64cin), gyz (B, 96cin), gxm/gxp (B, 40cin) and the weights of
    ``bricks2d.sm_weights`` -> (B, 64*cout), unmasked (side 4's widths;
    ``_sm_layout``'s at side s): the plain version, on CPU tensors only."""
    tensors = (x, gyz, gxm, gxp, wc, wh, wx)
    if all(t.device.type == 'cpu' for t in tensors):
        return banded_conv_sm_plain(*tensors, out_dtype)
    raise ValueError('banded_conv_sm: no kernel for CUDA tensors (the '
                     'banded-weight kernel is deleted); run '
                     'banded_conv_sm_taps on the raster weights (bf16 or '
                     'float32 operands)')


# ---------------------------------------------------------------------------
# the kernel: raster weights, the taps only
# ---------------------------------------------------------------------------

def banded_conv_sm_taps_plain(x, gyz, gxm, gxp, w, out_dtype) -> torch.Tensor:
    """``banded_conv_sm_plain``'s arithmetic on ``sm_weights(w)``."""
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
    lib.doda_banded_conv_sm_taps_f32.argtypes = \
        lib.doda_banded_conv_sm_taps.argtypes
    lib.doda_banded_conv_sm_taps_f32.restype = ctypes.c_int
    for fn in (lib.doda_banded_conv_sm_taps_smem,
               lib.doda_banded_conv_sm_taps_f32_smem):
        fn.argtypes = [ctypes.c_int] * 2
        fn.restype = ctypes.c_int
    return lib


def sm_taps_smem_bytes(cin: int, side: int = 4,
                       dtype=torch.bfloat16) -> int:
    """Dynamic shared memory of one ``banded_conv_sm_taps`` launch on
    bricks of ``side`` with operands of ``dtype``."""
    lib = _taps_lib()
    fn = lib.doda_banded_conv_sm_taps_f32_smem if dtype == torch.float32 \
        else lib.doda_banded_conv_sm_taps_smem
    return fn(cin, side)


def _check_taps(x, gyz, gxm, gxp, w, out_dtype, side) -> None:
    tensors = (x, gyz, gxm, gxp, w)
    if any(t.device.type != 'cuda' or t.device != x.device for t in tensors):
        raise ValueError('banded_conv_sm_taps: operands on '
                         f'{[str(t.device) for t in tensors]}; all must be '
                         'on one CUDA device')
    if x.dtype not in _DTYPE_CODES or any(t.dtype != x.dtype
                                          for t in tensors):
        raise ValueError('banded_conv_sm_taps: operands '
                         f'{[str(t.dtype) for t in tensors]}; all must be '
                         'bfloat16 or all float32')
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
    """x (B, 64cin), gyz (B, 96cin), gxm/gxp (B, 40cin) and raster weights
    w (27, cin, cout), all bf16 or all float32 -> (B, 64*cout), unmasked
    (side 4's widths; ``_sm_layout``'s at side s)."""
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
    f32 = x.dtype == torch.float32
    lib = _taps_lib()
    fn = lib.doda_banded_conv_sm_taps_f32 if f32 \
        else lib.doda_banded_conv_sm_taps
    err = fn(x.data_ptr(), x.stride(0), gyz.data_ptr(), gyz.stride(0),
             gxm.data_ptr(), gxm.stride(0), gxp.data_ptr(), gxp.stride(0),
             w.data_ptr(), out.data_ptr(), b, w.shape[1], cout, side,
             _DTYPE_CODES[out_dtype],
             torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError('banded_conv_sm_taps: kernel launch failed with '
                           f'error {err} (CUDA runtime; 1000 + CUresult '
                           'where a tensor map was refused)')
    if f32:
        banded_conv_sm_taps.f32_launches += 1
    else:
        banded_conv_sm_taps.launches += 1
    return out


banded_conv_sm_taps.launches = 0
banded_conv_sm_taps.f32_launches = 0
