"""Kernel K1: the banded 3-tap submanifold conv over six halo planes.

Port of ``doda_tpu/ops/pallas_banded.py::banded_conv``. For rows6
(B, 6, 36*cin) — the six halo planes x = -1, 0..3, +4 of each brick — and
banded weights wb (3, 36*cin, 16*cout) it computes

    out[:, x*16*cout:(x+1)*16*cout] = sum_{j<3} rows6[:, x + j] @ wb[j]

for x = 0..3, unmasked, accumulating in float32. On CUDA tensors this is
the hand-written kernel of ``csrc/banded_conv.cu``; on CPU tensors it is
``banded_conv_plain``. There is no other path.

``banded_conv_fused`` is the kernel's second version
(``csrc/banded_conv_fused.cu``): the same conv from the activation x2
(rows, 64*cin), the rulebook nbr (rows, 27) and the raster weights
w (27, cin, cout). It assembles each brick's halo in shared memory and
multiplies only the taps, so neither the planes nor the banded weights are
built. Its plain version is the first route on plain PyTorch:
``banded_conv_plain(_assemble_p6(x2, halo_index(nbr)), banded_weights(w))``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def banded_conv_plain(rows6: torch.Tensor, wb: torch.Tensor,
                      out_dtype) -> torch.Tensor:
    """The same function as 12 float32 matmuls, cast once to out_dtype."""
    r, w = rows6.float(), wb.float()
    outs = [r[:, x] @ w[0] + r[:, x + 1] @ w[1] + r[:, x + 2] @ w[2]
            for x in range(4)]
    return torch.cat(outs, dim=1).to(out_dtype)


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.load('banded_conv').doda_banded_conv
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(rows6: torch.Tensor, wb: torch.Tensor, out_dtype) -> None:
    if rows6.device.type != 'cuda' or wb.device != rows6.device:
        raise ValueError(f'banded_conv: rows6 on {rows6.device} and wb on '
                         f'{wb.device}; both must be on one CUDA device')
    if rows6.dtype not in _DTYPE_CODES or wb.dtype != rows6.dtype:
        raise ValueError(f'banded_conv: operands {rows6.dtype}/{wb.dtype}; '
                         'both must be float32 or bfloat16')
    if out_dtype not in _DTYPE_CODES:
        raise ValueError(f'banded_conv: out_dtype {out_dtype} unsupported')
    if rows6.dim() != 3 or rows6.shape[1] != 6 or wb.dim() != 3 \
            or wb.shape[0] != 3 or wb.shape[1] != rows6.shape[2] \
            or wb.shape[2] % 8:
        raise ValueError(f'banded_conv: shapes {tuple(rows6.shape)} and '
                         f'{tuple(wb.shape)}; need (B, 6, K) and (3, K, N) '
                         'with N a multiple of 8')
    if not (rows6.is_contiguous() and wb.is_contiguous()):
        raise ValueError('banded_conv: operands must be contiguous')
    if wb.data_ptr() % 16:
        raise ValueError('banded_conv: wb must be 16-byte aligned')


def banded_conv(rows6: torch.Tensor, wb: torch.Tensor,
                out_dtype) -> torch.Tensor:
    """rows6 (B, 6, 36*cin), wb (3, 36*cin, 16*cout) -> (B, 64*cout)."""
    if rows6.device.type == 'cpu' and wb.device.type == 'cpu':
        return banded_conv_plain(rows6, wb, out_dtype)
    _check(rows6, wb, out_dtype)
    b, _, k = rows6.shape
    n = wb.shape[2]
    out = torch.empty((b, 4 * n), dtype=out_dtype, device=rows6.device)
    err = _entry()(rows6.data_ptr(), wb.data_ptr(), out.data_ptr(), b, k, n,
                   _DTYPE_CODES[rows6.dtype], _DTYPE_CODES[out_dtype],
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

def banded_conv_fused_plain(x2: torch.Tensor, nbr: torch.Tensor,
                            w: torch.Tensor, out_dtype) -> torch.Tensor:
    """The assembled route on plain PyTorch: halo planes by one gather,
    banded weights, 12 float32 matmuls."""
    from . import bricks2d
    rows6 = bricks2d._assemble_p6(x2, bricks2d.halo_index(nbr), w.dtype)
    return banded_conv_plain(rows6, bricks2d.banded_weights(w), out_dtype)


@functools.lru_cache(maxsize=None)
def _fused_lib():
    lib = _build.load('banded_conv_fused')
    lib.doda_banded_conv_fused.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]
    lib.doda_banded_conv_fused.restype = ctypes.c_int
    lib.doda_banded_conv_fused_smem.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.doda_banded_conv_fused_smem.restype = ctypes.c_int
    return lib


def fused_smem_bytes(cin: int, cout: int) -> int:
    """Dynamic shared memory of one fused launch at (cin, cout)."""
    return _fused_lib().doda_banded_conv_fused_smem(cin, cout)


def _check_fused(x2, nbr, w, out_dtype) -> None:
    if x2.device.type != 'cuda' or nbr.device != x2.device \
            or w.device != x2.device:
        raise ValueError(f'banded_conv_fused: x2 on {x2.device}, nbr on '
                         f'{nbr.device}, w on {w.device}; all must be on '
                         'one CUDA device')
    if x2.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise ValueError(f'banded_conv_fused: operands {x2.dtype}/{w.dtype};'
                         ' both must be bfloat16')
    if out_dtype not in _DTYPE_CODES:
        raise ValueError(f'banded_conv_fused: out_dtype {out_dtype} '
                         'unsupported')
    if nbr.dtype != torch.int32 or nbr.dim() != 2 or nbr.shape[1] != 27 \
            or x2.dim() != 2 or nbr.shape[0] != x2.shape[0]:
        raise ValueError(f'banded_conv_fused: nbr {nbr.dtype} '
                         f'{tuple(nbr.shape)} for x2 {tuple(x2.shape)}; need '
                         'int32 (rows, 27)')
    if w.dim() != 3 or w.shape[0] != 27 or w.shape[1] % 8 or w.shape[2] % 8 \
            or x2.shape[1] != 64 * w.shape[1]:
        raise ValueError(f'banded_conv_fused: x2 {tuple(x2.shape)} and w '
                         f'{tuple(w.shape)}; need (rows, 64*cin) and '
                         '(27, cin, cout) with cin and cout multiples of 8')
    if not (x2.is_contiguous() and nbr.is_contiguous()
            and w.is_contiguous()):
        raise ValueError('banded_conv_fused: operands must be contiguous')
    if x2.data_ptr() % 16 or w.data_ptr() % 16 or nbr.data_ptr() % 4:
        raise ValueError('banded_conv_fused: x2 and w must be 16-byte '
                         'aligned')


def banded_conv_fused(x2: torch.Tensor, nbr: torch.Tensor, w: torch.Tensor,
                      out_dtype) -> torch.Tensor:
    """x2 (rows, 64*cin), nbr (rows, 27) int32 with null id == rows,
    w (27, cin, cout) -> (rows, 64*cout), unmasked."""
    if all(t.device.type == 'cpu' for t in (x2, nbr, w)):
        return banded_conv_fused_plain(x2, nbr, w, out_dtype)
    _check_fused(x2, nbr, w, out_dtype)
    rows, cin, cout = x2.shape[0], w.shape[1], w.shape[2]
    out = torch.empty((rows, 64 * cout), dtype=out_dtype, device=x2.device)
    if rows == 0:
        return out
    err = _fused_lib().doda_banded_conv_fused(
        x2.data_ptr(), nbr.data_ptr(), w.data_ptr(), out.data_ptr(), rows,
        cin, cout, _DTYPE_CODES[out_dtype],
        torch.cuda.current_stream(x2.device).cuda_stream)
    if err != 0:
        raise RuntimeError('banded_conv_fused: kernel launch failed with '
                           f'CUDA error {err}')
    banded_conv_fused.launches += 1
    return out


banded_conv_fused.launches = 0
