"""The point -> cell reduction over brickify's sorted stream.

Port of the JAX package's default reduction,
``doda_tpu/ops/bricks.py::_brick_feats_sorted`` (``DODA_FEATS`` unset), by
its semantics: ``brickify`` leaves the points in (brick, cell) order, so
the points of a cell form one run of the stream, and each run is summed
alone; no float scatter. That function reaches no Pallas kernel. Its way
of summing (expand each point to the 16*(C+1) lanes of its x-slice, a
float32 cumsum over the whole stream, differences at run ends) serves the
TPU's 128-lane tiles, and it loses precision as the stream grows: the
prefix sum of all-positive features reaches ~1e4 before two nearby values
are subtracted. Here the runs are summed directly.

``cell_reduce_sorted`` (``csrc/cell_mean.cu``) takes the stream
(``sort_cell``, ``sort_pos``) and returns the dense (rows, cells*C)
table, float32 or bf16: each run's points summed in stream order in
float32 by one thread (mode 3, the sum), divided by the run's length
(mode 4, the mean), rounded once to the output type; every cell that no
point reaches exactly zero. One launch writes every output element once:
a block builds whole rows (bricks) in shared memory, zeros included, and
stores them; there is no separate fill. It uses no atomics and no float
scan, so two calls on one input give the same bits; ``index_add_`` on the
card, the route of ``bricks.cell_feats_2d``, does not.

Mode 3 is also the transpose of the voxel -> point gather: summing each
cell's point cotangents over the same stream is ``index_select``'s
backward in a fixed order (``models/unet.py::gather_cells``, whose
backward calls this with the float32 cotangent and the cell table's type).
The reduction itself has no backward: it raises on features that require
a gradient (the point features need none; the cotangent has none).

``cell_reduce_sorted_plain`` is its plain version: a float64
``index_add_`` over the same ids, cast to the output type (sequential on
the CPU, so reproducible).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

MODES = (3, 4)              # 3 = sum, 4 = mean (ref voxelize.cu:10-31)
OUT_DTYPES = (torch.float32, torch.bfloat16)


def _check(feats, sort_cell, sort_pos, rows, cells, mode) -> None:
    if mode not in MODES:
        raise NotImplementedError(f'brick voxel mode {mode}')
    if feats.requires_grad:
        raise ValueError('cell_reduce_sorted has no backward: the point '
                         'features must not require a gradient')
    n = feats.shape[0]
    if feats.dim() != 2 or sort_cell.shape != sort_pos.shape \
            or sort_cell.dim() not in (1, 2) or sort_cell.numel() != n \
            or rows < 0 or cells < 1 \
            or (sort_cell.dim() == 2 and rows % max(sort_cell.shape[0], 1)):
        raise ValueError(f'cell_reduce_sorted: feats {tuple(feats.shape)}, '
                         f'sort_cell {tuple(sort_cell.shape)}, sort_pos '
                         f'{tuple(sort_pos.shape)}, rows {rows}, cells '
                         f'{cells}; need (N, C), a stream of N slots, (N,) '
                         'or (scenes, N/scenes) with rows a multiple of '
                         'scenes, rows >= 0 and cells >= 1')


def cell_reduce_sorted_plain(feats: torch.Tensor, sort_cell: torch.Tensor,
                             sort_pos: torch.Tensor, rows: int, cells: int,
                             mode: int = 4,
                             out_dtype: torch.dtype | None = None
                             ) -> torch.Tensor:
    """The plain version of ``cell_reduce_sorted``: sums and counts in
    float64 by ``index_add_`` over the stream's ids (null ids, those >=
    rows*cells, dropped), cast to ``out_dtype`` (the features' type by
    default)."""
    _check(feats, sort_cell, sort_pos, rows, cells, mode)
    n_seg = rows * cells
    c = feats.shape[1]
    ids = sort_cell.reshape(-1).long().clamp(max=n_seg)
    f64 = feats.to(torch.float64)[sort_pos.reshape(-1).long()]
    total = f64.new_zeros((n_seg + 1, c)).index_add_(0, ids, f64)[:n_seg]
    if mode == 4:
        count = f64.new_zeros(n_seg + 1).index_add_(
            0, ids, f64.new_ones(ids.shape[0]))[:n_seg]
        total = total / count.clamp(min=1.0)[:, None]
    return total.reshape(rows, cells * c).to(out_dtype or feats.dtype)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load('cell_mean')
    lib.doda_cell_reduce_sorted.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.doda_cell_reduce_sorted.restype = ctypes.c_int
    lib.doda_cell_reduce_max_c.argtypes = [ctypes.c_int]
    lib.doda_cell_reduce_max_c.restype = ctypes.c_int
    return lib


def cell_reduce_sorted(feats: torch.Tensor, sort_cell: torch.Tensor,
                       sort_pos: torch.Tensor, rows: int, cells: int,
                       mode: int = 4,
                       out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Point features into cells: feats (N, C), the sorted stream
    sort_cell (int32 flat cell ids in [0, rows*cells), any larger id for
    none) and sort_pos (int32, the feats row of each slot) -> (rows,
    cells*C) in ``out_dtype`` (float32 by default; bf16 rounds once at the
    store), mode 4 the mean over each cell, 3 the sum; cells no point
    reaches are exactly zero.

    The stream is (N,), one segment, or (scenes, N/scenes), one segment a
    scene: segment s holds the ids of rows [s*rows/scenes,
    (s+1)*rows/scenes) in ascending order (a cell's slots adjacent), then
    its null ids, as ``brickify`` leaves a scene's stream and
    ``unet.batch_stream`` viewed as (Batch, N) a batch's."""
    if all(t.device.type == 'cpu' for t in (feats, sort_cell, sort_pos)):
        return cell_reduce_sorted_plain(feats, sort_cell, sort_pos, rows,
                                        cells, mode, out_dtype)
    _check(feats, sort_cell, sort_pos, rows, cells, mode)
    dev = feats.device
    out_dtype = out_dtype or torch.float32
    if feats.dtype != torch.float32 or not feats.is_contiguous() \
            or out_dtype not in OUT_DTYPES \
            or any(t.device != dev or t.dtype != torch.int32
                   or not t.is_contiguous() for t in (sort_cell, sort_pos)):
        raise ValueError('cell_reduce_sorted: need contiguous float32 feats '
                         'and int32 sort_cell and sort_pos on one card, '
                         f'and a float32 or bf16 output, not {out_dtype}')
    n, c = feats.shape
    if c > _lib().doda_cell_reduce_max_c(cells):
        raise ValueError(f'cell_reduce_sorted: a row of {cells} cells x {c} '
                         'float32 channels exceeds one block\'s tile (at '
                         f'most {_lib().doda_cell_reduce_max_c(cells)} '
                         'channels)')
    scenes = sort_cell.shape[0] if sort_cell.dim() == 2 else 1
    out = torch.empty((rows, cells * c), dtype=out_dtype, device=dev)
    if out.numel() == 0:
        return out
    err = _lib().doda_cell_reduce_sorted(
        feats.data_ptr(), sort_cell.data_ptr(), sort_pos.data_ptr(),
        out.data_ptr(), n, c, rows, cells, scenes, mode,
        int(out_dtype == torch.bfloat16),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError('cell_reduce_sorted: kernel launch failed with '
                           f'CUDA error {err}')
    cell_reduce_sorted.launches += 1
    return out


cell_reduce_sorted.launches = 0
