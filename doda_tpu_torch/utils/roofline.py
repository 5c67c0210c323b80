"""The card's peak rates and the least time a kernel's work could take.

One model of bytes and operations for ``chip_smoke.py`` and the probes
(``tools/roofline.py``, ``tools/bench_conv.py``), so that their bounds
cannot drift apart. The peaks are the NVIDIA H100 SXM data sheet's (dense
rates, no sparsity, at its full 700 W power limit); a card set below that
limit runs slower under load, so a bound is stated with the card's power
limit beside it.

A bound is the larger of two times: the bytes the function must move
(each input read once, each output written once) over the memory rate,
and the operations it does on these inputs over the peak rate of their
type. Where the work depends on the data (a halo cell of an absent
neighbour brick is read by no tap), the count is what the given rulebook
needs.

The K1 and K2 models take the brick side (``side``, 4 by default): at
side s a brick has s^3 cells and an (s+2)^3 halo. The side-2 bound is the
same function's work counted at that side.
"""

from __future__ import annotations

import torch

PEAK_BF16 = 989e12         # H100 SXM dense bf16 FLOP/s (data sheet)
PEAK_BYTES = 3.35e12       # H100 SXM HBM3 bytes/s (data sheet)
PEAK_F32 = 67e12           # H100 SXM float32 FLOP/s off the tensor cores

CELLS, TAPS, HALO = 64, 27, 216     # side 4's cells, taps and halo cells


def bound(moved: float, ops: float, peak: float = PEAK_BF16) -> dict:
    """The least time for the work, ms: ``moved`` bytes over the memory
    rate or ``ops`` operations over ``peak``, whichever is larger."""
    t_bytes, t_ops = moved / PEAK_BYTES * 1e3, ops / peak * 1e3
    return {'bound_ms': max(t_bytes, t_ops),
            'bound_by': 'bytes' if t_bytes >= t_ops else 'operations'}


def cell_mean_work(n_pts: int, n_valid: int, c: int, n_cells: int,
                   n_runs: int, mode: int = 4, out_bytes: int = 4) -> dict:
    """The sorted point -> cell reduction (``ops/cell_mean.py``): the
    stream's ids (every slot) and rows (the valid points'), the valid
    points' float32 features and the dense (n_cells, c) output of
    ``out_bytes`` an element (4 float32, 2 bf16) moved once; a float32 add
    a valid point and channel and, in mode 4 (the mean), a division a run
    and channel."""
    moved = 4 * (n_pts + n_valid + n_valid * c) + out_bytes * n_cells * c
    ops = n_valid * c + (n_runs * c if mode == 4 else 0)
    return {'bytes': moved, 'flops': ops, **bound(moved, ops, PEAK_F32)}


def halo_reads(device=None, side: int = 4) -> torch.Tensor:
    """((s+2)^3,) float32: how many (output cell, tap) pairs of a brick of
    side s read each of its halo cells (6 x 6 x 6 at side 4), in
    ``bricks2d.halo_index`` order."""
    per_axis = torch.tensor([float(sum(0 <= h - d < side for d in range(3)))
                             for h in range(side + 2)], device=device)
    return (per_axis[:, None, None] * per_axis[None, :, None]
            * per_axis[None, None, :]).reshape(-1)


def present_reads(halo: torch.Tensor) -> float:
    """The (output cell, tap) reads of present halo cells over a level's
    ``halo_index`` table (rows, (s+2)^3; 216 at side 4): a cell of an
    absent neighbour brick points at the zero row rows*s^3 and needs no
    operation."""
    from ..ops.bricks2d import halo_side_of
    rows, side = halo.shape[0], halo_side_of(halo.shape[1])
    present = (halo < rows * side ** 3).float()
    return (present @ halo_reads(halo.device, side)).sum().item()


def _size_peak(dtype) -> tuple:
    """Bytes an element and the peak FLOP/s of a conv in ``dtype``: bf16
    on the tensor cores, float32 as FMAs on the CUDA cores."""
    if dtype == torch.float32:
        return 4, PEAK_F32
    return 2, PEAK_BF16


def fused_work(rows: int, cin: int, cout: int, reads: float,
               side: int = 4, dtype=torch.bfloat16) -> dict:
    """K1 from the activation and the rulebook over ``rows`` bricks of side
    s whose rulebook needs ``reads`` present halo reads
    (``present_reads``): it reads x2 (rows, s^3*cin), the raster weights
    and the rulebook (int32) once and writes the output once; its
    operations are the taps those reads need. bf16 (the fused version) on
    the tensor cores; float32 (``banded_conv_f32``) 4-byte operands and
    outputs, its FMAs on the CUDA cores. ``executed_flops`` are every tap
    of every row."""
    cells = side ** 3
    size, peak = _size_peak(dtype)
    moved = (rows * cells * (cin + cout) + TAPS * cin * cout) * size \
        + rows * TAPS * 4
    needed = 2 * cin * cout * reads
    return {'bytes': moved, 'flops': needed,
            'executed_flops': 2 * rows * cells * TAPS * cin * cout,
            **bound(moved, needed, peak)}


def narrow_work(rows: int, cin: int, cout: int, reads: float,
                side: int = 4) -> dict:
    """K1's narrow-input version (1 <= cin <= 7), bf16: the fused
    version's bytes and operations at that cin (x2, the raster weights and
    the rulebook read once, the output written once; the taps the present
    reads need). ``executed_flops`` are every row's products over its
    padded K: 27 taps of cin rounded up to even channels, in k16 steps."""
    work = fused_work(rows, cin, cout, reads, side)
    k = -(-TAPS * (cin + cin % 2) // 16) * 16
    work['executed_flops'] = 2 * rows * side ** 3 * k * cout
    return work


def prologue_work(rows: int, cin: int, cout: int, reads: float,
                  side: int = 4) -> dict:
    """K1's prologue variant: the fused version's bytes plus the occupancy
    words (int64) and the bf16 scale and bias; its taps on the tensor
    cores or 3 float32 operations (multiply, add, max) an input element on
    the CUDA cores, whichever takes longer (the two units run at once)."""
    fused = fused_work(rows, cin, cout, reads, side)
    moved = fused['bytes'] + rows * 8 + 2 * cin * 2
    t_bytes = moved / PEAK_BYTES * 1e3
    t_ops = max(fused['flops'] / PEAK_BF16,
                3 * rows * side ** 3 * cin / PEAK_F32) * 1e3
    return {'bytes': moved, 'flops': fused['flops'],
            'bound_ms': max(t_bytes, t_ops),
            'bound_by': 'bytes' if t_bytes >= t_ops else 'operations'}


def padded_work(rows: int, cin: int, cout: int, reads: float,
                side: int = 4) -> dict:
    """The route 'padded' (``banded_conv_padded``), bf16: its function's
    bytes and operations are the fused version's at the true widths (x2,
    the raster weights and the rulebook read once, the output written
    once; the taps the present reads need), and those bound it. Beside
    them (``padded_*``) the work of the kernel it launches at
    ``padded_widths``: the fused version's, or the narrow one's for cin <=
    7, whose zero channels it reads, multiplies and writes."""
    from ..ops.banded_conv import NARROW_MAX_CIN, padded_widths
    cin_p, cout_p = padded_widths(cin, cout)
    kernel = narrow_work if cin_p <= NARROW_MAX_CIN else fused_work
    work = fused_work(rows, cin, cout, reads, side)
    launched = kernel(rows, cin_p, cout_p, reads, side)
    work.update(padded_cin=cin_p, padded_cout=cout_p,
                **{f'padded_{k}': launched[k] for k in (
                    'bytes', 'flops', 'bound_ms', 'bound_by')})
    return work


def sm_taps_work(rows: int, cin: int, cout: int, side: int = 4,
                 dtype=torch.bfloat16, reads: float | None = None) -> dict:
    """K2 (``banded_conv_sm_taps``) on bricks of side s: the (s+2)^3 halo
    cells a brick needs (216 at side 4: x 64, gyz 80, gxm and gxp 36 each;
    64 at side 2; the operand layout's padding cells take part in no tap),
    the s^3 output cells and the raster weights, once. Its operations are
    the taps that ``reads`` present halo reads need (``present_reads`` of
    the rulebook the operands were assembled from: a cell of an absent
    neighbour is a zero), or every tap of every row where every cell is
    present (``reads`` None). ``executed_flops`` are every tap of every
    row. bf16 on the tensor cores; float32 4-byte operands and outputs,
    its FMAs on the CUDA cores."""
    cells = side ** 3
    size, peak = _size_peak(dtype)
    moved = (rows * (side + 2) ** 3 * cin + rows * cells * cout
             + TAPS * cin * cout) * size
    executed = 2 * rows * cells * TAPS * cin * cout
    flops = executed if reads is None else 2 * cin * cout * reads
    return {'bytes': moved, 'flops': flops, 'executed_flops': executed,
            **bound(moved, flops, peak)}


def ideal_work(cells: int, cin: int, cout: int) -> dict:
    """An idealized occupied-cell conv (spconv-like): each active cell's
    input read once and output written once, bf16, and every tap of every
    active cell on the tensor cores; a floor for any engine of that
    family on this card."""
    moved = cells * (cin + cout) * 2
    flops = 2 * TAPS * cells * cin * cout
    return {'bytes': moved, 'flops': flops, **bound(moved, flops)}
