"""Times one subm conv on each route at the bench shapes.

    python -m doda_tpu_torch.tools.bench_conv [--reps 20] [--levels 0-6]
                                              [--brick 4|2]
                                              [--dtype bfloat16|float32]
                                              [--device cuda|cpu]

from the repo root; the counterpart of the JAX package's root
``tools/bench_conv.py``. The level plan of the bench batch (4 scenes of
``utils/synth.py::make_batch``, brick caps ``default_brick_caps(40960,
7)``) is built on the device, and each (level, cin, cout) is timed over
that level's real rulebook, on seeded activations masked to its active
cells. By default: level 0 at the JAX tool's combos (16 -> 16, 32 -> 16,
32 -> 32); ``--levels a-b`` takes each level l of the range at its own
width (16·(l+1) -> 16·(l+1)). Where level 0 is taken, the input conv's
shape (3 -> 16) is timed too, in float32 and in bf16.

Routes, each where it applies (bf16 unless said):
  fused      K1's fused version, ``banded_conv_fused`` (cin, cout % 8 == 0)
  prologue   its prologue variant (``pro=``): seeded scale and bias (bias
             > 0 on half the channels), the level's occupancy words
  unfused    the sequence the prologue replaces: ``bricks2d.pro_full``
             (scale, bias, ReLU, mask), then the fused K1
  narrow     K1's narrow-input version, ``banded_conv_narrow`` (cin < 8)
  padded     the fused K1 on x2 and w zero-padded to cin = 8, the padding
             pass timed with it: a yardstick for ``narrow``, on no path
  assembled  K1's first version, ``banded_conv``, over ``_assemble_p6``'s
             planes and ``banded_weights`` (built once, not timed)
  assembled+gather  the same with ``_assemble_p6``'s plane gather timed
             (where ``narrow`` applies: the route it replaces)
  sm         K2's second version, ``banded_conv_sm_taps``, over
             ``_assemble_sm``'s operands (built once; cin % 16 == 0)
  plain      the plain version of the route the model takes at the shape
  conv3d     cuDNN ``F.conv3d`` over the shell-gather oracle's assembled
             halo (``bricks.shell_halo``, built once): one library call of
             the same function
With ``--dtype float32`` (the port's checking precision; TF32 off) the
routes are the float32 ones:
  f32        K1 in float32, ``banded_conv_f32`` (every cin and cout)
  sm         K2 in float32, ``banded_conv_sm_taps`` on float32 operands
             (cin % 16 == 0)
  route_k1, route_k2  the whole subm conv product as the model runs it,
             ``bricks2d._subm_raw`` at ``sm_max_cin`` 0 and 32, its
             assembly included (route_k2 where cin % 16 == 0)
  plain      ``banded_conv_fused_plain`` in float32
  conv3d     cuDNN ``F.conv3d`` in float32 over the oracle's halo
Each bound is ``utils/roofline.py``'s at float32 (operations on the CUDA
cores). Every kernel's operations, K2's included, are the taps that the
level's present halo cells need.
Each route runs once to warm up, then ``reps`` times back to back between
two CUDA events (the JAX tool's unrolled chain: eager PyTorch elides no
application, so no data dependency is needed). Prints one JSON line a
reading: ms an application, the bound of ``utils/roofline.py`` beside it
(none for the library call), and the card's name and power limit.
``--brick 2`` builds the plan in bricks of side 2, under
``synth.BRICK_CAPS_SIDE2``; every route is timed there too. ``--points``,
``--batch`` and ``--brick-cap`` cut the size for the CPU (``--device
cpu``), where the times are the host's.
"""

from __future__ import annotations

import argparse
import json
import time

import torch
import torch.nn.functional as F

from ..models.unet import build_level_plan, default_brick_caps, flatten_plan
from ..ops import bricks, bricks2d
from ..ops.banded_conv import (banded_conv, banded_conv_f32,
                               banded_conv_fused, banded_conv_fused_plain,
                               banded_conv_narrow, banded_conv_plain,
                               occ_words)
from ..ops.banded_conv_sm import banded_conv_sm_taps
from ..utils import roofline, synth
from ..utils.device import card_label, resolve_device

LEVEL0_COMBOS = ((16, 16), (32, 16), (32, 32))
INPUT_CONV = (3, 16)


def timed_ms(fn, reps: int, dev: torch.device) -> float:
    """ms of one call of ``fn``: one warm-up call, then ``reps`` calls
    between two CUDA events (the host clock on the CPU)."""
    fn()
    if dev.type != 'cuda':
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize(dev)
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize(dev)
    return e0.elapsed_time(e1) / reps


def bench_caps(brick: int, cap0, num_levels: int) -> tuple:
    """The brick caps of ``num_levels`` levels at side ``brick``: the
    schedule of ``cap0`` where given, else the bench caps of the side
    (``default_brick_caps(synth.BRICK_CAP)`` at 4,
    ``synth.BRICK_CAPS_SIDE2`` at 2)."""
    if cap0 is not None:
        return default_brick_caps(cap0, num_levels)
    if brick == 2:
        return synth.BRICK_CAPS_SIDE2[:num_levels]
    return default_brick_caps(synth.BRICK_CAP, num_levels)


def combos(levels: str) -> list:
    """(level, cin, cout) to time: the JAX tool's level-0 combos, or each
    level of the range ``a-b`` at its width."""
    if levels == '0':
        return [(0, cin, cout) for cin, cout in LEVEL0_COMBOS]
    lo, _, hi = levels.partition('-')
    return [(lvl, 16 * (lvl + 1), 16 * (lvl + 1))
            for lvl in range(int(lo), int(hi or lo) + 1)]


def _conv3d(x2, lv, w, cin, cout, dtype, reps):
    """cuDNN ``F.conv3d`` over the shell-gather oracle's halo, one
    reading."""
    dev = lv.occ.device
    rows, cells = lv.occ.shape
    halo = bricks.shell_halo(x2.reshape(rows, cells, cin), lv.nbr, dtype)
    hin = halo.permute(0, 4, 1, 2, 3)
    wc = w.reshape(3, 3, 3, cin, cout).permute(4, 3, 0, 1, 2).contiguous(
        memory_format=torch.channels_last_3d)
    return {'route': 'conv3d',
            'ms': timed_ms(lambda: F.conv3d(hin, wc), reps, dev),
            'bound_ms': None, 'bound_by': None,
            'call': "F.conv3d over the shell-gather oracle's halo"}


def f32_readings(lv, cin: int, cout: int, reps: int, gen) -> list:
    """The float32 routes at (cin -> cout) over the flat level ``lv``."""
    f32 = torch.float32
    dev = lv.occ.device
    rows, cells = lv.occ.shape
    side = bricks.side_of(cells)
    x3 = torch.randn(rows, cells, cin, device=dev, generator=gen)
    x2 = torch.where(lv.occ[..., None], x3, 0).reshape(rows, -1)
    w = torch.randn(27, cin, cout, device=dev, generator=gen) \
        / (27 * cin) ** 0.5
    reads = roofline.present_reads(lv.halo)
    k1_work = roofline.fused_work(rows, cin, cout, reads, side, f32)
    k2_work = roofline.sm_taps_work(rows, cin, cout, side, f32, reads)
    k2_ok = cin % 16 == 0 and cout % 8 == 0
    sm = bricks2d.sm_index(lv.nbr, side) if k2_ok else None
    out = []

    def add(name, fn, work):
        out.append({'route': name, 'ms': timed_ms(fn, reps, dev),
                    **{k: work[k] for k in ('bound_ms', 'bound_by', 'bytes',
                                            'flops')}})

    add('f32', lambda: banded_conv_f32(x2, lv.nbr, w, f32), k1_work)
    add('route_k1', lambda: bricks2d._subm_raw(
        x2, lv.halo, sm, w, f32, 0, lv.nbr), k1_work)
    if k2_ok:
        ops = bricks2d._assemble_sm(x2, sm, f32, side)
        add('sm', lambda: banded_conv_sm_taps(*ops, w, f32), k2_work)
        add('route_k2', lambda: bricks2d._subm_raw(
            x2, lv.halo, sm, w, f32, 32, lv.nbr), k2_work)
        del ops
    add('plain', lambda: banded_conv_fused_plain(x2, lv.nbr, w, f32),
        k1_work)
    out.append(_conv3d(x2, lv, w, cin, cout, f32, reps))
    return out


def readings(lv, cin: int, cout: int, dtype, reps: int, gen) -> list:
    """One dict a route at (cin -> cout) over the flat level ``lv``."""
    if dtype == torch.float32:
        return f32_readings(lv, cin, cout, reps, gen)
    dev = lv.occ.device
    rows, cells = lv.occ.shape
    side = bricks.side_of(cells)
    x3 = torch.randn(rows, cells, cin, device=dev, generator=gen)
    x2 = torch.where(lv.occ[..., None], x3, 0).reshape(rows, -1).to(dtype)
    w = (torch.randn(27, cin, cout, device=dev, generator=gen)
         / (27 * cin) ** 0.5).to(dtype)
    route = bricks2d.subm_route(cin, cout, dtype, 0, side)
    reads = roofline.present_reads(lv.halo)
    out = []

    def add(name, fn, work):
        out.append({'route': name, 'ms': timed_ms(fn, reps, dev),
                    **{k: work[k] for k in ('bound_ms', 'bound_by', 'bytes',
                                            'flops')}})

    if route == 'fused':
        fused = roofline.fused_work(rows, cin, cout, reads, side)
        add('fused', lambda: banded_conv_fused(x2, lv.nbr, w, dtype), fused)
        add('plain', lambda: banded_conv_fused_plain(x2, lv.nbr, w, dtype),
            fused)
        scale = 1 + 0.2 * torch.randn(cin, device=dev, generator=gen)
        bias = 0.2 * torch.randn(cin, device=dev, generator=gen)
        bias[::2] = bias[::2].abs() + 0.1
        pro = (scale, bias, occ_words(lv.occ))
        work = roofline.prologue_work(rows, cin, cout, reads, side)
        add('prologue', lambda: banded_conv_fused(x2, lv.nbr, w, dtype, pro),
            work)
        add('unfused', lambda: banded_conv_fused(bricks2d.pro_full(
            x2, (scale, bias, lv.occ), cin, dtype), lv.nbr, w, dtype), work)
    if route == 'narrow':
        narrow = roofline.narrow_work(rows, cin, cout, reads, side)
        add('narrow', lambda: banded_conv_narrow(x2, lv.nbr, w, dtype),
            narrow)
        add('plain', lambda: banded_conv_fused_plain(x2, lv.nbr, w, dtype),
            narrow)
        w8 = F.pad(w, (0, 0, 0, 8 - cin)).contiguous()

        def padded():
            x8 = F.pad(x2.reshape(rows, cells, cin), (0, 8 - cin))
            return banded_conv_fused(x8.reshape(rows, -1), lv.nbr, w8, dtype)
        add('padded', padded, narrow)
    rows6 = bricks2d._assemble_p6(x2, lv.halo, dtype)
    wb = bricks2d.banded_weights(w, side)
    assembled = roofline.assembled_work(rows, cin, cout, dtype, side=side)
    add('assembled', lambda: banded_conv(rows6, wb, dtype), assembled)
    if route == 'narrow':
        add('assembled+gather', lambda: banded_conv(
            bricks2d._assemble_p6(x2, lv.halo, dtype), wb, dtype), assembled)
    if route == 'assembled':
        add('plain', lambda: banded_conv_plain(rows6, wb, dtype), assembled)
    del rows6, wb
    if dtype == torch.bfloat16 and cin % 16 == 0 and cout % 8 == 0:
        ops = bricks2d._assemble_sm(x2, bricks2d.sm_index(lv.nbr, side),
                                    dtype, side)
        add('sm', lambda: banded_conv_sm_taps(*ops, w, dtype),
            roofline.sm_taps_work(rows, cin, cout, side, reads=reads))
        del ops
    out.append(_conv3d(x2, lv, w, cin, cout, dtype, reps))
    return out


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--reps', type=int, default=20)
    ap.add_argument('--levels', default='0',
                    help="'0': level 0 at 16/32 -> 16/32 (default); 'a-b': "
                         'each level of the range at its width')
    ap.add_argument('--device', default='cuda', help="'cuda' or 'cpu'")
    ap.add_argument('--batch', type=int, default=synth.BATCH)
    ap.add_argument('--points', type=int, default=synth.N_REAL,
                    help='points a scene')
    ap.add_argument('--brick', type=int, choices=(2, 4), default=4,
                    help='brick side (default 4)')
    ap.add_argument('--brick-cap', type=int, default=None,
                    help='level-0 brick cap (default: the bench caps of '
                         'the side)')
    ap.add_argument('--dtype', choices=('bfloat16', 'float32'),
                    default='bfloat16',
                    help='the routes of this dtype (default bfloat16)')
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == 'cuda':
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    todo = combos(args.levels)
    num_levels = max(lvl for lvl, _, _ in todo) + 1
    b_caps = bench_caps(args.brick, args.brick_cap, num_levels)
    batch = synth.bench_batch(args.batch, args.points, b_caps,
                              brick=args.brick)
    with torch.no_grad():
        plan = build_level_plan(batch.coords, batch.valid, b_caps, dev,
                                brick=args.brick)
        levels, _ = flatten_plan(plan)
    dtype = getattr(torch, args.dtype)
    if todo[0][0] == 0:
        todo += [(0, *INPUT_CONV, torch.float32)] + (
            [(0, *INPUT_CONV)] if dtype == torch.bfloat16 else [])
    card = card_label(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    results = []
    with torch.no_grad():
        for lvl, cin, cout, *dt in todo:
            dt = dt[0] if dt else dtype
            for r in readings(levels[lvl], cin, cout, dt, args.reps, gen):
                r = {'card': card, 'brick': args.brick, 'level': lvl, 'rows':
                     levels[lvl].occ.shape[0], 'cin': cin, 'cout': cout,
                     'dtype': str(dt).replace('torch.', ''),
                     'reps': args.reps, 'clock': 'cuda events'
                     if dev.type == 'cuda' else 'host', **r}
                print(json.dumps(r), flush=True)
                results.append(r)
            if dev.type == 'cuda':
                torch.cuda.empty_cache()
    return results


if __name__ == '__main__':
    main()
