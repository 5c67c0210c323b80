"""Bytes, operations and bounds of the subm convs of one bench forward.

    python -m doda_tpu_torch.tools.roofline [--device cuda|cpu] [--brick 4|2]
                                            [--dtype bfloat16|float32]

from the repo root; the counterpart of the JAX package's root
``tools/roofline.py``, which models that package's TPU engine. This one
models the port's routes at the card's peaks (``utils/roofline.py``: the
H100 SXM data sheet's). It builds the level plan of the bench batch (4
scenes of ``utils/synth.py::make_batch``, brick caps
``default_brick_caps(40960, 7)``) on the device and prints one JSON line
per level of the flagship (cfgs/scannet/spconv.yaml): its rows (scenes x
brick cap), occupied bricks, active cells and cell occupancy, its width
and subm convs (9, 8, 8, 8, 8, 8, 4 for the flagship), and, for the
kernel route each conv launches in bf16 (``bricks2d.subm_route``; with
``--dtype float32`` the float32 routes, 'f32' and 'sm', at 4-byte
operands and the CUDA cores' peak), the bytes moved, the operations the
level's rulebook needs and the bound; then
an idealized occupied-cell conv's floor (each active cell read once and
written once, every tap of every active cell). A last line holds the
totals of one forward's subm convs. Nothing here is measured: the card's
name and power limit stand beside the bounds because a card set below
700 W does not reach the peaks. ``--brick 2`` counts the same forward
in bricks of side 2 (under ``synth.BRICK_CAPS_SIDE2``, or the schedule of
``--brick-cap`` where given). ``--points``, ``--batch``, ``--brick-cap``
and ``--levels`` cut the size (for the CPU).
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..config import CfgNode, cfg_from_yaml_file
from ..models import model_fn
from ..models.unet import build_level_plan, flatten_plan
from ..ops.bricks import side_of
from ..ops.bricks2d import subm_route
from ..utils import roofline, synth
from ..utils.device import card_label, resolve_device
from .bench_conv import bench_caps


def level_convs(model) -> list:
    """Per level, the (cin, cout, route, dtype) of each subm conv of
    ``model``, from its parameter shapes, as ``SparseConvNet.subm_routes``
    counts them."""
    convs = [[] for _ in range(model.num_levels)]
    for name, p in model.named_parameters():
        if p.dim() == 3 and p.shape[0] == 27:
            _, cin, cout = p.shape
            convs[name.split('.').count('u')].append(
                (cin, cout, subm_route(cin, cout, model.dtype,
                                       model.sm_max_cin, model.brick),
                 model.dtype))
    return convs


def level_rows(levels, convs, scenes: int) -> list:
    """One dict per level of the flat plan ``levels`` (``flatten_plan``)
    with the subm convs ``convs`` (``level_convs``)."""
    out = []
    for lvl, (lv, level_conv) in enumerate(zip(levels, convs)):
        rows, per_brick = lv.occ.shape
        side = side_of(per_brick)
        cells = int(lv.occ.sum())
        reads = roofline.present_reads(lv.halo)
        work = {'bytes': 0, 'flops': 0, 'bound_ms': 0.0}
        ideal = dict(work)
        routes = {}
        for cin, cout, route, dtype in level_conv:
            if route in ('fused', 'f32'):
                w = roofline.fused_work(rows, cin, cout, reads, side, dtype)
            elif route == 'narrow':
                w = roofline.narrow_work(rows, cin, cout, reads, side)
            elif route == 'assembled':
                w = roofline.assembled_work(rows, cin, cout, side=side)
            else:
                w = roofline.sm_taps_work(rows, cin, cout, side, dtype, reads)
            routes[route] = routes.get(route, 0) + 1
            i = roofline.ideal_work(cells, cin, cout)
            for acc, got in ((work, w), (ideal, i)):
                for k in acc:
                    acc[k] += got[k]
        out.append({
            'level': lvl, 'brick': side, 'rows': rows, 'scenes': scenes,
            'bricks': int(lv.occ.any(1).sum()), 'active_cells': cells,
            'cell_occupancy': cells / (rows * per_brick),
            'channels': level_conv[-1][1], 'subm_convs': len(level_conv),
            'routes': routes, 'present_halo_reads': reads,
            'bytes': work['bytes'], 'flops': work['flops'],
            'bound_ms': work['bound_ms'], 'ideal_bytes': ideal['bytes'],
            'ideal_flops': ideal['flops'], 'ideal_ms': ideal['bound_ms']})
    return out


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--device', default='cuda', help="'cuda' or 'cpu'")
    ap.add_argument('--batch', type=int, default=synth.BATCH)
    ap.add_argument('--points', type=int, default=synth.N_REAL,
                    help='points a scene')
    ap.add_argument('--brick', type=int, choices=(2, 4), default=4,
                    help='brick side (default 4)')
    ap.add_argument('--brick-cap', type=int, default=None,
                    help='level-0 brick cap (default: the bench caps of '
                         'the side)')
    ap.add_argument('--levels', type=int, default=7)
    ap.add_argument('--dtype', choices=('bfloat16', 'float32'),
                    default='bfloat16',
                    help="the net's compute dtype (default bfloat16)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = cfg_from_yaml_file('cfgs/scannet/spconv.yaml', CfgNode())
    cfg.MODEL.BACKBONE.num_levels = args.levels
    model = model_fn.build_model(cfg, device='cpu', brick=args.brick,
                                 dtype=getattr(torch, args.dtype))
    b_caps = bench_caps(args.brick, args.brick_cap, args.levels)
    batch = synth.bench_batch(args.batch, args.points, b_caps,
                              brick=args.brick)
    with torch.no_grad():
        plan = build_level_plan(batch.coords, batch.valid, b_caps, dev,
                                brick=args.brick)
        levels, _ = flatten_plan(plan)
        table = level_rows(levels, level_convs(model), args.batch)
    card = card_label(dev)
    for row in table:
        print(json.dumps({'card': card, 'dtype': args.dtype, **row}),
              flush=True)
    total = {k: float(np.sum([r[k] for r in table])) for k in (
        'bytes', 'flops', 'bound_ms', 'ideal_bytes', 'ideal_flops',
        'ideal_ms')}
    total['subm_convs'] = sum(r['subm_convs'] for r in table)
    print(json.dumps({'card': card, 'level': 'all', **total,
                      'peaks': {'bf16_flops': roofline.PEAK_BF16,
                                'bytes_per_s': roofline.PEAK_BYTES,
                                'f32_flops': roofline.PEAK_F32}}),
          flush=True)
    return table + [total]


if __name__ == '__main__':
    main()
