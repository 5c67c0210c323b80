"""Where one bench-shaped flagship eval forward, or train step, spends its
device time.

    python -m doda_tpu_torch.tools.trace_fwd [--train] [--sm-max-cin N]
                                             [--fuse-norm] [--remat P]
                                             [--brick 4|2] [--trace PATH]
                                             [--dtype bfloat16|float32]

from the repo root. Builds the flagship (cfgs/scannet/spconv.yaml) with
seeded weights in bf16 (``--dtype float32``: in float32, the port's
checking precision, every subm conv on the float32 kernels; TF32 is off
either way), runs ``make_eval_step`` on 4 bench scenes (with
``--train``: ``make_train_step`` on 2 scenes, SGD as in the YAML;
``--sm-max-cin`` picks the subm-conv kernels, by default 0, K1 everywhere,
for the forward and 32, K2 at levels 0 and 1, for the train step;
``--fuse-norm`` turns on the fused norm + ReLU engine, whose block convs
run K1's prologue variant, a bucket of its own; ``--remat`` is the train
step's memory policy, ``build_model``'s ``remat``; ``--brick 2`` builds
the net and its plans in bricks of side 2 under ``synth.BRICK_CAPS_SIDE2``)
twice to warm up, times
three calls on the host clock, then profiles one with
``torch.profiler``. Prints one JSON line: the call's wall
time, the device's busy share of it, device time per bucket of kernels, and
the top kernels. ``--trace`` also writes a Chrome trace.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import time
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile

from ..config import CfgNode, cfg_from_yaml_file
from ..models import model_fn
from ..models.unet import default_brick_caps
from ..utils import optim, synth

# first match wins; kernel names as the CUDA runtime reports them
BUCKETS = (
    ('banded_conv_fused prologue (K1, fused norm)', r'fused_tc.*(true|Lb1E)'),
    ('banded_conv_fused (K1, fused)', r'fused_tc'),
    ('banded_conv_narrow (K1, input conv)', r'narrow_tc'),
    ('banded_conv_f32 (K1, float32)', r'subm_f32'),
    ('banded_conv_sm_taps (K2)', r'sm_taps_tc|sm_taps_f32'),
    ('cell_reduce_sorted (point -> cell)', r'cell_rows'),
    ('gemm (down/up/1x1/head)', r'gemm|cutlass|xmma|cublas|sm90_|nvjet'),
    ('sort / search', r'sort|radix|searchsorted|Scan|scan'),
    ('index / gather / scatter', r'index|gather|scatter|Indexing'),
    ('concat', r'[Cc]at'),
    ('elementwise / reduce', r'elementwise|vectorized|reduce|Reduce'),
)


def _device_us(evt) -> float:
    for attr in ('self_device_time_total', 'self_cuda_time_total'):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--train', action='store_true',
                    help='profile one train step instead of an eval forward')
    ap.add_argument('--sm-max-cin', type=int, default=None,
                    help='convs with cin up to this run on K2 '
                         '(default: 0, or 32 with --train)')
    ap.add_argument('--fuse-norm', action='store_true',
                    help='the fused norm + ReLU engine (fuse_norm=True)')
    ap.add_argument('--remat', default='off',
                    help="the train step's memory policy: off (default), "
                         'dots, all, mix or mixN')
    ap.add_argument('--brick', type=int, choices=(2, 4), default=4,
                    help='brick side (default 4)')
    ap.add_argument('--trace', help='write a Chrome trace to this path')
    ap.add_argument('--dtype', choices=('bfloat16', 'float32'),
                    default='bfloat16',
                    help="the net's compute dtype (default bfloat16)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('trace_fwd: needs a CUDA device')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    cfg = cfg_from_yaml_file('cfgs/scannet/spconv.yaml', CfgNode())
    b_caps = default_brick_caps(synth.BRICK_CAP, 7) if args.brick == 4 \
        else synth.BRICK_CAPS_SIDE2
    batch = synth.make_batch(
        seed=0, batch=synth.TRAIN_BATCH if args.train else synth.BATCH)
    synth.capacity_audit(batch, b_caps, args.brick)
    batch = batch.to('cuda')
    sm_max_cin = args.sm_max_cin if args.sm_max_cin is not None else (
        32 if args.train else 0)
    model = model_fn.build_model(cfg, sm_max_cin=sm_max_cin,
                                 train=args.train, fuse_norm=args.fuse_norm,
                                 remat=args.remat, brick=args.brick,
                                 dtype=getattr(torch, args.dtype))
    model.load_state_dict(synth.seeded_state_dict(model, seed=0))
    if args.train:
        opt = optim.build_optimizer(cfg.OPTIMIZATION, model.parameters())
        train_step = model_fn.make_train_step(cfg, model, opt, b_caps)

        def step(b):
            return train_step(b, cfg.OPTIMIZATION.base_lr)
    else:
        step = model_fn.make_eval_step(cfg, model, b_caps)
    for _ in range(2):
        step(batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        step(batch)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / 3 * 1e3

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(batch)
        torch.cuda.synchronize()
    if args.trace:
        prof.export_chrome_trace(args.trace)

    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    buckets = defaultdict(float)
    for e in kernels:
        name = next((b for b, pat in BUCKETS if re.search(pat, e.key)),
                    'other')
        buckets[name] += _device_us(e) / 1e3
    device_ms = sum(buckets.values())
    top = sorted(kernels, key=_device_us, reverse=True)[:12]
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({
        'card': smi, 'mode': 'train step' if args.train else 'eval forward',
        'sm_max_cin': sm_max_cin, 'fuse_norm': args.fuse_norm,
        'remat': args.remat, 'brick': args.brick, 'dtype': args.dtype,
        'scenes': int(batch.coords.shape[0]),
        'wall_ms': wall_ms,
        'profiled_device_ms': device_ms,
        'device_busy_share': device_ms / wall_ms if wall_ms else None,
        'buckets_ms': dict(sorted(buckets.items(), key=lambda kv: -kv[1])),
        'kernel_launches': int(sum(e.count for e in kernels)),
        'top_kernels': [{'name': e.key[:90], 'count': e.count,
                         'ms': _device_us(e) / 1e3} for e in top]}))


if __name__ == '__main__':
    main()
