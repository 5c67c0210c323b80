#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on an NVIDIA GPU.

    python3 chip_smoke.py        # from the repo root, one card

Phases, each printing one line:
  1. device: the card's name, nvidia-smi's name and power limit; TF32 off
  2. build: every CUDA source of doda_tpu_torch/csrc, compiled with nvcc
  3. plan: the bench batch's level plan on the card equals the CPU's
     kernels: each kernel's wrapper on the card vs its plain version, at
     the main path's widths, and one full subm conv on a real plan
  4. forward: the flagship net (cfgs/scannet/spconv.yaml: mid 16, 7
     levels, 2 blocks per level, 20 classes) with seeded random weights
     serves bench-shaped batches (4 scenes, ~150k points each) through
     ``make_eval_step``: launch counts, scenes/sec, peak memory, float32
     logits kernel vs plain path, bf16 predictions kernel vs plain path
  5. timing: each kernel at the level-0 shape beside its bound, its plain
     version and one PyTorch library call computing the same function
Then a JSON line of the kernels and, last, {"ok": true, "device": ...}.
Any failure raises, and the script exits non-zero without that last line.
"""

import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from unittest.mock import patch

import torch

SUBM_CONVS = 53            # subm convs per flagship forward
PEAK_BF16 = 989e12         # H100 SXM dense bf16 FLOP/s (data sheet)
PEAK_BYTES = 3.35e12       # H100 SXM HBM3 bytes/s (data sheet)


def log(phase, **kv):
    print(f'{phase}: {json.dumps(kv)}', flush=True)


def cuda_ms(fn, reps):
    """Mean device time of ``fn`` over ``reps`` calls after a warm-up."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def phase_device():
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log('device', name=name, count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda)
    print(smi, flush=True)
    return name, smi


def phase_build():
    from doda_tpu_torch.ops import _build
    names = sorted(p.stem for p in _build.CSRC.glob('*.cu'))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as ex:     # one nvcc per source
        list(ex.map(_build.build, names))
    log('build', sources=names, seconds=round(time.perf_counter() - t0, 3))


def phase_plan(batch, b_caps):
    """The bench batch's level plan built on the card equals the one built
    on the CPU, table for table; returns the card's flat level 0."""
    from doda_tpu_torch.models.unet import build_level_plan, flatten_plan
    t0 = time.perf_counter()
    plan = build_level_plan(batch.coords, batch.valid, b_caps)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    ref = build_level_plan(batch.coords, batch.valid, b_caps, device='cpu')
    (levels, downs), (ref_levels, ref_downs) = (flatten_plan(plan),
                                                flatten_plan(ref))
    for got, want in zip(levels + downs, ref_levels + ref_downs):
        for name, a, b in zip(got._fields, got, want):
            assert torch.equal(a.cpu(), b), f'plan table {name} differs'
    bricks = [int(plan.grid0.table.n.sum())] + [
        int(d.parent.n.sum()) for d in plan.downs]
    log('plan', equal_to_cpu=True, first_build_seconds=seconds,
        occupied_bricks_per_level=bricks)
    return levels[0]


def phase_kernels(level0):
    from doda_tpu_torch.ops import bricks2d
    from doda_tpu_torch.ops.banded_conv import banded_conv, banded_conv_plain
    g = torch.Generator(device='cuda').manual_seed(1)
    worst = {}
    for b, cin, cout in ((1000, 3, 16), (4096, 16, 16), (4099, 32, 16),
                         (2048, 112, 112), (512, 192, 96)):
        rows6 = torch.randn(b, 6, 36 * cin, device='cuda', generator=g)
        w = torch.randn(27, cin, cout, device='cuda', generator=g)
        wb = bricks2d.banded_weights(w / (27 * cin) ** 0.5)
        for dt, rel, bound in ((torch.float32, False, 1e-3),
                               (torch.bfloat16, True, 2e-2)):
            got = banded_conv(rows6.to(dt), wb.to(dt), dt)
            torch.cuda.synchronize()
            ref = banded_conv_plain(rows6.to(dt), wb.to(dt), dt).float()
            err = (got.float() - ref).abs().max().item()
            lim = bound * (ref.abs().max().item() if rel else 1.0)
            assert err <= lim, f'banded_conv {b},{cin},{cout} {dt}: {err}'
            worst[f'{b}x{cin}x{cout}/{str(dt)[6:]}'] = err

    # one full subm conv on the real level-0 plan of the bench batch
    rows, cin = level0.occ.shape[0], 16
    x2 = torch.randn(rows, 64, cin, device='cuda', generator=g)
    x2 = (x2 * level0.occ[..., None]).reshape(rows, -1)
    w = torch.randn(27, cin, 16, device='cuda', generator=g) / 20.8
    for dt, rel, bound in ((torch.float32, False, 1e-3),
                           (torch.bfloat16, True, 2e-2)):
        got = bricks2d.subm_conv3_2d(x2.to(dt), level0.occ, level0.halo, w,
                                     dt).float()
        with patch.object(bricks2d, 'banded_conv', banded_conv_plain):
            ref = bricks2d.subm_conv3_2d(x2.to(dt), level0.occ, level0.halo,
                                         w, dt).float()
        err = (got - ref).abs().max().item()
        lim = bound * (ref.abs().max().item() if rel else 1.0)
        assert err <= lim, f'subm_conv3_2d {dt}: {err}'
        worst[f'subm_conv3_2d/{rows}x{cin}x16/{str(dt)[6:]}'] = err
    log('kernels', max_abs_err=worst)


def phase_forward(cfg, batch, b_caps, card):
    from doda_tpu_torch.models import model_fn
    from doda_tpu_torch.ops import bricks2d
    from doda_tpu_torch.ops.banded_conv import banded_conv, banded_conv_plain
    from doda_tpu_torch.utils import synth
    n_valid = int(batch.valid.sum())
    batch = batch.to('cuda')

    def run(dtype, sd):
        model = model_fn.build_model(cfg, dtype=dtype)
        model.load_state_dict(sd, strict=True)
        step = model_fn.make_eval_step(cfg, model, b_caps)
        return step

    sd = synth.seeded_state_dict(model_fn.build_model(cfg), seed=0)
    step = run(torch.bfloat16, sd)
    step(batch)                                     # warm-up (set-up)
    torch.cuda.synchronize()

    banded_conv.launches = 0                        # the counted main path
    out = step(batch)
    torch.cuda.synchronize()
    launches = banded_conv.launches
    assert launches == SUBM_CONVS, f'{launches} banded_conv launches'
    logits = out['output']
    assert logits.shape == (synth.BATCH, synth.N_CAP, 20)
    assert torch.isfinite(logits).all()
    assert int(out['count']) == n_valid
    assert int(out['target'].sum()) == n_valid
    preds_k = out['preds']

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(3):
        step(batch)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    assert banded_conv.launches == 4 * SUBM_CONVS
    peak = torch.cuda.max_memory_allocated()

    # float32: kernel path vs plain path, same weights and batch
    step32 = run(torch.float32, sd)
    lk = step32(batch)['output']
    with patch.object(bricks2d, 'banded_conv', banded_conv_plain):
        lp = step32(batch)['output']
        preds_p = step(batch)['preds']
    err32 = (lk - lp).abs().max().item()
    lim32 = 1e-3 * max(1.0, lp.abs().max().item())
    assert err32 <= lim32, f'float32 logits kernel vs plain: {err32}'
    agree = (preds_k == preds_p)[batch.valid].float().mean().item()
    assert agree >= 0.99, f'bf16 preds agree on {agree:.4f} of points'
    log('forward', card=card, launches_per_forward=launches,
        scenes_per_sec=3 * synth.BATCH / dt, seconds_per_forward=dt / 3,
        peak_memory_gib=peak / 2 ** 30, f32_logit_max_abs_err=err32,
        f32_logit_max_abs=lp.abs().max().item(), bf16_pred_agreement=agree,
        valid_points=n_valid, b_caps=list(b_caps))
    return launches


def phase_timing(launches):
    """banded_conv at the level-0 bench shape, bf16."""
    from doda_tpu_torch.ops import bricks2d
    from doda_tpu_torch.ops.banded_conv import banded_conv, banded_conv_plain
    from doda_tpu_torch.utils import synth
    b, cin, cout = synth.BATCH * synth.BRICK_CAP, 16, 16
    g = torch.Generator(device='cuda').manual_seed(2)
    rows6 = torch.randn(b, 6, 36 * cin, device='cuda', generator=g).to(
        torch.bfloat16)
    w = torch.randn(27, cin, cout, device='cuda', generator=g) / 20.8
    wb = bricks2d.banded_weights(w.to(torch.bfloat16))
    out = banded_conv(rows6, wb, torch.bfloat16)
    ref = banded_conv_plain(rows6, wb, torch.bfloat16)
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= 2e-2 * ref.float().abs().max().item()
    del ref

    ms = cuda_ms(lambda: banded_conv(rows6, wb, torch.bfloat16), 20)
    plain_ms = cuda_ms(lambda: banded_conv_plain(rows6, wb, torch.bfloat16),
                       5)
    # one library call of the same function: conv1d over the 6 planes
    x = rows6.transpose(1, 2).contiguous()           # (B, 36cin, 6)
    wc = wb.permute(2, 1, 0).contiguous()            # (16cout, 36cin, 3)
    lib = torch.nn.functional.conv1d(x, wc)          # (B, 16cout, 4)
    lib_err = (lib.transpose(1, 2).reshape(b, -1).float()
               - out.float()).abs().max().item()
    library_ms = cuda_ms(lambda: torch.nn.functional.conv1d(x, wc), 20)

    moved = (rows6.numel() + wb.numel() + out.numel()) * 2
    ops = 2 * b * 4 * int((wb != 0).sum())           # the non-zero taps
    t_bytes, t_ops = moved / PEAK_BYTES * 1e3, ops / PEAK_BF16 * 1e3
    row = {'name': 'banded_conv', 'route': 'cuda',
           'source': 'doda_tpu_torch/csrc/banded_conv.cu',
           'replaces': 'doda_tpu/ops/pallas_banded.py:71',
           'launches': launches, 'max_abs_err': err, 'ms': ms,
           'plain_ms': plain_ms, 'bound_ms': max(t_bytes, t_ops),
           'bound_by': 'bytes' if t_bytes >= t_ops else 'operations',
           'library_ms': library_ms}
    log('timing', shape=[b, cin, cout], dtype='bfloat16', bytes=moved,
        flops=ops, library_max_abs_err=lib_err, **row)
    return row


def main():
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is false',
              file=sys.stderr)
        return 1
    from doda_tpu_torch.config import CfgNode, cfg_from_yaml_file
    from doda_tpu_torch.models.unet import default_brick_caps
    from doda_tpu_torch.utils import synth

    name, card = phase_device()
    phase_build()

    cfg = cfg_from_yaml_file('cfgs/scannet/spconv.yaml', CfgNode())
    b_caps = default_brick_caps(synth.BRICK_CAP, cfg.MODEL.BACKBONE.get(
        'num_levels', 7))
    assert b_caps == (40960, 16384, 3328, 768, 256, 128, 128), b_caps
    batch = synth.make_batch(seed=0)
    synth.capacity_audit(batch, b_caps)
    level0 = phase_plan(batch, b_caps)
    phase_kernels(level0)
    del level0

    launches = phase_forward(cfg, batch, b_caps, card)
    row = phase_timing(launches)
    print(json.dumps({'kernels': [row]}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': name,
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
