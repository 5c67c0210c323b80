#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on an NVIDIA GPU.

    python3 chip_smoke.py        # from the repo root, one card

Phases, each printing one line:
  1. device: the card's name, nvidia-smi's name and power limit; TF32 off
  2. build: every CUDA source of doda_tpu_torch/csrc, compiled with nvcc
  3. plan: the bench batch's level plan on the card equals the CPU's
     kernels: each kernel's wrapper (K1 banded_conv, K2 banded_conv_sm) on
     the card vs its plain version, at the main paths' widths; one full
     subm conv on a real plan under either kernel, forward, and its
     weight gradient in bf16 against float32 accumulation
  4. forward: the flagship net (cfgs/scannet/spconv.yaml: mid 16, 7
     levels, 2 blocks per level, 20 classes) with seeded random weights
     serves bench-shaped batches (4 scenes, ~150k points each) through
     ``make_eval_step``: launch counts, scenes/sec, peak memory, float32
     logits kernel vs plain path, bf16 predictions kernel vs plain path
  5. train: the same net in train mode with ``sm_max_cin=32`` (K2 at
     levels 0 and 1, K1 elsewhere) takes three bf16 SGD steps on 2 bench
     scenes through ``make_train_step``: launch counts of both kernels,
     forward and backward, against the selection rule; loss finite, every
     parameter and running statistic moved; steps/sec, trained scenes/sec,
     peak memory; then one float32 step on the kernel path against the
     plain path, loss and every gradient
  6. timing: each kernel at the level-0 shape beside its bound, its plain
     version and, where there is one, a PyTorch library call computing the
     same function
Then a JSON line of the kernels and, last, {"ok": true, "device": ...}.
Any failure raises, and the script exits non-zero without that last line.
"""

import json
import math
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from unittest.mock import patch

import torch

SUBM_CONVS = 53            # subm convs per flagship forward
SM_MAX_CIN = 32            # the train phase's kernel choice: K2 for cin <= 32
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
    (levels, downs), (ref_levels, ref_downs) = (
        flatten_plan(plan, sm_levels=(0, 1)),
        flatten_plan(ref, sm_levels=(0, 1)))
    for got, want in zip(levels + downs, ref_levels + ref_downs):
        for name, a, b in zip(got._fields, got, want):
            assert (a is None) == (b is None), f'plan table {name} differs'
            if a is not None:
                assert torch.equal(a.cpu(), b), f'plan table {name} differs'
    bricks = [int(plan.grid0.table.n.sum())] + [
        int(d.parent.n.sum()) for d in plan.downs]
    log('plan', equal_to_cpu=True, first_build_seconds=seconds,
        occupied_bricks_per_level=bricks)
    return levels[0]


def _close(got, ref, rel, bound, what):
    """Assert max|got - ref| <= bound (times max|ref| if ``rel``)."""
    err = (got.float() - ref.float()).abs().max().item()
    lim = bound * (ref.float().abs().max().item() if rel else 1.0)
    assert err <= lim, f'{what}: {err} > {lim}'
    return err


# (dtype, tolerance relative to max|ref|?, tolerance): float32 sums in
# another order; bf16 outputs differ by at most one rounding of the result
CHECKS = ((torch.float32, False, 1e-3), (torch.bfloat16, True, 2e-2))


def phase_kernels(level0):
    from doda_tpu_torch.ops import bricks2d
    from doda_tpu_torch.ops.banded_conv import banded_conv, banded_conv_plain
    from doda_tpu_torch.ops.banded_conv_sm import (banded_conv_sm,
                                                   banded_conv_sm_plain)
    g = torch.Generator(device='cuda').manual_seed(1)
    worst = {}
    for b, cin, cout in ((1000, 3, 16), (4096, 16, 16), (4099, 32, 16),
                         (2048, 112, 112), (512, 192, 96)):
        rows6 = torch.randn(b, 6, 36 * cin, device='cuda', generator=g)
        w = torch.randn(27, cin, cout, device='cuda', generator=g)
        wb = bricks2d.banded_weights(w / (27 * cin) ** 0.5)
        for dt, rel, bound in CHECKS:
            got = banded_conv(rows6.to(dt), wb.to(dt), dt)
            torch.cuda.synchronize()
            ref = banded_conv_plain(rows6.to(dt), wb.to(dt), dt)
            worst[f'K1/{b}x{cin}x{cout}/{str(dt)[6:]}'] = _close(
                got, ref, rel, bound, f'banded_conv {b},{cin},{cout} {dt}')

    # K2 at every shape the rule can send it, ragged B included
    for b, cin, cout in ((4099, 16, 16), (4096, 32, 16), (2048, 16, 32),
                         (2048, 32, 32), (1000, 32, 64), (512, 112, 112)):
        ops = [torch.randn(b, cells * cin, device='cuda', generator=g)
               for cells in (64, 96, 40, 40)]
        w = torch.randn(27, cin, cout, device='cuda', generator=g)
        w = w / (27 * cin) ** 0.5
        for dt, rel, bound in CHECKS:
            args = [t.to(dt) for t in ops] + list(
                bricks2d.sm_weights(w.to(dt)))
            got = banded_conv_sm(*args, dt)
            torch.cuda.synchronize()
            ref = banded_conv_sm_plain(*args, dt)
            worst[f'K2/{b}x{cin}x{cout}/{str(dt)[6:]}'] = _close(
                got, ref, rel, bound, f'banded_conv_sm {b},{cin},{cout} {dt}')
    assert banded_conv_sm(*(t[:0] for t in args[:4]), *args[4:],
                          torch.float32).shape == (0, 64 * 112)

    # one full subm conv on the real level-0 plan of the bench batch: the
    # K2 engine against the K1 engine and against the plain path
    rows, cin = level0.occ.shape[0], 16
    x2 = torch.randn(rows, 64, cin, device='cuda', generator=g)
    x2 = (x2 * level0.occ[..., None]).reshape(rows, -1)
    w = torch.randn(27, cin, 16, device='cuda', generator=g) / 20.8

    def conv(dt, sm_max_cin, xin=x2, win=w):
        return bricks2d.subm_conv3_2d(xin.to(dt), level0.occ, level0.halo,
                                      win, dt, level0.sm, sm_max_cin)

    for dt, rel, bound in CHECKS:
        got_k1, got_k2 = conv(dt, 0), conv(dt, SM_MAX_CIN)
        with patch.object(bricks2d, 'banded_conv', banded_conv_plain), \
                patch.object(bricks2d, 'banded_conv_sm',
                             banded_conv_sm_plain):
            ref = conv(dt, 0)
        key = f'subm_conv3_2d/{rows}x{cin}x16/{str(dt)[6:]}'
        worst[f'K1/{key}'] = _close(got_k1, ref, rel, bound, f'K1 {key}')
        worst[f'K2/{key}'] = _close(got_k2, ref, rel, bound, f'K2 {key}')
        worst[f'K2-vs-K1/{key}'] = _close(got_k2, got_k1, rel, bound,
                                          f'K2 vs K1 {key}')

    # the bf16 weight gradient keeps a float32 accumulator: on the same
    # bf16-rounded operands it must agree with the float32 conv's dW far
    # inside bf16's own rounding (2^-9 of the result)
    cot = torch.randn(rows, 64 * 16, device='cuda',
                      generator=g).bfloat16()
    grads = {}
    for dt in (torch.bfloat16, torch.float32):
        wl = w.bfloat16().float().requires_grad_(True)
        xl = x2.bfloat16().to(dt).requires_grad_(True)
        conv(dt, SM_MAX_CIN, xl, wl).backward(cot.to(dt))
        grads[dt] = (wl.grad, xl.grad)
    dw16, dx16 = grads[torch.bfloat16]
    dw32, dx32 = grads[torch.float32]
    worst['dW/bf16-vs-f32-accumulation'] = _close(
        dw16, dw32, True, 1e-4, 'subm dW bf16 vs float32 accumulation')
    worst['dx/bf16-vs-f32'] = _close(dx16, dx32, True, 2e-2,
                                     'subm dx bf16 vs float32')
    log('kernels', max_abs_err=worst, dW_max_abs=dw32.abs().max().item())


def phase_forward(cfg, batch, b_caps, card):
    from doda_tpu_torch.models import model_fn
    from doda_tpu_torch.ops import bricks2d
    from doda_tpu_torch.ops.banded_conv import banded_conv, banded_conv_plain
    from doda_tpu_torch.ops.banded_conv_sm import banded_conv_sm
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

    banded_conv.launches = banded_conv_sm.launches = 0   # the counted path
    out = step(batch)
    torch.cuda.synchronize()
    launches = banded_conv.launches
    assert launches == SUBM_CONVS, f'{launches} banded_conv launches'
    assert banded_conv_sm.launches == 0     # sm_max_cin=0: K1 everywhere
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


def expected_launches(model, sm_max_cin):
    """(K1, K2) launches of one train step by the selection rule: every
    (27, cin, cout) kernel runs one forward conv on (cin, cout) and one dx
    conv on the flipped shape (cout, cin), except the input conv, whose
    input needs no gradient."""
    from doda_tpu_torch.ops.bricks2d import uses_sm
    counts = {'fwd': [0, 0], 'bwd': [0, 0]}
    for name, p in model.named_parameters():
        if p.dim() != 3 or p.shape[0] != 27:
            continue
        _, cin, cout = p.shape
        counts['fwd'][uses_sm(cin, cout, sm_max_cin)] += 1
        if name != 'input_kernel':
            counts['bwd'][uses_sm(cout, cin, sm_max_cin)] += 1
    return counts


def phase_train(cfg, b_caps, card):
    """Three bf16 train steps of the flagship on 2 bench scenes, then one
    float32 step on the kernel path against the plain path."""
    from doda_tpu_torch.models import model_fn
    from doda_tpu_torch.ops import bricks2d
    from doda_tpu_torch.ops.banded_conv import banded_conv, banded_conv_plain
    from doda_tpu_torch.ops.banded_conv_sm import (banded_conv_sm,
                                                   banded_conv_sm_plain)
    from doda_tpu_torch.utils import optim, synth
    batch = synth.make_batch(seed=0, batch=synth.TRAIN_BATCH)
    synth.capacity_audit(batch, b_caps)
    batch = batch.to('cuda')
    lr = optim.make_lr_fn(cfg.OPTIMIZATION, cfg.OPTIMIZATION.NUM_EPOCHS,
                          100)(1, 0)

    def trainer(dtype, sd):
        model = model_fn.build_model(cfg, dtype=dtype, sm_max_cin=SM_MAX_CIN,
                                     train=True)
        model.load_state_dict(sd, strict=True)
        opt = optim.build_optimizer(cfg.OPTIMIZATION, model.parameters())
        return model, model_fn.make_train_step(cfg, model, opt, b_caps)

    sd = synth.seeded_state_dict(model_fn.build_model(cfg), seed=0)
    model, step = trainer(torch.bfloat16, sd)
    want = expected_launches(model, SM_MAX_CIN)
    assert want == {'fwd': [38, 15], 'bwd': [36, 16]}, want   # the flagship
    step(batch, lr)                                 # warm-up (set-up)
    torch.cuda.synchronize()
    before = {k: v.clone() for k, v in model.state_dict().items()}

    torch.cuda.reset_peak_memory_stats()
    steps = 3
    banded_conv.launches = banded_conv_sm.launches = 0   # the counted path
    t0 = time.perf_counter()
    losses = [step(batch, lr)['loss'] for _ in range(steps)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    k1, k2 = banded_conv.launches, banded_conv_sm.launches
    peak = torch.cuda.max_memory_allocated()
    assert k1 == steps * (want['fwd'][0] + want['bwd'][0]), k1
    assert k2 == steps * (want['fwd'][1] + want['bwd'][1]), k2
    losses = [float(v) for v in losses]
    assert all(math.isfinite(v) for v in losses), losses
    after = model.state_dict()
    stuck = [k for k, v in before.items() if torch.equal(v, after[k])]
    assert not stuck, f'unchanged after {steps} steps: {stuck}'
    assert all(torch.isfinite(v).all() for v in after.values())

    # split one step's launches into forward and backward
    banded_conv.launches = banded_conv_sm.launches = 0
    with torch.no_grad():
        plan = model_fn.build_level_plan(batch.coords, batch.valid, b_caps)
        model(model_fn.model_input(cfg, batch), plan)
    fwd = [banded_conv.launches, banded_conv_sm.launches]
    assert fwd == want['fwd'], fwd
    del model, step, before, after, plan
    torch.cuda.empty_cache()

    # float32: one step from identical weights, kernel path vs plain path
    model_k, step_k = trainer(torch.float32, sd)
    loss_k = float(step_k(batch, lr)['loss'])
    grads_k = {n: p.grad.clone() for n, p in model_k.named_parameters()}
    del model_k, step_k
    model_p, step_p = trainer(torch.float32, sd)
    with patch.object(bricks2d, 'banded_conv', banded_conv_plain), \
            patch.object(bricks2d, 'banded_conv_sm', banded_conv_sm_plain):
        loss_p = float(step_p(batch, lr)['loss'])
    assert abs(loss_k - loss_p) <= 1e-4 * abs(loss_p), (loss_k, loss_p)
    worst = 0.0
    for n, p in model_p.named_parameters():
        err = (grads_k[n] - p.grad).abs().max().item()
        scale = max(1.0, p.grad.abs().max().item())
        assert err <= 1e-3 * scale, f'float32 gradient {n}: {err}'
        worst = max(worst, err / scale)
    log('train', card=card, sm_max_cin=SM_MAX_CIN, batch=synth.TRAIN_BATCH,
        k1_launches_per_step=k1 // steps, k2_launches_per_step=k2 // steps,
        forward_launches=fwd, backward_launches=want['bwd'],
        steps_per_sec=steps / dt,
        trained_scenes_per_sec=steps * synth.TRAIN_BATCH / dt,
        seconds_per_step=dt / steps, peak_memory_gib=peak / 2 ** 30,
        losses=losses, lr=lr, f32_loss_kernel=loss_k, f32_loss_plain=loss_p,
        f32_worst_gradient_err=worst)
    return {'banded_conv': k1, 'banded_conv_sm': k2}


def _bound(moved, ops):
    """The least time for the work, ms: bytes over the memory rate or
    operations over the bf16 peak, whichever is larger."""
    t_bytes, t_ops = moved / PEAK_BYTES * 1e3, ops / PEAK_BF16 * 1e3
    return {'bound_ms': max(t_bytes, t_ops),
            'bound_by': 'bytes' if t_bytes >= t_ops else 'operations'}


def phase_timing(launches):
    """Each kernel at the level-0 bench shape, bf16; ``launches`` maps a
    kernel's name to its (eval forward, train steps) counts."""
    from doda_tpu_torch.ops import bricks2d
    from doda_tpu_torch.ops.banded_conv import banded_conv, banded_conv_plain
    from doda_tpu_torch.ops.banded_conv_sm import (banded_conv_sm,
                                                   banded_conv_sm_plain)
    from doda_tpu_torch.utils import synth
    b, cin, cout = synth.BATCH * synth.BRICK_CAP, 16, 16
    g = torch.Generator(device='cuda').manual_seed(2)
    bf = torch.bfloat16
    w = (torch.randn(27, cin, cout, device='cuda', generator=g) / 20.8).to(bf)
    rows = []

    def row(name, source, replaces, err, ms, plain_ms, bound, library_ms):
        fwd, train = launches[name]
        return {'name': name, 'route': 'cuda', 'source': source,
                'replaces': replaces, 'launches': fwd + train,
                'launches_eval_forward': fwd, 'launches_train_steps': train,
                'max_abs_err': err, 'ms': ms, 'plain_ms': plain_ms, **bound,
                'library_ms': library_ms}

    # K1
    rows6 = torch.randn(b, 6, 36 * cin, device='cuda', generator=g).to(bf)
    wb = bricks2d.banded_weights(w)
    out = banded_conv(rows6, wb, bf)
    ref = banded_conv_plain(rows6, wb, bf)
    err = _close(out, ref, True, 2e-2, 'banded_conv at the timing shape')
    del ref
    ms = cuda_ms(lambda: banded_conv(rows6, wb, bf), 20)
    plain_ms = cuda_ms(lambda: banded_conv_plain(rows6, wb, bf), 5)
    # one library call of the same function: conv1d over the 6 planes
    x = rows6.transpose(1, 2).contiguous()           # (B, 36cin, 6)
    wc = wb.permute(2, 1, 0).contiguous()            # (16cout, 36cin, 3)
    lib = torch.nn.functional.conv1d(x, wc)          # (B, 16cout, 4)
    lib_err = (lib.transpose(1, 2).reshape(b, -1).float()
               - out.float()).abs().max().item()
    library_ms = cuda_ms(lambda: torch.nn.functional.conv1d(x, wc), 20)
    moved = (rows6.numel() + wb.numel() + out.numel()) * 2
    ops = 2 * b * 4 * int((wb != 0).sum())           # the non-zero taps
    rows.append(row('banded_conv', 'doda_tpu_torch/csrc/banded_conv.cu',
                    'doda_tpu/ops/pallas_banded.py:71', err, ms, plain_ms,
                    _bound(moved, ops), library_ms))
    log('timing', kernel='banded_conv', shape=[b, cin, cout],
        dtype='bfloat16', bytes=moved, flops=ops, executed_flops=2 * b * 4
        * wb.numel(), library_max_abs_err=lib_err, **rows[-1])
    del rows6, x, wc, lib, out

    # K2, same B; no single PyTorch call computes it from these operands
    args = [torch.randn(b, cells * cin, device='cuda', generator=g).to(bf)
            for cells in (64, 96, 40, 40)]
    wts = bricks2d.sm_weights(w)
    args += list(wts)
    out = banded_conv_sm(*args, bf)
    ref = banded_conv_sm_plain(*args, bf)
    err = _close(out, ref, True, 2e-2, 'banded_conv_sm at the timing shape')
    del ref
    ms = cuda_ms(lambda: banded_conv_sm(*args, bf), 20)
    plain_ms = cuda_ms(lambda: banded_conv_sm_plain(*args, bf), 5)
    moved = (sum(t.numel() for t in args) + out.numel()) * 2
    nz_c, nz_h, nz_x = ([int((m != 0).sum()) for m in t] for t in wts)
    taps = 0                 # non-zero weights the four slices multiply by
    for xr in range(4):
        for i in range(3):
            cx = xr + i - 1
            taps += nz_x[0] if cx == -1 else nz_x[1] if cx == 4 \
                else nz_c[i] + nz_h[i]
    ops = 2 * b * taps
    rows.append(row('banded_conv_sm', 'doda_tpu_torch/csrc/banded_conv_sm.cu',
                    'doda_tpu/ops/pallas_sm.py:83', err, ms, plain_ms,
                    _bound(moved, ops), None))
    log('timing', kernel='banded_conv_sm', shape=[b, cin, cout],
        dtype='bfloat16', bytes=moved, flops=ops,
        executed_flops=2 * b * 4 * 120 * cin * 16 * cout, **rows[-1])
    return rows


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

    fwd = phase_forward(cfg, batch, b_caps, card)
    del batch
    train = phase_train(cfg, b_caps, card)
    rows = phase_timing({'banded_conv': (fwd, train['banded_conv']),
                         'banded_conv_sm': (0, train['banded_conv_sm'])})
    for r in rows:       # every kernel of the paths really ran on them
        assert r['launches'] > 0, r['name']
    print(json.dumps({'kernels': rows}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': name,
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
