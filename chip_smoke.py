#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on an NVIDIA GPU.

    python3 chip_smoke.py        # from the repo root, one card

Phases, each printing one line:
  1. device: the card's name, nvidia-smi's name and power limit; TF32 off
  2. build: every CUDA source of doda_tpu_torch/csrc, compiled with nvcc,
     and the host library of the data path (native/src/host_ops.cc, g++)
  3. plan: the bench batch's level plan on the card equals the CPU's
     kernels: each kernel's wrapper (K1 banded_conv, its fused version
     banded_conv_fused, K2 banded_conv_sm and its second version
     banded_conv_sm_taps) on the card vs its plain version, at the main
     paths' widths (K2's second version also on row-strided operands, a
     ragged tile and no rows); the fused K1 on the real plan's
     rulebooks (levels 0, 1, 5, 6) and on a synthetic one (ragged rows,
     absent faces with present diagonals, no rows), also against the
     assembled K1; one full subm conv on a real plan under either engine,
     forward, and its weight gradient in bf16 against float32 accumulation
  4. forward: the flagship net (cfgs/scannet/spconv.yaml: mid 16, 7
     levels, 2 blocks per level, 20 classes) with seeded random weights
     serves bench-shaped batches (4 scenes, ~150k points each) through
     ``make_eval_step``: launch counts (52 fused K1 + 1 assembled K1, from
     the parameter shapes), scenes/sec, peak memory, float32
     logits kernel vs plain path, bf16 predictions kernel vs plain path
  5. train: the same net in train mode with ``sm_max_cin=32`` (K2's
     second version at levels 0 and 1, the fused K1 elsewhere; float32
     steps run K2's first version) takes three bf16 SGD steps on 2 bench
     scenes through ``make_train_step``: launch counts of both kernels,
     forward and backward, against the selection rule; loss finite, every
     parameter and running statistic moved; steps/sec, trained scenes/sec,
     peak memory; then one float32 step on the kernel path against the
     plain path, loss and every gradient; and three bf16 steps under
     ``sm_max_cin=0`` (fused K1 everywhere) beside the ``sm_max_cin=32`` ones
  6. cli: the port's three CLIs in process (``doda_tpu_torch.tools``), at
     full width and depth and the cfgs' batch size (4), on synthetic rooms
     of ~150k points written by ``tools/make_synth_data.py``: ``train``
     (cfgs/da_front3d_scannet/spconv.yaml, one epoch on 6 3D-FRONT-format
     rooms, validation on 4 ScanNet-format rooms), ``test`` of its
     checkpoint on those 4 rooms (mIoU equal to ``make_eval_step``'s on
     the same batches) and on 2 S3DIS-format rooms through the 1-NN
     broadcast (cfgs/da_front3d_s3dis/spconv.yaml), and ``st``
     (spconv_st.yaml, one epoch from that checkpoint on 6 ScanNet-format
     target rooms: pseudo labels, TACM-mixed batches, DSNorm); every
     step's kernel launches read from the counters against the rule,
     scenes/sec, step ms, data-wait ms, peak memory, IoU and the files
     written, with the output tree asserted
  7. import: a seeded reference ``.pth`` of the DA flagship (the
     reference's key names and layouts), converted into the JAX package's
     format by ``doda_tpu_torch.tools.convert_torch_ckpt``, through
     ``test --ckpt`` on the 4 ScanNet rooms: launches, its mIoU equal to
     that of the same tree loaded through ``params_from_jax`` and run
     through ``make_eval_step``, one batch's float32 logits bit-equal
     between the two loads (all under deterministic algorithms)
  8. device_aug: ``train`` and ``st``, one step each, with
     ``DATA_AUG.device`` on: step ms, data wait and its share, peak memory,
     launches, beside phase cli's host-path readings; the augmentation's
     own device time; ``device_augment`` on the card against the CPU on
     the same CPU draws (feats to 1e-5, coords equal but for floor flips
     inside 1e-4 of an integer); the brick audit of each step's augmented
     batch
  9. ddp: two gloo ranks spawned on the one card, one bench scene each
     (150k and 100k points; st targets of 120k and 150k), against one
     process on both, float32 on the kernel path
     (``tests/_torch_equivalence.py``): for a train step and an st step
     with soft labels, the losses, histograms, gradients, updated weights
     and running statistics; eval predictions and histograms;
     ``all_gather_objects``; each rank's peak memory; then ``train
     --launcher pytorch`` at WORLD_SIZE=1 for one step
 10. timing: each kernel at the level-0 shape beside its bound, its plain
     version and, where there is one, a PyTorch library call computing the
     same function; K1 in both versions, with the plane gather alone, at
     the level-0 and level-1 shapes on the real rulebooks; K2 in both
     versions at the level-0 and level-1 shapes
Then a JSON line of the kernels and, last, {"ok": true, "device": ...}.
Any failure raises, and the script exits non-zero without that last line.
"""

import json
import math
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from unittest.mock import patch

import torch

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
    from doda_tpu_torch.native import host_ops
    from doda_tpu_torch.ops import _build
    names = sorted(p.stem for p in _build.CSRC.glob('*.cu'))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names) + 1) as ex:  # one nvcc per source
        host = ex.submit(host_ops._load)            # and g++ for the host
        list(ex.map(_build.build, names))           # library of the data
        host.result()                               # path
    log('build', sources=names + ['native/src/host_ops.cc'],
        seconds=round(time.perf_counter() - t0, 3),
        ptxas={n: _build.resources(n) for n in names})


def phase_plan(batch, b_caps):
    """The bench batch's level plan built on the card equals the one built
    on the CPU, table for table; returns the card's flat levels."""
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
    return levels


def _close(got, ref, rel, bound, what):
    """Assert max|got - ref| <= bound (times max|ref| if ``rel``)."""
    err = (got.float() - ref.float()).abs().max().item()
    lim = bound * (ref.float().abs().max().item() if rel else 1.0)
    assert err <= lim, f'{what}: {err} > {lim}'
    return err


# (dtype, tolerance relative to max|ref|?, tolerance): float32 sums in
# another order; bf16 outputs differ by at most one rounding of the result
CHECKS = ((torch.float32, False, 1e-3), (torch.bfloat16, True, 2e-2))
# the fused K1 takes bf16 operands: (output dtype, tolerance relative to
# max|ref|): float32 output, the same bf16 products summed in float32 in
# another order; bf16 output, one rounding of the result
FUSED_CHECKS = ((torch.float32, 1e-4), (torch.bfloat16, 2e-2))
# (B, cin, cout) of the K2 checks: every shape the rule can send it,
# ragged B included
K2_SHAPES = ((4099, 16, 16), (4096, 32, 16), (2048, 16, 32), (2048, 32, 32),
             (1000, 32, 64), (512, 112, 112))


def plain_path():
    """Context in which every kernel wrapper of the conv engine is its
    plain PyTorch version."""
    from contextlib import ExitStack
    from doda_tpu_torch.ops import bricks2d
    from doda_tpu_torch.ops.banded_conv import (banded_conv_fused_plain,
                                                banded_conv_plain)
    from doda_tpu_torch.ops.banded_conv_sm import (banded_conv_sm_plain,
                                                   banded_conv_sm_taps_plain)
    stack = ExitStack()
    for name, fn in (('banded_conv', banded_conv_plain),
                     ('banded_conv_fused', banded_conv_fused_plain),
                     ('banded_conv_sm', banded_conv_sm_plain),
                     ('banded_conv_sm_taps', banded_conv_sm_taps_plain)):
        stack.enter_context(patch.object(bricks2d, name, fn))
    return stack


def check_fused(worst, key, x2, nbr, w):
    """The fused K1 against its plain version (both output types) and
    against the assembled K1 on the same inputs."""
    from doda_tpu_torch.ops import bricks2d
    from doda_tpu_torch.ops.banded_conv import (banded_conv,
                                                banded_conv_fused,
                                                banded_conv_fused_plain)
    for dt, bound in FUSED_CHECKS:
        got = banded_conv_fused(x2, nbr, w, dt)
        torch.cuda.synchronize()
        ref = banded_conv_fused_plain(x2, nbr, w, dt)
        worst[f'K1f/{key}/{str(dt)[6:]}'] = _close(
            got, ref, True, bound, f'banded_conv_fused {key} {dt}')
    old = banded_conv(bricks2d._assemble_p6(x2, bricks2d.halo_index(nbr),
                                            x2.dtype),
                      bricks2d.banded_weights(w), torch.bfloat16)
    worst[f'K1f-vs-K1/{key}'] = _close(got, old, True, 2e-2,
                                       f'fused vs assembled K1 {key}')


def phase_kernels(levels):
    from doda_tpu_torch.ops import bricks2d
    from doda_tpu_torch.ops.banded_conv import (banded_conv,
                                                banded_conv_fused,
                                                banded_conv_plain)
    from doda_tpu_torch.ops.banded_conv_sm import (banded_conv_sm,
                                                   banded_conv_sm_plain,
                                                   banded_conv_sm_taps,
                                                   banded_conv_sm_taps_plain)
    from doda_tpu_torch.utils import synth
    g = torch.Generator(device='cuda').manual_seed(1)
    worst = {}
    level0 = levels[0]
    bf = torch.bfloat16

    def operands(rows, cin, cout):
        x2 = torch.randn(rows, 64 * cin, device='cuda', generator=g)
        w = torch.randn(27, cin, cout, device='cuda', generator=g)
        return x2.to(bf), (w / (27 * cin) ** 0.5).to(bf)

    # the fused K1 on the bench batch's own rulebooks ...
    for lvl, cin, cout in ((0, 16, 16), (0, 32, 16), (1, 32, 32),
                           (6, 112, 112), (5, 192, 96)):
        nbr = levels[lvl].nbr
        x2, w = operands(nbr.shape[0], cin, cout)
        check_fused(worst, f'level{lvl}/{nbr.shape[0]}x{cin}x{cout}', x2,
                    nbr, w)
    # ... and on a synthetic one: rows not a multiple of the brick tile,
    # bricks whose -x face neighbour is absent while a (-x, +-y) diagonal
    # is present, a cin that ends in a half chunk, and no rows at all
    for rows, grid, cin, cout in ((4099, 20, 16, 16), (1001, 12, 24, 8),
                                  (3, 4, 16, 32)):
        nbr = synth.synth_rulebook(rows, grid, seed=rows)
        if rows > 1000:
            face, diag = nbr[:, 4], nbr[:, [1, 7]]
            assert ((face == rows) & (diag < rows).any(1)).any()
        x2, w = operands(rows, cin, cout)
        check_fused(worst, f'synthetic/{rows}x{cin}x{cout}', x2, nbr, w)
    before = banded_conv_fused.launches
    empty = banded_conv_fused(x2[:0], nbr[:0], w, bf)
    assert empty.shape == (0, 64 * 32)
    assert banded_conv_fused.launches == before     # nothing to launch

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
    for b, cin, cout in K2_SHAPES:
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

    # K2's second version at the same shapes, on less than one tile, with a
    # half-filled last cout block, and at a cin that takes two weight
    # groups, the last one smaller: bf16 operands, gyz/gxm/gxp as column
    # slices of one gathered buffer, float32 and bf16 output; contiguous
    # copies give the same bits
    for b, cin, cout in K2_SHAPES + ((7, 32, 32), (1000, 16, 24),
                                     (333, 144, 24)):
        x = torch.randn(b, 64 * cin, device='cuda', generator=g).to(bf)
        buf = torch.randn(b, 176 * cin, device='cuda', generator=g).to(bf)
        halo = (buf[:, :96 * cin], buf[:, 96 * cin:136 * cin],
                buf[:, 136 * cin:])
        w = (torch.randn(27, cin, cout, device='cuda', generator=g)
             / (27 * cin) ** 0.5).to(bf)
        key = f'K2taps/{b}x{cin}x{cout}'
        for dt, bound in FUSED_CHECKS:
            got = banded_conv_sm_taps(x, *halo, w, dt)
            torch.cuda.synchronize()
            ref = banded_conv_sm_taps_plain(x, *halo, w, dt)
            worst[f'{key}/{str(dt)[6:]}'] = _close(
                got, ref, True, bound, f'banded_conv_sm_taps {key} {dt}')
        again = banded_conv_sm_taps(x, *(t.contiguous() for t in halo), w,
                                    torch.bfloat16)
        assert torch.equal(again, got), f'{key}: strided != contiguous'
    before = banded_conv_sm_taps.launches
    empty = banded_conv_sm_taps(x[:0], *(t[:0] for t in halo), w, bf)
    assert empty.shape == (0, 64 * cout)
    assert banded_conv_sm_taps.launches == before   # nothing to launch

    # one full subm conv on the real level-0 plan of the bench batch: the
    # K2 engine against the K1 engine and against the plain path
    rows, cin = level0.occ.shape[0], 16
    x2 = torch.randn(rows, 64, cin, device='cuda', generator=g)
    x2 = (x2 * level0.occ[..., None]).reshape(rows, -1)
    w = torch.randn(27, cin, 16, device='cuda', generator=g) / 20.8

    def conv(dt, sm_max_cin, xin=x2, win=w):
        return bricks2d.subm_conv3_2d(xin.to(dt), level0.occ, level0.halo,
                                      win, dt, level0.sm, sm_max_cin,
                                      level0.nbr)

    for dt, rel, bound in CHECKS:
        got_k1, got_k2 = conv(dt, 0), conv(dt, SM_MAX_CIN)
        with plain_path():
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
    from doda_tpu_torch.ops.banded_conv import banded_conv, banded_conv_fused
    from doda_tpu_torch.ops.banded_conv_sm import (banded_conv_sm,
                                                   banded_conv_sm_taps)
    from doda_tpu_torch.utils import synth
    n_valid = int(batch.valid.sum())
    batch = batch.to('cuda')

    def run(dtype, sd):
        model = model_fn.build_model(cfg, dtype=dtype)
        model.load_state_dict(sd, strict=True)
        return model, model_fn.make_eval_step(cfg, model, b_caps)

    sd = synth.seeded_state_dict(model_fn.build_model(cfg), seed=0)
    model, step = run(torch.bfloat16, sd)
    # the rule on the parameter shapes: all but the cin = 3 input conv
    want = model.subm_routes()
    assert want == {'sm': 0, 'fused': 52, 'assembled': 1}, want
    step(batch)                                     # warm-up (set-up)
    torch.cuda.synchronize()

    def reset():
        banded_conv.launches = banded_conv_fused.launches = 0
        banded_conv_sm.launches = banded_conv_sm_taps.launches = 0

    reset()                                         # the counted path
    out = step(batch)
    torch.cuda.synchronize()
    launches = {'fused': banded_conv_fused.launches,
                'assembled': banded_conv.launches,
                'sm': banded_conv_sm_taps.launches}
    assert banded_conv_sm.launches == 0
    assert launches == want, launches
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
    assert banded_conv_fused.launches == 4 * want['fused']
    assert banded_conv.launches == 4 * want['assembled']
    peak = torch.cuda.max_memory_allocated()

    # float32: kernel path vs plain path, same weights and batch
    _, step32 = run(torch.float32, sd)
    lk = step32(batch)['output']
    with plain_path():
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


def phase_train(cfg, b_caps, card):
    """Three bf16 train steps of the flagship on 2 bench scenes, then one
    float32 step on the kernel path against the plain path."""
    from doda_tpu_torch.models import model_fn
    from doda_tpu_torch.ops.banded_conv import banded_conv, banded_conv_fused
    from doda_tpu_torch.ops.banded_conv_sm import (banded_conv_sm,
                                                   banded_conv_sm_taps)
    from doda_tpu_torch.utils import optim, synth
    batch = synth.make_batch(seed=0, batch=synth.TRAIN_BATCH)
    synth.capacity_audit(batch, b_caps)
    batch = batch.to('cuda')
    lr = optim.make_lr_fn(cfg.OPTIMIZATION, cfg.OPTIMIZATION.NUM_EPOCHS,
                          100)(1, 0)

    def trainer(dtype, sd, sm_max_cin=SM_MAX_CIN):
        model = model_fn.build_model(cfg, dtype=dtype, sm_max_cin=sm_max_cin,
                                     train=True)
        model.load_state_dict(sd, strict=True)
        opt = optim.build_optimizer(cfg.OPTIMIZATION, model.parameters())
        return model, model_fn.make_train_step(cfg, model, opt, b_caps)

    sd = synth.seeded_state_dict(model_fn.build_model(cfg), seed=0)
    model, step = trainer(torch.bfloat16, sd)
    # launches of one step by the rule on the parameter shapes: every
    # kernel runs one forward conv and one dx conv on the flipped shape,
    # except the input conv, whose input needs no gradient
    fwd_want, bwd_want = model.subm_routes(), model.subm_routes(True)
    assert fwd_want == {'sm': 15, 'fused': 37, 'assembled': 1}, fwd_want
    assert bwd_want == {'sm': 16, 'fused': 36, 'assembled': 0}, bwd_want
    want = {k: fwd_want[k] + bwd_want[k] for k in fwd_want}

    def reset():
        banded_conv.launches = banded_conv_fused.launches = 0
        banded_conv_sm.launches = banded_conv_sm_taps.launches = 0

    def counts():
        # bf16 'sm' convs run K2's second version; its first version runs
        # only on float32 operands and must not appear here
        assert banded_conv_sm.launches == 0, banded_conv_sm.launches
        return {'sm': banded_conv_sm_taps.launches,
                'fused': banded_conv_fused.launches,
                'assembled': banded_conv.launches}

    step(batch, lr)                                 # warm-up (set-up)
    torch.cuda.synchronize()
    before = {k: v.clone() for k, v in model.state_dict().items()}

    torch.cuda.reset_peak_memory_stats()
    steps = 3
    reset()                                         # the counted path
    t0 = time.perf_counter()
    losses = [step(batch, lr)['loss'] for _ in range(steps)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    ran = counts()
    peak = torch.cuda.max_memory_allocated()
    assert ran == {k: steps * v for k, v in want.items()}, ran
    losses = [float(v) for v in losses]
    assert all(math.isfinite(v) for v in losses), losses
    after = model.state_dict()
    stuck = [k for k, v in before.items() if torch.equal(v, after[k])]
    assert not stuck, f'unchanged after {steps} steps: {stuck}'
    assert all(torch.isfinite(v).all() for v in after.values())

    # split one step's launches into forward and backward
    reset()
    with torch.no_grad():
        plan = model_fn.build_level_plan(batch.coords, batch.valid, b_caps)
        model(model_fn.model_input(cfg, batch), plan)
    assert counts() == fwd_want, counts()
    del model, step, before, after, plan
    torch.cuda.empty_cache()

    # whether K2 still pays: the same three steps with the fused K1
    # everywhere (sm_max_cin=0), same batch, same weights
    model0, step0 = trainer(torch.bfloat16, sd, sm_max_cin=0)
    step0(batch, lr)                                # warm-up (set-up)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset()
    t0 = time.perf_counter()
    losses0 = [step0(batch, lr)['loss'] for _ in range(steps)]
    torch.cuda.synchronize()
    dt0 = time.perf_counter() - t0
    peak0 = torch.cuda.max_memory_allocated()
    assert counts() == {'sm': 0, 'fused': steps * 104,
                        'assembled': steps}, counts()
    assert all(math.isfinite(float(v)) for v in losses0)
    log('train_k2_or_fused', card=card, batch=synth.TRAIN_BATCH,
        steps_per_sec_sm_max_cin_32=steps / dt,
        steps_per_sec_sm_max_cin_0=steps / dt0,
        peak_memory_gib_sm_max_cin_32=peak / 2 ** 30,
        peak_memory_gib_sm_max_cin_0=peak0 / 2 ** 30)
    del model0, step0
    reset()
    torch.cuda.empty_cache()

    # float32: one step from identical weights, kernel path vs plain path;
    # the 'sm' convs run K2's first version (exact float32 CUDA cores)
    model_k, step_k = trainer(torch.float32, sd)
    reset()
    loss_k = float(step_k(batch, lr)['loss'])
    f32_sm = banded_conv_sm.launches
    assert f32_sm == want['sm'] and banded_conv_sm_taps.launches == 0, (
        f32_sm, banded_conv_sm_taps.launches)
    grads_k = {n: p.grad.clone() for n, p in model_k.named_parameters()}
    del model_k, step_k
    model_p, step_p = trainer(torch.float32, sd)
    with plain_path():
        loss_p = float(step_p(batch, lr)['loss'])
    assert abs(loss_k - loss_p) <= 1e-4 * abs(loss_p), (loss_k, loss_p)
    worst = 0.0
    for n, p in model_p.named_parameters():
        err = (grads_k[n] - p.grad).abs().max().item()
        scale = max(1.0, p.grad.abs().max().item())
        assert err <= 1e-3 * scale, f'float32 gradient {n}: {err}'
        worst = max(worst, err / scale)
    log('train', card=card, sm_max_cin=SM_MAX_CIN, batch=synth.TRAIN_BATCH,
        launches_per_step=want, forward_launches=fwd_want,
        backward_launches=bwd_want,
        steps_per_sec=steps / dt,
        trained_scenes_per_sec=steps * synth.TRAIN_BATCH / dt,
        seconds_per_step=dt / steps, peak_memory_gib=peak / 2 ** 30,
        losses=losses, lr=lr, f32_loss_kernel=loss_k, f32_loss_plain=loss_p,
        f32_worst_gradient_err=worst, f32_step_sm_first_version=f32_sm)
    return ran, f32_sm


CLI_POINTS = 150_000       # points per synthetic room of the cli phases
CFG_DA = 'cfgs/da_front3d_scannet/spconv.yaml'
CFG_ST = 'cfgs/da_front3d_scannet/spconv_st.yaml'
DEVICE_AUG = ['DATA_CONFIG.DATA_AUG.device', 'True',
              'DATA_CONFIG_TAR.DATA_AUG.device', 'True']


def _cli_launches():
    """The launch counters of every kernel, by route."""
    from doda_tpu_torch.ops.banded_conv import banded_conv, banded_conv_fused
    from doda_tpu_torch.ops.banded_conv_sm import (banded_conv_sm,
                                                   banded_conv_sm_taps)
    return {'fused': banded_conv_fused.launches,
            'assembled': banded_conv.launches,
            'sm': banded_conv_sm_taps.launches + banded_conv_sm.launches}


def _cli_reset():
    from doda_tpu_torch.ops.banded_conv import banded_conv, banded_conv_fused
    from doda_tpu_torch.ops.banded_conv_sm import (banded_conv_sm,
                                                   banded_conv_sm_taps)
    banded_conv.launches = banded_conv_fused.launches = 0
    banded_conv_sm.launches = banded_conv_sm_taps.launches = 0


def _lines(path):
    with open(path, 'rb') as f:
        return sum(1 for _ in f)


def _points(scene):
    """The point count of a synthetic room file (.pth or .npy)."""
    if scene.suffix == '.pth':
        return len(torch.load(scene, weights_only=False)[0])
    import numpy as np
    return len(np.load(scene, mmap_mode='r'))


def cli_rooms(tmp):
    """The synthetic rooms of the cli phases under ``tmp``, the ``--set``
    pairs that point the DA cfgs at them, and the rule's launches of each
    step kind on the flagship's parameter shapes."""
    import numpy as np

    from doda_tpu_torch.config import CfgNode, cfg_from_yaml_file
    from doda_tpu_torch.models import model_fn
    from doda_tpu_torch.tools import make_synth_data
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    make_synth_data.make_front3d(str(tmp), 6, 0, CLI_POINTS, rng)
    make_synth_data.make_scannet(str(tmp), 6, 4, CLI_POINTS, rng)
    make_synth_data.make_s3dis(str(tmp), 0, 2, CLI_POINTS, rng)
    log('cli_data', seconds=time.perf_counter() - t0,
        rooms={'front3d_train': 6, 'scannet_train': 6, 'scannet_val': 4,
               's3dis_val': 2}, points_per_room=CLI_POINTS)
    flagship = model_fn.build_model(
        cfg_from_yaml_file(CFG_DA, CfgNode()), device='cpu')
    fwd, bwd = flagship.subm_routes(), flagship.subm_routes(True)
    assert fwd == {'sm': 0, 'fused': 52, 'assembled': 1}, fwd
    return {
        'tmp': tmp,
        'roots': ['DATA_CONFIG.DATA_ROOT', str(tmp / '3dfront/density1250'),
                  'DATA_CONFIG_TAR.DATA_ROOT', str(tmp / 'scannetv2'),
                  'DATA_CONFIG_TAR.DATA_SPLIT.training', 'train',
                  'DATA_CONFIG_TAR.DATA_SPLIT.validation', 'val',
                  'DATA_CONFIG_TAR.DATA_SPLIT.test', 'val'],
        's3dis': ['DATA_CONFIG.DATA_ROOT', str(tmp / '3dfront/density1250'),
                  'DATA_CONFIG_TAR.DATA_ROOT',
                  str(tmp / 's3dis' / 'trainval_fullarea')],
        'per_call': {'eval': fwd,
                     'train': {k: fwd[k] + bwd[k] for k in fwd},
                     'st': {k: 2 * (fwd[k] + bwd[k]) for k in fwd}}}


def cli_run(ctx, cli, argv, sets=None, tag='chip_smoke'):
    """One CLI run in process; every step's launches, read from the
    counters around the call, must be the rule's. Returns the run's
    result, steps and launches by kind, seconds, peak memory and the
    host arguments of each kind's first step."""
    from doda_tpu_torch import config
    from doda_tpu_torch.models import model_fn
    calls, first = {}, {}

    def counted(kind, factory):
        def make(*a, **k):
            step = factory(*a, **k)

            def call(*sa, **sk):
                first.setdefault(kind, (sa, sk))
                before = _cli_launches()
                out = step(*sa, **sk)
                after = _cli_launches()
                calls.setdefault(kind, []).append(
                    {r: after[r] - before[r] for r in after})
                return out
            return call
        return make

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _cli_reset()                                 # the counted path
    t0 = time.perf_counter()
    with patch.object(model_fn, 'make_eval_step', counted(
            'eval', model_fn.make_eval_step)), \
            patch.object(model_fn, 'make_train_step', counted(
                'train', model_fn.make_train_step)), \
            patch.object(model_fn, 'make_st_step', counted(
                'st', model_fn.make_st_step)), \
            patch.object(config, 'ROOT_DIR', ctx['tmp']):
        result = cli.main([*argv, '--workers', '4', '--extra_tag', tag,
                           '--set', *(ctx['roots'] if sets is None
                                      else sets)])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    total = _cli_launches()
    for kind, seen in calls.items():
        for got in seen:
            assert got == ctx['per_call'][kind], (tag, kind, got)
    assert sum(sum(c.values()) for v in calls.values()
               for c in v) == sum(total.values()), (tag, total)
    return {'result': result, 'steps': {k: len(v) for k, v in calls.items()},
            'launches': total, 'seconds': seconds, 'first': first,
            'peak': torch.cuda.max_memory_allocated() / 2 ** 30}


def cli_report(ctx, name, card, run, timing, **kv):
    """Log one CLI run's readings; returns them."""
    out = run['result']['output_dir']
    n = max(timing.get('steps', timing.get('batches', 1)), 1)
    readings = dict(
        run=name, card=card, launches_per_step={
            kind: ctx['per_call'][kind] for kind in run['steps']},
        steps=run['steps'], launches=run['launches'],
        seconds=run['seconds'],
        scenes_per_sec=timing['scenes'] / timing['batch_s'],
        step_ms=1e3 * timing['step_s'] / n,
        data_wait_ms_per_batch=1e3 * timing['data_s'] / n,
        data_wait_share=timing['data_s'] / timing['batch_s'],
        peak_memory_gib=run['peak'], files=sorted(
            str(p.relative_to(out)) for p in out.rglob('*') if p.is_file()),
        **kv)
    log('cli', **readings)
    return readings


def _eval_miou(cfg, model, split='test'):
    """The mIoU of ``make_eval_step`` over the batches of the cfg's
    target split, as ``tools/test.py`` batches them."""
    from doda_tpu_torch.data import build_dataloader
    from doda_tpu_torch.models import model_fn
    from doda_tpu_torch.models.unet import default_brick_caps
    from doda_tpu_torch.utils.metrics import calc_metrics
    step = model_fn.make_eval_step(cfg, model, default_brick_caps(
        cfg.DATA_CONFIG_TAR.DATA_PROCESSOR.brick_cap, model.num_levels))
    _, loader, _ = build_dataloader(
        cfg.DATA_CONFIG_TAR, cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU,
        split=split, training=False)
    assert len(loader.dataset) % cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU == 0
    hist, first = [0, 0, 0], None
    for batch in loader:
        first = first or batch
        o = step(batch.points)
        hist = [h + o[k].cpu().numpy() for h, k in
                zip(hist, ('intersection', 'union', 'target'))]
    return calc_metrics(*hist)[0], first


def phase_cli(card, ctx):
    """The port's three CLIs in process, at full width and depth and the
    cfgs' batch size, on synthetic rooms of ~150k points: train on
    3D-FRONT-format rooms, test on ScanNet- and S3DIS-format rooms (the
    latter through the 1-NN broadcast), self-training from the trained
    checkpoint. Every step's launches come from the counters. Returns each
    run's launches by route and readings, and the trained checkpoint."""
    from doda_tpu_torch.models import model_fn
    from doda_tpu_torch.tools import st, test, train
    from doda_tpu_torch.utils import checkpoint
    import numpy as np
    tmp = ctx['tmp']
    launches, readings = {}, {}
    run = cli_run(ctx, train, ['--cfg_file', CFG_DA, '--epochs', '1',
                               '--manual_seed', '0'])
    out = run['result']['output_dir']
    ep = run['result']['epochs'][0]
    assert ep['losses_finite'] and run['steps'] == {'train': 1, 'eval': 1}, (
        ep, run['steps'])
    ckpt = out / 'ckpt' / 'train_epoch_1'
    assert ckpt.is_file() and (out / 'spconv.yaml').is_file()
    assert len(list(out.glob('log_train_*.txt'))) == 1
    readings['train'] = cli_report(ctx, 'train', card, run, ep,
                                   train_miou=ep['miou'],
                                   val_miou=ep['miou_val'])
    launches['train'] = run['launches']

    run = cli_run(ctx, test, ['--cfg_file', CFG_DA, '--ckpt', str(ckpt),
                              '--save_to_file'])
    result = run['result']
    out = result['output_dir']
    for scene in sorted((tmp / 'scannetv2' / 'val').glob('*.pth')):
        dump = out / 'txt' / f'{scene.name[:-4]}.txt'
        assert _lines(dump) == _points(scene), dump   # one per point
    # the same checkpoint through make_eval_step on the same batches
    _, cfg = test.parse_config(['--cfg_file', CFG_DA, '--set',
                                *ctx['roots']])
    model = model_fn.build_model(cfg)
    checkpoint.load_params_from_pretrain(ckpt, model, strict=True)
    miou_step, _ = _eval_miou(cfg, model)
    assert abs(miou_step - result['miou']) <= 1e-4, (
        miou_step, result['miou'])
    assert run['steps'] == {'eval': 1}, run['steps']
    readings['test'] = cli_report(ctx, 'test', card, run, result,
                                  miou=result['miou'],
                                  miou_make_eval_step=miou_step,
                                  allacc=result['allacc'])
    launches['test'] = run['launches']
    del model

    run = cli_run(ctx, test, ['--cfg_file',
                              'cfgs/da_front3d_s3dis/spconv.yaml', '--ckpt',
                              str(ckpt), '--save_to_file'],
                  sets=ctx['s3dis'])
    result = run['result']
    out = result['output_dir']
    rooms = sorted((tmp / 's3dis' / 'trainval_fullarea').glob(
        'Area_5_*.npy'))
    for room in rooms:          # broadcast to every full-res point
        assert _lines(out / 'txt' / f'{room.stem}.txt') == _points(room), \
            room
    assert run['steps'] == {'eval': 1}, run['steps']
    readings['test_s3dis'] = cli_report(ctx, 'test_s3dis', card, run, result,
                                        miou=result['miou'],
                                        downsampling_scale=4)
    launches['test_s3dis'] = run['launches']

    run = cli_run(ctx, st, ['--cfg_file', CFG_ST, '--weight', str(ckpt),
                            '--epochs', '1', '--manual_seed', '0',
                            '--preserve_pseudo_labels'])
    result = run['result']
    out = result['output_dir']
    ep = result['epochs'][0]
    assert ep['losses_finite'] and ep['pseudo_labels_generated'], ep
    assert run['steps']['st'] == 1, run['steps']
    assert (out / 'ckpt' / 'train_epoch_1').is_file()
    assert (out / 'split_sampler.pkl').is_file()
    pl = out / 'pseudo_labels'
    assert (pl / 'done.txt').is_file() and (pl / 'class_ratio.txt').is_file()
    for scene in sorted((tmp / 'scannetv2' / 'train').glob('*.pth')):
        labels = pl / 'npy' / f'{scene.name[:-4]}.npy'
        assert len(np.load(labels)) == _points(scene), labels
    readings['st'] = cli_report(ctx, 'st', card, run, ep,
                                miou_initial=result['miou_initial'],
                                val_miou=ep['miou_val'],
                                src_miou=ep['miou_x'], tar_miou=ep['miou_u'],
                                pseudo_label_seconds=ep['pseudo_s'])
    launches['st'] = run['launches']
    return launches, readings, ckpt


def reference_state_dict(cfg, seed):
    """A reference-format ``state_dict`` (ref model/unet.py:15-69,
    model/unet_block.py:10-100: its key names and (k,k,k,Ci,Co) layouts)
    for the net of ``cfg``, with seeded weights scaled by fan-in and
    statistics away from identity."""
    import numpy as np
    bk = cfg.MODEL.BACKBONE
    mid, reps, levels = bk.mid_channel, bk.block_reps, bk.get('num_levels',
                                                              7)
    rng = np.random.default_rng(seed)
    sd = {}

    def t(*shape, scale=1.0):
        return torch.tensor(rng.normal(0, scale, shape).astype(np.float32))

    def conv(key, k, cin, cout):
        sd[key] = t(k, k, k, cin, cout, scale=(k ** 3 * cin) ** -0.5)

    def norm(prefix, c):
        sd[prefix + '.weight'] = 1 + t(c, scale=0.2)
        sd[prefix + '.bias'] = t(c, scale=0.2)
        sd[prefix + '.running_mean'] = t(c, scale=0.2)
        sd[prefix + '.running_var'] = torch.tensor(
            rng.uniform(0.5, 1.5, c).astype(np.float32))
        sd[prefix + '.num_batches_tracked'] = torch.tensor(0)

    def block(prefix, cin, cout):
        if cin != cout:
            conv(prefix + '.i_branch.0.weight', 1, cin, cout)
        norm(prefix + '.conv_branch.0', cin)
        conv(prefix + '.conv_branch.2.weight', 3, cin, cout)
        norm(prefix + '.conv_branch.3', cout)
        conv(prefix + '.conv_branch.5.weight', 3, cout, cout)

    def ublock(prefix, planes):
        p = planes[0]
        for i in range(reps):
            block(f'{prefix}.blocks.block{i}', p, p)
        if len(planes) > 1:
            norm(f'{prefix}.conv.0', p)
            conv(f'{prefix}.conv.2.weight', 2, p, planes[1])
            ublock(f'{prefix}.u', planes[1:])
            norm(f'{prefix}.deconv.0', planes[1])
            conv(f'{prefix}.deconv.2.weight', 2, planes[1], p)
            for i in range(reps):
                block(f'{prefix}.blocks_tail.block{i}',
                      2 * p if i == 0 else p, p)

    conv('input_conv.0.weight', 3, bk.in_channel, mid)
    ublock('unet', [mid * (i + 1) for i in range(levels)])
    norm('output_layer.0', mid)
    n_classes = cfg.COMMON_CLASSES.n_classes
    sd['linear.weight'] = t(n_classes, mid, scale=mid ** -0.5)
    sd['linear.bias'] = t(n_classes, scale=0.1)
    return sd


def phase_import(card, ctx):
    """A reference ``.pth`` of the flagship, converted into the JAX
    package's format by the port's converter, evaluated by
    ``tools/test.py --ckpt`` on the ScanNet rooms: launches, and the mIoU
    and one batch's float32 logits equal to those of the same tree loaded
    through ``params_from_jax``. Returns the run's launches."""
    from doda_tpu_torch.config import CfgNode, cfg_from_yaml_file
    from doda_tpu_torch.models import model_fn
    from doda_tpu_torch.models.unet import (build_level_plan,
                                            default_brick_caps)
    from doda_tpu_torch.tools import convert_torch_ckpt, test
    from doda_tpu_torch.utils import checkpoint, flax_msgpack
    from doda_tpu_torch.utils.convert import params_from_jax
    from doda_tpu_torch.utils.device import deterministic
    t0 = time.perf_counter()
    tmp = ctx['tmp']
    src, dst = tmp / 'reference.pth', tmp / 'converted'
    sd = reference_state_dict(cfg_from_yaml_file(CFG_DA, CfgNode()), seed=3)
    torch.save({'epoch': 12, 'state_dict': {'module.' + k: v
                                            for k, v in sd.items()},
                'metric': 0.5, 'commit_id': 'ref0001'}, src)
    convert_torch_ckpt.main(['--src', str(src), '--dst', str(dst),
                             '--cfg_file', CFG_DA])
    blob = dst.read_bytes()
    tree = flax_msgpack.restore(blob[8 + int.from_bytes(blob[:8],
                                                        'little'):])
    assert sorted(tree) == ['batch_stats', 'params'], sorted(tree)
    assert checkpoint.load_metric_from_ckpt(dst) == (0.5, 12)

    # both evaluations take the point -> cell means with deterministic
    # algorithms (index_add_'s atomics would vary the logits from run to
    # run), so that their mIoUs can be held equal exactly
    with deterministic():
        run = cli_run(ctx, test, ['--cfg_file', CFG_DA, '--ckpt', str(dst)],
                      tag='chip_smoke_import')
    result = run['result']
    assert run['steps'] == {'eval': 1}, run['steps']
    _, cfg = test.parse_config(['--cfg_file', CFG_DA, '--set',
                                *ctx['roots']])
    model = model_fn.build_model(cfg)
    model.load_state_dict(params_from_jax(tree['params'],
                                          tree['batch_stats']), strict=True)
    with deterministic():
        miou_tree, batch = _eval_miou(cfg, model)
    assert miou_tree == result['miou'], (miou_tree, result['miou'])
    # one batch's float32 logits, loaded both ways
    b_caps = default_brick_caps(cfg.DATA_CONFIG_TAR.DATA_PROCESSOR.brick_cap,
                                model.num_levels)
    points = batch.points.to('cuda')
    plan = build_level_plan(points.coords, points.valid, b_caps)
    logits = []
    for load in ('file', 'tree'):
        m = model_fn.build_model(cfg, dtype=torch.float32)
        if load == 'file':
            checkpoint.load_params_from_pretrain(dst, m, strict=True)
        else:
            m.load_state_dict(params_from_jax(tree['params'],
                                              tree['batch_stats']))
        with torch.no_grad(), deterministic():
            logits.append(m(model_fn.model_input(cfg, points), plan))
    assert torch.isfinite(logits[0]).all()
    assert torch.equal(logits[0], logits[1])
    cli_report(ctx, 'import_test', card, run, result, miou=result['miou'],
               miou_params_from_jax=miou_tree, f32_logits_bit_equal=True,
               converted_bytes=len(blob),
               phase_seconds=time.perf_counter() - t0)
    return {'import_test': run['launches']}


def _audit(batch, cap, num_levels):
    """``check_brick_capacity``'s count of a device batch: the worst
    scene's bricks at each level and the levels that drop some."""
    from types import SimpleNamespace

    from doda_tpu_torch.data.dataset import Dataset
    seen = {'over': []}

    class Log:
        def info(self, fmt, util):
            seen['util'] = util

        def warning(self, fmt, lvl, w, c, *rest):
            seen['over'].append((lvl, w, c))

    Dataset.check_brick_capacity(None, SimpleNamespace(points=batch.to(
        'cpu')), cap, Log(), num_levels=num_levels)
    return seen


def phase_device_aug(card, ctx, ckpt, host):
    """``train`` and ``st`` with ``DATA_AUG.device`` on, one step each,
    beside phase cli's host-path readings (``host``); ``device_augment``
    on the card against the CPU on the same CPU draws; the brick audit of
    each step's augmented batch. Returns the runs' launches."""
    from doda_tpu_torch.data import device_aug
    from doda_tpu_torch.models import model_fn
    from doda_tpu_torch.tools import st, train
    t0 = time.perf_counter()
    launches, readings, batches = {}, {}, {}
    run = cli_run(ctx, train, ['--cfg_file', CFG_DA, '--epochs', '1',
                               '--manual_seed', '0'],
                  sets=ctx['roots'] + DEVICE_AUG, tag='chip_smoke_device_aug')
    ep = run['result']['epochs'][0]
    assert ep['losses_finite'] and run['steps'] == {'train': 1, 'eval': 1}
    (points, _lr, _dom), kw = run['first']['train']
    batches['train'] = (points, kw['step'])
    readings['train'] = cli_report(
        ctx, 'train_device_aug', card, run, ep, host_path=host['train'])
    launches['train_device_aug'] = run['launches']

    run = cli_run(ctx, st, ['--cfg_file', CFG_ST, '--weight', str(ckpt),
                            '--epochs', '1', '--manual_seed', '0'],
                  sets=ctx['roots'] + DEVICE_AUG, tag='chip_smoke_device_aug')
    ep = run['result']['epochs'][0]
    assert ep['losses_finite'] and run['steps']['st'] == 1, (ep, run['steps'])
    (src, tar, *_), kw = run['first']['st']
    batches['st_source'] = (src, 2 * kw['step'])
    batches['st_target'] = (tar, 2 * kw['step'] + 1)
    readings['st'] = cli_report(ctx, 'st_device_aug', card, run, ep,
                                host_path=host['st'])
    launches['st_device_aug'] = run['launches']

    # the augmented batches of the steps, drawn again as the steps drew
    # them, through the brick audit at the caps each step's plan uses
    # (train: the source cfg's; st: the target cfg's, for both terms)
    cfgs = {c: train.parse_config(['--cfg_file', c, '--set', *ctx['roots'],
                                   *DEVICE_AUG])[1] for c in (CFG_DA, CFG_ST)}
    da, stc = cfgs[CFG_DA], cfgs[CFG_ST]
    plans = {'train': (da, device_aug.aug_fn_for(da.DATA_CONFIG),
                       da.DATA_CONFIG.DATA_PROCESSOR.brick_cap),
             'st_source': (stc, device_aug.aug_fn_for(stc.DATA_CONFIG),
                           stc.DATA_CONFIG_TAR.DATA_PROCESSOR.brick_cap),
             'st_target': (stc, device_aug.aug_fn_for(
                 stc.DATA_CONFIG_TAR, ['elastic', 'crop', 'shuffle']),
                 stc.DATA_CONFIG_TAR.DATA_PROCESSOR.brick_cap)}
    audits, aug_ms = {}, {}
    for name, (points, key) in batches.items():
        cfg, aug, cap = plans[name]
        points = points.to('cuda')
        out = model_fn._augment(aug, points, int(cfg.get('AUG_SEED', 0)),
                                key)
        seen = _audit(out, cap, cfg.MODEL.BACKBONE.get('num_levels', 7))
        assert not seen['over'], (name, seen['over'])
        audits[name] = seen['util']
        # what the augmentation adds to a step on the card: draws included
        aug_ms[name] = cuda_ms(lambda: model_fn._augment(
            aug, points, int(cfg.get('AUG_SEED', 0)), key), 5)

    # device_augment on the card against the CPU on the same CPU draws
    ac = da.DATA_CONFIG.DATA_AUG
    scale = da.DATA_CONFIG.DATA_PROCESSOR.voxel_scale
    points = batches['train'][0]
    draws = device_aug.make_draws(ac, scale, points.valid.shape[0],
                                  torch.Generator().manual_seed(0))
    cpu = device_aug.device_augment(ac, scale, points, draws)
    positions, _ = device_aug.augmented_positions(ac, scale, points, draws)
    card_draws = {k: [n.cuda() for n in v] if isinstance(v, list)
                  else v.cuda() for k, v in draws.items()}
    gpu = device_aug.device_augment(ac, scale, points.to('cuda'), card_draws)
    feats_err = (gpu.feats.cpu() - cpu.feats).abs().max().item()
    assert feats_err <= 1e-5, feats_err
    frac = (positions - positions.round()).abs()[points.valid].numpy()
    diff = (gpu.coords.cpu().long() - cpu.coords.long()).abs()
    assert (diff[~points.valid] == 0).all()
    diff = diff[points.valid].numpy()
    assert (diff[frac > 1e-4] == 0).all() and diff.max() <= 1, diff.max()
    log('device_aug', card=card, readings=readings, brick_audit=audits,
        augment_ms_per_batch=aug_ms,
        device_vs_cpu={'feats_max_abs_err': feats_err,
                       'coords_floor_flips': int((diff > 0).sum()),
                       'coords_in_band': int((frac <= 1e-4).sum()),
                       'points': int(points.valid.sum())},
        elastic_grids=[d for _, _, d in device_aug.elastic_pairs(ac, scale)],
        phase_seconds=time.perf_counter() - t0)
    return launches


def phase_ddp(card, ctx, cfg, b_caps):
    """Two gloo ranks spawned on the one card, one bench scene each,
    against one process on both, float32 on the kernel path, a train step
    and an st step with soft labels (the bounds of phase train's float32
    check); then ``tools/train.py --launcher pytorch`` at WORLD_SIZE=1 for
    one step. Returns that run's launches."""
    import os

    from doda_tpu_torch.models import model_fn
    from doda_tpu_torch.tools import train
    from doda_tpu_torch.utils import optim, synth
    # the check lives with the tests, not in the package; the ranks that
    # it spawns inherit this path
    sys.path.insert(0, str(Path(__file__).resolve().parent / 'tests'))
    import _torch_equivalence as equivalence
    t0 = time.perf_counter()
    src, tar = (synth.make_batch(seed=s, batch=2) for s in (1, 2))
    # the ranks must hold different point counts, or a per-rank loss mean
    # and per-rank statistics would pass for the whole batch's
    src.valid[1, 100_000:] = False
    tar.valid[0, 120_000:] = False
    for batch in (src, tar):
        synth.capacity_audit(batch, b_caps)
    sd = {k: v.cpu() for k, v in synth.seeded_state_dict(
        model_fn.build_model(cfg), seed=0).items()}
    lr = optim.make_lr_fn(cfg.OPTIMIZATION, cfg.OPTIMIZATION.NUM_EPOCHS,
                          100)(1, 0)
    torch.cuda.empty_cache()
    got = equivalence.compare(cfg, sd, src, tar, b_caps, device='cuda',
                              dtype=torch.float32, lr=lr)
    for step in ('train', 'st'):
        assert got[f'{step}_loss_rel'] <= 1e-4, got
        assert got[f'{step}_grad'] <= 1e-3, got
        assert got[f'{step}_weights'] <= 1e-3, got
        assert got[f'{step}_stats'] <= 1e-3, got
        assert got[f'{step}_ranks_equal'] is True, (step, got)
    assert got['train_hist_equal'] is True, got
    # the st step's predictions come from batch statistics that the card
    # sums in another order over two ranks: an argmax within rounding of
    # a tie may flip a point. Its histograms may differ by 1e-4 of the
    # target's points (27 of 270k)
    tar_points = sum(got['tar_points_per_rank'])
    assert got['st_hist_max_diff'] <= 1e-4 * tar_points, got
    for key in ('eval_preds_equal', 'eval_hist_equal', 'gathered_equal'):
        assert got[key] is True, (key, got)
    for key in ('points_per_rank', 'tar_points_per_rank'):
        assert got[key][0] != got[key][1], got
    ranks_s = time.perf_counter() - t0

    with patch.dict(os.environ, {'WORLD_SIZE': '1'}):
        run = cli_run(ctx, train, ['--cfg_file', CFG_DA, '--epochs', '1',
                                   '--launcher', 'pytorch'],
                      sets=ctx['roots'] + ['EVALUATION.evaluate', 'False'],
                      tag='chip_smoke_launcher')
    ep = run['result']['epochs'][0]
    assert ep['losses_finite'] and run['steps'] == {'train': 1}, run['steps']
    log('ddp', card=card, backend='gloo', world=2, **got,
        two_ranks_seconds=ranks_s, launcher_world_1=dict(
            steps=run['steps'], launches=run['launches'],
            step_ms=1e3 * ep['step_s'], seconds=run['seconds']),
        phase_seconds=time.perf_counter() - t0)
    return {'train_launcher_world_1': run['launches']}


def _bound(moved, ops):
    """The least time for the work, ms: bytes over the memory rate or
    operations over the bf16 peak, whichever is larger."""
    t_bytes, t_ops = moved / PEAK_BYTES * 1e3, ops / PEAK_BF16 * 1e3
    return {'bound_ms': max(t_bytes, t_ops),
            'bound_by': 'bytes' if t_bytes >= t_ops else 'operations'}


def time_k1(nbr, halo, cin, cout, g):
    """K1 in both versions on one level's real rulebook, bf16: the fused
    kernel, its plain version and bound; the plane gather alone; the
    assembled kernel on those planes with its plain version, bound and the
    cuDNN ``conv1d`` that computes the same function of the planes."""
    from doda_tpu_torch.ops import bricks2d
    from doda_tpu_torch.ops.banded_conv import (banded_conv,
                                                banded_conv_fused,
                                                banded_conv_fused_plain,
                                                banded_conv_plain,
                                                fused_smem_bytes)
    bf = torch.bfloat16
    rows = nbr.shape[0]
    x2 = torch.randn(rows, 64 * cin, device='cuda', generator=g).to(bf)
    w = (torch.randn(27, cin, cout, device='cuda', generator=g)
         / (27 * cin) ** 0.5).to(bf)

    out = banded_conv_fused(x2, nbr, w, bf)
    ref = banded_conv_fused_plain(x2, nbr, w, bf)
    err = _close(out, ref, True, 2e-2, 'banded_conv_fused at a timing shape')
    del ref
    fused_ms = cuda_ms(lambda: banded_conv_fused(x2, nbr, w, bf), 20)
    fused_plain_ms = cuda_ms(
        lambda: banded_conv_fused_plain(x2, nbr, w, bf), 3)
    # the taps this rulebook needs: a halo cell is read by as many (cell,
    # tap) pairs as its coordinates allow, and only present cells count
    per_axis = torch.tensor([1., 2., 3., 3., 2., 1.], device='cuda')
    reads = (per_axis[:, None, None] * per_axis[None, :, None]
             * per_axis[None, None, :]).reshape(216)
    present_reads = ((halo < rows * 64).float() @ reads).sum().item()
    needed = 2 * cin * cout * present_reads
    executed = 2 * rows * 64 * 27 * cin * cout
    moved = (x2.numel() + out.numel() + w.numel()) * 2 + nbr.numel() * 4
    fused = {'ms': fused_ms, 'plain_ms': fused_plain_ms,
             'max_abs_err': err, **_bound(moved, needed), 'bytes': moved,
             'flops': needed, 'executed_flops': executed,
             'dynamic_smem_bytes': fused_smem_bytes(cin, cout)}

    assembly_ms = cuda_ms(lambda: bricks2d._assemble_p6(x2, halo, bf), 10)
    rows6 = bricks2d._assemble_p6(x2, halo, bf)
    wb = bricks2d.banded_weights(w)
    weights_ms = cuda_ms(lambda: bricks2d.banded_weights(w), 10)
    old = banded_conv(rows6, wb, bf)
    vs_old = _close(out, old, True, 2e-2, 'fused vs assembled K1')
    ref = banded_conv_plain(rows6, wb, bf)
    err = _close(old, ref, True, 2e-2, 'banded_conv at a timing shape')
    del ref
    ms = cuda_ms(lambda: banded_conv(rows6, wb, bf), 20)
    plain_ms = cuda_ms(lambda: banded_conv_plain(rows6, wb, bf), 3)
    # one library call of the same function: conv1d over the 6 planes
    x = rows6.transpose(1, 2).contiguous()           # (B, 36cin, 6)
    wc = wb.permute(2, 1, 0).contiguous()            # (16cout, 36cin, 3)
    lib = torch.nn.functional.conv1d(x, wc)          # (B, 16cout, 4)
    lib_err = (lib.transpose(1, 2).reshape(rows, -1).float()
               - old.float()).abs().max().item()
    library_ms = cuda_ms(lambda: torch.nn.functional.conv1d(x, wc), 10)
    moved = (rows6.numel() + wb.numel() + old.numel()) * 2
    ops = 2 * rows * 4 * int((wb != 0).sum())        # the non-zero taps
    assembled = {'ms': ms, 'plain_ms': plain_ms, 'max_abs_err': err,
                 **_bound(moved, ops), 'bytes': moved, 'flops': ops,
                 'executed_flops': 2 * rows * 4 * wb.numel(),
                 'library_ms': library_ms, 'library_max_abs_err': lib_err}
    return {'shape': [rows, cin, cout], 'fused': fused,
            'assembly_ms': assembly_ms, 'banded_weights_ms': weights_ms,
            'assembled': assembled, 'fused_vs_assembled_max_abs_err': vs_old}


def time_k2(b, cin, cout, g):
    """K2 in both versions at (B, cin, cout), bf16, on random operands laid
    out as the path lays them (x contiguous, gyz/gxm/gxp column slices of
    one gathered buffer): the second version, its plain version and bound;
    the first version on ``sm_weights``. Every cell is present, so every
    tap is needed."""
    from doda_tpu_torch.ops import bricks2d
    from doda_tpu_torch.ops.banded_conv_sm import (banded_conv_sm,
                                                   banded_conv_sm_taps,
                                                   banded_conv_sm_taps_plain,
                                                   sm_taps_smem_bytes)
    bf = torch.bfloat16
    x = torch.randn(b, 64 * cin, device='cuda', generator=g).to(bf)
    buf = torch.randn(b, 176 * cin, device='cuda', generator=g).to(bf)
    ops = (x, buf[:, :96 * cin], buf[:, 96 * cin:136 * cin],
           buf[:, 136 * cin:])
    w = (torch.randn(27, cin, cout, device='cuda', generator=g)
         / (27 * cin) ** 0.5).to(bf)
    out = banded_conv_sm_taps(*ops, w, bf)
    ref = banded_conv_sm_taps_plain(*ops, w, bf)
    err = _close(out, ref, True, 2e-2, f'banded_conv_sm_taps at {b}x{cin}')
    del ref
    ms = cuda_ms(lambda: banded_conv_sm_taps(*ops, w, bf), 20)
    plain_ms = cuda_ms(lambda: banded_conv_sm_taps_plain(*ops, w, bf), 3)
    # bytes: the 216 halo cells a brick needs (x 64, gyz 80, gxm/gxp 36
    # each; no padding cell), the output and the raster weights, once
    moved = (b * 216 * cin + out.numel() + w.numel()) * 2
    flops = 2 * b * 64 * 27 * cin * cout
    taps = {'ms': ms, 'plain_ms': plain_ms, 'max_abs_err': err,
            **_bound(moved, flops), 'bytes': moved, 'flops': flops,
            'executed_flops': flops,
            'dynamic_smem_bytes': sm_taps_smem_bytes(cin)}
    wts = bricks2d.sm_weights(w)
    sm_weights_ms = cuda_ms(lambda: bricks2d.sm_weights(w), 10)
    old = banded_conv_sm(*ops, *wts, bf)
    vs_old = _close(out, old, True, 2e-2, f'K2 second vs first at {b}x{cin}')
    old_ms = cuda_ms(lambda: banded_conv_sm(*ops, *wts, bf), 10)
    old_moved = (sum(t.numel() for t in ops + wts) + old.numel()) * 2
    first = {'ms': old_ms, 'sm_weights_ms': sm_weights_ms,
             'executed_flops': 2 * b * 4 * 120 * cin * 16 * cout,
             'bound_ms_of_its_operands': _bound(old_moved, flops)['bound_ms'],
             'second_vs_first_max_abs_err': vs_old}
    return {'shape': [b, cin, cout], 'taps': taps, 'first': first}


def phase_timing(levels, launches):
    """Each kernel at the level-0 bench shape, bf16, and at the level-1
    shape. ``launches`` maps a route to its (eval forward, train steps)
    counts, and 'sm_f32' to K2's first version's launches in the float32
    train step."""
    from doda_tpu_torch.ops import _build
    from doda_tpu_torch.utils import synth
    b, cin, cout = synth.BATCH * synth.BRICK_CAP, 16, 16
    g = torch.Generator(device='cuda').manual_seed(2)
    rows = []

    # K1: one row, both versions. The row's own numbers are the fused
    # version's, which runs 52 of the 53 convs of a forward; the assembled
    # version's stand under 'assembled'
    l0 = time_k1(levels[0].nbr, levels[0].halo, 16, 16, g)
    l1 = time_k1(levels[1].nbr, levels[1].halo, 32, 32, g)
    assert l0['shape'] == [b, cin, cout], l0['shape']
    for name, t in (('level 0', l0), ('level 1', l1)):
        log('timing', kernel='banded_conv', at=name, dtype='bfloat16', **t)
    assert l0['fused']['executed_flops'] <= 2.9e11
    fused_fwd, fused_train = launches['fused']
    old_fwd, old_train = launches['assembled']
    f0, a0 = l0['fused'], dict(l0['assembled'])
    a0.update(source='doda_tpu_torch/csrc/banded_conv.cu',
              launches=old_fwd + old_train, launches_eval_forward=old_fwd,
              launches_train_steps=old_train,
              **_build.resources('banded_conv'))
    rows.append({
        'name': 'banded_conv', 'route': 'cuda',
        'source': 'doda_tpu_torch/csrc/banded_conv_fused.cu',
        'replaces': 'doda_tpu/ops/pallas_banded.py:71',
        'launches': fused_fwd + fused_train,
        'launches_eval_forward': fused_fwd,
        'launches_train_steps': fused_train,
        'max_abs_err': f0['max_abs_err'], 'ms': f0['ms'],
        'plain_ms': f0['plain_ms'], 'bound_ms': f0['bound_ms'],
        'bound_by': f0['bound_by'],
        # no single PyTorch call computes the conv from (x2, nbr, w); the
        # conv1d of the assembled planes stands under 'assembled'
        'library_ms': None,
        'fused_ms': f0['ms'], 'fused_bound_ms': f0['bound_ms'],
        'assembly_ms': l0['assembly_ms'],
        'executed_flops': f0['executed_flops'],
        'dynamic_smem_bytes': f0['dynamic_smem_bytes'],
        **_build.resources('banded_conv_fused'),
        'assembled': a0,
        'level1': {'shape': l1['shape'], 'fused_ms': l1['fused']['ms'],
                   'fused_bound_ms': l1['fused']['bound_ms'],
                   'fused_bound_by': l1['fused']['bound_by'],
                   'fused_plain_ms': l1['fused']['plain_ms'],
                   'assembly_ms': l1['assembly_ms'],
                   'assembled_ms': l1['assembled']['ms'],
                   'assembled_bound_ms': l1['assembled']['bound_ms'],
                   'library_ms': l1['assembled']['library_ms']}})

    # K2: one row, both versions. The row's own numbers are the second
    # version's, which runs every bf16 'sm' conv; the first version's, which
    # runs the float32 ones, stand under 'first_version'
    k0 = time_k2(b, 16, 16, g)
    k1 = time_k2(levels[1].nbr.shape[0], 32, 32, g)
    for name, t in (('level 0', k0), ('level 1', k1)):
        log('timing', kernel='banded_conv_sm', at=name, dtype='bfloat16', **t)
    assert k0['taps']['executed_flops'] == k0['taps']['flops']
    fwd, train = launches['sm']
    t0 = k0['taps']
    rows.append({
        'name': 'banded_conv_sm', 'route': 'cuda',
        'source': 'doda_tpu_torch/csrc/banded_conv_sm_taps.cu',
        'replaces': 'doda_tpu/ops/pallas_sm.py:83',
        'launches': fwd + train, 'launches_eval_forward': fwd,
        'launches_train_steps': train, 'max_abs_err': t0['max_abs_err'],
        'ms': t0['ms'], 'plain_ms': t0['plain_ms'],
        'bound_ms': t0['bound_ms'], 'bound_by': t0['bound_by'],
        # no single PyTorch call computes it from these operands
        'library_ms': None,
        'executed_flops': t0['executed_flops'],
        'dynamic_smem_bytes': t0['dynamic_smem_bytes'],
        **_build.resources('banded_conv_sm_taps'),
        'first_version': {**k0['first'],
                          'source': 'doda_tpu_torch/csrc/banded_conv_sm.cu',
                          'launches_f32_train_step': launches['sm_f32'],
                          **_build.resources('banded_conv_sm')},
        'level1': {'shape': k1['shape'], 'ms': k1['taps']['ms'],
                   'bound_ms': k1['taps']['bound_ms'],
                   'bound_by': k1['taps']['bound_by'],
                   'plain_ms': k1['taps']['plain_ms'],
                   'first_version_ms': k1['first']['ms']}})
    return rows


def main():
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is false',
              file=sys.stderr)
        return 1
    from doda_tpu_torch.config import CfgNode, cfg_from_yaml_file
    from doda_tpu_torch.models.unet import default_brick_caps
    from doda_tpu_torch.utils import synth

    start = time.perf_counter()
    name, card = phase_device()
    phase_build()

    cfg = cfg_from_yaml_file('cfgs/scannet/spconv.yaml', CfgNode())
    b_caps = default_brick_caps(synth.BRICK_CAP, cfg.MODEL.BACKBONE.get(
        'num_levels', 7))
    assert b_caps == (40960, 16384, 3328, 768, 256, 128, 128), b_caps
    batch = synth.make_batch(seed=0)
    synth.capacity_audit(batch, b_caps)
    levels = phase_plan(batch, b_caps)
    phase_kernels(levels)

    fwd = phase_forward(cfg, batch, b_caps, card)
    del batch
    train, f32_sm = phase_train(cfg, b_caps, card)
    tmp = Path(tempfile.mkdtemp(prefix='chip_smoke_cli_'))
    try:
        ctx = cli_rooms(tmp)
        cli, host, ckpt = phase_cli(card, ctx)
        cli.update(phase_import(card, ctx))
        cli.update(phase_device_aug(card, ctx, ckpt, host))
        cli.update(phase_ddp(card, ctx, cfg, b_caps))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rows = phase_timing(levels, {**{k: (fwd[k], train[k]) for k in fwd},
                                 'sm_f32': f32_sm})
    # each CLI run's launches, counted in the cli phases, join each
    # kernel's
    for row, route in ((rows[0], 'fused'), (rows[0]['assembled'],
                                            'assembled'), (rows[1], 'sm')):
        row['launches_cli'] = {run: n[route] for run, n in cli.items()}
        row['launches'] += sum(row['launches_cli'].values())
    for r in rows:       # every kernel of the paths really ran on them
        assert r['launches'] > 0, r['name']
    assert rows[0]['assembled']['launches'] > 0
    assert rows[1]['first_version']['launches_f32_train_step'] > 0
    log('run', card=card, seconds=time.perf_counter() - start)
    print(json.dumps({'kernels': rows}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': name,
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
