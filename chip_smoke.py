#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on an NVIDIA GPU.

    python3 chip_smoke.py        # from the repo root, one card

Phases, each printing one line:
  1. device: the card's name, nvidia-smi's name and power limit; TF32 off
  2. build: every CUDA source of doda_tpu_torch/csrc, compiled with nvcc,
     and the host library of the data path (native/src/host_ops.cc, g++)
  3. plan: the bench batch's level plan on the card equals the CPU's
     kernels: each kernel's wrapper (K1's fused version
     banded_conv_fused, its narrow-input version banded_conv_narrow, its
     route for the other bf16 widths banded_conv_padded, its float32 kernel
     banded_conv_f32, and K2 banded_conv_sm_taps on bf16 and on float32
     operands; the deleted first version's banded_conv_sm raises on the
     card) on the card vs its plain version, at the main
     paths' widths (K2 also on row-strided operands, a
     ragged tile and no rows); the float32 kernels (K1 at every level's
     bench rulebook, the input conv 3 -> 16 and the widest conv 192 ->
     96, on synthetic rulebooks of ragged rows, odd widths and no rows;
     K2 at every shape the rule sends it) to float32 output within 1e-5 of
     max|ref| and bf16 within one bf16 step, bit-equal on a repeated call;
     the fused K1 on the real plan's
     rulebooks (levels 0, 1, 5, 6) and on a synthetic one (ragged rows,
     absent faces with present diagonals, no rows); the fused K1's
     prologue variant on the real rulebooks
     and occupancy (levels 0 and 1), a synthetic cin = 24 and no rows, with
     bias > 0 on half the channels, float32 output to 1e-4 of max|ref|;
     the narrow K1 at the bench input conv (the level-0 rulebook, 3 -> 16)
     and on synthetic rulebooks (cin 1 to 7, couts in several blocks,
     ragged rows, no rows), float32 output to 1e-4 of max|ref|, bf16 to
     the fused K1's bound; the route 'padded' (the fused or narrow K1 on
     operands zero-padded to multiples of 8 channels) at 12 -> 20, 20 ->
     12, 9 -> 5, 3 -> 12 and 40 -> 36 on the level-0 rulebook and on
     synthetic ones at sides 4 and 2, float32 output to 1e-4 of max|ref|,
     bf16 to 2e-2, bit-equal on a repeated call, counted apart from the
     kernels' own routes;
     one full subm conv on a real plan under either engine, forward, and
     its weight gradient in bf16 against float32 accumulation
  4. forward: the flagship net (cfgs/scannet/spconv.yaml: mid 16, 7
     levels, 2 blocks per level, 20 classes) with seeded random weights
     serves bench-shaped batches (4 scenes, ~150k points each) through
     ``make_eval_step``: launch counts (52 fused K1 + 1 narrow K1 + 1
     sorted point -> cell reduction, from the parameter shapes),
     scenes/sec, peak memory, float32 logits kernel vs plain path (53
     launches of K1's float32 kernel, no halo planes), bf16 predictions
     kernel vs plain path
  5. train: the same net in train mode with ``sm_max_cin=32`` (K2 at
     levels 0 and 1, the fused K1 elsewhere; a float32 step runs K2's and
     K1's float32 kernels) takes three bf16 SGD steps on 2 bench
     scenes through ``make_train_step``: launch counts of both kernels,
     forward and backward, against the selection rule; loss finite, every
     parameter and running statistic moved; steps/sec, trained scenes/sec,
     peak memory; then one float32 step on the kernel path against the
     plain path, loss and every gradient; and three bf16 steps under
     ``sm_max_cin=0`` (fused K1 everywhere) beside the ``sm_max_cin=32`` ones;
     repeat: with deterministic algorithms off, two runs of two steps each
     from one seeded state (bf16 and float32 train steps under
     ``sm_max_cin=32`` and an st step of the DA flagship at side 4, bf16
     train steps at side 2) leave the same bits in every loss, gradient,
     weight, running statistic and momentum; launches by route against
     the rule in every step (the sorted reduction 2 a train step, 4 an st
     step: the point -> cell reduction and the voxel -> point gather's
     backward)
  6. fuse_norm: the flagship with ``fuse_norm=True`` (the fused norm +
     ReLU engine: its 52 block convs on K1's prologue variant) against the
     same weights unfused: the eval forward on the 4 bench scenes (launches
     by route from the counters, scenes/sec, device time by bucket and
     kernel launches, both ways; float32 logits to 1e-3, bf16 predictions
     on >= 99% of points), a float32 train step on the pro_full routes
     (loss 1e-4 relative, gradients 1e-3 of their scale) and three bf16
     train steps both ways (launches, step time, peak memory, and the
     bf16 fused step's gradient error against the float32 unfused step, at
     most twice the bf16 unfused step's)
  7. engines: the JAX package's other subm-conv engines in the same
     flagship with the same weights (``conv_engine`` 'slab', 'xla',
     'oracle', and '2d' with ``deep_xla_rows=4096``: levels 3-6 on the
     concat-assembly engine), each against '2d': the bench scenes'
     occupied x-slices within ``default_slab_caps`` and the card's slab
     maps equal to the CPU's; the eval forward on the 4 bench scenes
     (float32 logits to 1e-3, bf16 predictions >= 99%, launches and engine
     calls against ``subm_routes``, ms in two turns, peak memory); a
     float32 train step on 2 scenes (loss 1e-4 relative, gradients 1e-3,
     ms, peak memory); K1 against references that share none of its
     halo tables at levels 0 and 1 of the real rulebooks (the oracle, the
     slab and concat-assembly convs against K1's float32 path, the fused
     K1 against the oracle, the voxel-level ``sparse.subm_conv`` on scene
     0's voxels; 1e-4 of max|ref|); cuDNN ``conv3d`` alone over the
     oracle's assembled bf16 halo (the library call of K1's function)
  8. brick: the brick side (``build_model(..., brick=2)``, the JAX
     package's ``DODA_BRICK=2``) against side 4 on the same weights: the
     bench batch's side-2 plan under ``synth.BRICK_CAPS_SIDE2`` (audited;
     each level's active voxels equal side 4's, integer for integer); every
     K1 kernel built for side 2 against its plain version on the side-2
     rulebooks (the fused K1 at every level, the prologue variant at
     levels 0-1, the narrow K1 at the input conv, the float32 K1 at every
     level, the input conv and the widest conv), timed beside its side-2
     bound, its plain version, cuDNN
     ``conv3d`` over the oracle's side-2 halo and the same kernel at side
     4; K2 at side 2 likewise (bf16 operands to float32, 1e-5 of
     max|ref|, and bf16, 1.6e-2; float32 operands, its float32 kernel, as
     phase kernels holds it, at every level's p -> p and the
     sm_max_cin=32 step's other shapes; bf16 timed at every level beside
     the side-2 fused K1 and K2 at side 4, float32 at level 0); the eval
     forward at both sides (bf16 predictions >= 99%, float32
     logits to 1e-3, launches against ``subm_routes``, scenes/sec in
     turns, device time by bucket, launches and peak), the ``fuse_norm``
     forward at side 2, one float32 train step (loss 1e-4 relative,
     gradients 1e-3) and three bf16 train steps at both sides; at side 2
     the same under ``sm_max_cin=32`` (K2): the bf16 forward (predictions
     >= 99% against ``sm_max_cin=0``), the float32 step against side 2's
     ``sm_max_cin=0`` step (loss 1e-4 relative, gradients 1e-3 of their
     scale) and three bf16 steps, launches against ``subm_routes``
  9. feats: the point -> cell reduction (the JAX package's default,
     ``DODA_FEATS`` unset) on the bench batch at sides 4 and 2, and at side
     4 the same kernel as the voxel -> point gather's backward (C = 16, a
     float32 cotangent, bf16 and float32 out): the sorted kernel
     (``cell_reduce_sorted``, csrc/cell_mean.cu) against its float64 twin
     (1e-6 of max|ref|, bf16 out one bf16 step) and at C = 3 the scatter
     route (``bricks.cell_feats_2d``, ``index_add_``, 1e-5), modes 3 and
     4, bit-equal on a repeated call, untouched cells zero, one launch and
     no fill a call (torch.profiler); its ms beside its bound, the first
     version's, the twin's, the scatter route's, ``index_reduce_``'s and
     ``index_select``'s autograd backward; the flagship's eval forward
     with deterministic algorithms off: two forwards bit-equal in float32
     and bf16, one launch a forward; device time by bucket, wall time in
     two pairs of turns of balanced order and the host time inside the
     call, beside the same forward with the scatter route patched in
 10. remat: the U-Net blocks' memory policies (``remat``) in the
     CLI-shaped train step (cfgs/da_front3d_scannet/spconv.yaml, batch 4
     of the bench rooms, bf16, ``sm_max_cin=0``), 'off', 'dots', 'all'
     and 'mix2' from one seeded state: each policy's first step
     (deterministic algorithms) against 'off''s (loss 1e-4 relative,
     gradients 1e-3 of their scale, running statistics 1e-3), launches by
     route of four steps against ``subm_routes`` with the replays ('dots'
     equal to 'off': no conv runs again), step ms and peak memory over two
     steps ('all' strictly below 'off'), device ms of a profiled step;
     an st step (DSNorm) and a ``fuse_norm`` step (the replay runs the
     prologue K1) under 'all' against 'off', each domain's running
     statistics moved once
 11. pointops: every point op, offset wrapper and voxelization function
     on the card against the CPU on one bench scene's points (FPS of 4,096
     of 150k points, kNN k = 16 of 4,096 queries among 16,384 points, a
     0.05 m voxel grid): integer outputs equal, floats to 1e-5
 12. cli: the port's three CLIs in process (``doda_tpu_torch.tools``), at
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
     written, with the output tree asserted; ``doda_tpu_torch.tools.
     visualize`` on one room with ``test``'s dumps (the .ply files' header,
     vertex count and colours)
 13. import: a seeded reference ``.pth`` of the DA flagship (the
     reference's key names and layouts), converted into the JAX package's
     format by ``doda_tpu_torch.tools.convert_torch_ckpt``, through
     ``test --ckpt`` on the 4 ScanNet rooms: launches, its mIoU equal to
     that of the same tree loaded through ``params_from_jax`` and run
     through ``make_eval_step``, one batch's float32 logits bit-equal
     between the two loads (all under deterministic algorithms)
 14. device_aug: ``train`` and ``st``, one step each, with
     ``DATA_AUG.device`` on: step ms, data wait and its share, peak memory,
     launches, beside phase cli's host-path readings; the augmentation's
     own device time; ``device_augment`` on the card against the CPU on
     the same CPU draws (feats to 1e-5, coords equal but for floor flips
     inside 1e-4 of an integer); the brick audit of each step's augmented
     batch
 15. ddp: two gloo ranks spawned on the one card, one bench scene each
     (150k and 100k points; st targets of 120k and 150k), against one
     process on both, float32 on the kernel path
     (``tests/_torch_equivalence.py``): for a train step and an st step
     with soft labels, the losses, histograms, gradients, updated weights
     and running statistics; eval predictions and histograms;
     ``all_gather_objects``; each rank's peak memory; then ``train
     --launcher pytorch`` at WORLD_SIZE=1 for one step
 16. timing: each kernel at the level-0 shape beside its bound, its plain
     version and, where there is one, a PyTorch library call computing the
     same function; K1's fused version, with the plane gather alone, and
     its prologue variant beside the unfused sequence it replaces (norm
     apply + ReLU + mask + K1), at the level-0 and level-1 shapes on the
     real rulebooks; the route 'padded' at 12 -> 20 and 20 -> 12 on the
     level-0 rulebook beside its bound at the true and the padded widths,
     the launched kernel alone, the padding copy alone and cuDNN conv3d
     over the oracle's halo; K1's narrow-input version at the input conv
     beside the fused K1 on x2 zero-padded to cin = 8 (padding pass
     included) and cuDNN conv3d over the oracle's halo; K2 at the level-0
     and level-1
     shapes in bf16 and float32; K1's float32 kernel at levels 0 and 1
     beside its float32 bound, its plain version, float32 cuDNN conv3d
     over the oracle's halo (TF32 off) and the bf16 fused K1 of the same
     call; K1's and K2's bf16 library time is phase engines' conv3d
Then a JSON line of the kernels (rows of their own for K1 and K2 in
float32, and for K2 in bf16 and both float32 kernels at side 2, from
phase brick, and for the sorted point -> cell reduction, from phase
feats) and, last, {"ok": true, "device": ...}.
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
        ptxas={n: _build.kernel_resources(n) for n in names})


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
# (level, cin, cout) of the fused K1's checks on the bench rulebooks, in
# both variants: a level's block conv and its 2p -> p tail at levels 0 and
# 1, and the deepest block and tail, whose weights are streamed a chunk at a
# time in tiles of TB = 8 bricks
K1_BENCH_SHAPES = ((0, 16, 16), (0, 32, 16), (1, 32, 32), (1, 64, 32),
                   (6, 112, 112), (5, 192, 96))
# (B, cin, cout) of the K2 checks: every shape the rule can send it,
# ragged B included
K2_SHAPES = ((4099, 16, 16), (4096, 32, 16), (2048, 16, 32), (2048, 32, 32),
             (1000, 32, 64), (512, 112, 112))
# the float32 kernels (K1's banded_conv_f32, K2's sm_taps_f32), (output
# dtype, tolerance relative to max|ref|): float32 output, float32 FMAs
# summed in another order than the plain version's matmuls; bf16 output,
# one rounding of the result (at most one bf16 step, 2^-7 of max|ref|)
F32_CHECKS = ((torch.float32, 1e-5), (torch.bfloat16, 2.0 ** -7))
# (level, cin, cout) of the float32 K1's checks on the bench rulebooks (at
# side 4 in phase kernels, side 2 in phase brick): every level's block
# conv p -> p, the 2p -> p tails of levels 0 and 1, the dx of the level-0
# tail (16 -> 32), the input conv 3 -> 16 and the widest conv 192 -> 96
F32_K1_SHAPES = tuple((lvl, 16 * (lvl + 1), 16 * (lvl + 1))
                      for lvl in range(7)) + (
    (0, 32, 16), (0, 16, 32), (1, 64, 32), (0, 3, 16), (5, 192, 96))


def check_f32(worst, key, fn, ref_fn):
    """A float32 kernel call ``fn(out_dtype)`` against its plain version
    ``ref_fn(out_dtype)`` (``F32_CHECKS``), and bit-equal on a repeated
    call (a fixed order of summation, no atomics)."""
    for dt, bound in F32_CHECKS:
        got = fn(dt)
        torch.cuda.synchronize()
        ref = ref_fn(torch.float32)
        worst[f'{key}/{str(dt)[6:]}'] = _close(got, ref, True, bound,
                                               f'{key} {dt}')
        again = fn(dt)
        torch.cuda.synchronize()
        assert torch.equal(got, again), f'{key} {dt}: not bit-equal again'
    return got


def plain_path():
    """Context in which every kernel wrapper of the conv engine, and the
    sorted point -> cell reduction, is its plain PyTorch version."""
    from contextlib import ExitStack
    from doda_tpu_torch.models import unet
    from doda_tpu_torch.ops import bricks2d
    from doda_tpu_torch.ops.banded_conv import banded_conv_fused_plain
    from doda_tpu_torch.ops.banded_conv_sm import banded_conv_sm_taps_plain
    from doda_tpu_torch.ops.cell_mean import cell_reduce_sorted_plain
    stack = ExitStack()
    for name, fn in (('banded_conv_padded', banded_conv_fused_plain),
                     ('banded_conv_fused', banded_conv_fused_plain),
                     ('banded_conv_narrow', banded_conv_fused_plain),
                     ('banded_conv_f32', banded_conv_fused_plain),
                     ('banded_conv_sm_taps', banded_conv_sm_taps_plain)):
        stack.enter_context(patch.object(bricks2d, name, fn))
    stack.enter_context(patch.object(unet, 'cell_reduce_sorted',
                                     cell_reduce_sorted_plain))
    return stack


def check_fused(worst, key, x2, nbr, w, narrow=False):
    """The fused K1 (with ``narrow``, its narrow-input version) against its
    plain version (both output types) on the same inputs, at the brick side
    of x2's width."""
    from doda_tpu_torch.ops.banded_conv import (banded_conv_fused,
                                                banded_conv_fused_plain,
                                                banded_conv_narrow)
    fn, tag = ((banded_conv_narrow, 'K1n') if narrow
               else (banded_conv_fused, 'K1f'))
    for dt, bound in FUSED_CHECKS:
        got = fn(x2, nbr, w, dt)
        torch.cuda.synchronize()
        ref = banded_conv_fused_plain(x2, nbr, w, dt)
        worst[f'{tag}/{key}/{str(dt)[6:]}'] = _close(
            got, ref, True, bound, f'{fn.__name__} {key} {dt}')


# (cin, cout) of the padded route's checks: cin past a multiple of 8 and
# cout short of one, both ways round, cin below 8 (the narrow K1 on a
# padded cout) and a wide pair in several cout blocks
PADDED_WIDTHS = ((12, 20), (20, 12), (9, 5), (3, 12), (40, 36))


def check_padded(worst, key, x2, nbr, w):
    """The route 'padded' (the fused or narrow K1 on zero-padded operands)
    against its plain version, bf16 operands: float32 output to 1e-4 of
    max|ref| and bf16 output within ``CHECKS``' bf16 bound, bit-equal on a
    repeated call; one count a call with rows, none on the kernels' own
    counters."""
    from doda_tpu_torch.ops.banded_conv import (banded_conv_fused,
                                                banded_conv_fused_plain,
                                                banded_conv_narrow,
                                                banded_conv_padded)
    own = banded_conv_fused.launches, banded_conv_narrow.launches
    before = banded_conv_padded.launches
    for dt, bound in ((torch.float32, FUSED_CHECKS[0][1]),
                      (torch.bfloat16, CHECKS[1][2])):
        got = banded_conv_padded(x2, nbr, w, dt)
        torch.cuda.synchronize()
        ref = banded_conv_fused_plain(x2, nbr, w, dt)
        worst[f'K1pad/{key}/{str(dt)[6:]}'] = _close(
            got, ref, True, bound, f'banded_conv_padded {key} {dt}')
        again = banded_conv_padded(x2, nbr, w, dt)
        torch.cuda.synchronize()
        assert torch.equal(got, again), f'{key} {dt}: not bit-equal again'
    assert banded_conv_padded.launches == before + 4
    assert (banded_conv_fused.launches, banded_conv_narrow.launches) == own


def check_fused_pro(worst, key, x2, nbr, w, occ, g):
    """K1's prologue variant against its plain version (float32 output to
    1e-4 of max|ref|, bf16 to one rounding), with a bias > 0 on half the
    channels: the plain version without the occupancy mask must then miss
    the float32 bound, so a kernel that skipped the mask would fail."""
    from doda_tpu_torch.ops.banded_conv import (banded_conv_fused,
                                                banded_conv_fused_plain,
                                                occ_words)
    cin = w.shape[1]
    scale = 1 + 0.3 * torch.randn(cin, device='cuda', generator=g)
    bias = 0.3 * torch.randn(cin, device='cuda', generator=g)
    bias[::2] = bias[::2].abs() + 0.1
    pro = (scale, bias, occ_words(occ))
    for dt, bound in FUSED_CHECKS:
        got = banded_conv_fused(x2, nbr, w, dt, pro)
        torch.cuda.synchronize()
        ref = banded_conv_fused_plain(x2, nbr, w, dt, pro)
        worst[f'K1pro/{key}/{str(dt)[6:]}'] = _close(
            got, ref, True, bound, f'banded_conv_fused prologue {key} {dt}')
        if dt == torch.float32:
            ref32 = ref
    unmasked = banded_conv_fused_plain(
        x2, nbr, w, torch.float32, (scale, bias,
                                    occ_words(torch.ones_like(occ))))
    miss = (unmasked - ref32).abs().max().item()
    assert miss > 1e-4 * ref32.abs().max().item(), f'{key}: mask not tested'
    worst[f'K1pro-unmasked/{key}'] = miss


def phase_kernels(levels):
    from doda_tpu_torch.ops import bricks2d
    from doda_tpu_torch.ops.banded_conv import (banded_conv_f32,
                                                banded_conv_fused,
                                                banded_conv_fused_plain)
    from doda_tpu_torch.ops.banded_conv_sm import (banded_conv_sm,
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
    for lvl, cin, cout in K1_BENCH_SHAPES:
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

    # its prologue variant (the fused norm + ReLU engine) on the bench
    # batch's rulebooks and cell occupancy at the same shapes, on a
    # synthetic rulebook at a cin that ends in a half chunk, and on no rows
    from doda_tpu_torch.ops.banded_conv import occ_words
    for lvl, cin, cout in K1_BENCH_SHAPES:
        lv = levels[lvl]
        x2, w = operands(lv.nbr.shape[0], cin, cout)
        check_fused_pro(worst, f'level{lvl}/{lv.nbr.shape[0]}x{cin}x{cout}',
                        x2, lv.nbr, w, lv.occ, g)
    nbr = synth.synth_rulebook(1001, 12, seed=7)
    x2, w = operands(1001, 24, 16)
    occ = torch.rand(1001, 64, device='cuda', generator=g) < 0.6
    check_fused_pro(worst, 'synthetic/1001x24x16', x2, nbr, w, occ, g)
    before = banded_conv_fused.pro_launches
    pro = (torch.ones(24, device='cuda'), torch.ones(24, device='cuda'),
           occ_words(occ[:0]))
    empty = banded_conv_fused(x2[:0], nbr[:0], w, torch.float32, pro)
    assert empty.shape == (0, 64 * 16)
    assert banded_conv_fused.pro_launches == before  # nothing to launch

    # the narrow K1 at the bench input conv (the level-0 rulebook, 3 ->
    # 16) and on synthetic rulebooks: every padded channel count (cin 1 to
    # 7), couts in one, two and three blocks, ragged rows and no rows
    from doda_tpu_torch.ops.banded_conv import banded_conv_narrow
    x2, w = operands(level0.nbr.shape[0], 3, 16)
    check_fused(worst, f'input/level0/{level0.nbr.shape[0]}x3x16', x2,
                level0.nbr, w, narrow=True)
    for rows, grid, cin, cout in ((4099, 20, 1, 8), (4099, 20, 4, 16),
                                  (1001, 12, 5, 24), (4099, 20, 6, 32),
                                  (1001, 12, 7, 40), (3, 4, 2, 16)):
        nbr = synth.synth_rulebook(rows, grid, seed=rows)
        x2, w = operands(rows, cin, cout)
        check_fused(worst, f'synthetic/{rows}x{cin}x{cout}', x2, nbr, w,
                    narrow=True)
    before = banded_conv_narrow.launches
    empty = banded_conv_narrow(x2[:0], nbr[:0], w, bf)
    assert empty.shape == (0, 64 * 16)
    assert banded_conv_narrow.launches == before    # nothing to launch

    # the route 'padded' (bf16 widths neither the fused nor the narrow K1
    # takes as they are) on the level-0 bench rulebook and on synthetic
    # ones at sides 4 and 2 (x2 of 8 cells a row: the same rulebooks in
    # bricks of side 2), ragged rows, and no rows
    from doda_tpu_torch.ops.banded_conv import banded_conv_padded
    for cin, cout in PADDED_WIDTHS:
        assert bricks2d.subm_route(cin, cout, bf, 0) == 'padded'
        x2, w = operands(level0.nbr.shape[0], cin, cout)
        check_padded(worst, f'level0/{level0.nbr.shape[0]}x{cin}x{cout}',
                     x2, level0.nbr, w)
        for rows, grid in ((4099, 20), (1001, 12)):
            nbr = synth.synth_rulebook(rows, grid, seed=rows + cin)
            x2, w = operands(rows, cin, cout)
            check_padded(worst, f'synthetic/{rows}x{cin}x{cout}', x2, nbr,
                         w)
            x2 = x2.reshape(rows, 8, 8, cin)[:, 0].reshape(rows, -1)
            check_padded(worst, f'side2/synthetic/{rows}x{cin}x{cout}',
                         x2.contiguous(), nbr, w)
    before = banded_conv_padded.launches
    empty = banded_conv_padded(x2[:0], nbr[:0], w, bf)
    assert empty.shape == (0, 8 * 36)
    assert banded_conv_padded.launches == before    # nothing to launch
    f32 = torch.float32

    # K1 in float32 (banded_conv_f32) on the bench batch's own rulebooks:
    # every level's block conv, the tails, the input conv and the widest
    # conv, on activations masked to the level's active cells; float32
    # and bf16 output, bit-equal on a repeated call
    for lvl, cin, cout in F32_K1_SHAPES:
        lv = levels[lvl]
        rows = lv.nbr.shape[0]
        x2 = (torch.randn(rows, 64, cin, device='cuda', generator=g)
              * lv.occ[..., None]).reshape(rows, -1)
        w = torch.randn(27, cin, cout, device='cuda', generator=g) \
            / (27 * cin) ** 0.5
        check_f32(worst, f'K1f32/level{lvl}/{rows}x{cin}x{cout}',
                  lambda dt: banded_conv_f32(x2, lv.nbr, w, dt),
                  lambda dt: banded_conv_fused_plain(x2, lv.nbr, w, dt))
    # ... and on synthetic rulebooks: ragged rows, absent faces beside
    # present diagonals, odd channel counts, several cout blocks, no rows
    for rows, grid, cin, cout in ((4099, 20, 16, 16), (1001, 12, 5, 13),
                                  (1001, 12, 40, 24), (777, 12, 192, 96),
                                  (3, 4, 16, 32)):
        nbr = synth.synth_rulebook(rows, grid, seed=rows)
        x2 = torch.randn(rows, 64 * cin, device='cuda', generator=g)
        w = torch.randn(27, cin, cout, device='cuda', generator=g) \
            / (27 * cin) ** 0.5
        check_f32(worst, f'K1f32/synthetic/{rows}x{cin}x{cout}',
                  lambda dt: banded_conv_f32(x2, nbr, w, dt),
                  lambda dt: banded_conv_fused_plain(x2, nbr, w, dt))
    before = banded_conv_f32.launches
    assert banded_conv_f32(x2[:0], nbr[:0], w, f32).shape == (0, 64 * 32)
    assert banded_conv_f32.launches == before       # nothing to launch

    # K2's float32 kernel (banded_conv_sm_taps on float32 operands) at
    # every shape the rule can send it, ragged B, less than a tile, a half
    # cout block and two weight groups, operands as column slices of one
    # gathered buffer; the first version's wrapper raises on the card,
    # naming it
    for b, cin, cout in K2_SHAPES + ((7, 32, 32), (1000, 16, 24),
                                     (333, 144, 24)):
        x = torch.randn(b, 64 * cin, device='cuda', generator=g)
        buf = torch.randn(b, 176 * cin, device='cuda', generator=g)
        halo = (buf[:, :96 * cin], buf[:, 96 * cin:136 * cin],
                buf[:, 136 * cin:])
        w = torch.randn(27, cin, cout, device='cuda', generator=g) \
            / (27 * cin) ** 0.5
        got = check_f32(
            worst, f'K2f32/{b}x{cin}x{cout}',
            lambda dt: banded_conv_sm_taps(x, *halo, w, dt),
            lambda dt: banded_conv_sm_taps_plain(x, *halo, w, dt))
        again = banded_conv_sm_taps(x, *(t.contiguous() for t in halo), w,
                                    torch.bfloat16)
        assert torch.equal(again, got), f'K2f32 {b}: strided != contiguous'
    before = banded_conv_sm_taps.f32_launches
    assert banded_conv_sm_taps(x[:0], *(t[:0] for t in halo), w,
                               f32).shape == (0, 64 * cout)
    assert banded_conv_sm_taps.f32_launches == before
    try:
        banded_conv_sm(x, *halo, *bricks2d.sm_weights(w), f32)
        raise AssertionError('banded_conv_sm ran on the card')
    except ValueError as e:
        assert 'banded_conv_sm_taps' in str(e), e

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
    """The bf16 eval forward on the kernels (launches, scenes/sec, peak);
    the float32 forward on the kernels (every subm conv on K1's float32
    kernel, launches by route against ``subm_routes``) against the plain
    path. Returns the bf16 forward's launches and the float32 one's."""
    from doda_tpu_torch.models import model_fn
    from doda_tpu_torch.utils import synth
    n_valid = int(batch.valid.sum())
    batch = batch.to('cuda')

    def run(dtype, sd):
        model = model_fn.build_model(cfg, dtype=dtype)
        model.load_state_dict(sd, strict=True)
        return model, model_fn.make_eval_step(cfg, model, b_caps)

    sd = synth.seeded_state_dict(model_fn.build_model(cfg), seed=0)
    model, step = run(torch.bfloat16, sd)
    # the rule on the parameter shapes: the cin = 3 input conv on the
    # narrow K1, all others on the fused K1; one sorted point -> cell
    # reduction
    want = model.subm_routes()
    assert want == {'sm': 0, 'fused': 52, 'narrow': 1, 'f32': 0,
                    'padded': 0, 'cell_mean': 1}, want
    step(batch)                                     # warm-up (set-up)
    torch.cuda.synchronize()

    _cli_reset()                                    # the counted path
    out = step(batch)
    torch.cuda.synchronize()
    launches = _cli_launches()
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
    assert _cli_launches() == {k: 4 * v for k, v in want.items()}
    peak = torch.cuda.max_memory_allocated()

    # float32: kernel path vs plain path, same weights and batch; every
    # subm conv on K1's float32 kernel, none on halo planes
    model32, step32 = run(torch.float32, sd)
    want32 = model32.subm_routes()
    assert want32 == {'sm': 0, 'fused': 0, 'narrow': 0, 'f32': 53,
                      'padded': 0, 'cell_mean': 1}, want32
    _cli_reset()
    lk = step32(batch)['output']
    torch.cuda.synchronize()
    launches32 = _cli_launches()
    assert launches32 == want32, launches32
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
        f32_launches_per_forward=launches32,
        valid_points=n_valid, b_caps=list(b_caps))
    return launches, launches32


def phase_train(cfg, b_caps, card):
    """Three bf16 train steps of the flagship on 2 bench scenes, then one
    float32 step on the kernel path against the plain path."""
    from doda_tpu_torch.models import model_fn
    from doda_tpu_torch.ops.banded_conv import (banded_conv_f32,
                                                banded_conv_fused)
    from doda_tpu_torch.ops.banded_conv_sm import banded_conv_sm_taps
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
    # except the input conv, whose input needs no gradient; the sorted
    # reduction once a forward and once a backward (the gather's)
    fwd_want, bwd_want = model.subm_routes(), model.subm_routes(True)
    assert fwd_want == {'sm': 15, 'fused': 37, 'narrow': 1, 'f32': 0,
                        'padded': 0, 'cell_mean': 1}, fwd_want
    assert bwd_want == {'sm': 16, 'fused': 36, 'narrow': 0, 'f32': 0,
                        'padded': 0, 'cell_mean': 1}, bwd_want
    want = {k: fwd_want[k] + bwd_want[k] for k in fwd_want}
    reset = _cli_reset

    def counts():
        # bf16 steps launch no float32 kernel
        assert banded_conv_sm_taps.f32_launches == 0
        assert banded_conv_f32.launches == 0
        assert banded_conv_fused.pro_launches == 0
        return _cli_launches()

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
    assert counts() == {'sm': 0, 'fused': steps * 104, 'narrow': steps,
                        'f32': 0, 'padded': 0, 'cell_mean': 2 * steps}, \
        counts()
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
    # the 'sm' convs run K2's float32 kernel, the others K1's (exact
    # float32 FMAs on the CUDA cores): launches by route as subm_routes
    # counts them, none of the bf16 kernels
    model_k, step_k = trainer(torch.float32, sd)
    want32 = {k: v + model_k.subm_routes(True)[k]
              for k, v in model_k.subm_routes().items()}
    assert want32 == {'sm': 31, 'fused': 0, 'narrow': 0, 'f32': 74,
                      'padded': 0, 'cell_mean': 2}, want32
    reset()
    loss_k = float(step_k(batch, lr)['loss'])
    f32_ran = _cli_launches()
    assert f32_ran == want32, f32_ran
    assert banded_conv_sm_taps.f32_launches == want32['sm']
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
        f32_worst_gradient_err=worst, f32_launches_per_step=f32_ran)
    return ran, f32_ran


ROUTES = ('sm', 'fused', 'narrow', 'f32', 'padded', 'prologue', 'cell_mean')


def _step_bits(model, opt, outs):
    """Every tensor a run of steps leaves, by name: each step's outputs
    (the losses), the last step's gradients, the state dict (weights and
    running statistics) and the optimizer's state (momentum)."""
    bits = {f'step{i}/{k}': v for i, out in enumerate(outs)
            for k, v in out.items() if torch.is_tensor(v)}
    bits.update({f'grad/{n}': p.grad for n, p in model.named_parameters()})
    bits.update({f'state/{k}': v for k, v in model.state_dict().items()})
    for i, st in opt.state_dict()['state'].items():
        bits.update({f'opt/{i}/{k}': v for k, v in st.items()
                     if torch.is_tensor(v)})
    return {k: v.detach().clone() for k, v in bits.items()}


def phase_repeat(cfg, card):
    """Bit-equal steps with deterministic algorithms off: from one seeded
    state, two runs of two steps each of the flagship (batch 2 of the bench
    scenes) in bf16 under ``sm_max_cin=32`` (K2 and the fused K1), in
    float32 under ``sm_max_cin=32`` (K2's and K1's float32 kernels), an st
    step of the DA flagship (DSNorm, ``sm_max_cin=0``, the CLIs' kernels)
    at side 4, and bf16 under ``sm_max_cin=0`` at side 2. The two runs of
    each must leave the same bits in every loss, gradient, weight, running
    statistic and momentum; every step's launches equal ``subm_routes``'
    rule (``cell_reduce_sorted`` 1 a forward and 1 a backward: 2 a train
    step, 4 an st step). Returns the launches of every counted step."""
    from doda_tpu_torch.config import CfgNode, cfg_from_yaml_file
    from doda_tpu_torch.models import model_fn
    from doda_tpu_torch.models.unet import default_brick_caps
    from doda_tpu_torch.utils import optim, synth
    t_phase = time.perf_counter()
    assert not torch.are_deterministic_algorithms_enabled()
    tbatch = synth.make_batch(seed=0, batch=synth.TRAIN_BATCH)
    st_cfg = cfg_from_yaml_file(CFG_ST, CfgNode())
    n_st = st_cfg.COMMON_CLASSES.n_classes
    st_caps = default_brick_caps(
        st_cfg.DATA_CONFIG.DATA_PROCESSOR.brick_cap, 7)
    src = synth.make_batch(seed=0, batch=synth.TRAIN_BATCH, n_classes=n_st)
    tar = synth.make_batch(seed=1, batch=synth.TRAIN_BATCH, n_classes=n_st)
    caps4 = default_brick_caps(synth.BRICK_CAP, 7)
    for b, caps, side in ((tbatch, caps4, 4), (tbatch, synth.BRICK_CAPS_SIDE2,
                                                2), (src, st_caps, 4),
                          (tar, st_caps, 4)):
        synth.capacity_audit(b, caps, side)
    tbatch, src, tar = tbatch.to('cuda'), src.to('cuda'), tar.to('cuda')
    lr = optim.make_lr_fn(cfg.OPTIMIZATION, cfg.OPTIMIZATION.NUM_EPOCHS,
                          100)(1, 0)
    sd = synth.seeded_state_dict(model_fn.build_model(cfg), seed=0)
    sd_st = synth.seeded_state_dict(model_fn.build_model(st_cfg), seed=0)
    w_src = st_cfg.SELF_TRAIN.SRC.get('loss_weight', 1.0)
    w_tar = st_cfg.SELF_TRAIN.TAR.get('loss_weight', 1.0)

    def train(dtype, side, sm_max_cin):
        def make():
            model = model_fn.build_model(cfg, dtype=dtype, brick=side,
                                         sm_max_cin=sm_max_cin, train=True)
            model.load_state_dict(sd, strict=True)
            opt = optim.build_optimizer(cfg.OPTIMIZATION, model.parameters())
            step = model_fn.make_train_step(
                cfg, model, opt, caps4 if side == 4 else
                synth.BRICK_CAPS_SIDE2)
            return model, opt, (lambda: step(tbatch, lr)), 1
        return make

    def st():
        model = model_fn.build_model(st_cfg, train=True)
        model.load_state_dict(sd_st, strict=True)
        opt = optim.build_optimizer(st_cfg.OPTIMIZATION, model.parameters())
        step = model_fn.make_st_step(st_cfg, model, opt, st_caps)
        return model, opt, (lambda: step(src, tar, lr, w_src, w_tar)), 2

    pairs = {'train_bf16_side4_sm32': train(torch.bfloat16, 4, SM_MAX_CIN),
             'train_f32_side4_sm32': train(torch.float32, 4, SM_MAX_CIN),
             'st_bf16_side4': st,
             'train_bf16_side2': train(torch.bfloat16, 2, 0)}
    readings, launched = {}, {}
    for name, make in pairs.items():
        runs = []
        for run in range(2):
            model, opt, step, terms = make()
            fwd, bwd = model.subm_routes(), model.subm_routes(True)
            rule = {k: terms * (fwd.get(k, 0) + bwd.get(k, 0))
                    for k in ROUTES}
            outs = []
            for _ in range(2):
                _cli_reset()                        # the counted path
                outs.append(step())
                torch.cuda.synchronize()
                ran = _launches()
                assert ran == rule, (name, run, ran, rule)
            launched[f'{name}_run{run}'] = {k: 2 * v for k, v in ran.items()}
            runs.append(_step_bits(model, opt, outs))
            del model, opt, step, outs
            torch.cuda.empty_cache()
        a, b = runs
        assert a.keys() == b.keys()
        differ = [k for k in a if not torch.equal(a[k], b[k])]
        assert not differ, (name, differ)
        readings[name] = {
            'tensors_bit_equal': len(a),
            'losses': {k: float(v) for k, v in a.items()
                       if k.split('/')[1].startswith('loss')},
            'launches_per_step': rule}
        del runs, a, b
    log('repeat', card=card, deterministic_algorithms=False,
        batch=synth.TRAIN_BATCH, steps_a_run=2, runs=readings,
        phase_seconds=time.perf_counter() - t_phase)
    _cli_reset()
    return launched


def _profile(fn):
    """Device ms by ``tools/trace_fwd.py``'s buckets and kernel launches of
    one call of ``fn``, from torch.profiler."""
    import re
    from torch.profiler import ProfilerActivity, profile
    from doda_tpu_torch.tools.trace_fwd import BUCKETS, _device_us
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    buckets = {}
    for e in kernels:
        name = next((b for b, pat in BUCKETS if re.search(pat, e.key)),
                    'other')
        buckets[name] = buckets.get(name, 0.0) + _device_us(e) / 1e3
    return {'device_ms': sum(buckets.values()),
            'kernel_launches': int(sum(e.count for e in kernels)),
            'buckets_ms': dict(sorted(buckets.items(),
                                      key=lambda kv: -kv[1]))}


def _grad_error(grads, ref):
    """Relative L2 error of a step's gradients against a reference step's,
    over all parameters, and the worst parameter's max error over its
    scale."""
    num = sum(((grads[n] - g) ** 2).sum().item() for n, g in ref.items())
    den = sum((g ** 2).sum().item() for g in ref.values())
    worst = max((grads[n] - g).abs().max().item()
                / max(1.0, g.abs().max().item()) for n, g in ref.items())
    return math.sqrt(num / den), worst


def phase_fuse_norm(cfg, batch, b_caps, card):
    """The flagship with ``fuse_norm=True`` (its block convs on K1's
    prologue variant) against the same weights unfused: the eval forward
    on the 4 bench scenes (launches by route, scenes/sec, device time and
    buckets, both ways; float32 logits and bf16 predictions), then train
    steps on 2 scenes (a float32 step on the pro_full routes; three bf16
    steps both ways, the bf16 steps' gradient error against the float32
    unfused step). Returns the launches of each route in the counted runs."""
    from doda_tpu_torch.models import model_fn
    from doda_tpu_torch.ops.banded_conv_sm import banded_conv_sm_taps
    from doda_tpu_torch.utils import optim, synth
    t_phase = time.perf_counter()
    bf, f32 = torch.bfloat16, torch.float32
    n_valid = int(batch.valid.sum())
    batch = batch.to('cuda')
    sd = synth.seeded_state_dict(model_fn.build_model(cfg), seed=0)

    def counts():
        assert banded_conv_sm_taps.launches == 0
        assert banded_conv_sm_taps.f32_launches == 0
        return _launches()

    def evaluator(dtype, fuse):
        model = model_fn.build_model(cfg, dtype=dtype, fuse_norm=fuse)
        model.load_state_dict(sd, strict=True)
        return model, model_fn.make_eval_step(cfg, model, b_caps)

    model_f, step_f = evaluator(bf, True)
    model_u, step_u = evaluator(bf, False)
    want = model_f.subm_routes()
    assert want == {'sm': 0, 'fused': 0, 'narrow': 1, 'f32': 0,
                    'padded': 0, 'prologue': 52, 'cell_mean': 1}, want
    step_f(batch)                                   # warm-up (set-up)
    step_u(batch)
    torch.cuda.synchronize()
    launched = {}
    _cli_reset()                                    # the counted path
    out_f = step_f(batch)
    torch.cuda.synchronize()
    launched['eval_forward_fused'] = counts()
    assert launched['eval_forward_fused'] == want, launched
    _cli_reset()
    out_u = step_u(batch)
    torch.cuda.synchronize()
    launched['eval_forward_unfused'] = counts()
    assert launched['eval_forward_unfused'] == {
        'sm': 0, 'fused': 52, 'narrow': 1, 'f32': 0, 'padded': 0,
        'prologue': 0, 'cell_mean': 1}, launched
    logits = out_f['output']
    assert logits.shape == (synth.BATCH, synth.N_CAP, 20)
    assert torch.isfinite(logits).all() and int(out_f['count']) == n_valid
    agree = (out_f['preds'] == out_u['preds'])[batch.valid].float().mean()
    agree = agree.item()
    assert agree >= 0.99, f'bf16 preds fused vs unfused agree on {agree}'

    seconds = {True: [], False: []}                 # in turns: u, f, f, u
    for fuse in (False, True, True, False):
        step = step_f if fuse else step_u
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            step(batch)
        torch.cuda.synchronize()
        seconds[fuse].append((time.perf_counter() - t0) / 3)
    prof = {fuse: _profile(lambda: (step_f if fuse else step_u)(batch))
            for fuse in (False, True)}
    del model_f, step_f, model_u, step_u, out_f, out_u
    torch.cuda.empty_cache()
    (_, s32f), (_, s32u) = evaluator(f32, True), evaluator(f32, False)
    lf, lu = s32f(batch)['output'], s32u(batch)['output']
    err32 = (lf - lu).abs().max().item()
    lim32 = 1e-3 * max(1.0, lu.abs().max().item())
    assert err32 <= lim32, f'float32 logits fused vs unfused: {err32}'
    del s32f, s32u, lf, lu, logits
    torch.cuda.empty_cache()
    readings = {
        'launches': launched,
        'eval_forward': {
            'bf16_pred_agreement': agree,
            'f32_logit_max_abs_err': err32, 'f32_logit_bound': lim32,
            'seconds_per_forward_fused': seconds[True],
            'seconds_per_forward_unfused': seconds[False],
            'scenes_per_sec_fused': synth.BATCH / min(seconds[True]),
            'scenes_per_sec_unfused': synth.BATCH / min(seconds[False]),
            'profiled_fused': prof[True], 'profiled_unfused': prof[False]}}

    tbatch = synth.make_batch(seed=0, batch=synth.TRAIN_BATCH)
    synth.capacity_audit(tbatch, b_caps)
    tbatch = tbatch.to('cuda')
    lr = optim.make_lr_fn(cfg.OPTIMIZATION, cfg.OPTIMIZATION.NUM_EPOCHS,
                          100)(1, 0)

    def first_step(dtype, fuse):
        """A trainer's first step from the seeded weights: its loss and
        gradients; the model and step for more."""
        model = model_fn.build_model(cfg, dtype=dtype, sm_max_cin=0,
                                     train=True, fuse_norm=fuse)
        model.load_state_dict(sd, strict=True)
        opt = optim.build_optimizer(cfg.OPTIMIZATION, model.parameters())
        step = model_fn.make_train_step(cfg, model, opt, b_caps)
        loss = float(step(tbatch, lr)['loss'])
        grads = {n: p.grad.float().clone()
                 for n, p in model.named_parameters()}
        return model, step, loss, grads

    _, _, loss_u32, grads_u32 = first_step(f32, False)
    torch.cuda.empty_cache()
    _cli_reset()
    _, _, loss_f32, grads_f32 = first_step(f32, True)
    launched['train_f32_fused'] = counts()   # float32: pro_full, then 'f32'
    assert launched['train_f32_fused'] == {
        'sm': 0, 'fused': 0, 'narrow': 0, 'f32': 105, 'padded': 0,
        'prologue': 0, 'cell_mean': 2}, launched
    assert abs(loss_f32 - loss_u32) <= 1e-4 * abs(loss_u32), (loss_f32,
                                                             loss_u32)
    _, f32_worst = _grad_error(grads_f32, grads_u32)
    assert f32_worst <= 1e-3, f'float32 gradients fused vs unfused {f32_worst}'
    del grads_f32
    torch.cuda.empty_cache()

    steps = 3
    train = {}
    for fuse in (False, True):
        model, step, loss0, grads = first_step(bf, fuse)
        rule = model.subm_routes()
        rule_bwd = model.subm_routes(backward=True)
        rule = {k: steps * (rule.get(k, 0) + rule_bwd.get(k, 0))
                for k in ('sm', 'fused', 'narrow', 'f32', 'padded',
                          'prologue', 'cell_mean')}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _cli_reset()
        t0 = time.perf_counter()
        losses = [step(tbatch, lr)['loss'] for _ in range(steps)]
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        key = 'train_bf16_fused' if fuse else 'train_bf16_unfused'
        launched[key] = counts()
        assert launched[key] == rule, (key, launched[key], rule)
        losses = [float(v) for v in losses]
        assert all(math.isfinite(v) for v in losses), losses
        l2, worst = _grad_error(grads, grads_u32)
        train[key] = {
            'seconds_per_step': dt / steps,
            'trained_scenes_per_sec': steps * synth.TRAIN_BATCH / dt,
            'peak_memory_gib': torch.cuda.max_memory_allocated() / 2 ** 30,
            'first_loss': loss0, 'losses': losses,
            'grad_rel_l2_err_vs_f32_unfused': l2,
            'grad_worst_err_vs_f32_unfused': worst,
            'loss_rel_err_vs_f32_unfused': abs(loss0 - loss_u32)
            / abs(loss_u32)}
        del model, step, grads
        torch.cuda.empty_cache()
    e_f = train['train_bf16_fused']['grad_rel_l2_err_vs_f32_unfused']
    e_u = train['train_bf16_unfused']['grad_rel_l2_err_vs_f32_unfused']
    assert e_f <= 2 * e_u, f'bf16 fused step error {e_f} > 2 x {e_u}'
    readings['train'] = {'batch': synth.TRAIN_BATCH, 'lr': lr,
                         'f32_loss_fused': loss_f32,
                         'f32_loss_unfused': loss_u32,
                         'f32_worst_gradient_err': f32_worst, **train}
    log('fuse_norm', card=card, **readings,
        phase_seconds=time.perf_counter() - t_phase)
    _cli_reset()
    return launched


# (conv_engine, deep_xla_rows) of phase engines, each against '2d': at
# batch 4, deep_xla_rows=4096 sends levels 3-6 (3,072 / 1,024 / 512 / 512
# flat rows) to the concat-assembly engine
ENGINE_RUNS = (('slab', 0), ('xla', 0), ('oracle', 0), ('2d', 4096))
ENGINE_CONVS = (('slab', 'subm_conv3_slab'), ('xla', 'subm_conv3_v2'),
                ('oracle', 'subm_conv3'))


def counting_engines():
    """Context that counts the forward calls of the engines' convs on the
    model's path (they launch no kernel), by engine name; returns (the
    context, the counts)."""
    from contextlib import ExitStack
    from doda_tpu_torch.models import unet
    calls = {k: 0 for k, _ in ENGINE_CONVS}
    stack = ExitStack()
    for key, name in ENGINE_CONVS:
        def counted(*a, _fn=getattr(unet, name), _key=key, **k):
            calls[_key] += 1
            return _fn(*a, **k)
        stack.enter_context(patch.object(unet, name, counted))
    return stack, calls


def _routes_ran(calls):
    """The launches by route from the kernels' counters, and the engines'
    calls, as ``subm_routes`` keys them."""
    ran = _cli_launches()
    ran.update(calls)
    return ran


def _routes_match(ran, want):
    return all(ran.get(k, 0) == v for k, v in want.items()) and \
        sum(ran.values()) == sum(want.values())


def engine_k1_checks(levels, slab_levels, batch, plan):
    """K1 against references that do not share its halo tables, float32,
    at levels 0 and 1 of the bench batch's real rulebooks: the oracle and
    the slab conv against ``subm_conv3_2d`` on the kernel path (K1's
    float32 kernel, ``banded_conv_f32``), the fused K1 (bf16 operands,
    float32 output)
    against the oracle on the same rounded operands, ``subm_conv3_v2``
    against K1 too, and the voxel-level
    ``sparse.subm_conv`` on scene 0's voxel table (its rulebook from
    ``build_subm_rulebook``, card against CPU) against K1 at those
    voxels. Bounds 1e-4 of max|ref|. Also times ``F.conv3d`` alone on the
    oracle's assembled bf16 halo, the library call of K1's function."""
    import torch.nn.functional as F
    from doda_tpu_torch.ops import bricks, bricks2d, slabs, sparse
    from doda_tpu_torch.ops.banded_conv import (banded_conv_f32,
                                                banded_conv_fused)
    from doda_tpu_torch.ops.coords import (CoordTable, lookup_packed,
                                           unique_coords)
    g = torch.Generator(device='cuda').manual_seed(4)
    bf, f32 = torch.bfloat16, torch.float32
    errs, library = {}, {}
    # scene 0's voxel table and the level-0 brick cell of each voxel
    pts = batch.coords[0][batch.valid[0]].to('cuda')
    n_pts = pts.shape[0]
    table0 = unique_coords(pts, torch.ones_like(pts[:, 0], dtype=torch.bool),
                           n_pts)
    pt_idx = torch.nonzero(batch.valid[0]).squeeze(1).to('cuda')
    vox_pt = torch.zeros(n_pts + 1, dtype=torch.long, device='cuda')
    vox_pt[table0.p2v.long()] = pt_idx
    cell0 = plan.grid0.flat_index()[0][vox_pt[:n_pts]]
    ds = sparse.build_downsample(table0, n_pts)
    parent = CoordTable(*(t[0] for t in plan.downs[0].parent))
    for lvl, cin in ((0, 16), (1, 32)):
        lv, slab = levels[lvl], slab_levels[lvl].slab
        rows = lv.occ.shape[0]
        x3 = torch.randn(rows, 64, cin, device='cuda', generator=g)
        x3 = x3 * lv.occ[..., None]
        w = torch.randn(27, cin, cin, device='cuda', generator=g)
        w = w / (27 * cin) ** 0.5
        x2 = x3.reshape(rows, -1)
        before = banded_conv_f32.launches
        k1 = bricks2d.subm_conv3_2d(x2, lv.occ, lv.halo, w, f32, lv.sm, 0,
                                    lv.nbr)
        assert banded_conv_f32.launches == before + 1  # the kernel path
        oracle = bricks.subm_conv3(x3, lv.occ, lv.nbr, w, f32)
        key = f'level{lvl}/{rows}x{cin}x{cin}'
        errs[f'oracle-vs-K1/{key}'] = _close(
            oracle.reshape(rows, -1), k1, True, 1e-4, f'oracle vs K1 {key}')
        errs[f'slab-vs-K1/{key}'] = _close(
            slabs.subm_conv3_slab(x2, slab, w, f32), k1, True, 1e-4,
            f'slab vs K1 {key}')
        errs[f'xla-vs-K1/{key}'] = _close(
            bricks.subm_conv3_v2(x3, lv.occ, lv.nbr, w, f32).reshape(rows, -1),
            k1, True, 1e-4, f'subm_conv3_v2 vs K1 {key}')
        xb, wb = x3.to(bf), w.to(bf)
        fused = bricks2d._mask(banded_conv_fused(
            xb.reshape(rows, -1), lv.nbr, wb, f32), lv.occ, cin)
        errs[f'fusedK1-vs-oracle/{key}'] = _close(
            fused, bricks.subm_conv3(xb.float(), lv.occ, lv.nbr, wb.float(),
                                     f32).reshape(rows, -1), True, 1e-4,
            f'fused K1 vs oracle {key}')

        # the voxel-level engine on scene 0: no bricks at all
        table = table0 if lvl == 0 else ds.parent
        rb = sparse.build_subm_rulebook(table, 3)
        rb_cpu = sparse.build_subm_rulebook(CoordTable(
            *(t.cpu() for t in table)), 3)
        assert torch.equal(rb.cpu(), rb_cpu), f'voxel rulebook {lvl}'
        if lvl == 0:
            cell = cell0
        else:
            vc = table.coords
            bid = lookup_packed(parent, torch.div(vc, 4, rounding_mode='floor'),
                                table.valid)
            m = vc % 4
            cell = bid.long() * 64 + m[:, 0] * 16 + m[:, 1] * 4 + m[:, 2]
        n = int(table.n)
        cell = cell[:n]
        # every voxel lands on an active cell of its level (a wrong map
        # would compare zeros with zeros)
        assert (cell < rows * 64).all() and lv.occ.reshape(-1)[cell].all()
        feats = x3.new_zeros(table.cap, cin)     # rows past n: the null id
        feats[:n] = x3.reshape(-1, cin)[cell]
        vox = sparse.subm_conv(feats, rb, w, f32)[:n]
        want = k1.reshape(-1, cin)[cell]
        assert want.abs().max() > 0.1
        errs[f'voxel-vs-K1/level{lvl}/{n}x{cin}x{cin}'] = _close(
            vox, want, True, 1e-4, f'voxel subm_conv vs K1 level {lvl}')
        errs[f'voxels/level{lvl}'] = n

        # K1's library reading: F.conv3d alone over the oracle's assembled
        # bf16 halo (channels-last), and the oracle's assembly + conv
        halo = bricks.shell_halo(xb, lv.nbr, bf)
        hin = halo.permute(0, 4, 1, 2, 3)
        wc = wb.reshape(3, 3, 3, cin, cin).permute(4, 3, 0, 1, 2).contiguous(
            memory_format=torch.channels_last_3d)
        lib = F.conv3d(hin, wc)
        lib_out = bricks2d._mask(lib.permute(0, 2, 3, 4, 1).reshape(rows, -1),
                                 lv.occ, cin)
        k1b = bricks2d._mask(banded_conv_fused(xb.reshape(rows, -1), lv.nbr,
                                               wb, bf), lv.occ, cin)
        library[f'level{lvl}'] = {
            'shape': [rows, cin, cin],
            'conv3d_ms': cuda_ms(lambda: F.conv3d(hin, wc), 10),
            'oracle_assembly_plus_conv_ms': cuda_ms(
                lambda: bricks.subm_conv3(xb, lv.occ, lv.nbr, wb, bf), 3),
            'oracle_assembly_ms': cuda_ms(
                lambda: bricks.shell_halo(xb, lv.nbr, bf), 3),
            'fused_k1_ms': cuda_ms(lambda: banded_conv_fused(
                xb.reshape(rows, -1), lv.nbr, wb, bf), 10),
            'conv3d_vs_fused_k1_max_abs_err': _close(
                lib_out, k1b, True, 2e-2, f'conv3d vs fused K1 {key}')}
        del halo, hin, lib, lib_out, k1b, oracle, fused, x3, x2, k1
        torch.cuda.empty_cache()
    return errs, library


def phase_engines(cfg, batch, b_caps, card, levels):
    """The JAX package's other subm-conv engines in the flagship, each
    against '2d' (``ENGINE_RUNS``), with phase forward's seeded weights:
    the slab capacity of the bench scenes and the card's slab maps against
    the CPU's; the eval forward on the 4 bench scenes (float32 logits to
    1e-3 of max(1, max|logit|), bf16 predictions on >= 99% of points,
    launches and engine calls by route against ``subm_routes``, forward
    ms in two turns, peak memory); one float32 train step on 2 scenes
    (loss 1e-4 relative, every gradient 1e-3 of its scale; launches, ms,
    peak memory); then ``engine_k1_checks``. One line per engine.
    Returns K1's library reading and the phase's kernel launches."""
    from doda_tpu_torch.models import model_fn
    from doda_tpu_torch.models.unet import (SLAB_LEVELS, build_level_plan,
                                            default_slab_caps, flatten_plan)
    from doda_tpu_torch.utils import optim, synth
    t_phase = time.perf_counter()
    bf, f32 = torch.bfloat16, torch.float32
    cpu_batch = batch
    batch = batch.to('cuda')
    valid = batch.valid

    # slab capacity: every scene's occupied x-slices fit at levels 0 and 1,
    # so no engine compares on a truncated plan; the card's maps equal the
    # CPU's
    plan = build_level_plan(batch.coords, batch.valid, b_caps, slabs=True)
    ref = build_level_plan(cpu_batch.coords, cpu_batch.valid, b_caps,
                           device='cpu', slabs=True)
    capacity = {}
    for lvl, cap in enumerate(default_slab_caps(b_caps)):
        occ = plan.occs[lvl]
        slices = occ.reshape(occ.shape[0], -1, 16).any(-1).sum(1)
        bricks = occ.any(-1).sum(1)
        assert int(slices.max()) <= cap, (lvl, slices.tolist(), cap)
        for name, a, b in zip(plan.slabs[lvl]._fields, plan.slabs[lvl],
                              ref.slabs[lvl]):
            assert torch.equal(a.cpu(), b), f'slab maps {lvl} {name}'
        capacity[f'level{lvl}'] = {
            'slice_cap': cap, 'occupied_slices': slices.tolist(),
            'slices_per_brick': float(slices.sum() / bricks.sum())}
    assert len(capacity) == SLAB_LEVELS
    slab_levels, _ = flatten_plan(plan)
    del ref

    sd = synth.seeded_state_dict(model_fn.build_model(cfg), seed=0)
    level_rows = [synth.BATCH * c for c in b_caps]
    train_rows = [synth.TRAIN_BATCH * c for c in b_caps]

    def evaluator(dtype, engine='2d', deep=0):
        model = model_fn.build_model(cfg, dtype=dtype, conv_engine=engine,
                                     deep_xla_rows=deep)
        model.load_state_dict(sd, strict=True)
        return model, model_fn.make_eval_step(cfg, model, b_caps)

    _, step = evaluator(bf)
    ref_preds = step(batch)['preds']
    _, step = evaluator(f32)
    ref_logits = step(batch)['output']
    lim32 = 1e-3 * max(1.0, ref_logits.abs().max().item())
    del step
    torch.cuda.empty_cache()

    tbatch = synth.make_batch(seed=0, batch=synth.TRAIN_BATCH)
    synth.capacity_audit(tbatch, b_caps)
    tbatch = tbatch.to('cuda')
    lr = optim.make_lr_fn(cfg.OPTIMIZATION, cfg.OPTIMIZATION.NUM_EPOCHS,
                          100)(1, 0)

    def trainer(engine='2d', deep=0):
        """A float32 trainer's first step from the seeded weights: its loss,
        gradients, launches, time and peak memory."""
        model = model_fn.build_model(cfg, dtype=f32, train=True,
                                     conv_engine=engine, deep_xla_rows=deep)
        model.load_state_dict(sd, strict=True)
        opt = optim.build_optimizer(cfg.OPTIMIZATION, model.parameters())
        step = model_fn.make_train_step(cfg, model, opt, b_caps)
        ctx, calls = counting_engines()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _cli_reset()
        t0 = time.perf_counter()
        with ctx:
            loss = float(step(tbatch, lr)['loss'])
        torch.cuda.synchronize()
        step_ms = 1e3 * (time.perf_counter() - t0)
        ran = _routes_ran(calls)
        fwd = model.subm_routes(level_rows=train_rows)
        bwd = model.subm_routes(True, level_rows=train_rows)
        want = {k: fwd.get(k, 0) + bwd.get(k, 0) for k in {**fwd, **bwd}}
        for k in calls:          # the engines' calls are forward calls
            if k in want:
                want[k] = fwd[k]
        assert _routes_match(ran, want), (engine, deep, ran, want)
        grads = {n: p.grad.float().clone()
                 for n, p in model.named_parameters()}
        out = {'loss': loss, 'grads': grads, 'launches': ran,
               'step_ms': step_ms,
               'peak_memory_gib': torch.cuda.max_memory_allocated() / 2 ** 30}
        del model, opt, step
        torch.cuda.empty_cache()
        return out

    base = trainer()
    launched = {'train_f32_2d': base['launches']}
    readings = {}
    for engine, deep in ENGINE_RUNS:
        name = engine if not deep else f'2d+deep_xla_rows={deep}'
        model, step = evaluator(bf, engine, deep)
        want = model.subm_routes(level_rows=level_rows)
        step(batch)                                 # warm-up (set-up)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ctx, calls = counting_engines()
        _cli_reset()                                # the counted path
        with ctx:
            out = step(batch)
        torch.cuda.synchronize()
        ran = _routes_ran(calls)
        assert _routes_match(ran, want), (name, ran, want)
        launched[f'eval_{name}'] = ran
        agree = (out['preds'] == ref_preds)[valid].float().mean().item()
        assert agree >= 0.99, f'{name}: bf16 preds agree on {agree}'
        turns = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(batch)
            torch.cuda.synchronize()
            turns.append(1e3 * (time.perf_counter() - t0))
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        del model, step, out
        torch.cuda.empty_cache()
        _, step32 = evaluator(f32, engine, deep)
        err32 = (step32(batch)['output'] - ref_logits).abs().max().item()
        assert err32 <= lim32, f'{name}: float32 logits off by {err32}'
        del step32
        torch.cuda.empty_cache()

        tr = trainer(engine, deep)
        launched[f'train_f32_{name}'] = tr['launches']
        assert abs(tr['loss'] - base['loss']) <= 1e-4 * abs(base['loss']), (
            name, tr['loss'], base['loss'])
        worst = 0.0
        for n, gref in base['grads'].items():
            err = (tr['grads'][n] - gref).abs().max().item()
            scale = max(1.0, gref.abs().max().item())
            assert err <= 1e-3 * scale, f'{name}: float32 gradient {n}: {err}'
            worst = max(worst, err / scale)
        readings[name] = {
            'routes_eval_forward': want, 'bf16_pred_agreement': agree,
            'f32_logit_max_abs_err': err32, 'f32_logit_bound': lim32,
            'forward_ms_turns': turns,
            'scenes_per_sec': synth.BATCH * 1e3 / min(turns),
            'eval_peak_memory_gib': peak,
            'train_f32': {'loss': tr['loss'], 'loss_2d': base['loss'],
                          'worst_gradient_err': worst,
                          'launches': tr['launches'],
                          'first_step_ms': tr['step_ms'],
                          'first_step_ms_2d': base['step_ms'],
                          'peak_memory_gib': tr['peak_memory_gib'],
                          'peak_memory_gib_2d': base['peak_memory_gib']}}
        del tr
    del base
    torch.cuda.empty_cache()

    errs, library = engine_k1_checks(levels, slab_levels, cpu_batch, plan)
    readings['slab']['capacity'] = capacity
    readings['slab']['slab_maps_equal_to_cpu'] = True
    for name, r in readings.items():
        key = {'2d+deep_xla_rows=4096': None}.get(name, name)
        if key:
            r['independent_k1_max_abs_err'] = {
                k: v for k, v in errs.items() if k.startswith(key)}
        if name == 'oracle':
            r['k1_library'] = library
            r['fused_k1_vs_oracle_max_abs_err'] = {
                k: v for k, v in errs.items() if k.startswith('fusedK1')}
        log('engines', engine=name, card=card, **r)
    log('engines', engine='voxel', card=card,
        independent_k1_max_abs_err={k: v for k, v in errs.items()
                                    if k.startswith('vox')},
        phase_seconds=time.perf_counter() - t_phase)
    _cli_reset()
    return library, launched


# (level, cin, cout) of phase brick's fused K1 checks on the side-2 bench
# rulebooks: every level's block conv p -> p and the 2p -> p tails of
# levels 0 and 1
BRICK_K1_SHAPES = tuple((lvl, 16 * (lvl + 1), 16 * (lvl + 1))
                        for lvl in range(7)) + ((0, 32, 16), (1, 64, 32))


# (level, cin, cout) of phase brick's K2 checks on the side-2 bench
# rulebooks: every level's block conv p -> p, and the shapes the
# sm_max_cin=32 step adds at levels 0 and 1 (the 2p -> p tail 32 -> 16 and
# the dx of the tails, 16 -> 32 and 32 -> 64)
BRICK_K2_SHAPES = tuple((lvl, 16 * (lvl + 1), 16 * (lvl + 1))
                        for lvl in range(7)) + ((0, 32, 16), (0, 16, 32),
                                                (1, 32, 64))
# K2 at side 2, (output dtype, tolerance relative to max|ref|): float32
# output, the same products summed in float32 in another order; bf16
# output, one rounding of the result
K2_SIDE2_CHECKS = ((torch.float32, 1e-5), (torch.bfloat16, 1.6e-2))


def _scene_table(table, s):
    """Scene ``s`` of a stacked ``CoordTable``."""
    return type(table)(*(f[s] for f in table))


def _voxel_keys(table, occ, side):
    """Sorted packed keys of one scene's active voxels at a level: brick
    coords * side + the active cell's offset in its brick."""
    n = int(table.n)
    b, cell = occ[:n].nonzero(as_tuple=True)
    off = torch.stack([cell // (side * side), cell // side % side,
                       cell % side], 1)
    v = table.coords[:n].long()[b] * side + off
    return torch.sort((v[:, 0] << 42) | (v[:, 1] << 21) | v[:, 2]).values


def _side_timings(lv, cin, cout, side, g, plain=False, library=False,
                  pro=False):
    """One K1 shape on one level's real rulebook at ``side``, bf16: the
    fused (cin >= 8) or narrow kernel's ms over 20 launches, its bound
    (``utils/roofline.py`` at that side) and, where asked, its plain
    version's ms over 3, cuDNN ``conv3d`` over the oracle's assembled
    halo (assembly not timed) and the prologue variant's ms and bound."""
    import torch.nn.functional as F
    from doda_tpu_torch.ops import bricks
    from doda_tpu_torch.ops.banded_conv import (banded_conv_fused,
                                                banded_conv_fused_plain,
                                                banded_conv_narrow,
                                                occ_words)
    from doda_tpu_torch.utils import roofline
    bf = torch.bfloat16
    rows, cells = lv.occ.shape
    x3 = torch.randn(rows, cells, cin, device='cuda', generator=g)
    x2 = (x3 * lv.occ[..., None]).reshape(rows, -1).to(bf)
    w = (torch.randn(27, cin, cout, device='cuda', generator=g)
         / (27 * cin) ** 0.5).to(bf)
    narrow = cin < 8
    fn = banded_conv_narrow if narrow else banded_conv_fused
    reads = roofline.present_reads(lv.halo)
    work = (roofline.narrow_work if narrow else roofline.fused_work)(
        rows, cin, cout, reads, side)
    out = {'side': side, 'shape': [rows, cin, cout],
           'ms': cuda_ms(lambda: fn(x2, lv.nbr, w, bf), 20),
           'bound_ms': work['bound_ms'], 'bound_by': work['bound_by']}
    out['x_bound'] = out['ms'] / out['bound_ms']
    if plain:
        out['plain_ms'] = cuda_ms(
            lambda: banded_conv_fused_plain(x2, lv.nbr, w, bf), 3)
    if library:
        hin = bricks.shell_halo(x2.reshape(rows, cells, cin), lv.nbr,
                                bf).permute(0, 4, 1, 2, 3)
        wc = w.reshape(3, 3, 3, cin, cout).permute(4, 3, 0, 1, 2).contiguous(
            memory_format=torch.channels_last_3d)
        out['library_ms'] = cuda_ms(lambda: F.conv3d(hin, wc), 10)
        del hin
    if pro:
        scale = 1 + 0.2 * torch.randn(cin, device='cuda', generator=g)
        bias = 0.2 * torch.randn(cin, device='cuda', generator=g)
        bias[::2] = bias[::2].abs() + 0.1
        p = (scale, bias, occ_words(lv.occ))
        pw = roofline.prologue_work(rows, cin, cout, reads, side)
        out['prologue'] = {
            'ms': cuda_ms(lambda: banded_conv_fused(x2, lv.nbr, w, bf, p),
                          20),
            'bound_ms': pw['bound_ms'], 'bound_by': pw['bound_by']}
        if plain:
            out['prologue']['plain_ms'] = cuda_ms(
                lambda: banded_conv_fused_plain(x2, lv.nbr, w, bf, p), 3)
    return out


def _f32_timings(lv, side, g, cin=16, cout=16):
    """K1's float32 kernel (``banded_conv_f32``) at (cin -> cout) on one
    level's rulebook at ``side``, on activations masked to its active
    cells: ms over 20 launches, its float32 bound (operations on the CUDA
    cores, the taps the present halo cells need), its plain version's ms
    over 3, float32 cuDNN ``conv3d`` over the oracle's halo (TF32 off,
    assembly not timed) and the bf16 fused K1 on the same activations
    rounded to bf16."""
    import torch.nn.functional as F
    from doda_tpu_torch.ops import bricks
    from doda_tpu_torch.ops.banded_conv import (banded_conv_f32,
                                                banded_conv_fused,
                                                banded_conv_fused_plain,
                                                f32_smem_bytes)
    from doda_tpu_torch.utils import roofline
    f32, bf = torch.float32, torch.bfloat16
    rows, cells = lv.occ.shape
    x2 = (torch.randn(rows, cells, cin, device='cuda', generator=g)
          * lv.occ[..., None]).reshape(rows, -1)
    w = torch.randn(27, cin, cout, device='cuda', generator=g) \
        / (27 * cin) ** 0.5
    work = roofline.fused_work(rows, cin, cout,
                               roofline.present_reads(lv.halo), side, f32)
    got = banded_conv_f32(x2, lv.nbr, w, f32)
    ref = banded_conv_fused_plain(x2, lv.nbr, w, f32)
    err = _close(got, ref, True, F32_CHECKS[0][1], 'banded_conv_f32 timed')
    del got, ref
    out = {'side': side, 'shape': [rows, cin, cout], 'dtype': 'float32',
           'ms': cuda_ms(lambda: banded_conv_f32(x2, lv.nbr, w, f32), 20),
           'bound_ms': work['bound_ms'], 'bound_by': work['bound_by'],
           'flops': work['flops'], 'bytes': work['bytes'],
           'max_abs_err': err,
           'plain_ms': cuda_ms(
               lambda: banded_conv_fused_plain(x2, lv.nbr, w, f32), 3),
           'dynamic_smem_bytes': f32_smem_bytes(cin, cout, side)}
    out['x_bound'] = out['ms'] / out['bound_ms']
    xb, wb = x2.to(bf), w.to(bf)
    out['fused_bf16_ms'] = cuda_ms(
        lambda: banded_conv_fused(xb, lv.nbr, wb, bf), 20)
    del xb, wb
    hin = bricks.shell_halo(x2.reshape(rows, cells, cin), lv.nbr,
                            f32).permute(0, 4, 1, 2, 3)
    wc = w.reshape(3, 3, 3, cin, cout).permute(4, 3, 0, 1, 2).contiguous(
        memory_format=torch.channels_last_3d)
    out['library_ms'] = cuda_ms(lambda: F.conv3d(hin, wc), 10)
    del hin
    return out


def _sm_operands(lv, cin, cout, side, g, dtype):
    """Seeded activations masked to one level's active cells, assembled
    into K2's operands at ``side`` (``_assemble_sm``; not timed), and
    raster weights, in ``dtype``."""
    from doda_tpu_torch.ops import bricks2d
    rows, cells = lv.occ.shape
    x2 = (torch.randn(rows, cells, cin, device='cuda', generator=g)
          * lv.occ[..., None]).reshape(rows, -1)
    w = torch.randn(27, cin, cout, device='cuda', generator=g) \
        / (27 * cin) ** 0.5
    ops = bricks2d._assemble_sm(x2, bricks2d.sm_index(lv.nbr, side), dtype,
                                side)
    return ops, w.to(dtype)


def _sm_timings(lv, cin, cout, side, g, plain=False):
    """K2's second version at one (cin -> cout) on one level's rulebook at
    ``side``, bf16: ms over 20 launches, its bound (``utils/roofline.py``
    at that side, the taps the rulebook's present halo cells need) and,
    where asked, its plain version's ms over 3."""
    from doda_tpu_torch.ops.banded_conv_sm import (banded_conv_sm_taps,
                                                   banded_conv_sm_taps_plain,
                                                   sm_taps_smem_bytes)
    from doda_tpu_torch.utils import roofline
    bf = torch.bfloat16
    ops, w = _sm_operands(lv, cin, cout, side, g, bf)
    rows = lv.occ.shape[0]
    work = roofline.sm_taps_work(rows, cin, cout, side,
                                 reads=roofline.present_reads(lv.halo))
    out = {'side': side, 'shape': [rows, cin, cout],
           'ms': cuda_ms(lambda: banded_conv_sm_taps(*ops, w, bf), 20),
           'bound_ms': work['bound_ms'], 'bound_by': work['bound_by'],
           'dynamic_smem_bytes': sm_taps_smem_bytes(cin, side)}
    out['x_bound'] = out['ms'] / out['bound_ms']
    if plain:
        out['plain_ms'] = cuda_ms(
            lambda: banded_conv_sm_taps_plain(*ops, w, bf), 3)
    return out


def _sm_f32_timings(lv, side, g, cin=16, cout=16):
    """K2's float32 kernel (``banded_conv_sm_taps`` on float32 operands)
    at (cin -> cout) on one level's rulebook at ``side``: ms over 20
    launches, its float32 bound (operations on the CUDA cores, the taps
    the rulebook's present halo cells need, as K1 float32's) and its plain
    version's ms over 3."""
    from doda_tpu_torch.ops.banded_conv_sm import (banded_conv_sm_taps,
                                                   banded_conv_sm_taps_plain,
                                                   sm_taps_smem_bytes)
    from doda_tpu_torch.utils import roofline
    f32 = torch.float32
    ops, w = _sm_operands(lv, cin, cout, side, g, f32)
    rows = lv.occ.shape[0]
    work = roofline.sm_taps_work(rows, cin, cout, side, f32,
                                 roofline.present_reads(lv.halo))
    err = _close(banded_conv_sm_taps(*ops, w, f32),
                 banded_conv_sm_taps_plain(*ops, w, f32), True,
                 F32_CHECKS[0][1], 'K2 float32 timed')
    out = {'side': side, 'shape': [rows, cin, cout], 'dtype': 'float32',
           'ms': cuda_ms(lambda: banded_conv_sm_taps(*ops, w, f32), 20),
           'bound_ms': work['bound_ms'], 'bound_by': work['bound_by'],
           'flops': work['flops'], 'bytes': work['bytes'],
           'max_abs_err': err,
           'plain_ms': cuda_ms(
               lambda: banded_conv_sm_taps_plain(*ops, w, f32), 3),
           'dynamic_smem_bytes': sm_taps_smem_bytes(cin, side, f32)}
    out['x_bound'] = out['ms'] / out['bound_ms']
    return out


def phase_brick(cfg, batch, b_caps, card):
    """The brick side (``build_model(..., brick=2)``, the JAX package's
    ``DODA_BRICK=2``) on the flagship against side 4 (``b_caps``), on the
    bench scenes and the same seeded weights: the side-2 plan under
    ``synth.BRICK_CAPS_SIDE2`` (audited; every level's active voxels equal
    side 4's, integer for integer); each K1 kernel at side 2 against its
    plain version on the side-2 bench rulebooks (the fused K1 at every
    level, its prologue variant at levels 0-1, the narrow K1 at the input
    conv, the route 'padded' at level 0 at ``PADDED_WIDTHS``, the float32
    K1 at every level), and timed beside its
    side-2 bound, its plain version, cuDNN ``conv3d`` over the oracle's
    side-2 halo and the same kernel at side 4; then the model at both
    sides: the bf16 eval forward (predictions >= 99%, launches by route
    against ``subm_routes``, scenes/sec in turns, device time by bucket,
    launches and peak from a profiled forward), the ``fuse_norm`` forward
    at side 2 (the prologue K1), the float32 forward (logits 1e-3 of
    max(1, max|logit|)), one float32 train step (loss 1e-4 relative,
    gradients 1e-3 of their scale) and three bf16 train steps (step ms,
    peak). Returns the phase's launches by run and route, and the kernel
    readings for the kernels line."""
    from doda_tpu_torch.models import model_fn
    from doda_tpu_torch.models.unet import build_level_plan, flatten_plan
    from doda_tpu_torch.ops.banded_conv import (banded_conv_f32,
                                                banded_conv_fused,
                                                banded_conv_fused_plain)
    from doda_tpu_torch.ops.banded_conv_sm import (banded_conv_sm_taps,
                                                   banded_conv_sm_taps_plain)
    from doda_tpu_torch.utils import optim, synth
    t_phase = time.perf_counter()
    bf, f32 = torch.bfloat16, torch.float32
    caps = {4: tuple(b_caps), 2: synth.BRICK_CAPS_SIDE2}
    synth.capacity_audit(batch, caps[2], 2)
    n_valid = int(batch.valid.sum())
    batch = batch.to('cuda')
    valid = batch.valid

    # the plan: the same active voxels at every level, both sides
    plans = {s: build_level_plan(batch.coords, valid, caps[s], brick=s)
             for s in (4, 2)}
    voxels = []
    for lvl in range(len(b_caps)):
        count = 0
        for sc in range(valid.shape[0]):
            keys = {}
            for s, p in plans.items():
                table = p.grid0.table if lvl == 0 else p.downs[lvl - 1].parent
                keys[s] = _voxel_keys(_scene_table(table, sc),
                                      p.occs[lvl][sc], s)
            assert torch.equal(keys[2], keys[4]), (
                f'level {lvl} scene {sc}: active voxels differ by side')
            count += keys[2].numel()
        voxels.append(count)
    bricks_by_side = {s: [int(t.n.sum()) for t in [p.grid0.table]
                          + [d.parent for d in p.downs]]
                      for s, p in plans.items()}
    levels = {s: flatten_plan(p)[0] for s, p in plans.items()}
    del plans
    lv2, lv4 = levels[2], levels[4]
    plan = {'caps_side2': list(caps[2]), 'caps_side4': list(caps[4]),
            'active_voxels_per_level': voxels,
            'bricks_per_level': {f'side{s}': b
                                 for s, b in bricks_by_side.items()},
            'padded_cells_per_level': {
                f'side{s}': [lv.occ.numel() for lv in levels[s]]
                for s in (4, 2)}}

    # each K1 kernel at side 2 against its plain version
    g = torch.Generator(device='cuda').manual_seed(5)
    worst = {}
    for lvl, cin, cout in BRICK_K1_SHAPES:
        lv = lv2[lvl]
        rows = lv.nbr.shape[0]
        x2 = (torch.randn(rows, 8, cin, device='cuda', generator=g)
              * lv.occ[..., None]).reshape(rows, -1).to(bf)
        w = (torch.randn(27, cin, cout, device='cuda', generator=g)
             / (27 * cin) ** 0.5).to(bf)
        for dt, bound in FUSED_CHECKS:
            got = banded_conv_fused(x2, lv.nbr, w, dt)
            torch.cuda.synchronize()
            ref = banded_conv_fused_plain(x2, lv.nbr, w, dt)
            worst[f'K1f/L{lvl}/{cin}x{cout}/{str(dt)[6:]}'] = _close(
                got, ref, True, bound, f'side-2 fused K1 L{lvl} {dt}')
        if lvl <= 1 and cin == cout:
            check_fused_pro(worst, f'L{lvl}/{cin}x{cout}', x2, lv.nbr, w,
                            lv.occ, g)
    x2 = (torch.randn(lv2[0].nbr.shape[0], 8, 3, device='cuda', generator=g)
          * lv2[0].occ[..., None]).reshape(-1, 24).to(bf)
    w = (torch.randn(27, 3, 16, device='cuda', generator=g) / 9).to(bf)
    check_fused(worst, 'L0/3x16', x2, lv2[0].nbr, w, narrow=True)
    # the route 'padded' at side 2 on the level-0 side-2 rulebook
    for cin, cout in PADDED_WIDTHS:
        rows = lv2[0].nbr.shape[0]
        x2 = (torch.randn(rows, 8, cin, device='cuda', generator=g)
              * lv2[0].occ[..., None]).reshape(rows, -1).to(bf)
        w = (torch.randn(27, cin, cout, device='cuda', generator=g)
             / (27 * cin) ** 0.5).to(bf)
        check_padded(worst, f'L0/{cin}x{cout}', x2, lv2[0].nbr, w)
    # K1's float32 kernel at side 2 on every level's side-2 rulebook
    for lvl, cin, cout in F32_K1_SHAPES:
        lv = lv2[lvl]
        rows = lv.nbr.shape[0]
        x2 = (torch.randn(rows, 8, cin, device='cuda', generator=g)
              * lv.occ[..., None]).reshape(rows, -1)
        w = torch.randn(27, cin, cout, device='cuda', generator=g) \
            / (27 * cin) ** 0.5
        got = check_f32(worst, f'K1f32/L{lvl}/{cin}x{cout}',
                        lambda dt: banded_conv_f32(x2, lv.nbr, w, dt),
                        lambda dt: banded_conv_fused_plain(x2, lv.nbr, w,
                                                           dt))
        assert got.shape == (rows, 8 * cout)
    del x2, w, got
    torch.cuda.empty_cache()

    # K2 at side 2 against its plain version: bf16 operands to float32 and
    # bf16, float32 operands (its float32 kernel) to float32 and bf16
    for lvl, cin, cout in BRICK_K2_SHAPES:
        for op_dt in (bf, f32):
            ops, w = _sm_operands(lv2[lvl], cin, cout, 2, g, op_dt)
            if op_dt == bf:
                for dt, bound in K2_SIDE2_CHECKS:
                    got = banded_conv_sm_taps(*ops, w, dt)
                    torch.cuda.synchronize()
                    key = f'K2/L{lvl}/{cin}x{cout}/{str(dt)[6:]}'
                    worst[key] = _close(
                        got, banded_conv_sm_taps_plain(*ops, w, dt), True,
                        bound, f'side-2 {key}')
            else:
                got = check_f32(
                    worst, f'K2f32/L{lvl}/{cin}x{cout}',
                    lambda dt: banded_conv_sm_taps(*ops, w, dt),
                    lambda dt: banded_conv_sm_taps_plain(*ops, w, dt))
            assert got.shape == (lv2[lvl].occ.shape[0], 8 * cout)
            del ops, w, got
    torch.cuda.empty_cache()

    # the kernels timed at side 2 beside side 4, in this call
    timing = {'fused': [], 'narrow': [], 'f32': []}
    for lvl in range(7):
        p = 16 * (lvl + 1)
        for s, lv in ((4, lv4), (2, lv2)):
            timing['fused'].append(dict(level=lvl, **_side_timings(
                lv[lvl], p, p, s, g, plain=lvl == 0, library=lvl <= 1,
                pro=lvl <= 1)))
        torch.cuda.empty_cache()
    for s, lv in ((4, lv4), (2, lv2)):
        timing['narrow'].append(_side_timings(lv[0], 3, 16, s, g,
                                              plain=True, library=True))
        timing['f32'].append(_f32_timings(lv[0], s, g))
        torch.cuda.empty_cache()
    # K2: bf16 at every level, float32 at level 0
    timing['sm'], timing['sm_f32'] = [], []
    for lvl in range(7):
        p = 16 * (lvl + 1)
        for s, lv in ((4, lv4), (2, lv2)):
            timing['sm'].append(dict(level=lvl, **_sm_timings(
                lv[lvl], p, p, s, g, plain=lvl == 0)))
        torch.cuda.empty_cache()
    for s, lv in ((4, lv4), (2, lv2)):
        timing['sm_f32'].append(_sm_f32_timings(lv[0], s, g))
        torch.cuda.empty_cache()
    del levels, lv2, lv4
    torch.cuda.empty_cache()

    # the model at both sides, one seeded state
    sd = synth.seeded_state_dict(model_fn.build_model(cfg), seed=0)
    launched, model_r = {}, {}

    def evaluator(dtype, side, fuse=False, sm_max_cin=0):
        model = model_fn.build_model(cfg, dtype=dtype, brick=side,
                                     fuse_norm=fuse, sm_max_cin=sm_max_cin)
        model.load_state_dict(sd, strict=True)
        return model, model_fn.make_eval_step(cfg, model, caps[side])

    def counted(name, model, fn, rule=None):
        """``fn()`` between a reset of the launch counters and their
        reading, held to ``subm_routes``' rule (or ``rule``)."""
        _cli_reset()
        out = fn()
        torch.cuda.synchronize()
        ran = _launches()
        want = rule or {'prologue': 0, **model.subm_routes()}
        assert ran == want, (name, ran, want)
        launched[name] = ran
        return out

    steps, preds = {}, {}
    for s in (4, 2):
        model, step = evaluator(bf, s)
        step(batch)                                 # warm-up (set-up)
        out = counted(f'eval_bf16_side{s}', model, lambda: step(batch))
        assert out['output'].shape == (synth.BATCH, synth.N_CAP, 20)
        assert torch.isfinite(out['output']).all()
        assert int(out['count']) == n_valid
        preds[s] = out['preds']
        steps[s] = step
    assert launched['eval_bf16_side2'] == {
        'sm': 0, 'fused': 52, 'narrow': 1, 'f32': 0, 'padded': 0,
        'prologue': 0, 'cell_mean': 1}
    agree = (preds[2] == preds[4])[valid].float().mean().item()
    assert agree >= 0.99, f'bf16 preds side 2 vs 4 agree on {agree}'
    seconds = {4: [], 2: []}                        # in turns: 4, 2, 2, 4
    for s in (4, 2, 2, 4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            steps[s](batch)
        torch.cuda.synchronize()
        seconds[s].append((time.perf_counter() - t0) / 3)
    for s in (4, 2):
        torch.cuda.reset_peak_memory_stats()
        prof = _profile(lambda: steps[s](batch))
        model_r[f'eval_forward_side{s}'] = {
            'seconds_per_forward': seconds[s],
            'scenes_per_sec': synth.BATCH / min(seconds[s]),
            'peak_memory_gib': torch.cuda.max_memory_allocated() / 2 ** 30,
            'profiled': prof}
    del steps, model, step, out
    torch.cuda.empty_cache()
    model, step = evaluator(bf, 2, fuse=True)
    step(batch)
    out = counted('eval_bf16_fuse_norm_side2', model, lambda: step(batch))
    assert launched['eval_bf16_fuse_norm_side2'] == {
        'sm': 0, 'fused': 0, 'narrow': 1, 'f32': 0, 'padded': 0,
        'prologue': 52, 'cell_mean': 1}
    agree_fuse = (out['preds'] == preds[2])[valid].float().mean().item()
    assert agree_fuse >= 0.99, f'side-2 fuse_norm preds agree {agree_fuse}'
    del model, step, out
    torch.cuda.empty_cache()
    # K2 at side 2: the same forward with sm_max_cin=32
    model, step = evaluator(bf, 2, sm_max_cin=SM_MAX_CIN)
    step(batch)
    out = counted('eval_bf16_side2_sm32', model, lambda: step(batch))
    assert launched['eval_bf16_side2_sm32'] == {
        'sm': 15, 'fused': 37, 'narrow': 1, 'f32': 0, 'padded': 0,
        'prologue': 0, 'cell_mean': 1}
    agree_sm = (out['preds'] == preds[2])[valid].float().mean().item()
    assert agree_sm >= 0.99, f'side-2 sm_max_cin=32 preds agree {agree_sm}'
    del model, step, out, preds
    torch.cuda.empty_cache()
    logits = {}
    for s in (4, 2):
        model, step = evaluator(f32, s)
        logits[s] = counted(f'eval_f32_side{s}', model,
                            lambda: step(batch))['output']
        del model, step
    lim32 = 1e-3 * max(1.0, logits[4].abs().max().item())
    err32 = (logits[2] - logits[4]).abs().max().item()
    assert err32 <= lim32, f'float32 logits side 2 vs 4: {err32} > {lim32}'
    del logits
    torch.cuda.empty_cache()
    model_r['eval_forward'] = {
        'bf16_pred_agreement': agree,
        'bf16_fuse_norm_side2_pred_agreement': agree_fuse,
        'bf16_sm_max_cin_32_side2_pred_agreement': agree_sm,
        'f32_logit_max_abs_err': err32, 'f32_logit_bound': lim32}

    tbatch = synth.make_batch(seed=0, batch=synth.TRAIN_BATCH)
    for s in (4, 2):
        synth.capacity_audit(tbatch, caps[s], s)
    tbatch = tbatch.to('cuda')
    lr = optim.make_lr_fn(cfg.OPTIMIZATION, cfg.OPTIMIZATION.NUM_EPOCHS,
                          100)(1, 0)

    def trainer(dtype, s, sm_max_cin=0):
        model = model_fn.build_model(cfg, dtype=dtype, brick=s, train=True,
                                     sm_max_cin=sm_max_cin)
        model.load_state_dict(sd, strict=True)
        opt = optim.build_optimizer(cfg.OPTIMIZATION, model.parameters())
        return model, model_fn.make_train_step(cfg, model, opt, caps[s])

    def rule(model, n):
        fwd, bwd = model.subm_routes(), model.subm_routes(backward=True)
        return {k: n * (fwd.get(k, 0) + bwd.get(k, 0))
                for k in ('sm', 'fused', 'narrow', 'f32', 'padded',
                          'prologue', 'cell_mean')}

    first = {}
    for s in (4, 2):
        model, step = trainer(f32, s)
        loss = float(counted(f'train_f32_side{s}', model,
                             lambda: step(tbatch, lr),
                             rule(model, 1))['loss'])
        first[s] = (loss, {n: p.grad.float().clone()
                           for n, p in model.named_parameters()})
        del model, step
        torch.cuda.empty_cache()
    assert launched['train_f32_side2']['f32'] == 105
    assert launched['eval_f32_side2']['f32'] == 53
    # K2 at side 2: the float32 step with sm_max_cin=32 (its float32 kernel)
    model, step = trainer(f32, 2, SM_MAX_CIN)
    loss = float(counted('train_f32_side2_sm32', model,
                         lambda: step(tbatch, lr), rule(model, 1))['loss'])
    g2_sm = {n: p.grad.float().clone() for n, p in model.named_parameters()}
    del model, step
    assert launched['train_f32_side2_sm32']['sm'] == 31
    (l4, g4), (l2, g2) = first[4], first[2]
    assert abs(l2 - l4) <= 1e-4 * abs(l4), (l2, l4)
    l2_err, f32_worst = _grad_error(g2, g4)
    assert f32_worst <= 1e-3, f'float32 gradients side 2 vs 4: {f32_worst}'
    assert abs(loss - l2) <= 1e-4 * abs(l2), (loss, l2)
    sm_l2_err, sm_worst = _grad_error(g2_sm, g2)
    assert sm_worst <= 1e-3, \
        f'float32 gradients K2 vs K1 at side 2: {sm_worst}'
    del first, g4, g2, g2_sm
    torch.cuda.empty_cache()
    train = {'f32_loss_side4': l4, 'f32_loss_side2': l2,
             'f32_grad_rel_l2_err': l2_err,
             'f32_worst_gradient_err': f32_worst,
             'f32_loss_side2_sm32': loss,
             'f32_sm32_vs_sm0_side2_grad_rel_l2_err': sm_l2_err,
             'f32_sm32_vs_sm0_side2_worst_gradient_err': sm_worst}
    n_steps = 3
    for s, smc in ((4, 0), (2, 0), (2, SM_MAX_CIN)):
        model, step = trainer(bf, s, smc)
        step(tbatch, lr)                            # warm-up (set-up)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        run = f'bf16_side{s}' + (f'_sm{smc}' if smc else '')
        t0 = time.perf_counter()
        losses = counted(f'train_{run}', model, lambda: [
            float(step(tbatch, lr)['loss']) for _ in range(n_steps)],
            rule(model, n_steps))
        dt = time.perf_counter() - t0
        assert all(math.isfinite(v) for v in losses), losses
        train[run] = {
            'seconds_per_step': dt / n_steps,
            'trained_scenes_per_sec': n_steps * synth.TRAIN_BATCH / dt,
            'peak_memory_gib': torch.cuda.max_memory_allocated() / 2 ** 30,
            'losses': losses}
        del model, step
        torch.cuda.empty_cache()
    model_r['train'] = {'batch': synth.TRAIN_BATCH, 'lr': lr, **train}
    timing['sm_err'] = {'taps': worst['K2/L0/16x16/bfloat16'],
                        'f32': worst['K2f32/L0/16x16/float32']}
    log('brick', card=card, plan=plan, kernel_max_abs_err=worst,
        kernel_timing=timing, **model_r, launches=launched,
        phase_seconds=time.perf_counter() - t_phase)
    _cli_reset()
    return launched, timing


# the times of the first version of csrc/cell_mean.cu (a zero fill, then
# one thread a slot) at C = 3, "NVIDIA H100 80GB HBM3, 700.00 W" (PERF.md
# section 6), printed in phase feats' line beside the kernel's and kept
# out of the kernels line, whose numbers this run measures
FIRST_VERSION_MS = {4: 0.1039, 2: 0.0570}
BWD_C = 16                 # the gather's backward: the flagship's mid width


def _kernels_of(fn):
    """The CUDA kernels, by name and count, that torch.profiler records over
    one call of ``fn`` and one reduction of the first row of its output (a
    PyTorch kernel of known name in the session)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()[:1].sum()
        torch.cuda.synchronize()
    return {e.key: e.count for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA}


def feats_kernels():
    """Phase feats' launch check, run by ``phase_feats`` in a process of its
    own (there, after the earlier phases, torch.profiler recorded no kernel
    of a session this short, PyTorch's own included): the kernels of one
    ``cell_reduce_sorted`` call (mode 3, and a reduction after it) at C = 3
    on the bench batch's stream at sides 4 and 2 and at C = 16, bf16 and
    float32 out, at side 4; printed as one JSON line, by case."""
    from doda_tpu_torch.config import CfgNode, cfg_from_yaml_file
    from doda_tpu_torch.models import model_fn
    from doda_tpu_torch.models.unet import batch_stream, default_brick_caps
    from doda_tpu_torch.ops.cell_mean import cell_reduce_sorted
    from doda_tpu_torch.utils import synth
    cfg = cfg_from_yaml_file('cfgs/scannet/spconv.yaml', CfgNode())
    batch = synth.make_batch(seed=0).to('cuda')
    x = model_fn.model_input(cfg, batch)
    bt, n, c = x.shape
    x = x.reshape(bt * n, c).float().contiguous()
    out = {}
    for s, caps in ((4, default_brick_caps(synth.BRICK_CAP, 7)),
                    (2, synth.BRICK_CAPS_SIDE2)):
        g0 = model_fn.build_level_plan(batch.coords, batch.valid, caps[:1],
                                       brick=s).grid0
        rows, cells = bt * g0.occ.shape[1], g0.occ.shape[2]
        sc, sp = (t.view(bt, n) for t in batch_stream(g0))
        cases = {f'side{s}_c3_float32': (x, torch.float32)}
        if s == 4:
            ct = torch.randn(bt * n, BWD_C, device='cuda')
            cases.update({f'side4_c16_{str(dt)[6:]}': (ct, dt)
                          for dt in (torch.bfloat16, torch.float32)})
        for tag, (f, dt) in cases.items():
            out[tag] = _kernels_of(lambda: cell_reduce_sorted(
                f, sc, sp, rows, cells, 3, dt))
    print(json.dumps(out), flush=True)


def _one_launch_no_fill():
    """``feats_kernels`` in a fresh process: every case launches one
    ``cell_rows`` and nothing else but the reduction after it (no fill).
    Returns the kernels by case."""
    res = subprocess.run(
        [sys.executable, '-c', 'import chip_smoke; chip_smoke.feats_kernels()'],
        capture_output=True, text=True, timeout=600,
        cwd=Path(__file__).resolve().parent)
    assert res.returncode == 0, res.stderr[-3000:]
    kernels = json.loads(res.stdout.strip().splitlines()[-1])
    for tag, got in kernels.items():
        ours = [n for k, n in got.items() if 'cell_rows' in k]
        rest = {k: n for k, n in got.items() if 'cell_rows' not in k}
        assert ours == [1] and sum(rest.values()) == 1 \
            and all('reduce' in k for k in rest), (tag, got)
    assert len(kernels) == 4, kernels
    return kernels


def _feats_kernel(x, sc, sp, rows, cells, untouched, out_dtype, err, tag):
    """``cell_reduce_sorted`` on one input, modes 3 and 4, against its
    float64 twin (float32 out 1e-6 of max|ref|, bf16 out one bf16 step),
    bit-equal on a repeated call, exact zeros at the untouched cells. Mode
    3 and 4's float32 outputs are also held bit for bit against a float32
    ``index_add_`` in stream order on the CPU (the same adds in the same
    order), recorded. Returns mode 3's output."""
    from doda_tpu_torch.ops.cell_mean import (cell_reduce_sorted,
                                              cell_reduce_sorted_plain)
    c = x.shape[1]
    bound = 1e-6 if out_dtype == torch.float32 else 2.0 ** -7
    ids = sc.reshape(-1).long().cpu()
    keep = ids < rows * cells
    rows_cpu = x.cpu()[sp.reshape(-1).long().cpu()[keep]]
    seq = torch.zeros(rows * cells, c).index_add_(0, ids[keep], rows_cpu)
    count = torch.zeros(rows * cells).index_add_(
        0, ids[keep], torch.ones(int(keep.sum())))
    for mode in (3, 4):
        got = cell_reduce_sorted(x, sc, sp, rows, cells, mode, out_dtype)
        torch.cuda.synchronize()
        again = cell_reduce_sorted(x, sc, sp, rows, cells, mode, out_dtype)
        torch.cuda.synchronize()
        assert got.dtype == out_dtype
        assert torch.equal(got, again), f'{tag} mode {mode}: repeat'
        assert (got.reshape(rows, cells, c)[untouched] == 0).all(), tag
        err[f'{tag}_twin_mode{mode}'] = _close(
            got, cell_reduce_sorted_plain(x, sc, sp, rows, cells, mode,
                                          torch.float64), True, bound,
            f'{tag} mode {mode}')
        if out_dtype == torch.float32:
            ref = seq if mode == 3 else \
                seq / count.clamp(min=1.0)[:, None]
            err[f'{tag}_bit_equal_cpu_index_add_mode{mode}'] = torch.equal(
                got.cpu(), ref.reshape(rows, cells * c))
        if mode == 3:
            total = got
        del again
    return total


def phase_feats(cfg, batch, b_caps, card):
    """The point -> cell reduction on the bench batch at brick sides 4
    and 2: the sorted kernel (``cell_reduce_sorted``, csrc/cell_mean.cu)
    on the points' features (C = 3) and, at side 4, as the voxel -> point
    gather's backward (C = 16, a seeded float32 cotangent, bf16 and
    float32 out) against its float64 twin, modes 3 and 4, bit-equal on a
    repeated call, exact zeros at the cells no point reaches
    (``_feats_kernel``), one launch and no fill a call
    (``_one_launch_no_fill``); at C = 3 against the scatter
    route too (``bricks.cell_feats_2d``, ``index_add_`` over each point's
    flat cell id, float32 atomics in another order: 1e-5 of max|ref|);
    its ms beside its bound, the first version's (``FIRST_VERSION_MS``),
    the twin's, the scatter route's, ``index_reduce_``'s (the library call
    at C = 3) and ``index_select``'s autograd backward (a zero fill and
    ``index_add_``: the library call of the gather's backward). Then the
    flagship's eval forward: two forwards bit-equal with deterministic
    algorithms off (float32 logits; bf16 logits and predictions), one
    launch a forward, and its device time by bucket
    (``tools/trace_fwd.py``'s) and bf16 wall time in turns beside the same
    forward with the scatter route patched in for the kernel, in two pairs
    of turns whose order alternates, with the host time spent inside each
    route's call.
    Returns the kernel's readings and the counted runs' launches."""
    from doda_tpu_torch.models import model_fn, unet
    from doda_tpu_torch.models.unet import _flat_ids, batch_stream
    from doda_tpu_torch.ops.bricks import cell_feats_2d
    from doda_tpu_torch.ops.cell_mean import (cell_reduce_sorted,
                                              cell_reduce_sorted_plain)
    from doda_tpu_torch.utils import roofline, synth
    t_phase = time.perf_counter()
    assert not torch.are_deterministic_algorithms_enabled()
    launches_a_call = _one_launch_no_fill()
    caps = {4: b_caps, 2: synth.BRICK_CAPS_SIDE2}
    synth.capacity_audit(batch, caps[2], 2)
    dbatch = batch.to('cuda')
    x = model_fn.model_input(cfg, dbatch)
    bt, n, c = x.shape
    x = x.reshape(bt * n, c).float().contiguous()
    sd = synth.seeded_state_dict(model_fn.build_model(cfg), seed=0)
    readings, launched = {}, {}
    for s in (4, 2):
        plan = model_fn.build_level_plan(dbatch.coords, dbatch.valid,
                                         caps[s][:1], brick=s)
        g0 = plan.grid0
        cap0, cells = g0.occ.shape[1:]
        rows = bt * cap0
        sc, sp = (t.view(bt, n) for t in batch_stream(g0))
        flat = _flat_ids(g0.flat_index(), cap0 * cells)   # the scatter ids
        untouched = ~g0.occ.reshape(rows, cells)
        err = {}
        _feats_kernel(x, sc, sp, rows, cells, untouched, torch.float32, err,
                      'c3')
        for mode in (3, 4):
            got = cell_reduce_sorted(x, sc, sp, rows, cells, mode)
            err[f'scatter_mode{mode}'] = _close(
                got, cell_feats_2d(x, flat, rows, mode, cells), True, 1e-5,
                f'cell_reduce_sorted vs scatter side {s} mode {mode}')
        mean = got

        def library():
            return torch.zeros((rows * cells + 1, c), device='cuda')\
                .index_reduce_(0, flat, x, 'mean', include_self=False)
        err['library_mode4'] = _close(
            mean, library()[:-1].reshape(rows, cells * c), True, 1e-5,
            f'index_reduce_ side {s}')
        del got
        n_valid = int((sc < rows * cells).sum())
        n_active = int(g0.occ.sum())
        work = roofline.cell_mean_work(bt * n, n_valid, c, rows * cells,
                                       n_active)
        readings[s] = {
            'shape': {'points': bt * n, 'valid_points': n_valid,
                      'channels': c, 'rows': rows, 'cells': cells,
                      'active_cells': n_active},
            'max_abs_err': err['c3_twin_mode4'], 'errors': err,
            'ms': cuda_ms(lambda: cell_reduce_sorted(x, sc, sp, rows, cells),
                          50),
            'first_version_ms': FIRST_VERSION_MS[s],
            'plain_ms': cuda_ms(lambda: cell_reduce_sorted_plain(
                x, sc, sp, rows, cells), 5),
            'scatter_route_ms': cuda_ms(
                lambda: cell_feats_2d(x, flat, rows, 4, cells), 20),
            'library_ms': cuda_ms(library, 20), **work}
        if s == 4:
            # the gather's backward: the float32 cotangent of every point
            # into the (rows*cells, 16) cell table, against index_select's
            # autograd backward (the cotangent in the table's type, a zero
            # fill, index_add_)
            gen = torch.Generator(device='cuda').manual_seed(16)
            ct = torch.randn(bt * n, BWD_C, device='cuda', generator=gen)
            idx = flat.clamp(max=rows * cells - 1)
            miss = (flat >= rows * cells)[:, None]
            ct = torch.where(miss, 0, ct)          # as the head's where
            bwd = {}
            for dt in (torch.bfloat16, torch.float32):
                name = str(dt)[6:]
                total = _feats_kernel(ct, sc, sp, rows, cells, untouched,
                                      dt, err, f'c16_{name}')

                def index_select_bwd(dt=dt):
                    return torch.zeros((rows * cells, BWD_C), dtype=dt,
                                       device='cuda').index_add_(
                        0, idx, ct.to(dt))
                err[f'c16_{name}_vs_index_select_bwd'] = _close(
                    total, index_select_bwd().reshape(rows, -1), True,
                    2.0 ** -7 if dt == torch.bfloat16 else 1e-5,
                    f'gather backward {name} vs index_add_')
                bwd[name] = {
                    'max_abs_err': err[f'c16_{name}_twin_mode3'],
                    'ms': cuda_ms(lambda dt=dt: cell_reduce_sorted(
                        ct, sc, sp, rows, cells, 3, dt), 50),
                    'plain_ms': cuda_ms(lambda dt=dt: cell_reduce_sorted_plain(
                        ct, sc, sp, rows, cells, 3, dt), 3),
                    'library_ms': cuda_ms(index_select_bwd, 20),
                    **roofline.cell_mean_work(
                        bt * n, n_valid, BWD_C, rows * cells, n_active, 3,
                        dt.itemsize)}
                del total
            readings[s]['gather_backward'] = bwd
            del ct, idx, miss
        del plan, g0, untouched, mean
        torch.cuda.empty_cache()

        host_ms = []                    # host time inside the reduction

        def timed(fn):
            def call(*args):
                t0 = time.perf_counter()
                out = fn(*args)
                host_ms.append(1e3 * (time.perf_counter() - t0))
                return out
            return call

        def scatter(feats, sort_cell, sort_pos, rows, cells, mode=4):
            # the scatter route over the batch's flat ids in point order,
            # in the kernel's place in the forward
            return cell_feats_2d(feats, flat, rows, mode, cells)

        def route(name):
            return patch.object(unet, 'cell_reduce_sorted', timed(
                scatter if name == 'scatter' else cell_reduce_sorted))

        # the flagship's eval forward, one model a dtype, the route
        # switched in place: the kernel's bit-equal on a repeat, then both
        # routes' device time, and their bf16 forwards timed on the host
        # clock in two pairs of turns, the kernel first in one of them
        # (sorted, scatter, scatter, sorted)
        runs = {}
        for dtype in (torch.float32, torch.bfloat16):
            model = model_fn.build_model(cfg, dtype=dtype, brick=s)
            model.load_state_dict(sd, strict=True)
            step = model_fn.make_eval_step(cfg, model, caps[s])
            for feats in ('sorted', 'scatter'):
                with route(feats):
                    step(dbatch)                    # warm-up (set-up)
                    torch.cuda.synchronize()
                    _cli_reset()                    # the counted path
                    a = step(dbatch)
                    torch.cuda.synchronize()
                    ran = _launches()
                    tag = f'eval_{str(dtype)[6:]}_{feats}_side{s}'
                    assert ran == {'prologue': 0, **model.subm_routes(),
                                   'cell_mean': int(feats == 'sorted')}, (
                                       tag, ran)
                    launched[tag] = ran
                    b = step(dbatch)
                    torch.cuda.synchronize()
                    same = (torch.equal(a['output'], b['output']),
                            torch.equal(a['preds'], b['preds']))
                    if feats == 'sorted':
                        assert same == (True, True), (tag, same)
                    run = {'logits_bit_equal_on_repeat': same[0],
                           'preds_equal_on_repeat': same[1]}
                    if dtype == torch.bfloat16:
                        run['profiled'] = _profile(lambda: step(dbatch))
                runs[tag] = run
                del a, b
            if dtype == torch.float32:
                del model, step
                torch.cuda.empty_cache()
        seconds = {'sorted': [], 'scatter': []}
        inside = {'sorted': [], 'scatter': []}
        for feats in ('sorted', 'scatter', 'scatter', 'sorted'):
            host_ms.clear()
            with route(feats):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(3):
                    step(dbatch)
                torch.cuda.synchronize()
            seconds[feats].append((time.perf_counter() - t0) / 3)
            inside[feats].append(sum(host_ms) / len(host_ms))
        del model, step, flat
        torch.cuda.empty_cache()
        # each pair's sorted - scatter gap (ms), by which of the two ran
        # first: a gap that follows the route keeps its sign in both lists
        gap = [1e3 * (a - b) for a, b in zip(seconds['sorted'],
                                             seconds['scatter'])]
        readings[s]['eval_forward'] = runs
        readings[s]['bf16_seconds_per_forward_in_turns'] = seconds
        readings[s]['bf16_gap_ms_sorted_first'] = gap[0::2]
        readings[s]['bf16_gap_ms_scatter_first'] = gap[1::2]
        readings[s]['bf16_host_ms_inside_the_reduction'] = inside
    log('feats', card=card, deterministic_algorithms=False,
        side4=readings[4], side2=readings[2], launches=launched,
        kernels_a_call=launches_a_call,
        phase_seconds=time.perf_counter() - t_phase)
    _cli_reset()
    return readings, launched


REMATS = ('off', 'dots', 'all', 'mix2')
REMAT_BATCH = 4            # the DA cfgs' batch


def _launches():
    """The launch counters of every kernel, by route, the prologue K1's
    apart from the fused K1's."""
    from doda_tpu_torch.ops.banded_conv import banded_conv_fused
    return {**_cli_launches(), 'prologue': banded_conv_fused.pro_launches}


def _remat_run(cfg, sd, remat, step_of, steps, fuse_norm=False):
    """A fresh model of ``cfg`` with the state ``sd`` under ``remat``: one
    step under deterministic algorithms from ``sd`` (its losses,
    gradients and running statistics are the policy's readings), then
    ``steps - 1`` more, the second and third of them timed on the host
    clock (step ms, peak memory) and a fourth, where ``steps`` is 4,
    through ``torch.profiler`` (device ms). ``step_of(model, opt)`` makes
    the step, a function of no argument. Launches are counted over all
    the steps and checked against the rule of ``subm_routes``."""
    from doda_tpu_torch.models import model_fn
    from doda_tpu_torch.utils import optim
    from doda_tpu_torch.utils.device import deterministic
    t0 = time.perf_counter()
    model = model_fn.build_model(cfg, train=True, remat=remat,
                                 fuse_norm=fuse_norm)
    model.load_state_dict(sd, strict=True)
    opt = optim.build_optimizer(cfg.OPTIMIZATION, model.parameters())
    step, terms = step_of(model, opt)
    fwd, bwd = model.subm_routes(), model.subm_routes(True)
    rule = {k: terms * (fwd.get(k, 0) + bwd.get(k, 0))
            for k in ('fused', 'prologue', 'narrow', 'f32', 'padded',
                      'sm', 'cell_mean')}
    _cli_reset()
    torch.cuda.reset_peak_memory_stats()
    with deterministic():
        out = step()
    run = {'losses': {k: float(v) for k, v in out.items()
                      if k.startswith('loss')},
           'grads': {n: p.grad.float().clone()
                     for n, p in model.named_parameters()},
           'stats': {k: v.clone() for k, v in model.state_dict().items()
                     if k.rsplit('.', 1)[-1] in ('mean', 'var')}}
    if steps > 1:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        for _ in range(2):
            step()
        torch.cuda.synchronize()
        run['step_ms'] = (time.perf_counter() - t1) / 2 * 1e3
        run['peak_gib'] = torch.cuda.max_memory_allocated() / 2 ** 30
        prof = _profile(step)
        run['device_ms'] = prof['device_ms']
        run['kernel_launches'] = prof['kernel_launches']
    else:
        run['peak_gib'] = torch.cuda.max_memory_allocated() / 2 ** 30
    ran = _launches()
    want = {k: steps * v for k, v in rule.items()}
    assert ran == want, (remat, fuse_norm, ran, want)
    run['launches_per_step'] = rule
    run['launches'] = ran
    del model, opt, step
    torch.cuda.empty_cache()
    run['seconds'] = time.perf_counter() - t0
    return run


def _remat_errors(run, ref, what):
    """``run``'s losses, gradients and running statistics against
    ``ref``'s, to phase train's bf16 bounds: loss 1e-4 relative, each
    gradient 1e-3 of max(1, max|ref|), statistics 1e-3."""
    loss = max(abs(v - ref['losses'][k]) / abs(ref['losses'][k])
               for k, v in run['losses'].items())
    assert loss <= 1e-4, (what, run['losses'], ref['losses'])
    grad = 0.0
    for n, g in ref['grads'].items():
        err = (run['grads'][n] - g).abs().max().item() \
            / max(1.0, g.abs().max().item())
        assert err <= 1e-3, f'{what}: gradient {n}: {err}'
        grad = max(grad, err)
    stat = max((run['stats'][k] - v).abs().max().item()
               for k, v in ref['stats'].items())
    assert stat <= 1e-3, (what, stat)
    return {'loss_rel': loss, 'grad': grad, 'stats': stat}


def phase_remat(card):
    """The blocks' memory policies in the CLI-shaped train step: the DA
    flagship (cfgs/da_front3d_scannet/spconv.yaml: 11 classes, mid 16, 7
    levels) at the cfgs' batch of 4 bench rooms, bf16, ``sm_max_cin=0``,
    one seeded state, under 'off', 'dots', 'all' and 'mix2', each from
    that state: losses, gradients and running statistics of its first
    step (deterministic algorithms) against 'off''s, launches by route of
    four steps against ``subm_routes``' rule with the replays (under
    'dots' equal to 'off''s: no K1 runs again), step ms and peak memory
    over two steps, device ms of one profiled step. Then an st step (DSNorm:
    the source on domain 0, the target on domain 1) under 'all' against
    'off', each domain's running statistics moved once; then a step with
    ``fuse_norm=True`` under 'all' against 'off', whose replay runs the
    prologue K1. Returns the launches by route of every step."""
    from doda_tpu_torch.config import CfgNode, cfg_from_yaml_file
    from doda_tpu_torch.models import model_fn
    from doda_tpu_torch.models.unet import default_brick_caps
    from doda_tpu_torch.utils import synth
    t0 = time.perf_counter()
    cfg = cfg_from_yaml_file(CFG_DA, CfgNode())
    n_classes = cfg.COMMON_CLASSES.n_classes
    b_caps = default_brick_caps(cfg.DATA_CONFIG.DATA_PROCESSOR.brick_cap, 7)
    # the source rooms are the bench batch's (seed 0), audited in main()
    # against caps no larger at any level
    assert all(a >= b for a, b in zip(b_caps, default_brick_caps(
        synth.BRICK_CAP, 7)))
    src = synth.make_batch(seed=0, batch=REMAT_BATCH, n_classes=n_classes)
    tar = synth.make_batch(seed=1, batch=REMAT_BATCH, n_classes=n_classes)
    synth.capacity_audit(tar, b_caps)
    src, tar = src.to('cuda'), tar.to('cuda')
    sd = synth.seeded_state_dict(model_fn.build_model(cfg), seed=0)
    lr = cfg.OPTIMIZATION.base_lr

    def train(model, opt):
        step = model_fn.make_train_step(cfg, model, opt, b_caps)
        return (lambda: step(src, lr)), 1

    runs = {r: _remat_run(cfg, sd, r, train, 4) for r in REMATS}
    off = runs['off']
    assert runs['dots']['launches'] == off['launches'], runs['dots']
    assert runs['all']['peak_gib'] < off['peak_gib'], (
        runs['all']['peak_gib'], off['peak_gib'])
    report = {}
    for r, run in runs.items():
        report[r] = {k: run[k] for k in (
            'step_ms', 'device_ms', 'peak_gib', 'kernel_launches',
            'launches_per_step', 'seconds')}
        if r != 'off':
            report[r]['vs_off'] = _remat_errors(run, off, r)
    log('remat', card=card, cfg=CFG_DA, batch=REMAT_BATCH,
        dtype='bfloat16', sm_max_cin=0, policies=report)

    # the st step: both domains' norms, replayed under 'all'
    st_cfg = cfg_from_yaml_file(CFG_ST, CfgNode())
    sd_st = synth.seeded_state_dict(model_fn.build_model(st_cfg), seed=0)
    w_src = st_cfg.SELF_TRAIN.SRC.get('loss_weight', 1.0)
    w_tar = st_cfg.SELF_TRAIN.TAR.get('loss_weight', 1.0)

    def st(model, opt):
        step = model_fn.make_st_step(st_cfg, model, opt, b_caps)
        return (lambda: step(src, tar, lr, w_src, w_tar)), 2

    st_runs = {r: _remat_run(st_cfg, sd_st, r, st, 1)
               for r in ('off', 'all')}
    st_err = _remat_errors(st_runs['all'], st_runs['off'], 'st all')
    moved = {}
    for d in (0, 1):            # each domain's statistics moved, once
        moved[d] = min((v[d] - sd_st[k].cuda()[d]).abs().max().item()
                       for k, v in st_runs['all']['stats'].items())
        assert moved[d] > 10 * st_err['stats'], (d, moved[d], st_err)

    # fuse_norm: the replay runs K1's prologue variant
    fuse_runs = {r: _remat_run(cfg, sd, r, train, 1, fuse_norm=True)
                 for r in ('off', 'all')}
    fuse_err = _remat_errors(fuse_runs['all'], fuse_runs['off'],
                             'fuse_norm all')
    pro = fuse_runs['all']['launches']['prologue']
    assert pro == 2 * fuse_runs['off']['launches']['prologue'] > 0, pro
    log('remat_st_fuse_norm', card=card,
        st={r: {k: run[k] for k in ('peak_gib', 'launches_per_step',
                                   'seconds')}
            for r, run in st_runs.items()},
        st_all_vs_off=st_err,
        st_least_statistic_move_by_domain=moved,
        fuse_norm={r: {k: run[k] for k in ('peak_gib', 'launches_per_step',
                                          'seconds')}
                   for r, run in fuse_runs.items()},
        fuse_norm_all_vs_off=fuse_err,
        phase_seconds=time.perf_counter() - t0)
    launches = {}
    for run in [*runs.values(), *st_runs.values(), *fuse_runs.values()]:
        for k, v in run['launches'].items():
            launches[k] = launches.get(k, 0) + v
    return launches


def phase_pointops(card):
    """Every point op, offset wrapper and voxelization function of the
    port on the card against the same function on the CPU, on one bench
    scene's points (metres): integer outputs equal, floats to
    rtol = atol = 1e-5; the host library's voxel hash against its numpy
    path."""
    import numpy as np
    from doda_tpu_torch.native import host_ops
    from doda_tpu_torch.ops import pointops as po
    from doda_tpu_torch.ops import pointops_offsets as pof
    from doda_tpu_torch.ops import voxelize as vox
    from doda_tpu_torch.utils import synth
    t_phase = time.perf_counter()
    rng = np.random.default_rng(3)
    xyz = synth.make_scene(rng).astype(np.float32) / 50.0   # (150k, 3) m
    n = len(xyz)
    sub = rng.permutation(n)[:16384]
    base, q = xyz[sub], xyz[sub[:4096]] + 0.01
    feats = rng.normal(size=(n, 4)).astype(np.float32)
    times, errs = {}, {}

    def both(name, fn, *args, exact=False):
        """fn on the card and on the CPU; returns the card's outputs."""
        outs = {}
        for dev in ('cuda', 'cpu'):
            a = [torch.as_tensor(x).to(dev) if isinstance(x, np.ndarray)
                 else x for x in args]
            if dev == 'cuda':
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a)
            if dev == 'cuda':
                torch.cuda.synchronize()
            times[f'{name}/{dev}_ms'] = (time.perf_counter() - t0) * 1e3
            outs[dev] = out if isinstance(out, tuple) else (out,)
        for i, (g, c) in enumerate(zip(outs['cuda'], outs['cpu'])):
            g, c = g.cpu(), c
            if exact or not g.is_floating_point():
                assert torch.equal(g, c), f'{name}[{i}] card != CPU'
                errs[f'{name}[{i}]'] = 0.0
            else:
                torch.testing.assert_close(g, c, rtol=1e-5, atol=1e-5,
                                           msg=f'{name}[{i}]')
                errs[f'{name}[{i}]'] = (g - c).abs().max().item()
        return outs['cuda']

    sel, = both('furthest_point_sampling',
                lambda x: po.furthest_point_sampling(x, 4096), xyz)
    assert len(torch.unique(sel)) == 4096
    idx, _ = both('knn', lambda a, b: po.knn(16, a, b), q, base)
    both('grouping', po.grouping, base, idx.cpu().numpy())
    both('interpolation', lambda a, b, f: po.interpolation(a, b, f), base,
         q, feats[sub])
    f1, fb = feats[sub[:4096]], feats[sub]
    both('subtraction', po.subtraction, f1, fb, idx.cpu().numpy())
    pos = rng.normal(size=(4096, 16, 4)).astype(np.float32)
    wgt = rng.normal(size=(4096, 16, 2)).astype(np.float32)
    both('aggregation', po.aggregation, fb, pos, wgt, idx.cpu().numpy())
    bidx, cnt = both('ballquery', lambda a: po.ballquery(a, 0.05, 16),
                     base[:4096])
    assert (cnt > 1).any()
    sem = (base[:4096, 2] > 0.5).astype(np.int32)
    clusters, = both('bfs_cluster', lambda b, s, v: po.bfs_cluster(b, s, v),
                     bidx.cpu().numpy(), sem, np.ones(4096, bool))
    offsets = np.array([0, 1000, 1000, 2500, 4096], np.int32)
    for name in ('sec_mean', 'sec_min', 'sec_max'):     # min/max: exact,
        both(name, getattr(po, name), f1, offsets,       # inf when empty
             exact=name != 'sec_mean')
    pids = np.where(clusters.cpu().numpy() < 64,
                    clusters.cpu().numpy(), -1).astype(np.int32)
    both('roipool', lambda f, p: po.roipool(f, p, 64), f1, pids)
    both('get_iou', lambda p, s: po.get_iou(p, s, 64, 2), pids, sem)

    two = np.concatenate([base[:4096], base[4096:8192] + 50.0])
    off, new_off = np.array([4096, 8192]), np.array([1024, 2048])
    both('offsets.furthestsampling', lambda x: pof.furthestsampling(
        x, off, new_off), two)
    both('offsets.knnquery', lambda x: pof.knnquery(16, x, None, off, off),
         two)
    both('offsets.queryandgroup', lambda x, f: pof.queryandgroup(
        8, x, None, f, None, off, off), two, fb[:8192])
    both('offsets.interpolation', lambda x, y, f: pof.interpolation(
        x, y, f, off, off), two, two + 0.01, fb[:8192])

    coords = np.floor(xyz / 0.05).astype(np.int32)            # 0.05 m
    valid = np.ones(n, bool)
    table = both('voxelize_coords', lambda c, v: tuple(
        vox.voxelize_coords(c, v, 131072).table), coords, valid)
    assert 0 < int(table[2]) < 131072        # no voxel overflowed
    for mode in (1, 2, 3, 4):
        both(f'voxelize_feats/{mode}', lambda c, v, f: vox.voxelize_feats(
            f, vox.voxelize_coords(c, v, 131072), mode), coords, valid,
            feats, exact=mode in (1, 2))
    both('devoxelize_feats', lambda c, v, f: vox.devoxelize_feats(
        vox.voxelize_feats(f, g := vox.voxelize_coords(c, v, 131072), 4),
        g), coords, valid, feats)
    p2v, hv = host_ops.voxelize_unique(coords)
    p2v_np, hv_np = host_ops.voxelize_unique(coords, native=False)
    assert np.array_equal(p2v, p2v_np) and np.array_equal(hv, hv_np)
    hm = host_ops.voxelize_mean(feats, p2v, len(hv))
    np.testing.assert_allclose(hm, host_ops.voxelize_mean(
        feats, p2v, len(hv), native=False), rtol=1e-5, atol=1e-5)
    log('pointops', card=card, points=n, queries=4096, base=16384,
        fps_samples=4096, knn_k=16, voxel_m=0.05, voxels=int(table[2]),
        host_voxels=len(hv),
        max_abs_err=errs, ms=times,
        phase_seconds=time.perf_counter() - t_phase)


CLI_POINTS = 150_000       # points per synthetic room of the cli phases
CFG_DA = 'cfgs/da_front3d_scannet/spconv.yaml'
CFG_ST = 'cfgs/da_front3d_scannet/spconv_st.yaml'
DEVICE_AUG = ['DATA_CONFIG.DATA_AUG.device', 'True',
              'DATA_CONFIG_TAR.DATA_AUG.device', 'True']


def _cli_launches():
    """The launch counters of every kernel, by route: 'sm' counts K2 in
    both dtypes, 'f32' K1 in float32, 'padded' the fused or narrow K1 on
    zero-padded operands (counted apart from their own routes),
    'cell_mean' the sorted point -> cell reduction."""
    from doda_tpu_torch.ops.banded_conv import (banded_conv_f32,
                                                banded_conv_fused,
                                                banded_conv_narrow,
                                                banded_conv_padded)
    from doda_tpu_torch.ops.banded_conv_sm import banded_conv_sm_taps
    from doda_tpu_torch.ops.cell_mean import cell_reduce_sorted
    return {'sm': banded_conv_sm_taps.launches
            + banded_conv_sm_taps.f32_launches,
            'fused': banded_conv_fused.launches,
            'narrow': banded_conv_narrow.launches,
            'f32': banded_conv_f32.launches,
            'padded': banded_conv_padded.launches,
            'cell_mean': cell_reduce_sorted.launches}


def _cli_reset():
    """Every kernel's launch counters to 0."""
    from doda_tpu_torch.ops.banded_conv import (banded_conv_f32,
                                                banded_conv_fused,
                                                banded_conv_narrow,
                                                banded_conv_padded)
    from doda_tpu_torch.ops.banded_conv_sm import banded_conv_sm_taps
    from doda_tpu_torch.ops.cell_mean import cell_reduce_sorted
    banded_conv_padded.launches = banded_conv_fused.launches = 0
    banded_conv_narrow.launches = banded_conv_f32.launches = 0
    banded_conv_sm_taps.launches = banded_conv_sm_taps.f32_launches = 0
    banded_conv_fused.pro_launches = cell_reduce_sorted.launches = 0


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
    assert fwd == {'sm': 0, 'fused': 52, 'narrow': 1, 'f32': 0,
                   'padded': 0, 'cell_mean': 1}, fwd
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


PLY_HEADER = ['ply', 'format ascii 1.0', None, 'property float x',
              'property float y', 'property float z', 'property uchar red',
              'property uchar green', 'property uchar blue', 'end_header']


def check_visualize(tmp, dumps):
    """``python -m doda_tpu_torch.tools.visualize``'s ``main`` on one
    ScanNet room with ``test``'s txt dumps: each .ply file's header, its
    vertex count (the room's points) and its colours (ground truth and
    predictions from the palette or the ignore gray, the predictions'
    those of the dumped ids)."""
    import numpy as np
    from doda_tpu_torch.tools import visualize
    from doda_tpu_torch.utils.visualize import class_palette
    t0 = time.perf_counter()
    scene = sorted((tmp / 'scannetv2' / 'val').glob('*.pth'))[0]
    prefix = visualize.main([
        '--dataset', 'scannet', '--data_root', str(tmp / 'scannetv2'),
        '--split', 'val', '--scene', scene.stem, '--result_dir', str(dumps),
        '--out', str(tmp / 'vis')])
    n = _points(scene)
    palette = class_palette('scannet')
    allowed = {tuple(c) for c in palette.tolist()} | {(128, 128, 128)}
    preds = np.loadtxt(dumps / f'{scene.stem}.txt', dtype=np.int64)
    files = {}
    for kind in ('input', 'gt', 'pred'):
        path = Path(f'{prefix}_{kind}.ply')
        lines = path.read_text().splitlines()
        head = PLY_HEADER[:2] + [f'element vertex {n}'] + PLY_HEADER[3:]
        assert lines[:len(head)] == head, (kind, lines[:len(head)])
        body = lines[len(head):]
        assert len(body) == n, (kind, len(body), n)
        cols = np.array([ln.split()[3:] for ln in body], np.int64)
        seen = np.unique(cols, axis=0)
        assert (cols >= 0).all() and (cols <= 255).all(), kind
        if kind != 'input':
            assert {tuple(c) for c in seen.tolist()} <= allowed, kind
        if kind == 'pred':
            assert np.array_equal(cols, palette[preds]), kind
        files[kind] = {'bytes': path.stat().st_size, 'vertices': len(body),
                       'colours': len(seen)}
    return {'scene': scene.stem, 'files': files,
            'seconds': time.perf_counter() - t0}


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
                                  allacc=result['allacc'],
                                  visualize=check_visualize(tmp, out / 'txt'))
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

    # both evaluations run with deterministic algorithms, so that their
    # mIoUs can be held equal exactly (the sorted point -> cell reduction
    # needs none)
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


def time_k1(nbr, halo, occ, cin, cout, g):
    """K1 on one level's real rulebook, bf16: the fused kernel, its plain
    version and bound; its prologue variant beside the unfused sequence it
    replaces (``MaskedBatchNorm`` apply + ReLU + mask + the fused kernel);
    the plane gather alone (``_assemble_p6``, which dW still reads). Bytes,
    operations and bounds are ``doda_tpu_torch/utils/roofline.py``'s."""
    from doda_tpu_torch.models.norm import MaskedBatchNorm
    from doda_tpu_torch.ops import bricks2d
    from doda_tpu_torch.ops.banded_conv import (banded_conv_fused,
                                                banded_conv_fused_plain,
                                                fused_smem_bytes, occ_words)
    from doda_tpu_torch.utils import roofline
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
    reads = roofline.present_reads(halo)
    fused = {'ms': fused_ms, 'plain_ms': fused_plain_ms,
             'max_abs_err': err,
             **roofline.fused_work(rows, cin, cout, reads),
             'dynamic_smem_bytes': fused_smem_bytes(cin, cout)}

    # the prologue variant: the same x2 read raw, the folded scale and bias
    # of an eval-mode norm (bias > 0 on some channels), the level's
    # occupancy words (made once a level, not timed)
    norm = MaskedBatchNorm(cin).cuda().eval()
    with torch.no_grad():
        norm.mean.normal_(0, 0.2, generator=g)
        norm.var.uniform_(0.5, 1.5, generator=g)
        norm.scale.normal_(1, 0.2, generator=g)
        norm.bias.normal_(0, 0.2, generator=g)
        scale, bias = norm(x2, occ, fold=True)
    assert (bias > 0).any()
    pro = (scale, bias, occ_words(occ))
    outp = banded_conv_fused(x2, nbr, w, bf, pro)
    refp = banded_conv_fused_plain(x2, nbr, w, bf, pro)
    errp = _close(outp, refp, True, 2e-2, 'prologue K1 at a timing shape')
    del refp, outp
    pro_ms = cuda_ms(lambda: banded_conv_fused(x2, nbr, w, bf, pro), 20)
    pro_plain_ms = cuda_ms(
        lambda: banded_conv_fused_plain(x2, nbr, w, bf, pro), 3)

    def unfused():
        with torch.no_grad():
            h = torch.relu(norm(x2, occ))          # apply, mask, ReLU
        return banded_conv_fused(h, nbr, w, bf)

    unfused_ms = cuda_ms(unfused, 20)
    prologue = {'ms': pro_ms, 'plain_ms': pro_plain_ms, 'max_abs_err': errp,
                **roofline.prologue_work(rows, cin, cout, reads),
                'unfused_sequence_ms': unfused_ms,
                'fused_kernel_alone_ms': fused_ms, 'library_ms': None,
                'dynamic_smem_bytes': fused_smem_bytes(cin, cout, True)}

    assembly_ms = cuda_ms(lambda: bricks2d._assemble_p6(x2, halo, bf), 10)
    return {'shape': [rows, cin, cout], 'fused': fused,
            'prologue': prologue, 'assembly_ms': assembly_ms}


def time_narrow(nbr, halo, occ, g):
    """K1's narrow-input version at the bench input conv (3 -> 16, bf16)
    on the level-0 rulebook, on seeded activations masked to the active
    cells: the kernel, its plain version and bound; beside it the fused K1
    on x2 and w zero-padded to cin = 8 with the padding pass (the cheapest
    route otherwise at hand, on no path); and cuDNN ``conv3d`` over the
    oracle's assembled halo, the library call of the same function.
    Bounds are ``utils/roofline.py``'s."""
    import torch.nn.functional as F
    from doda_tpu_torch.ops import bricks, bricks2d
    from doda_tpu_torch.ops.banded_conv import (banded_conv_fused,
                                                banded_conv_fused_plain,
                                                banded_conv_narrow)
    from doda_tpu_torch.utils import roofline
    bf = torch.bfloat16
    rows, cin, cout = nbr.shape[0], 3, 16
    x3 = torch.randn(rows, 64, cin, device='cuda', generator=g)
    x2 = (x3 * occ[..., None]).reshape(rows, -1).to(bf)
    w = (torch.randn(27, cin, cout, device='cuda', generator=g)
         / (27 * cin) ** 0.5).to(bf)
    out = banded_conv_narrow(x2, nbr, w, bf)
    ref = banded_conv_fused_plain(x2, nbr, w, bf)
    err = _close(out, ref, True, 2e-2, 'banded_conv_narrow at the input conv')
    del ref
    ms = cuda_ms(lambda: banded_conv_narrow(x2, nbr, w, bf), 20)
    plain_ms = cuda_ms(lambda: banded_conv_fused_plain(x2, nbr, w, bf), 3)
    w8 = F.pad(w, (0, 0, 0, 8 - cin)).contiguous()

    def padded():
        x8 = F.pad(x2.reshape(rows, 64, cin), (0, 8 - cin))
        return banded_conv_fused(x8.reshape(rows, -1), nbr, w8, bf)

    vs_padded = _close(padded(), out, True, 2e-2,
                       'padded fused K1 vs narrow at the input conv')
    padded_ms = cuda_ms(padded, 20)
    hin = bricks.shell_halo(x2.reshape(rows, 64, cin), nbr, bf).permute(
        0, 4, 1, 2, 3)
    wc = w.reshape(3, 3, 3, cin, cout).permute(4, 3, 0, 1, 2).contiguous(
        memory_format=torch.channels_last_3d)
    lib = F.conv3d(hin, wc).permute(0, 2, 3, 4, 1).reshape(rows, -1)
    lib_err = _close(bricks2d._mask(lib, occ, cout),
                     bricks2d._mask(out, occ, cout), True, 2e-2,
                     'conv3d vs narrow at the input conv')
    library_ms = cuda_ms(lambda: F.conv3d(hin, wc), 10)
    f32_ms = cuda_ms(lambda: banded_conv_narrow(x2, nbr, w, torch.float32),
                     20)
    return {'shape': [rows, cin, cout], 'ms': ms, 'plain_ms': plain_ms,
            'max_abs_err': err,
            **roofline.narrow_work(rows, cin, cout,
                                   roofline.present_reads(halo)),
            'library_ms': library_ms, 'library_max_abs_err': lib_err,
            'f32_out_ms': f32_ms, 'padded_fused_ms': padded_ms,
            'padded_fused_vs_narrow_max_abs_err': vs_padded}


def time_padded(nbr, halo, occ, cin, cout, g):
    """The route 'padded' at (cin -> cout), bf16, on one level's real
    rulebook, on seeded activations masked to the active cells: its ms
    (the padding copy, the kernel and the slice), its plain version's, its
    bound at the true widths and, as ``padded_*``, the launched kernel's
    at the padded widths (``utils/roofline.py::padded_work``); the
    launched kernel alone on the padded operands, the padding copy alone,
    and cuDNN ``conv3d`` over the oracle's assembled halo, the library
    call of the same function."""
    import torch.nn.functional as F
    from doda_tpu_torch.ops import bricks, bricks2d
    from doda_tpu_torch.ops.banded_conv import (NARROW_MAX_CIN,
                                                banded_conv_fused,
                                                banded_conv_fused_plain,
                                                banded_conv_narrow,
                                                banded_conv_padded,
                                                pad_channels)
    from doda_tpu_torch.utils import roofline
    bf = torch.bfloat16
    rows = nbr.shape[0]
    x3 = torch.randn(rows, 64, cin, device='cuda', generator=g)
    x2 = (x3 * occ[..., None]).reshape(rows, -1).to(bf)
    w = (torch.randn(27, cin, cout, device='cuda', generator=g)
         / (27 * cin) ** 0.5).to(bf)
    key = f'banded_conv_padded {cin} -> {cout} at a timing shape'
    out = banded_conv_padded(x2, nbr, w, bf)
    ref = banded_conv_fused_plain(x2, nbr, w, bf)
    err = _close(out, ref, True, 2e-2, key)
    del ref
    ms = cuda_ms(lambda: banded_conv_padded(x2, nbr, w, bf), 20)
    plain_ms = cuda_ms(lambda: banded_conv_fused_plain(x2, nbr, w, bf), 3)
    xp, wp = pad_channels(x2, w)
    kernel = (banded_conv_narrow if wp.shape[1] <= NARROW_MAX_CIN
              else banded_conv_fused)
    kernel_ms = cuda_ms(lambda: kernel(xp, nbr, wp, bf), 20)
    padding_ms = cuda_ms(lambda: pad_channels(x2, w), 20)
    del xp
    hin = bricks.shell_halo(x2.reshape(rows, 64, cin), nbr, bf).permute(
        0, 4, 1, 2, 3)
    wc = w.reshape(3, 3, 3, cin, cout).permute(4, 3, 0, 1, 2).contiguous(
        memory_format=torch.channels_last_3d)
    lib = F.conv3d(hin, wc).permute(0, 2, 3, 4, 1).reshape(rows, -1)
    lib_err = _close(bricks2d._mask(lib, occ, cout),
                     bricks2d._mask(out, occ, cout), True, 2e-2,
                     f'conv3d vs {key}')
    del lib
    library_ms = cuda_ms(lambda: F.conv3d(hin, wc), 10)
    return {'shape': [rows, cin, cout], 'ms': ms, 'plain_ms': plain_ms,
            'max_abs_err': err,
            **roofline.padded_work(rows, cin, cout,
                                   roofline.present_reads(halo)),
            'launched': kernel.__name__, 'kernel_alone_ms': kernel_ms,
            'padding_ms': padding_ms, 'library_ms': library_ms,
            'library_max_abs_err': lib_err}


def time_k2(b, cin, cout, g):
    """K2 at (B, cin, cout) on random operands laid out as the path lays
    them (x contiguous, gyz/gxm/gxp column slices of one gathered buffer):
    bf16 (``sm_taps_tc``), its plain version and bound; float32
    (``sm_taps_f32``, the float32 'sm' convs), its plain version and
    bound (float32 on the CUDA cores). Every cell is present, so every tap
    is needed (``doda_tpu_torch/utils/roofline.py``)."""
    from doda_tpu_torch.ops.banded_conv_sm import (banded_conv_sm_taps,
                                                   banded_conv_sm_taps_plain,
                                                   sm_taps_smem_bytes)
    from doda_tpu_torch.utils import roofline
    bf, f32 = torch.bfloat16, torch.float32
    x = torch.randn(b, 64 * cin, device='cuda', generator=g)
    buf = torch.randn(b, 176 * cin, device='cuda', generator=g)
    ops = (x, buf[:, :96 * cin], buf[:, 96 * cin:136 * cin],
           buf[:, 136 * cin:])
    w = torch.randn(27, cin, cout, device='cuda', generator=g) \
        / (27 * cin) ** 0.5
    bufb, wb = buf.to(bf), w.to(bf)
    opsb = (x.to(bf), bufb[:, :96 * cin], bufb[:, 96 * cin:136 * cin],
            bufb[:, 136 * cin:])
    out = banded_conv_sm_taps(*opsb, wb, bf)
    ref = banded_conv_sm_taps_plain(*opsb, wb, bf)
    err = _close(out, ref, True, 2e-2, f'banded_conv_sm_taps at {b}x{cin}')
    del ref, out
    ms = cuda_ms(lambda: banded_conv_sm_taps(*opsb, wb, bf), 20)
    plain_ms = cuda_ms(lambda: banded_conv_sm_taps_plain(*opsb, wb, bf), 3)
    taps = {'ms': ms, 'plain_ms': plain_ms, 'max_abs_err': err,
            **roofline.sm_taps_work(b, cin, cout),
            'dynamic_smem_bytes': sm_taps_smem_bytes(cin)}
    del opsb, bufb
    got = banded_conv_sm_taps(*ops, w, f32)
    ref = banded_conv_sm_taps_plain(*ops, w, f32)
    f32_err = _close(got, ref, True, F32_CHECKS[0][1],
                     f'banded_conv_sm_taps float32 at {b}x{cin}')
    del got, ref
    work = roofline.sm_taps_work(b, cin, cout, 4, f32)
    f32_taps = {'dtype': 'float32',
                'ms': cuda_ms(lambda: banded_conv_sm_taps(*ops, w, f32), 20),
                'plain_ms': cuda_ms(
                    lambda: banded_conv_sm_taps_plain(*ops, w, f32), 3),
                'max_abs_err': f32_err, 'bound_ms': work['bound_ms'],
                'bound_by': work['bound_by'], 'flops': work['flops'],
                'bytes': work['bytes'],
                'dynamic_smem_bytes': sm_taps_smem_bytes(cin, 4, f32)}
    return {'shape': [b, cin, cout], 'taps': taps, 'f32': f32_taps}


def phase_timing(levels, launches, fuse_launches, library, engine_launches,
                 f32_runs):
    """Each kernel at the level-0 bench shape, and at the level-1 shape:
    the bf16 ones and the float32 ones. ``launches`` maps a route to its
    (eval forward, train steps) counts; ``fuse_launches`` and
    ``engine_launches`` the launches by route of each counted run of
    phases fuse_norm and engines; ``f32_runs`` the launches by route of
    every counted float32 run at side 4 (the float32 kernels' rows);
    ``library`` phase engines' ``F.conv3d`` readings over the oracle's
    halo, the library call of the subm conv that K1 and K2 compute."""
    from doda_tpu_torch.ops import _build
    from doda_tpu_torch.utils import synth
    b, cin, cout = synth.BATCH * synth.BRICK_CAP, 16, 16
    g = torch.Generator(device='cuda').manual_seed(2)
    rows = []

    # K1: one row. Its own numbers are the fused version's, which runs 52
    # of the 53 convs of a forward; the route 'padded' (the fused or narrow
    # K1 on zero-padded operands, the bf16 widths no cfg has) stands under
    # 'padded', at 12 -> 20 and 20 -> 12 on the level-0 rulebook
    l0 = time_k1(levels[0].nbr, levels[0].halo, levels[0].occ, 16, 16, g)
    l1 = time_k1(levels[1].nbr, levels[1].halo, levels[1].occ, 32, 32, g)
    assert l0['shape'] == [b, cin, cout], l0['shape']
    for name, t in (('level 0', l0), ('level 1', l1)):
        log('timing', kernel='banded_conv', at=name, dtype='bfloat16', **t)
    assert l0['fused']['executed_flops'] <= 2.9e11
    fused_fwd, fused_train = launches['fused']
    f0 = l0['fused']
    lv0 = levels[0]
    pads = [time_padded(lv0.nbr, lv0.halo, lv0.occ, ci, co, g)
            for ci, co in ((12, 20), (20, 12))]
    for t in pads:
        log('timing', kernel='banded_conv_padded', at='level 0',
            dtype='bfloat16', **t)
    pad_fwd, pad_train = launches['padded']
    pad_fuse = sum(n['padded'] for n in fuse_launches.values())
    pad_eng = sum(n['padded'] for n in engine_launches.values())
    padded = {
        'name': 'banded_conv_padded', 'route': 'cuda',
        'source': 'doda_tpu_torch/csrc/banded_conv_fused.cu (cin > 7) and '
                  'doda_tpu_torch/csrc/subm_conv_narrow.cu (cin <= 7) on '
                  'operands zero-padded by doda_tpu_torch/ops/'
                  'banded_conv.py::pad_channels',
        'replaces': 'doda_tpu/ops/pallas_banded.py:71 at the bf16 widths '
                    'neither the fused nor the narrow K1 takes as they are',
        'launches': pad_fwd + pad_train + pad_fuse + pad_eng,
        'launches_fuse_norm_phase': pad_fuse,
        'launches_engines_phase': pad_eng,
        'launches_eval_forward': pad_fwd, 'launches_train_steps': pad_train,
        **{k: pads[0][k] for k in ('max_abs_err', 'ms', 'plain_ms',
                                   'bound_ms', 'bound_by', 'library_ms')},
        'library': "torch.nn.functional.conv3d over the shell-gather "
                   "oracle's assembled (rows, 6, 6, 6, cin) bf16 halo, "
                   'channels-last (assembly not timed)',
        'widths': pads}
    fuse_phase = sum(n['fused'] + n['prologue']
                     for n in fuse_launches.values())
    eng_phase = sum(n['fused'] for n in engine_launches.values())
    lib = {'call': 'torch.nn.functional.conv3d over the shell-gather '
                   "oracle's assembled (rows, 6, 6, 6, cin) bf16 halo, "
                   'channels-last (phase engines)', **library}
    rows.append({
        'name': 'banded_conv', 'route': 'cuda',
        'source': 'doda_tpu_torch/csrc/banded_conv_fused.cu',
        'replaces': 'doda_tpu/ops/pallas_banded.py:71',
        'launches': fused_fwd + fused_train + fuse_phase + eng_phase,
        'launches_fuse_norm_phase': fuse_phase,
        'launches_engines_phase': eng_phase,
        'launches_eval_forward': fused_fwd,
        'launches_train_steps': fused_train,
        'max_abs_err': f0['max_abs_err'], 'ms': f0['ms'],
        'plain_ms': f0['plain_ms'], 'bound_ms': f0['bound_ms'],
        'bound_by': f0['bound_by'],
        # the same function from one PyTorch call: cuDNN's conv3d over the
        # oracle's assembled halo at the same shape (its assembly not
        # timed)
        'library_ms': library['level0']['conv3d_ms'],
        'library': lib,
        'fused_ms': f0['ms'], 'fused_bound_ms': f0['bound_ms'],
        'assembly_ms': l0['assembly_ms'],
        'executed_flops': f0['executed_flops'],
        'dynamic_smem_bytes': f0['dynamic_smem_bytes'],
        **_build.resources('banded_conv_fused'),
        'padded': padded,
        'prologue': {
            'source': 'doda_tpu_torch/csrc/banded_conv_fused.cu (PRO)',
            'replaces': 'doda_tpu/ops/pallas_banded.py:71 under '
                        'DODA_FUSE_NORM (doda_tpu/ops/bricks2d.py:746)',
            'launches': sum(n['prologue'] for n in fuse_launches.values()),
            'launches_by_run': {k: n['prologue']
                                for k, n in fuse_launches.items()},
            **l0['prologue'],
            'level1': {k: l1['prologue'][k] for k in (
                'ms', 'plain_ms', 'bound_ms', 'bound_by',
                'unfused_sequence_ms', 'fused_kernel_alone_ms')}},
        'level1': {'shape': l1['shape'], 'fused_ms': l1['fused']['ms'],
                   'fused_bound_ms': l1['fused']['bound_ms'],
                   'fused_bound_by': l1['fused']['bound_by'],
                   'fused_plain_ms': l1['fused']['plain_ms'],
                   'assembly_ms': l1['assembly_ms'],
                   'library_ms': library['level1']['conv3d_ms']}})

    # K2: the bf16 kernel's row (its float32 kernel has a row of its own)
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
        # the same subm conv at the same shape: phase engines' conv3d over
        # the oracle's assembled halo (level 0, 16 -> 16)
        'library_ms': library['level0']['conv3d_ms'],
        'library': lib,
        'executed_flops': t0['executed_flops'],
        'dynamic_smem_bytes': t0['dynamic_smem_bytes'],
        **_build.resources('banded_conv_sm_taps', 'sm_taps_tc'),
        'level1': {'shape': k1['shape'], 'ms': k1['taps']['ms'],
                   'bound_ms': k1['taps']['bound_ms'],
                   'bound_by': k1['taps']['bound_by'],
                   'plain_ms': k1['taps']['plain_ms']}})

    # K1's narrow-input version: a row of its own (its own source), and
    # its readings beside the fused version's in K1's row
    n0 = time_narrow(levels[0].nbr, levels[0].halo, levels[0].occ, g)
    log('timing', kernel='banded_conv_narrow', at='input conv',
        dtype='bfloat16', **n0)
    fwd, train = launches['narrow']
    n_fuse = sum(n['narrow'] for n in fuse_launches.values())
    n_eng = sum(n['narrow'] for n in engine_launches.values())
    rows.append({
        'name': 'banded_conv_narrow', 'route': 'cuda',
        'source': 'doda_tpu_torch/csrc/subm_conv_narrow.cu',
        'replaces': 'doda_tpu/ops/pallas_banded.py:71 on the input conv '
                    '(doda_tpu/ops/bricks2d.py:572, planes of :330)',
        'launches': fwd + train + n_fuse + n_eng,
        'launches_eval_forward': fwd, 'launches_train_steps': train,
        'launches_fuse_norm_phase': n_fuse,
        'launches_engines_phase': n_eng,
        **n0,
        'library': "torch.nn.functional.conv3d over the shell-gather "
                   "oracle's assembled (rows, 6, 6, 6, 3) bf16 halo, "
                   'channels-last (assembly not timed)',
        **_build.resources('subm_conv_narrow')})
    rows[0]['narrow'] = {k: n0[k] for k in (
        'shape', 'ms', 'bound_ms', 'bound_by', 'plain_ms', 'padded_fused_ms',
        'library_ms')}

    # K1 in float32 (csrc/subm_conv_f32.cu): every float32 conv that K2
    # does not take, forward and dx, beside its float32 bound, its plain
    # version, float32 conv3d over the oracle's halo and the bf16 fused K1
    # of the same call
    f0 = _f32_timings(levels[0], 4, g)
    f1 = _f32_timings(levels[1], 4, g, 32, 32)
    for name, t in (('level 0', f0), ('level 1', f1)):
        log('timing', kernel='banded_conv_f32', at=name, **t)
    by_run = {run: n['f32'] for run, n in f32_runs.items() if n['f32']}
    f32_lib = ("torch.nn.functional.conv3d in float32 (TF32 off) over the "
               "shell-gather oracle's (rows, 6, 6, 6, cin) float32 halo, "
               'channels-last (assembly not timed)')
    rows.append({
        'name': 'banded_conv_f32', 'route': 'cuda',
        'source': 'doda_tpu_torch/csrc/subm_conv_f32.cu',
        'replaces': 'doda_tpu/ops/pallas_banded.py:71 on float32 operands '
                    '(with doda_tpu/ops/bricks2d.py::_assemble_p6)',
        'launches': sum(by_run.values()), 'launches_by_run': by_run,
        **{k: f0[k] for k in ('max_abs_err', 'ms', 'plain_ms', 'bound_ms',
                              'bound_by', 'library_ms', 'dtype', 'shape',
                              'flops', 'bytes', 'x_bound', 'fused_bf16_ms',
                              'dynamic_smem_bytes')},
        'library': f32_lib, **_build.resources('subm_conv_f32'),
        'level1': {k: f1[k] for k in ('shape', 'ms', 'plain_ms', 'bound_ms',
                                      'bound_by', 'library_ms',
                                      'fused_bf16_ms')}})
    # K2 in float32 (sm_taps_f32): the float32 'sm' convs
    s0 = k0['f32']
    by_run = {run: n['sm'] for run, n in f32_runs.items() if n['sm']}
    log('timing', kernel='banded_conv_sm_taps float32', at='level 0', **s0)
    rows.append({
        'name': 'banded_conv_sm_taps float32', 'route': 'cuda',
        'source': 'doda_tpu_torch/csrc/banded_conv_sm_taps.cu (sm_taps_f32)',
        'replaces': 'doda_tpu/ops/pallas_sm.py:83 on float32 operands',
        'launches': sum(by_run.values()), 'launches_by_run': by_run,
        **{k: s0[k] for k in ('max_abs_err', 'ms', 'plain_ms', 'bound_ms',
                              'bound_by', 'dtype', 'flops', 'bytes',
                              'dynamic_smem_bytes')},
        'shape': k0['shape'],
        # the same subm conv at the same shape in float32: K1 float32's
        # conv3d reading over the oracle's halo (level 0, 16 -> 16), and
        # the bf16 fused K1 of that reading
        'library_ms': f0['library_ms'], 'library': f32_lib,
        'fused_bf16_ms': f0['fused_bf16_ms'],
        **_build.resources('banded_conv_sm_taps', 'sm_taps_f32'),
        'level1': {'shape': k1['shape'], 'ms': k1['f32']['ms'],
                   'bound_ms': k1['f32']['bound_ms'],
                   'plain_ms': k1['f32']['plain_ms']}})
    return rows


def add_brick_phase(rows, launched, timing):
    """Phase brick's launches (``launches_brick_phase``, by run) into the
    kernel rows, and its readings at side 2 beside side 4's: the fused K1
    (every level; level 0 with its plain version and ``conv3d``), its
    prologue variant and the narrow K1. Three rows of their own at side 2
    are appended: K2 in bf16 (every level, beside the side-2 fused K1 and
    K2 at side 4 of the same call), K1 in float32 and K2 in float32 (level
    0, beside side 4). Their library call is cuDNN ``conv3d`` over the
    oracle's side-2 halo at the same shape, from the K1 readings of the
    phase (bf16, and float32 for the float32 kernels). The float32 runs at
    side 4 count in the side-4 float32 rows (``f32_runs`` of
    ``phase_timing``)."""
    from doda_tpu_torch.ops import _build

    def total(route, runs=None):
        return sum(n[route] for run, n in launched.items()
                   if runs is None or run in runs)

    def pair(readings, level=None):
        got = {r['side']: r for r in readings
               if level is None or r['level'] == level}
        two, four = dict(got[2]), got[4]
        two['side4_ms'] = four['ms']
        two['side4_bound_ms'] = four['bound_ms']
        two['side2_over_side4'] = two['ms'] / four['ms']
        return two

    k1, k2, narrow = rows[:3]
    fused_l0 = pair(timing['fused'], 0)
    pro = fused_l0.pop('prologue')
    pro4 = next(r for r in timing['fused']
                if r['side'] == 4 and r['level'] == 0)['prologue']
    for row, n, reading in (
            (k1, total('fused') + total('prologue'), fused_l0),
            (k1['prologue'], total('prologue'),
             {**pro, 'side4_ms': pro4['ms'],
              'side2_over_side4': pro['ms'] / pro4['ms']}),
            (k1['padded'], total('padded'), None),
            (k2, 0, None),
            (narrow, total('narrow'), pair(timing['narrow']))):
        row['launches_brick_phase'] = n
        row['launches'] += n
        if reading is not None:
            row['brick2'] = reading
    k1['launches_brick_phase_by_run'] = launched
    k1['brick2']['levels'] = [
        {k: v for k, v in pair(timing['fused'], lvl).items()
         if k != 'prologue'} for lvl in range(7)]

    # K2 at side 2: the bf16 runs launch sm_taps_tc, the float32 step
    # sm_taps_f32 (the row after next)
    sm_runs = [run for run, n in launched.items() if n['sm']]
    taps_runs = [run for run in sm_runs if 'bf16' in run]
    fused2 = {r['level']: r for r in timing['fused'] if r['side'] == 2}
    sm_levels = []
    for lvl in range(7):
        reading = pair(timing['sm'], lvl)
        reading['fused_k1_side2_ms'] = fused2[lvl]['ms']
        reading['side2_over_fused_k1'] = reading['ms'] / fused2[lvl]['ms']
        sm_levels.append(reading)
    l0 = sm_levels[0]
    err = timing['sm_err']
    rows.append({
        'name': 'banded_conv_sm_taps at side 2', 'route': 'cuda',
        'source': 'doda_tpu_torch/csrc/banded_conv_sm_taps.cu (S = 2)',
        'replaces': 'doda_tpu/ops/pallas_sm.py:83 under DODA_BRICK=2',
        'launches': total('sm', taps_runs),
        'launches_by_run': {run: launched[run]['sm'] for run in taps_runs},
        'max_abs_err': err['taps'], 'ms': l0['ms'],
        'plain_ms': l0['plain_ms'], 'bound_ms': l0['bound_ms'],
        'bound_by': l0['bound_by'],
        'library_ms': fused2[0]['library_ms'],
        'library': "torch.nn.functional.conv3d over the shell-gather "
                   "oracle's assembled side-2 (rows, 4, 4, 4, cin) bf16 "
                   'halo, channels-last (phase brick)',
        'shape': l0['shape'], 'side4_ms': l0['side4_ms'],
        'fused_k1_side2_ms': l0['fused_k1_side2_ms'],
        'dynamic_smem_bytes': l0['dynamic_smem_bytes'],
        **_build.resources('banded_conv_sm_taps', 'sm_taps_tc'),
        'levels': sm_levels})
    # the float32 kernels at side 2: every float32 run at side 2 launches
    # K1's, the sm_max_cin=32 step K2's
    f32_runs = [run for run in launched if 'f32' in run and 'side2' in run]
    k1f2, k2f2 = pair(timing['f32']), pair(timing['sm_f32'])
    f32_lib = ("torch.nn.functional.conv3d in float32 (TF32 off) over the "
               "shell-gather oracle's assembled side-2 (rows, 4, 4, 4, cin) "
               'float32 halo, channels-last (phase brick)')
    rows.append({
        'name': 'banded_conv_f32 at side 2', 'route': 'cuda',
        'source': 'doda_tpu_torch/csrc/subm_conv_f32.cu (S = 2)',
        'replaces': 'doda_tpu/ops/pallas_banded.py:71 on float32 operands '
                    'under DODA_BRICK=2',
        'launches': total('f32', f32_runs),
        'launches_by_run': {run: launched[run]['f32'] for run in f32_runs},
        **{k: k1f2[k] for k in ('max_abs_err', 'ms', 'plain_ms', 'bound_ms',
                                'bound_by', 'library_ms', 'dtype', 'shape',
                                'side4_ms', 'side4_bound_ms',
                                'side2_over_side4', 'fused_bf16_ms',
                                'dynamic_smem_bytes')},
        'library': f32_lib, **_build.resources('subm_conv_f32')})
    sm_f32_runs = [run for run in f32_runs if launched[run]['sm']]
    rows.append({
        'name': 'banded_conv_sm_taps float32 at side 2', 'route': 'cuda',
        'source': 'doda_tpu_torch/csrc/banded_conv_sm_taps.cu '
                  '(sm_taps_f32, S = 2)',
        'replaces': 'doda_tpu/ops/pallas_sm.py:83 on float32 operands '
                    'under DODA_BRICK=2',
        'launches': total('sm', sm_f32_runs),
        'launches_by_run': {run: launched[run]['sm'] for run in sm_f32_runs},
        'max_abs_err': err['f32'],
        **{k: k2f2[k] for k in ('ms', 'plain_ms', 'bound_ms', 'bound_by',
                                'dtype', 'shape', 'side4_ms',
                                'side4_bound_ms', 'side2_over_side4',
                                'dynamic_smem_bytes')},
        'library_ms': k1f2['library_ms'], 'library': f32_lib,
        'fused_bf16_ms': k1f2['fused_bf16_ms'],
        **_build.resources('banded_conv_sm_taps', 'sm_taps_f32')})
    assert len(taps_runs) == 2 and sm_f32_runs == ['train_f32_side2_sm32'], (
        sm_runs, f32_runs)


def main():
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is false',
              file=sys.stderr)
        return 1
    from doda_tpu_torch.config import CfgNode, cfg_from_yaml_file
    from doda_tpu_torch.models.unet import default_brick_caps
    from doda_tpu_torch.ops import _build
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

    fwd, fwd32 = phase_forward(cfg, batch, b_caps, card)
    train, train32 = phase_train(cfg, b_caps, card)
    repeat_launches = phase_repeat(cfg, card)
    fuse_launches = phase_fuse_norm(cfg, batch, b_caps, card)
    library, engine_launches = phase_engines(cfg, batch, b_caps, card,
                                             levels)
    brick_launches, brick_timing = phase_brick(cfg, batch, b_caps, card)
    feats, feats_launches = phase_feats(cfg, batch, b_caps, card)
    del batch
    remat_launches = phase_remat(card)
    phase_pointops(card)
    tmp = Path(tempfile.mkdtemp(prefix='chip_smoke_cli_'))
    try:
        ctx = cli_rooms(tmp)
        cli, host, ckpt = phase_cli(card, ctx)
        cli.update(phase_import(card, ctx))
        cli.update(phase_device_aug(card, ctx, ckpt, host))
        cli.update(phase_ddp(card, ctx, cfg, b_caps))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    # every counted float32 run at side 4 launches the float32 kernels:
    # their rows' launches
    f32_runs = {'eval_f32_forward': fwd32,
                'train_f32_sm_max_cin_32': train32,
                **{f'fuse_norm_{k}': v for k, v in fuse_launches.items()
                   if 'f32' in k},
                **{f'engines_{k}': v for k, v in engine_launches.items()
                   if 'f32' in k},
                **{f'brick_{k}': v for k, v in brick_launches.items()
                   if 'f32' in k and 'side4' in k}}
    rows = phase_timing(levels, {k: (fwd[k], train[k]) for k in fwd},
                        fuse_launches, library, engine_launches, f32_runs)
    # each CLI run's launches, counted in the cli phases, join each
    # kernel's (the CLIs run bf16 at sm_max_cin=0: no float32 kernel, no
    # 'padded' and no 'sm' conv)
    for row, route in ((rows[0], 'fused'), (rows[0]['padded'], 'padded'),
                       (rows[1], 'sm'),
                       (rows[2], 'narrow'), (rows[3], 'f32'),
                       (rows[4], 'sm')):
        row['launches_cli'] = {run: n[route] for run, n in cli.items()}
        row['launches'] += sum(row['launches_cli'].values())
    assert not any(n['f32'] or n['sm'] for n in cli.values()), cli
    # phase remat's steps (the replays included) join K1's rows
    k1 = rows[0]
    k1['launches_remat_phase'] = (remat_launches['fused']
                                  + remat_launches['prologue'])
    k1['launches'] += k1['launches_remat_phase']
    for sub, route in (('prologue', 'prologue'), ('padded', 'padded')):
        k1[sub]['launches_remat_phase'] = remat_launches[route]
        k1[sub]['launches'] += remat_launches[route]
    rows[2]['launches_remat_phase'] = remat_launches['narrow']
    rows[2]['launches'] += remat_launches['narrow']
    # phase brick's runs at sides 4 and 2 join each kernel's row, with the
    # side-2 readings beside the side-4 ones of the same call
    add_brick_phase(rows, brick_launches, brick_timing)
    # the sorted point -> cell reduction: once in every forward (but phase
    # feats' runs with the scatter route patched in) and once in every
    # backward, as the voxel -> point gather's
    by_phase = {
        'eval_forward': fwd['cell_mean'], 'train_steps': train['cell_mean'],
        'repeat': sum(n['cell_mean'] for n in repeat_launches.values()),
        'fuse_norm': sum(n['cell_mean'] for n in fuse_launches.values()),
        'engines': sum(n['cell_mean'] for n in engine_launches.values()),
        'brick': sum(n['cell_mean'] for n in brick_launches.values()),
        'feats': sum(n['cell_mean'] for n in feats_launches.values()),
        'remat': remat_launches['cell_mean'],
        'cli': {run: n['cell_mean'] for run, n in cli.items()}}
    f4 = feats[4]
    rows.append({
        'name': 'cell_reduce_sorted', 'route': 'cuda',
        'source': 'doda_tpu_torch/csrc/cell_mean.cu',
        'replaces': 'none: no pallas_call; the port of the JAX default '
                    'point -> cell reduction doda_tpu/ops/bricks.py:213 '
                    '(_brick_feats_sorted, plain XLA)',
        'launches': sum(v for k, v in by_phase.items() if k != 'cli')
        + sum(by_phase['cli'].values()),
        'launches_by_phase': by_phase,
        **{k: f4[k] for k in ('max_abs_err', 'ms', 'plain_ms', 'bound_ms',
                              'bound_by', 'library_ms', 'scatter_route_ms',
                              'shape', 'bytes', 'flops', 'errors')},
        'library': 'torch.zeros then Tensor.index_reduce_(0, flat, feats, '
                   "'mean', include_self=False): two calls, the zero fill "
                   'included',
        **_build.resources('cell_mean'),
        'gather_backward': {
            'library': "index_select's autograd backward: the cotangent "
                       'in the table\'s type, torch.zeros, index_add_',
            **f4['gather_backward']},
        'brick2': {k: feats[2][k] for k in (
            'max_abs_err', 'ms', 'plain_ms', 'bound_ms', 'bound_by',
            'library_ms', 'scatter_route_ms', 'shape')}})
    assert remat_launches['sm'] == remat_launches['f32'] == 0, remat_launches
    for r in rows:       # every kernel of the paths really ran on them
        assert r['launches'] > 0, r['name']
    assert rows[0]['prologue']['launches'] > 0
    # no conv of the flagship has a bf16 width that the fused and narrow K1
    # do not take: the route 'padded' is checked in phases kernels and
    # brick, timed in phase timing, and launched on no path
    assert rows[0]['padded']['launches'] == 0, rows[0]['padded']
    log('run', card=card, seconds=time.perf_counter() - start)
    print(json.dumps({'kernels': rows}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': name,
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
