"""Digests of the subm-conv kernels' outputs, to hold two builds of them
bit for bit.

    python -m doda_tpu_torch.tools.fused_digest [--csrc DIR] [--brick 4]
                      [--kernel fused|prologue|narrow|f32|sm|cell_mean]

from the repo root, on the card. ``--kernel fused`` (the default) builds
``banded_conv_fused.cu`` from ``DIR`` (by default this checkout's
``doda_tpu_torch/csrc``; another commit's, unpacked with ``git archive``,
to compare) and runs it without the prologue on seeded bf16 operands at
``chip_smoke.py``'s shapes: the bench batch's real rulebooks at levels 0,
1, 5 and 6 and three synthetic ones, each to float32 and to bf16.
``--kernel prologue`` runs the same source's prologue variant at the same
shapes, with seeded scale, bias (> 0 on half the channels) and cell
occupancy; ``--kernel narrow`` ``subm_conv_narrow.cu`` at the bench input
conv (3 -> 16 on the level-0 rulebook) and phase kernels' synthetic
shapes of cin 1 to 7; ``--kernel f32`` ``subm_conv_f32.cu`` on float32
operands at the fused shapes and the input conv.
``--kernel sm`` builds K2's source and runs it at the shapes of
``chip_smoke.py``'s phase kernels: ``banded_conv_sm_taps.cu`` on seeded
bf16 operands to float32 and to bf16 and, where the source has its
float32 kernel (``sm_taps_f32``), on float32 operands to float32 and to
bf16.
``--kernel cell_mean`` builds the sorted point -> cell reduction
(``cell_mean.cu``) and runs it over the bench batch's level-0 stream on
seeded features: C = 3 in modes 3 and 4 and C = 16 in mode 3 (the voxel
-> point gather's backward), to float32 and, where the source has it, to
bf16; a source from before the output type was an argument (its caller
zero-fills a float32 output) is called through its own signature.
Both in bricks of side ``--brick`` (4, or 2 for a source built for it).
Prints one JSON line a shape with the sha256 of each output's bytes and
the card's name and power limit; two builds that print the same digests
computed the same bits. A source from before the brick side was a kernel
argument is called through its own signature (side 4 only).
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
from pathlib import Path

import torch

from ..models.unet import build_level_plan, default_brick_caps, flatten_plan
from ..ops import _build
from ..ops.banded_conv import occ_words
from ..ops.banded_conv_sm import sm_widths
from ..utils import synth
from ..utils.device import card_label

# (level, cin, cout) on the bench rulebooks and (rows, grid, cin, cout) on
# synthetic ones: chip_smoke.py's K1_BENCH_SHAPES and its synthetic checks
LEVEL_SHAPES = ((0, 16, 16), (0, 32, 16), (1, 32, 32), (1, 64, 32),
                (6, 112, 112), (5, 192, 96))
SYNTH_SHAPES = ((4099, 20, 16, 16), (1001, 12, 24, 8), (3, 4, 16, 32))
# (rows, cin, cout) of K2: chip_smoke.py's K2_SHAPES and its second
# version's extra shapes (less than a tile, a half cout block, two weight
# groups)
SM_SHAPES = ((4099, 16, 16), (4096, 32, 16), (2048, 16, 32), (2048, 32, 32),
             (1000, 32, 64), (512, 112, 112), (7, 32, 32), (1000, 16, 24),
             (333, 144, 24))


def fused_entry(csrc: Path, side: int = 4):
    """The built ``doda_banded_conv_fused`` of ``csrc`` as fn(x2, nbr, w,
    out, rows, cin, cout, out_dtype code, stream) at ``side``."""
    src = csrc / 'banded_conv_fused.cu'
    lib = ctypes.CDLL(str(_build._compiled(
        src, 'banded_conv_fused', _build._nvcc, _build.NVCC_FLAGS,
        report='.ptxas.txt')))
    fn = lib.doda_banded_conv_fused
    sided = hasattr(lib, 'doda_banded_conv_fused_has_side')
    if not sided and side != 4:
        raise SystemExit(f'fused_digest: {src} has no brick side argument '
                         f'(side 4 only), asked for side {side}')
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] \
        + [ctypes.c_int] * (4 if sided else 3) + [ctypes.c_void_p] * 4
    fn.restype = ctypes.c_int

    def call(x2, nbr, w, out, rows, cin, cout, code, stream,
             pro=(None, None, None)):
        head = (x2, nbr, w, out, rows, cin, cout, code)
        return fn(*head, *((side,) if sided else ()), *pro, stream)
    return call


# (rows or level 0, grid, cin, cout) of the narrow K1: chip_smoke.py's
# input conv and its synthetic checks
NARROW_SHAPES = ((0, None, 3, 16), (4099, 20, 1, 8), (4099, 20, 4, 16),
                 (1001, 12, 5, 24), (4099, 20, 6, 32), (1001, 12, 7, 40),
                 (3, 4, 2, 16))


def k1_entry(csrc: Path, kernel: str, side: int):
    """fn(x2, nbr, w, out, rows, cin, cout, out_dtype code, stream, pro)
    of K1's ``kernel`` ('fused', 'prologue', 'narrow' or 'f32') built from
    ``csrc``."""
    if kernel in ('fused', 'prologue'):
        return fused_entry(csrc, side)
    name = {'narrow': 'subm_conv_narrow', 'f32': 'subm_conv_f32'}[kernel]
    lib = ctypes.CDLL(str(_build._compiled(        # both take the side
        csrc / f'{name}.cu', name, _build._nvcc, _build.NVCC_FLAGS,
        report='.ptxas.txt')))
    fn = getattr(lib, f'doda_{name}')
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] \
        + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def call(x2, nbr, w, out, rows, cin, cout, code, stream, pro=None):
        return fn(x2, nbr, w, out, rows, cin, cout, code, side, stream)
    return call


def _lib(csrc: Path, name: str, side: int) -> tuple:
    """The built library of ``csrc/<name>.cu`` and whether it takes the
    brick side."""
    lib = ctypes.CDLL(str(_build._compiled(
        csrc / f'{name}.cu', name, _build._nvcc, _build.NVCC_FLAGS,
        report='.ptxas.txt')))
    sided = hasattr(lib, f'doda_{name}_has_side')
    if not sided and side != 4:
        raise SystemExit(f'fused_digest: {csrc / name}.cu has no brick side '
                         f'argument (side 4 only), asked for side {side}')
    return lib, sided


def _sha(t) -> str:
    return hashlib.sha256(t.view(torch.uint8).cpu().numpy().tobytes()
                          ).hexdigest()


def sm_digests(csrc: Path, side: int, card: str) -> list:
    """K2's bf16 and float32 kernels at phase kernels' shapes
    (``SM_SHAPES``)."""
    taps, taps_sided = _lib(csrc, 'banded_conv_sm_taps', side)
    ops_t = [ctypes.c_void_p, ctypes.c_longlong] * 4
    taps.doda_banded_conv_sm_taps.argtypes = ops_t + [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong] + [
        ctypes.c_int] * (4 if taps_sided else 3) + [ctypes.c_void_p]
    taps_f32 = getattr(taps, 'doda_banded_conv_sm_taps_f32', None)
    if taps_f32 is not None:
        taps_f32.argtypes = taps.doda_banded_conv_sm_taps.argtypes
    dev = torch.device('cuda')
    stream = torch.cuda.current_stream(dev).cuda_stream
    g = torch.Generator(device=dev).manual_seed(1)
    cx, cg, cp = sm_widths(side)
    out = []
    for rows, cin, cout in SM_SHAPES:
        x = torch.randn(rows, cx * cin, device=dev, generator=g)
        buf = torch.randn(rows, (cg + 2 * cp) * cin, device=dev, generator=g)
        w = torch.randn(27, cin, cout, device=dev, generator=g) \
            / (27 * cin) ** 0.5
        a, b = cg * cin, (cg + cp) * cin
        digests = {}
        for dt in (torch.float32, torch.bfloat16):
            ops = [t.to(dt) for t in (x, buf[:, :a], buf[:, a:b], buf[:, b:])]
            args = [v for t in ops for v in (t.data_ptr(), t.stride(0))]
            if dt == torch.bfloat16:
                wb = w.to(dt)
                for code, odt in ((0, torch.float32), (1, torch.bfloat16)):
                    y = torch.zeros(rows, cx * cout, dtype=odt, device=dev)
                    err = taps.doda_banded_conv_sm_taps(
                        *args, wb.data_ptr(), y.data_ptr(), rows, cin, cout,
                        *((side,) if taps_sided else ()), code, stream)
                    if err:
                        raise RuntimeError(f'sm_taps {rows}: error {err}')
                    torch.cuda.synchronize(dev)
                    digests[f'taps_{str(odt)[6:]}'] = _sha(y)
                continue
            if taps_f32 is not None:
                for code, odt in ((0, torch.float32), (1, torch.bfloat16)):
                    y = torch.zeros(rows, cx * cout, dtype=odt, device=dev)
                    err = taps_f32(*args, w.data_ptr(), y.data_ptr(), rows,
                                   cin, cout, side, code, stream)
                    if err:
                        raise RuntimeError(f'sm_taps_f32 {rows}: error {err}')
                    torch.cuda.synchronize(dev)
                    digests[f'taps_f32_{str(odt)[6:]}'] = _sha(y)
        line = {'card': card, 'csrc': str(csrc), 'kernel': 'sm',
                'brick': side, 'shape': [rows, cin, cout], 'sha256': digests}
        print(json.dumps(line), flush=True)
        out.append(line)
    return out


def cell_mean_digests(csrc: Path, side: int, card: str) -> list:
    """The sorted point -> cell reduction on the bench batch's stream
    (``unet.batch_stream``) at brick side ``side``."""
    from ..models.unet import batch_stream
    lib = ctypes.CDLL(str(_build._compiled(
        csrc / 'cell_mean.cu', 'cell_mean', _build._nvcc, _build.NVCC_FLAGS,
        report='.ptxas.txt')))
    fn = lib.doda_cell_reduce_sorted
    typed = hasattr(lib, 'doda_cell_reduce_max_c')   # rows, scenes, type
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int] \
        + ([ctypes.c_longlong] + [ctypes.c_int] * 4 if typed else
           [ctypes.c_longlong, ctypes.c_int]) + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    dev = torch.device('cuda')
    stream = torch.cuda.current_stream(dev).cuda_stream
    batch = synth.make_batch(seed=0).to(dev)
    caps = default_brick_caps(synth.BRICK_CAP, 7) if side == 4 \
        else synth.BRICK_CAPS_SIDE2
    grid0 = build_level_plan(batch.coords, batch.valid, caps[:1],
                             brick=side).grid0
    bt, cap0, cells = grid0.occ.shape
    rows = bt * cap0
    sc, sp = batch_stream(grid0)
    g = torch.Generator(device=dev).manual_seed(3)
    out = []
    for c, modes in ((3, (3, 4)), (16, (3,))):
        feats = torch.randn(sc.numel(), c, device=dev, generator=g)
        digests = {}
        for mode in modes:
            for odt in (torch.float32, torch.bfloat16)[:1 + typed]:
                y = torch.zeros(rows, cells * c, dtype=odt, device=dev)
                head = (feats.data_ptr(), sc.data_ptr(), sp.data_ptr(),
                        y.data_ptr(), sc.numel(), c)
                err = fn(*head, rows, cells, bt, mode,
                         int(odt == torch.bfloat16), stream) if typed \
                    else fn(*head, rows * cells, mode, stream)
                if err:
                    raise RuntimeError(f'cell_mean C={c}: error {err}')
                torch.cuda.synchronize(dev)
                digests[f'mode{mode}_{str(odt)[6:]}'] = _sha(y)
        line = {'card': card, 'csrc': str(csrc), 'kernel': 'cell_mean',
                'brick': side, 'shape': [sc.numel(), c, rows, cells],
                'sha256': digests}
        print(json.dumps(line), flush=True)
        out.append(line)
    return out


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--csrc', type=Path, default=_build.CSRC)
    ap.add_argument('--brick', type=int, choices=(2, 4), default=4)
    ap.add_argument('--kernel', default='fused',
                    choices=('fused', 'prologue', 'narrow', 'f32', 'sm',
                             'cell_mean'))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('fused_digest: needs a CUDA device')
    side = args.brick
    if args.kernel in ('sm', 'cell_mean'):
        digests = sm_digests if args.kernel == 'sm' else cell_mean_digests
        return digests(args.csrc.resolve(), side,
                       card_label(torch.device('cuda')))
    kernel = args.kernel
    fn = k1_entry(args.csrc.resolve(), kernel, side)
    dev = torch.device('cuda')
    b_caps = default_brick_caps(synth.BRICK_CAP, 7) if side == 4 \
        else synth.BRICK_CAPS_SIDE2
    batch = synth.make_batch(seed=0)
    with torch.no_grad():
        levels, _ = flatten_plan(build_level_plan(
            batch.coords, batch.valid, b_caps, dev, brick=side))
    if kernel == 'narrow':
        cases = [('input', levels[0].nbr, cin, cout) if not rows else
                 (f'synthetic{rows}', synth.synth_rulebook(rows, grid, rows),
                  cin, cout) for rows, grid, cin, cout in NARROW_SHAPES]
    else:
        cases = [(f'level{lvl}', levels[lvl].nbr, cin, cout)
                 for lvl, cin, cout in LEVEL_SHAPES]
        cases += [(f'synthetic{rows}', synth.synth_rulebook(rows, grid,
                                                            rows),
                   cin, cout) for rows, grid, cin, cout in SYNTH_SHAPES]
    if kernel == 'f32':
        cases.append(('input', levels[0].nbr, 3, 16))
    g = torch.Generator(device=dev).manual_seed(1)
    card = card_label(dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    operand = torch.float32 if kernel == 'f32' else torch.bfloat16
    out = []
    for name, nbr, cin, cout in cases:
        rows = nbr.shape[0]
        x2 = torch.randn(rows, side ** 3 * cin, device=dev,
                         generator=g).to(operand)
        w = (torch.randn(27, cin, cout, device=dev, generator=g)
             / (27 * cin) ** 0.5).to(operand)
        pro, keep = (None, None, None), ()
        if kernel == 'prologue':
            scale = (1 + 0.3 * torch.randn(cin, device=dev, generator=g))
            bias = 0.3 * torch.randn(cin, device=dev, generator=g)
            bias[::2] = bias[::2].abs() + 0.1
            occ = torch.rand(rows, side ** 3, device=dev, generator=g) < 0.6
            keep = (scale.bfloat16(), bias.bfloat16(), occ_words(occ))
            pro = tuple(t.data_ptr() for t in keep)
        digests = {}
        for code, dt in ((0, torch.float32), (1, torch.bfloat16)):
            y = torch.zeros(rows, side ** 3 * cout, dtype=dt, device=dev)
            err = fn(x2.data_ptr(), nbr.data_ptr(), w.data_ptr(),
                     y.data_ptr(), rows, cin, cout, code, stream, pro)
            if err:
                raise RuntimeError(f'{name}: CUDA error {err}')
            torch.cuda.synchronize(dev)
            digests[str(dt)[6:]] = _sha(y)
        line = {'card': card, 'csrc': str(args.csrc), 'brick': side,
                'kernel': kernel, 'case': name,
                'shape': [rows, cin, cout], 'sha256': digests}
        print(json.dumps(line), flush=True)
        out.append(line)
    return out


if __name__ == '__main__':
    main()
