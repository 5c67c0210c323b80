"""Digests of the subm-conv kernels' outputs, to hold two builds of them
bit for bit.

    python -m doda_tpu_torch.tools.fused_digest [--csrc DIR] [--brick 4]
                                               [--kernel fused|sm]

from the repo root, on the card. ``--kernel fused`` (the default) builds
``banded_conv_fused.cu`` from ``DIR`` (by default this checkout's
``doda_tpu_torch/csrc``; another commit's, unpacked with ``git archive``,
to compare) and runs it without the prologue on seeded bf16 operands at
``chip_smoke.py``'s shapes: the bench batch's real rulebooks at levels 0,
1, 5 and 6 and three synthetic ones, each to float32 and to bf16.
``--kernel sm`` builds K2's source and runs it at the shapes of
``chip_smoke.py``'s phase kernels: ``banded_conv_sm_taps.cu`` on seeded
bf16 operands to float32 and to bf16 and, where the source has its
float32 kernel (``sm_taps_f32``), on float32 operands to float32 and to
bf16.
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

    def call(x2, nbr, w, out, rows, cin, cout, code, stream):
        head = (x2, nbr, w, out, rows, cin, cout, code)
        return fn(*head, *((side,) if sided else ()), None, None, None,
                  stream)
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


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--csrc', type=Path, default=_build.CSRC)
    ap.add_argument('--brick', type=int, choices=(2, 4), default=4)
    ap.add_argument('--kernel', choices=('fused', 'sm'), default='fused')
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('fused_digest: needs a CUDA device')
    side = args.brick
    if args.kernel == 'sm':
        return sm_digests(args.csrc.resolve(), side,
                          card_label(torch.device('cuda')))
    fn = fused_entry(args.csrc.resolve(), side)
    dev = torch.device('cuda')
    b_caps = default_brick_caps(synth.BRICK_CAP, 7) if side == 4 \
        else synth.BRICK_CAPS_SIDE2
    batch = synth.make_batch(seed=0)
    with torch.no_grad():
        levels, _ = flatten_plan(build_level_plan(
            batch.coords, batch.valid, b_caps, dev, brick=side))
    cases = [(f'level{lvl}', levels[lvl].nbr, cin, cout)
             for lvl, cin, cout in LEVEL_SHAPES]
    cases += [(f'synthetic{rows}', synth.synth_rulebook(rows, grid, rows),
               cin, cout) for rows, grid, cin, cout in SYNTH_SHAPES]
    g = torch.Generator(device=dev).manual_seed(1)
    card = card_label(dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    out = []
    for name, nbr, cin, cout in cases:
        rows = nbr.shape[0]
        x2 = torch.randn(rows, side ** 3 * cin, device=dev,
                         generator=g).bfloat16()
        w = (torch.randn(27, cin, cout, device=dev, generator=g)
             / (27 * cin) ** 0.5).bfloat16()
        digests = {}
        for code, dt in ((0, torch.float32), (1, torch.bfloat16)):
            y = torch.zeros(rows, side ** 3 * cout, dtype=dt, device=dev)
            err = fn(x2.data_ptr(), nbr.data_ptr(), w.data_ptr(),
                     y.data_ptr(), rows, cin, cout, code, stream)
            if err:
                raise RuntimeError(f'{name}: CUDA error {err}')
            torch.cuda.synchronize(dev)
            digests[str(dt)[6:]] = hashlib.sha256(
                y.view(torch.uint8).cpu().numpy().tobytes()).hexdigest()
        line = {'card': card, 'csrc': str(args.csrc), 'brick': side,
                'case': name,
                'shape': [rows, cin, cout], 'sha256': digests}
        print(json.dumps(line), flush=True)
        out.append(line)
    return out


if __name__ == '__main__':
    main()
