"""What holds ``banded_conv_sm_taps`` (K2's second version) back: its parts
and its layouts timed alone on the card.

    python -m doda_tpu_torch.tools.probe_sm [--brick 4|2]

from the repo root. Builds ``csrc/banded_conv_sm_taps.cu`` as it is and in
variants made by text substitution (into ``build/probe``). Three do not
compute the conv and exist to be timed: without the TMA copies (the
producer arrives on each stage without loading it, so the multiply runs
on whatever shared memory holds), without the multiply (copies and stores
only) and without the global stores. The others compute it and are first
checked against the plain version, as is the build as it is: with an
mbarrier wait that traps after 2^22 polls in place of 10 s of the global
timer, and other block layouts of the side (``Layout<S>``): at side 4 one
consumer warp an output slice (two share a slice as built); at side 2 two
warps a slice with three blocks an SM, or one with two blocks (as built:
one warp a slice, four blocks an SM). Each is run at the shapes the ``sm_max_cin=32`` train step
gives K2 at the side (level 0: 16 -> 16, 32 -> 16 and its dx 16 -> 32;
level 1: 32 -> 32; rows of the bench caps, ``synth.BRICK_CAPS_SIDE2`` at
side 2), bf16, with operands laid out as ``_assemble_sm`` lays them, and
one JSON line a (shape, variant) is printed: the time, the bytes the
copies move ((s+2)^3 halo cells a brick, once per cout block) and the
rate that makes, and the kernel's bound (``utils/roofline.py``).
"""

from __future__ import annotations

import argparse
import ctypes
import json
from concurrent.futures import ThreadPoolExecutor

import torch

from ..utils import roofline, synth
from .probe_fused import build_variant, card, ms

LAYOUT = {4: '  static constexpr int YSPLIT = 2, BLOCKS = 1;\n',
          2: '  static constexpr int YSPLIT = 1, BLOCKS = 4;\n'}


def _layout(side, ysplit, blocks):
    return [(LAYOUT[side], f'  static constexpr int YSPLIT = {ysplit}, '
             f'BLOCKS = {blocks};\n')]


# (name, [(text in the source, its replacement)]); a name becomes a file
# name, so it holds no comma
COMMON = (
    ('as built', []),
    ('no copy', [('        mbar_expect_tx(bar, G::UNIT_B);\n'
                  '        issue_unit<S>(p, smem_u32(stage0 + s * '
                  'G::UNIT_B), bar, kc, pl, c1);',
                  '        mbar_arrive(bar);')]),
    ('no multiply', [('    if (dx >= -1 && dx <= 1) {',
                      '    if (dx < -9 && dx <= 1) {')]),
    ('no store', [('      if (ok)\n', '      if (ok && lane > 32)\n')]),
    ('wait by poll count', [('    const uint64_t now = globaltimer_ns();\n'
                             '    if (t0 == 0)\n'
                             '      t0 = now;\n'
                             '    else if (now - t0 > WAIT_LIMIT_NS)\n'
                             '      __trap();\n',
                             '    if (++t0 == (1ull << 22)) __trap();\n')]),
)
LAYOUTS = {
    4: (('one warp a slice', _layout(4, 1, 1)),),
    2: (('2 warps a slice 3 blocks', _layout(2, 2, 3)),
        ('1 warp a slice 2 blocks', _layout(2, 1, 2))),
}
TIMED_ONLY = ('no copy', 'no multiply', 'no store')   # compute no conv


def shapes(side):
    """(rows, cin, cout) of the ``sm_max_cin=32`` step's K2 convs."""
    caps = synth.BRICK_CAPS_SIDE2 if side == 2 else (synth.BRICK_CAP, 16384)
    l0, l1 = (synth.BATCH * c for c in caps[:2])
    return ((l0, 16, 16), (l0, 32, 16), (l0, 16, 32), (l1, 32, 32))


def _build_variant(variant):
    lib = build_variant('banded_conv_sm_taps', variant)
    fn = lib.doda_banded_conv_sm_taps
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong] * 4
                   + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong]
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.doda_banded_conv_sm_taps_smem.argtypes = [ctypes.c_int] * 2
    lib.doda_banded_conv_sm_taps_smem.restype = ctypes.c_int
    return variant[0], fn, lib.doda_banded_conv_sm_taps_smem


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--brick', type=int, choices=(2, 4), default=4,
                    help='brick side (default 4)')
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('probe_sm: needs a CUDA device')
    from ..ops.banded_conv_sm import banded_conv_sm_taps_plain, sm_widths
    side = args.brick
    variants = COMMON + LAYOUTS[side]
    with ThreadPoolExecutor(len(variants)) as ex:
        built = list(ex.map(_build_variant, variants))
    name_limit = card()
    g = torch.Generator(device='cuda').manual_seed(1)
    bf = torch.bfloat16
    stream = torch.cuda.current_stream().cuda_stream
    cx, cg, cp = sm_widths(side)
    for rows, cin, cout in shapes(side):
        x = torch.randn(rows, cx * cin, device='cuda', generator=g).to(bf)
        buf = torch.randn(rows, (cg + 2 * cp) * cin, device='cuda',
                          generator=g).to(bf)
        a, b = cg * cin, (cg + cp) * cin
        ops = (x, buf[:, :a], buf[:, a:b], buf[:, b:])
        w = (torch.randn(27, cin, cout, device='cuda', generator=g)
             / (27 * cin) ** 0.5).to(bf)
        out = torch.empty(rows, cx * cout, device='cuda', dtype=bf)
        args_ = [v for t in ops for v in (t.data_ptr(), t.stride(0))]
        copied = rows * (side + 2) ** 3 * cin * 2 * -(-cout // 16)
        work = roofline.sm_taps_work(rows, cin, cout, side)
        ref = banded_conv_sm_taps_plain(*ops, w, bf).float()
        for name, fn, smem in built:
            def run():
                err = fn(*args_, w.data_ptr(), out.data_ptr(), rows, cin,
                         cout, side, 1, stream)
                if err:
                    raise RuntimeError(f'{name}: CUDA error {err}')
            if name not in TIMED_ONLY:
                run()
                err = (out.float() - ref).abs().max().item()
                assert err <= 2e-2 * ref.abs().max().item(), (name, err)
            t = ms(run)
            print(json.dumps({
                'card': name_limit, 'brick': side,
                'shape': [rows, cin, cout], 'variant': name, 'ms': t,
                'bound_ms': work['bound_ms'], 'bound_by': work['bound_by'],
                'copy_bytes': copied, 'copy_tb_per_s': copied / t / 1e9,
                'out_bytes': out.numel() * 2,
                'dynamic_smem_bytes': smem(cin, side)}), flush=True)
        del ref


if __name__ == '__main__':
    main()
