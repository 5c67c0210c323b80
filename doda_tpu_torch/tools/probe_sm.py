"""What holds ``banded_conv_sm_taps`` (K2's second version) back: its parts
timed alone on the card.

    python -m doda_tpu_torch.tools.probe_sm

from the repo root. Builds ``csrc/banded_conv_sm_taps.cu`` as it is and in
five variants made by text substitution (into ``build/probe``). Three do
not compute the conv and exist to be timed: without the TMA copies (the
producer arrives on each stage without loading it, so the multiply runs
on whatever shared memory holds), without the multiply (copies and stores
only) and without the global stores. Two compute it: with one consumer
warp an output slice (``YSPLIT``: two warps share a slice as built), and
with an mbarrier wait that traps after 2^22 polls in place of 10 s of the
global timer; they and the build as it is are first checked against the
plain version. Each is run at the shapes the ``sm_max_cin=32`` train step
gives K2 (level 0: 16 -> 16, 32 -> 16 and its
dx 16 -> 32; level 1: 32 -> 32), bf16, with operands laid out as
``_assemble_sm`` lays them, and one JSON line a (shape, variant) is
printed: the time, the bytes the copies move (216 halo cells a brick, once
per cout block) and the rate that makes, and the kernel's bound.
"""

from __future__ import annotations

import ctypes
import json
from concurrent.futures import ThreadPoolExecutor

import torch

from .probe_fused import build_variant, card, ms

PEAK_BF16, PEAK_BYTES = 989e12, 3.35e12   # H100 SXM data sheet

# (name, [(text in the source, its replacement)])
VARIANTS = (
    ('as built', []),
    ('no copy', [('        mbar_expect_tx(bar, UNIT_B);\n'
                  '        issue_unit(p, smem_u32(stage0 + s * UNIT_B), bar, '
                  'kc, pl, c1);',
                  '        mbar_arrive(bar);')]),
    ('no multiply', [('    if (dx >= -1 && dx <= 1) {',
                      '    if (dx < -9 && dx <= 1) {')]),
    ('no store', [('      if (ok)\n', '      if (ok && lane > 32)\n')]),
    ('one warp a slice', [('constexpr int YSPLIT = 2;',
                           'constexpr int YSPLIT = 1;')]),
    ('wait by poll count', [('    const uint64_t now = globaltimer_ns();\n'
                             '    if (t0 == 0)\n'
                             '      t0 = now;\n'
                             '    else if (now - t0 > WAIT_LIMIT_NS)\n'
                             '      __trap();\n',
                             '    if (++t0 == (1ull << 22)) __trap();\n')]),
)
TIMED_ONLY = ('no copy', 'no multiply', 'no store')   # compute no conv
SHAPES = ((163840, 16, 16), (163840, 32, 16), (163840, 16, 32),
          (65536, 32, 32))


def _build_variant(variant):
    lib = build_variant('banded_conv_sm_taps', variant)
    fn = lib.doda_banded_conv_sm_taps
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong] * 4
                   + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                      ctypes.c_int, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.doda_banded_conv_sm_taps_smem.argtypes = [ctypes.c_int]
    lib.doda_banded_conv_sm_taps_smem.restype = ctypes.c_int
    return variant[0], fn, lib.doda_banded_conv_sm_taps_smem


def main():
    if not torch.cuda.is_available():
        raise SystemExit('probe_sm: needs a CUDA device')
    from ..ops.banded_conv_sm import banded_conv_sm_taps_plain
    with ThreadPoolExecutor(len(VARIANTS)) as ex:
        built = list(ex.map(_build_variant, VARIANTS))
    name_limit = card()
    g = torch.Generator(device='cuda').manual_seed(1)
    bf = torch.bfloat16
    stream = torch.cuda.current_stream().cuda_stream
    for rows, cin, cout in SHAPES:
        x = torch.randn(rows, 64 * cin, device='cuda', generator=g).to(bf)
        buf = torch.randn(rows, 176 * cin, device='cuda', generator=g).to(bf)
        ops = (x, buf[:, :96 * cin], buf[:, 96 * cin:136 * cin],
               buf[:, 136 * cin:])
        w = (torch.randn(27, cin, cout, device='cuda', generator=g)
             / (27 * cin) ** 0.5).to(bf)
        out = torch.empty(rows, 64 * cout, device='cuda', dtype=bf)
        args = [a for t in ops for a in (t.data_ptr(), t.stride(0))]
        smem = built[0][2](cin)
        moved = (rows * (216 * cin + 64 * cout) + w.numel()) * 2
        copied = rows * 216 * cin * 2 * -(-cout // 16)   # per 16-cout block
        flops = 2 * rows * 64 * 27 * cin * cout
        bound = max(moved / PEAK_BYTES, flops / PEAK_BF16) * 1e3
        for name, fn, _ in built:
            def run():
                err = fn(*args, w.data_ptr(), out.data_ptr(), rows, cin,
                         cout, 1, stream)
                if err:
                    raise RuntimeError(f'{name}: CUDA error {err}')
            if name not in TIMED_ONLY:
                run()
                ref = banded_conv_sm_taps_plain(*ops, w, bf).float()
                err = (out.float() - ref).abs().max().item()
                assert err <= 2e-2 * ref.abs().max().item(), (name, err)
            t = ms(run)
            print(json.dumps({
                'card': name_limit, 'shape': [rows, cin, cout],
                'variant': name, 'ms': t, 'bound_ms': bound,
                'copy_bytes': copied, 'copy_tb_per_s': copied / t / 1e9,
                'out_bytes': out.numel() * 2, 'dynamic_smem_bytes': smem}),
                flush=True)


if __name__ == '__main__':
    main()
