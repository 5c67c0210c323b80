"""What holds ``banded_conv_fused`` back: its parts timed alone on the card.

    python -m doda_tpu_torch.tools.probe_fused

from the repo root. Builds ``csrc/banded_conv_fused.cu`` as it is and in
variants made by text substitution (into ``build/probe``): without the
halo copies (the multiply runs on whatever shared memory holds), without
the multiply (copies and stores only) and without the stores; and, for its
prologue variant, without the prologue's arithmetic (each thread still
waits for its copies and rewrites its cells unchanged), without the
rewrite pass (no wait, no pass: the occupancy words and the third
rulebook buffer alone) and with the wait alone. None of the variants
computes the conv; they exist to be timed. Each is run at the level-0,
level-1 and level-2 shapes of the flagship on a synthetic rulebook, bf16
(the prologue ones with half the cells active), and one JSON line a
(shape, variant) is printed: the time, the bytes the halo copies move (216
cells a brick) and the rate that makes, and the card's name and power
limit.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
from concurrent.futures import ThreadPoolExecutor

import torch

from ..ops import _build
from ..ops.banded_conv import occ_words
from ..utils import synth

# (name, [(text in the source, its replacement)])
VARIANTS = (
    ('as built', []),
    ('no halo copy', [('      issue_halo(kc1, stage ^ 1, (int)(i1 & 1));',
                       '      if (s < 0) issue_halo(kc1, stage ^ 1, 0);')]),
    ('no multiply', [('    for (int dy = 0; dy < 3; ++dy) {',
                      '    for (int dy = 0; dy < (p.cin < 0 ? 3 : 0); ++dy) {')]),
    ('no store', [('      if (brick < p.rows) {',
                   '      if (brick < p.rows && acc[0][0][0] == 123.456f) {')]),
)
# the prologue variant's, run with a scale, a bias and occupancy words
PRO_MATH = '          *cell = prologue8(*cell, hi ? s1 : s0, hi ? b1 : b0);'
PRO_PASS = '    cp_async_wait_all();\n    const unsigned long long* ow = occ_s'
PRO_VARIANTS = (
    ('prologue as built', []),
    ('prologue without its math', [(PRO_MATH, '          *cell = *cell;')]),
    ('prologue with the wait alone', [(PRO_PASS, PRO_PASS.replace(
        '\n', '\n    return;\n', 1))]),
    ('prologue without its pass', [(PRO_PASS, PRO_PASS.replace(
        'cp_async_wait_all();', 'return;'))]),
)
SHAPES = ((163840, 64, 16, 16), (65536, 48, 32, 32), (13312, 28, 48, 48))


def build_variant(source, variant) -> ctypes.CDLL:
    """``csrc/<source>.cu`` with the variant's text substitutions, built
    into ``build/probe``."""
    name, edits = variant
    src = (_build.CSRC / f'{source}.cu').read_text()
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f'variant {name!r}: source text not found')
        src = src.replace(old, new)
    out_dir = _build.BUILD / 'probe'
    out_dir.mkdir(parents=True, exist_ok=True)
    stem = f'{source}-{name.replace(" ", "_")}'
    cu, lib = out_dir / f'{stem}.cu', out_dir / f'lib{stem}.so'
    cu.write_text(src)
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, '-o', str(lib),
                          str(cu)], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f'nvcc failed on variant {name!r}:\n{res.stderr}')
    return ctypes.CDLL(str(lib))


def _build_variant(variant):
    name = variant[0]
    fn = build_variant('banded_conv_fused', variant).doda_banded_conv_fused
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] \
        + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 4
    fn.restype = ctypes.c_int
    return name, fn, variant in PRO_VARIANTS


def card() -> str:
    return subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True, timeout=60).stdout.strip()


def ms(fn, reps=20):
    fn()
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def main():
    if not torch.cuda.is_available():
        raise SystemExit('probe_fused: needs a CUDA device')
    variants = VARIANTS + PRO_VARIANTS
    with ThreadPoolExecutor(len(variants)) as ex:
        built = list(ex.map(_build_variant, variants))
    name_limit = card()
    g = torch.Generator(device='cuda').manual_seed(1)
    bf = torch.bfloat16
    for rows, grid, cin, cout in SHAPES:
        nbr = synth.synth_rulebook(rows, grid, seed=7)
        x2 = torch.randn(rows, 64 * cin, device='cuda', generator=g).to(bf)
        w = (torch.randn(27, cin, cout, device='cuda', generator=g)
             / (27 * cin) ** 0.5).to(bf)
        out = torch.empty(rows, 64 * cout, device='cuda', dtype=bf)
        stream = torch.cuda.current_stream().cuda_stream
        halo_bytes = rows * 216 * cin * 2 * -(-cout // 32)
        scale = (1 + 0.2 * torch.randn(cin, device='cuda', generator=g)).to(bf)
        bias = (0.2 * torch.randn(cin, device='cuda', generator=g)).to(bf)
        occw = occ_words(torch.rand(rows, 64, device='cuda', generator=g)
                         < 0.5)
        for name, fn, pro in built:
            ptrs = ((scale.data_ptr(), bias.data_ptr(), occw.data_ptr())
                    if pro else (None, None, None))

            def run():
                err = fn(x2.data_ptr(), nbr.data_ptr(), w.data_ptr(),
                         out.data_ptr(), rows, cin, cout, 1, 4, *ptrs,
                         stream)
                if err:
                    raise RuntimeError(f'{name}: CUDA error {err}')
            t = ms(run)
            print(json.dumps({
                'card': name_limit, 'shape': [rows, cin, cout],
                'variant': name,
                'ms': t, 'halo_copy_bytes': halo_bytes,
                'halo_copy_tb_per_s': halo_bytes / t / 1e9,
                'x2_bytes': x2.numel() * 2, 'out_bytes': out.numel() * 2}),
                flush=True)


if __name__ == '__main__':
    main()
