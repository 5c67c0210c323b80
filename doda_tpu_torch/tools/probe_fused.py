"""What holds ``banded_conv_fused`` back: its parts timed alone on the card.

    python -m doda_tpu_torch.tools.probe_fused

from the repo root. Builds ``csrc/banded_conv_fused.cu`` as it is and in
three variants made by text substitution (into ``build/probe``): without
the halo copies (the multiply runs on whatever shared memory holds),
without the multiply (copies and stores only) and without the stores.
None of the variants computes the conv; they exist to be timed. Each is
run at the level-0, level-1 and level-2 shapes of the flagship on a
synthetic rulebook, bf16, and one JSON line a (shape, variant) is printed:
the time, the bytes the halo copies move (216 cells a brick) and the rate
that makes.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
from concurrent.futures import ThreadPoolExecutor

import torch

from ..ops import _build
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
SHAPES = ((163840, 64, 16, 16), (65536, 48, 32, 32), (13312, 28, 48, 48))


def _build_variant(variant):
    name, edits = variant
    src = (_build.CSRC / 'banded_conv_fused.cu').read_text()
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f'variant {name!r}: source text not found')
        src = src.replace(old, new)
    out_dir = _build.BUILD / 'probe'
    out_dir.mkdir(parents=True, exist_ok=True)
    stem = name.replace(' ', '_')
    cu, lib = out_dir / f'{stem}.cu', out_dir / f'lib{stem}.so'
    cu.write_text(src)
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, '-o', str(lib),
                          str(cu)], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f'nvcc failed on variant {name!r}:\n{res.stderr}')
    fn = ctypes.CDLL(str(lib)).doda_banded_conv_fused
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] \
        + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return name, fn


def _ms(fn, reps=20):
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
    with ThreadPoolExecutor(len(VARIANTS)) as ex:
        built = list(ex.map(_build_variant, VARIANTS))
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True, timeout=60).stdout.strip()
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
        for name, fn in built:
            def run():
                err = fn(x2.data_ptr(), nbr.data_ptr(), w.data_ptr(),
                         out.data_ptr(), rows, cin, cout, 1, stream)
                if err:
                    raise RuntimeError(f'{name}: CUDA error {err}')
            ms = _ms(run)
            print(json.dumps({
                'card': card, 'shape': [rows, cin, cout], 'variant': name,
                'ms': ms, 'halo_copy_bytes': halo_bytes,
                'halo_copy_tb_per_s': halo_bytes / ms / 1e9,
                'x2_bytes': x2.numel() * 2, 'out_bytes': out.numel() * 2}),
                flush=True)


if __name__ == '__main__':
    main()
