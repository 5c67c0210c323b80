"""Build a CUDA source of ``csrc/`` with nvcc and load it with ctypes.

Each source is compiled at first use into ``build/`` at the repo root (a
git-ignored directory), as a shared library with a plain C interface. The
library's name carries a hash of the source and the flags, so an edited
source builds anew; a file lock keeps parallel first uses from racing.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / 'csrc'
BUILD = Path(__file__).resolve().parents[2] / 'build'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC')


def _nvcc() -> str:
    found = shutil.which('nvcc')
    if found:
        return found
    cuda = Path('/usr/local/cuda/bin/nvcc')
    if cuda.exists():
        return str(cuda)
    raise RuntimeError('nvcc not found: the CUDA kernels of doda_tpu_torch '
                       'build on a machine with the CUDA toolkit')


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built."""
    src = CSRC / f'{name}.cu'
    digest = hashlib.sha256(src.read_bytes()
                            + ' '.join(NVCC_FLAGS).encode()).hexdigest()
    out = BUILD / f'lib{name}-{digest[:16]}.so'
    BUILD.mkdir(exist_ok=True)
    with open(BUILD / f'{name}.lock', 'w') as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not out.exists():
            tmp = out.with_name(f'{out.name}.{os.getpid()}.tmp')
            res = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, '-o', str(tmp), str(src)],
                capture_output=True, text=True)
            if res.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f'nvcc failed on csrc/{name}.cu:\n'
                                   f'{res.stderr}')
            os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu``, building it if needed."""
    return ctypes.CDLL(str(build(name)))
