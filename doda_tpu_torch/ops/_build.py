"""Build a CUDA source of ``csrc/`` with nvcc and load it with ctypes.

Each source is compiled at first use into ``build/`` at the repo root (a
git-ignored directory), as a shared library with a plain C interface. The
library's name carries a hash of the source and the flags, so an edited
source builds anew; a file lock keeps parallel first uses from racing.
ptxas's resource report (``-Xptxas -v``) is kept beside the library and
read by ``resources``. ``build_host`` compiles a C++ host source with g++
by the same scheme; its hash also covers what ``-march=native`` means on
this machine's CPU.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / 'csrc'
BUILD = Path(__file__).resolve().parents[2] / 'build'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')
CXX_FLAGS = ('-O3', '-march=native', '-fPIC', '-std=c++17', '-Wall',
             '-shared')


def _nvcc() -> str:
    found = shutil.which('nvcc')
    if found:
        return found
    cuda = Path('/usr/local/cuda/bin/nvcc')
    if cuda.exists():
        return str(cuda)
    raise RuntimeError('nvcc not found: the CUDA kernels of doda_tpu_torch '
                       'build on a machine with the CUDA toolkit')


def _cxx() -> str:
    found = shutil.which('g++')
    if found:
        return found
    raise RuntimeError('g++ not found: the host library of doda_tpu_torch '
                       'builds on a machine with a C++ compiler')


def _compiled(src: Path, name: str, compiler, flags, salt: bytes = b'',
              report: str | None = None) -> Path:
    """Compile ``src`` into ``build/lib<name>-<hash>.so`` unless it is
    there. ``compiler`` returns the compiler's path and is called only
    for a build; ``report`` keeps its stderr beside the library."""
    digest = hashlib.sha256(src.read_bytes() + ' '.join(flags).encode()
                            + salt).hexdigest()
    out = BUILD / f'lib{name}-{digest[:16]}.so'
    BUILD.mkdir(exist_ok=True)
    with open(BUILD / f'{name}.lock', 'w') as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not out.exists():
            tmp = out.with_name(f'{out.name}.{os.getpid()}.tmp')
            cc = compiler()
            res = subprocess.run([cc, *flags, '-o', str(tmp), str(src)],
                                 capture_output=True, text=True)
            if res.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f'{Path(cc).name} failed on '
                                   f'{src.name}:\n{res.stderr}')
            if report:
                out.with_suffix(report).write_text(res.stderr)
            os.replace(tmp, out)
    return out


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built."""
    return _compiled(CSRC / f'{name}.cu', name, _nvcc, NVCC_FLAGS,
                     report='.ptxas.txt')


def build_host(src: Path, name: str) -> Path:
    """Compile the C++ host source ``src`` with g++ and ``CXX_FLAGS``."""
    cxx = _cxx()
    native = subprocess.run([cxx, '-march=native', '-Q', '--help=target'],
                            capture_output=True, text=True).stdout
    return _compiled(src, name, lambda: cxx, CXX_FLAGS,
                     salt=native.encode())


def kernel_resources(name: str) -> dict:
    """ptxas's report (``-Xptxas -v``) on ``csrc/<name>.cu`` by kernel: the
    mangled name of each entry function -> its registers, static shared
    memory and spill bytes."""
    log = build(name).with_suffix('.ptxas.txt').read_text()
    out = {}
    for part in log.split("Compiling entry function '")[1:]:
        kern = part.split("'", 1)[0]

        def first(pattern):
            found = re.search(pattern, part)
            return int(found.group(1)) if found else 0

        out[kern] = {'registers': first(r'Used (\d+) registers'),
                     'static_smem_bytes': first(r'(\d+) bytes smem'),
                     'spill_bytes': first(r'(\d+) bytes spill stores')}
    return out


def resources(name: str, kernel: str | None = None) -> dict:
    """What ptxas reported for ``csrc/<name>.cu``: the most registers,
    static shared memory and spill bytes of its kernels whose mangled
    name holds ``kernel`` (all of them where it is None), and the kernel
    that spills most (``spill_kernel``, None where none spills)."""
    found = {k: v for k, v in kernel_resources(name).items()
             if kernel is None or kernel in k}
    if not found:
        raise ValueError(f'ptxas reported no kernel {kernel!r} in {name}.cu')
    most = {key: max(v[key] for v in found.values())
            for key in ('registers', 'static_smem_bytes', 'spill_bytes')}
    spill = max(found, key=lambda k: found[k]['spill_bytes'])
    most['spill_kernel'] = spill if most['spill_bytes'] else None
    return most


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu``, building it if needed."""
    return ctypes.CDLL(str(build(name)))
