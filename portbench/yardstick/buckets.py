"""Kernel names, as the CUDA runtime reports them in a profiler trace,
to buckets of device time. The first pattern that matches wins.

The port's own kernels (``doda_tpu_torch/csrc``) come first, then the
library and PyTorch kernels by what they do."""

import re

BUCKETS = (
    ('banded_conv_fused prologue (K1, fused norm)', r'fused_tc.*(true|Lb1E)'),
    ('banded_conv_fused (K1, fused)', r'fused_tc'),
    ('banded_conv_narrow (K1, input conv)', r'narrow_tc'),
    ('banded_conv_f32 (K1, float32)', r'subm_f32'),
    ('banded_conv_sm_taps (K2)', r'sm_taps_tc|sm_taps_f32'),
    ('cell_reduce_sorted (point -> cell)', r'cell_rows'),
    ('gemm (down/up/1x1/head)', r'gemm|cutlass|xmma|cublas|sm90_|nvjet'),
    ('sort / search', r'sort|radix|searchsorted|Scan|scan'),
    ('index / gather / scatter', r'index|gather|scatter|Indexing'),
    ('concat', r'[Cc]at'),
    ('elementwise / reduce', r'elementwise|vectorized|reduce|Reduce'),
    ('memcpy / memset', r'Memcpy|Memset|memcpy|memset'),
)
OTHER = 'other'

# the buckets of the submanifold convs (K1 in every version, K2)
SUBM_CONV = tuple(name for name, _ in BUCKETS[:5])
ELEMENTWISE = 'elementwise / reduce'
GATHER = 'index / gather / scatter'

_COMPILED = tuple((name, re.compile(pat)) for name, pat in BUCKETS)


def bucket_of(kernel: str) -> str:
    """The bucket of a kernel name, ``OTHER`` where no pattern matches."""
    for name, pat in _COMPILED:
        if pat.search(kernel):
            return name
    return OTHER
