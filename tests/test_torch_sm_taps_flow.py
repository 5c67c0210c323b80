"""A numpy walk of K2's second version's data flow (TMA boxes, staged
slots, weight groups, per-slice accumulation, ragged tiles) computes the
conv, and its staged epilogue puts every output where its stores read
it.
"""

import numpy as np
import pytest
import torch

from _torch_threads import two_threads  # noqa: F401
from _torch_sm_taps_common import _kernel_walk, _operands, _staged_off, _t, TOL
from doda_tpu_torch.ops.banded_conv_sm import banded_conv_sm_taps


@pytest.mark.parametrize('b,cin,cout,ysplit,gk', [(37, 32, 24, 1, None),
                                                  (16, 16, 8, 1, None),
                                                  (21, 16, 16, 2, None),
                                                  (19, 48, 8, 2, 2)])
def test_kernel_data_flow_computes_the_conv(b, cin, cout, ysplit, gk):
    """gk = 2 at cin = 48: two weight groups, the last one half full."""
    rng = np.random.default_rng(b * cin)
    ops, w = _operands(rng, b, cin, cout)
    want = banded_conv_sm_taps(*map(_t, ops), _t(w), torch.float32)
    np.testing.assert_allclose(_kernel_walk(*ops, w, ysplit, gk),
                               want.numpy(), **TOL)


@pytest.mark.parametrize('cw', [8, 16])
def test_kernel_output_staging(cw):
    """``store_tile``'s shared buffer: each lane's bf16 pairs (brick r,
    couts j*8 + 2q) and float32 pairs (couts 2q of one n8 tile) land at
    distinct places, one warp store touches every bank once (bf16) or
    fills 256 contiguous bytes (float32), and each 16-byte copy-out read
    finds brick r's couts half*8.. (bf16) or half*4.. (float32) of cell
    c, 512 contiguous bytes a warp read."""
    bf16, f32 = {}, {}
    for c in range(cw):
        for h in range(2):
            for j in range(2):
                banks = []
                for lane in range(32):
                    g, q = lane >> 2, lane & 3
                    r = g + 8 * h
                    off = _staged_off(c, r, j) + q * 4
                    assert off not in bf16
                    bf16[off] = (c, r, j * 8 + 2 * q)
                    banks.append((off // 4) % 32)
                assert sorted(banks) == list(range(32))
            offs = []
            for lane in range(32):
                g, q = lane >> 2, lane & 3
                r = g + 8 * h
                off = _staged_off(c, r, q >> 1) + (q & 1) * 8
                f32[off] = (c, r, 2 * q)
                offs.append(off)
            lo = min(offs)
            assert sorted(offs) == list(range(lo, lo + 256, 8))
    assert sorted(bf16) == list(range(0, cw * 512, 4))
    assert sorted(f32) == list(range(0, cw * 512, 8))
    for c in range(cw):
        reads = []
        for lane in range(32):
            r, half = lane >> 1, lane & 1
            off = _staged_off(c, r, half)
            reads.append(off)
            assert bf16[off] == (c, r, half * 8)
            assert f32[off] == (c, r, half * 4)
        assert sorted(reads) == list(range(c * 512, c * 512 + 512, 16))
