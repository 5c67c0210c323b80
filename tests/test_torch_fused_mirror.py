"""A numpy mirror of ``csrc/banded_conv_fused.cu``'s address arithmetic
(rulebook entry + closed-form halo map -> flat cell id, null -> zero row)
equals ``halo_index`` exactly; its shared-memory swizzle is a bijection
that ``ldmatrix``'s row addresses invert without bank conflicts; the
wrapper raises off the CPU and without a rulebook.
"""

import numpy as np
import pytest
import torch

from _torch_threads import two_threads  # noqa: F401
from _torch_fused_common import (  # noqa: F401
    dense_grid, overflowed_grid, sparse_grid)
from _torch_fused_common import _kernel_halo_source, _t
from doda_tpu_torch.ops import bricks2d as tb2d
from doda_tpu_torch.ops.banded_conv import banded_conv_fused


@pytest.mark.parametrize('grid_name', ['dense_grid', 'sparse_grid',
                                       'overflowed_grid'])
def test_kernel_address_arithmetic_equals_halo_index(request, grid_name):
    g, nbr = request.getfixturevalue(grid_name)
    want = tb2d.halo_index(_t(nbr)).numpy()
    np.testing.assert_array_equal(_kernel_halo_source(nbr, g.b_cap), want)


def test_kernel_shared_memory_swizzle():
    """Where ``issue_halo`` writes the two 16-byte halves of a 32-byte cell
    chunk and where ``ldmatrix``'s per-lane row address reads them: every
    read finds the halo cell (x+dx, y+dy, z+dz) and its channel half, and
    the eight rows of each 8x8 matrix fall on eight distinct 16-byte bank
    groups (no conflict)."""
    cell_b = 32
    written = {}
    for hc in range(216):
        hy = (hc % 36) // 6
        for half in range(2):
            off = hc * cell_b + ((half ^ (hy & 1)) << 4)
            assert off not in written
            written[off] = (hc, half)
    assert sorted(written) == list(range(0, 216 * cell_b, 16))
    for dx in range(3):
        for dy in range(3):
            for dz in range(3):
                for m in range(4):
                    for mat in range(4):
                        groups = set()
                        for row8 in range(8):
                            lane = mat * 8 + row8
                            r = (lane & 7) + ((lane >> 3) & 1) * 8
                            ay, az = r >> 2, r & 3
                            a_half = (lane >> 4) ^ (ay & 1)
                            addr = ((ay * 6 + az) * cell_b
                                    + (dx * 36 + dy * 6 + dz) * cell_b
                                    + ((a_half ^ (dy & 1)) << 4)
                                    + m * 36 * cell_b)
                            hc = (m + dx) * 36 + (ay + dy) * 6 + az + dz
                            assert written[addr] == (hc, lane >> 4)
                            groups.add((addr // 16) % 8)
                        assert len(groups) == 8


def test_fused_raises_off_the_cpu_and_without_rulebook(sparse_grid):
    g, nbr = sparse_grid
    x2 = torch.zeros(4, 64 * 8, device='meta', dtype=torch.bfloat16)
    tn = torch.zeros(4, 27, device='meta', dtype=torch.int32)
    w = torch.zeros(27, 8, 8, device='meta', dtype=torch.bfloat16)
    with pytest.raises(ValueError, match='CUDA'):
        banded_conv_fused(x2, tn, w, torch.bfloat16)
    assert banded_conv_fused.launches == 0
    occ = _t(g.occ)
    xb = torch.zeros(g.b_cap, 64 * 8, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match='rulebook'):
        tb2d.subm_conv3_2d(xb, occ, tb2d.halo_index(_t(nbr)),
                           torch.zeros(27, 8, 8), torch.bfloat16)
