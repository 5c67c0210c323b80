"""A numpy mirror of K2's second version's tap table reads, through
``_assemble_sm``'s operands, exactly the windows of ``_assemble_p6``'s
planes and names no padding cell; its shared-memory plan fits every cin;
the 32-byte swizzle leaves ``ldmatrix`` conflict-free.
"""

import numpy as np
import pytest
import torch

from _torch_threads import two_threads  # noqa: F401
from _torch_sm_taps_common import dense_grid, sparse_grid  # noqa: F401
from _torch_sm_taps_common import _plan, _staged_slot, _t, _table
from doda_tpu_torch.ops import bricks2d as tb2d


def test_tap_table_names_every_halo_cell_and_no_padding():
    table = _table()
    pads = {64 + r * 24 + k for r in range(4) for k in range(20, 24)}
    pads |= {base + k for base in (160, 200) for k in range(36, 40)}
    named = set(table.ravel().tolist())
    assert not named & pads
    assert named == set(range(240)) - pads      # the 216 halo cells
    # the kernel's static_asserts
    assert (table[0, 0], table[63, 26], table[16, 13], table[16, 9]) == (
        160, 235, 16, 104)
    assert _staged_slot(64 + 24 + 19) == 35


@pytest.mark.parametrize('grid_name,cin', [('dense_grid', 16),
                                           ('sparse_grid', 32)])
def test_tap_table_reads_the_halo_plane_windows(request, grid_name, cin):
    """Gathering through the table from ``_assemble_sm``'s operands gives
    every (output cell, tap) the cell that ``_assemble_p6``'s planes put
    in its window: plane x + dx + 1, cell (y + dy + 1, z + dz + 1)."""
    g, nbr = request.getfixturevalue(grid_name)
    rows = g.b_cap
    rng = np.random.default_rng(cin)
    f = rng.normal(size=(rows, 64, cin)).astype(np.float32)
    x2 = _t((f * np.asarray(g.occ)[..., None]).reshape(rows, -1))
    tn = _t(nbr)
    x, gyz, gxm, gxp = tb2d._assemble_sm(x2, tb2d.sm_index(tn),
                                         torch.float32)
    src = torch.cat([t.reshape(rows, -1, cin) for t in (x, gyz, gxm, gxp)],
                    dim=1).numpy()                       # (rows, 240, cin)
    p6 = tb2d._assemble_p6(x2, tb2d.halo_index(tn),
                           torch.float32).reshape(rows, 6, 36, cin).numpy()
    table = _table()
    for o in range(64):
        xo, yo, zo = o >> 4, (o >> 2) & 3, o & 3
        for t in range(27):
            dx, dy, dz = t // 9 - 1, (t // 3) % 3 - 1, t % 3 - 1
            want = p6[:, xo + dx + 1, (yo + dy + 1) * 6 + (zo + dz + 1)]
            np.testing.assert_array_equal(src[:, table[o, t]], want)
    assert np.abs(src).sum() > 0


def test_kernel_plan_fits_every_cin():
    """One weight group up to cin = 112 (the flagship's widest), groups of
    equal chunks above it; always two to six stages within 227 KB."""
    for cin in range(16, 513, 16):
        nk = cin // 16
        gk, stages, smem = _plan(cin)
        assert 2 <= stages <= 6 and smem <= 227 * 1024
        assert (gk == nk) == (cin <= 112)
        assert -(-nk // gk) * gk - nk < gk      # no empty group
    assert _plan(16) == (1, 6, 34816 + 6 * 18432 + 20736)
    assert _plan(112)[:2] == (7, 2) and _plan(128)[:2] == (4, 6)


def test_kernel_shared_memory_swizzle():
    """TMA's 32-byte swizzle (16-byte half ^= bit 7 of the offset) of a
    unit laid out (cell, brick, 16 channels), and the ldmatrix row address
    of each lane: every lane finds (cell, brick, half), and the eight rows
    of each 8x8 matrix fall on eight distinct 16-byte bank groups. Weight
    rows of an odd pitch in 16-byte units are conflict-free as well."""
    def swz(off):
        return off ^ (((off >> 7) & 1) << 4)

    placed = {}
    for cell in range(36):
        for brick in range(16):
            for half in range(2):
                off = swz(cell * 512 + brick * 32 + half * 16)
                assert off not in placed
                placed[off] = (cell, brick, half)
    assert sorted(placed) == list(range(0, 36 * 512, 16))
    for cell in range(36):
        for mat in range(4):
            groups = set()
            for row8 in range(8):
                lane = mat * 8 + row8
                r = (lane & 7) + ((lane >> 3) & 1) * 8
                addr = cell * 512 + r * 32 + (((lane >> 4) ^ ((r >> 2) & 1))
                                              << 4)
                assert placed[addr] == (cell, r, lane >> 4)
                groups.add((addr // 16) % 8)
            assert len(groups) == 8
    pitch = 48                 # WPITCH: 16 couts of bf16 and 16 bytes
    assert len({(k * pitch // 16) % 8 for k in range(8)}) == 8
