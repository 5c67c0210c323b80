"""K2's second version (``banded_conv_sm_taps``) of the PyTorch port.

On the CPU the wrapper runs its plain version, the first version's plain
arithmetic on ``sm_weights(w)``; the CUDA kernel itself is held against it
on the card by ``chip_smoke.py``. Here:

* the wrapper equals ``banded_conv_sm_plain`` on ``sm_weights`` bit for bit,
  and the Pallas kernel (interpret mode) on the JAX package's
  ``sm_weights`` of the same raster weights to rtol = atol = 1e-5 at
  float32 (sums in another order), ragged B included;
* a numpy mirror of the kernel's tap table reads, through
  ``_assemble_sm``'s operands, exactly the windows of ``_assemble_p6``'s
  planes, names no padding cell, and a numpy walk of the kernel's data
  flow (TMA boxes, staged slots, weight groups, per-slice accumulation,
  ragged tiles) computes the conv, and its shared-memory plan fits every
  cin; the 32-byte swizzle leaves ``ldmatrix`` conflict-free,
  and the staged epilogue puts every output where its stores read it;
* the 'sm' route of ``_subm_raw`` calls the wrapper with raster weights
  and never ``sm_weights``, in bf16 and in float32 (the first version's
  kernel, on ``sm_weights``, is deleted).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from doda_tpu.ops import bricks as jbricks
from doda_tpu.ops import bricks2d as jb2d
from doda_tpu.ops import pallas_sm
from doda_tpu_torch.ops import bricks2d as tb2d
from doda_tpu_torch.ops.banded_conv_sm import (banded_conv_sm,
                                               banded_conv_sm_plain,
                                               banded_conv_sm_taps,
                                               banded_conv_sm_taps_plain)

TOL = dict(rtol=1e-5, atol=1e-5)
F32 = jnp.float32


def _grid(coords, cap):
    valid = np.ones(len(coords), bool)
    g = jbricks.brickify(jnp.asarray(coords), jnp.asarray(valid), cap)
    return g, np.asarray(jbricks.build_brick_rulebook(g.table))


@pytest.fixture(scope='module')
def dense_grid():
    rng = np.random.default_rng(3)
    return _grid(rng.integers(0, 24, (4096, 3)).astype(np.int32), 256)


@pytest.fixture(scope='module')
def sparse_grid():
    """Isolated voxels plus the corner contact whose x-halo cell only a
    diagonal brick supplies (see tests/test_torch_sm.py)."""
    rng = np.random.default_rng(11)
    coords = rng.integers(0, 96, (600, 3)).astype(np.int32)
    crafted = np.array([[4, 4, 4], [3, 3, 4], [3, 3, 7], [4, 7, 4]],
                       np.int32)
    return _grid(np.concatenate([coords, crafted]), 640)


def _t(a):
    return torch.from_numpy(np.array(a))


def _operands(rng, b, cin, cout):
    ops = [rng.normal(size=(b, cells * cin)).astype(np.float32)
           for cells in (64, 96, 40, 40)]
    w = rng.normal(size=(27, cin, cout)).astype(np.float32) * 0.1
    return ops, w


@pytest.mark.parametrize('b,cin,cout', [(64, 16, 16), (36, 32, 16),
                                        (48, 16, 32)])
def test_taps_equals_first_version_and_pallas(b, cin, cout):
    rng = np.random.default_rng(b + cin + cout)
    ops, w = _operands(rng, b, cin, cout)
    tops, tw = [_t(o) for o in ops], _t(w)
    for dt in (torch.float32, torch.bfloat16):
        args = [o.to(dt) for o in tops]
        got = banded_conv_sm_taps(*args, tw.to(dt), dt)
        want = banded_conv_sm_plain(*args, *tb2d.sm_weights(tw.to(dt)), dt)
        assert got.dtype == dt and got.shape == (b, 64 * cout)
        assert torch.equal(got, want)
    assert banded_conv_sm_taps.launches == 0   # the CPU never reaches a kernel
    # the Pallas kernel tiles rows by 8: a ragged B runs zero-padded
    pad = -b % 8
    jops = [jnp.asarray(np.pad(o, ((0, pad), (0, 0)))) for o in ops]
    jw = jb2d.sm_weights(jnp.asarray(w), F32)
    assert pallas_sm.fits_sm(b + pad, cin, cout, 4)
    want_pl = np.asarray(pallas_sm.banded_conv_sm(*jops, *jw, F32))[:b]
    got = banded_conv_sm_taps(*tops, tw, torch.float32)
    np.testing.assert_allclose(got.numpy(), want_pl, **TOL)


def test_taps_takes_row_strided_operands_and_no_rows():
    """gyz/gxm/gxp arrive as column slices of one gathered buffer."""
    rng = np.random.default_rng(5)
    (x, gyz, gxm, gxp), w = _operands(rng, 40, 16, 8)
    buf = _t(np.concatenate([gyz, gxm, gxp], axis=1)).bfloat16()
    a, b = 96 * 16, 136 * 16
    xb, tw = _t(x).bfloat16(), _t(w).bfloat16()
    got = banded_conv_sm_taps(xb, buf[:, :a], buf[:, a:b], buf[:, b:], tw,
                              torch.float32)
    want = banded_conv_sm_taps_plain(
        xb, *(_t(o).bfloat16() for o in (gyz, gxm, gxp)), tw, torch.float32)
    assert torch.equal(got, want)
    empty = banded_conv_sm_taps(xb[:0], buf[:0, :a], buf[:0, a:b],
                                buf[:0, b:], tw, torch.bfloat16)
    assert empty.shape == (0, 64 * 8) and empty.dtype == torch.bfloat16


def test_taps_raises_off_the_cpu():
    meta = [torch.zeros(4, c * 16, device='meta', dtype=torch.bfloat16)
            for c in (64, 96, 40, 40)]
    w = torch.zeros(27, 16, 16, device='meta', dtype=torch.bfloat16)
    with pytest.raises(ValueError, match='CUDA'):
        banded_conv_sm_taps(*meta, w, torch.bfloat16)
    assert banded_conv_sm_taps.launches == 0


# --- numpy mirror of csrc/banded_conv_sm_taps.cu ---------------------------

def _inside(h):
    return 0 <= h < 4


def _run_pos(hy, hz):
    if not _inside(hy) and not _inside(hz):
        return 16 + (hy == 4) * 2 + (hz == 4)
    if hz == -1:
        return hy
    if hz == 4:
        return 4 + hy
    return 8 + hz if hy == -1 else 12 + hz


def _tap_source(o, t):
    """The kernel's ``tap_source``: operand cell of [x 64 | gyz 96 |
    gxm 40 | gxp 40] that tap t of output cell o reads."""
    sx = (o >> 4) + t // 9 - 1
    hy = ((o >> 2) & 3) + (t // 3) % 3 - 1
    hz = (o & 3) + t % 3 - 1
    if sx in (-1, 4):
        return (160 if sx == -1 else 200) + (hy + 1) * 6 + (hz + 1)
    if _inside(hy) and _inside(hz):
        return sx * 16 + hy * 4 + hz
    return 64 + sx * 24 + _run_pos(hy, hz)


def _staged_slot(src):
    if src < 64:
        return src & 15
    return 16 + (src - 64) % 24 if src < 160 else (src - 160) % 40


def _table():
    return np.array([[_tap_source(o, t) for t in range(27)]
                     for o in range(64)])


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


def _load_weights(w, gk, k0):
    """``load_weights``: the resident rows (tap, channel of the group) of
    weight group k0 / gk, zero where a last group has fewer chunks."""
    cin, wc = w.shape[1], gk * 16
    w_s = np.zeros((27 * wc, w.shape[2]))
    for row in range(27 * wc):
        t, ch = row // wc, k0 * 16 + row % wc
        if ch < cin:
            w_s[row] = w[t, ch]
    return w_s


def _kernel_walk(x, gyz, gxm, gxp, w, ysplit, gk=None):
    """sm_taps_tc's data flow in numpy (float64): bricks in tiles of 16
    with TMA's zero fill, units (channel chunk, plane) staged as its boxes
    place them, each of ``ysplit`` warps of a slice accumulating its y-rows
    from the units of planes xr..xr+2 with the slot a representative
    reader's table entry names and the B rows of the resident weight group
    of ``gk`` chunks (all chunks if None), stores masked to the real
    rows."""
    b, cin, cout = x.shape[0], w.shape[1], w.shape[2]
    bp = -(-b // 16) * 16
    gk = gk or cin // 16
    wc = gk * 16

    def view(a):            # (cells, bricks padded to the tile, cin)
        a = np.pad(a.astype(np.float64), ((0, bp - b), (0, 0)))
        return a.reshape(bp, -1, cin).transpose(1, 0, 2)

    x3, g3, m3, p3 = map(view, (x, gyz, gxm, gxp))
    acc = np.zeros((4, 16, bp, cout))
    for kc in range(cin // 16):
        ch = slice(kc * 16, kc * 16 + 16)
        kg = kc % gk
        if kg == 0:
            w_s = _load_weights(w, gk, kc)
        for pl in range(6):
            if pl in (0, 5):                      # one 36-cell box
                unit = (m3 if pl == 0 else p3)[:36, :, ch]
                rep_o, rep_t0 = 0, 0
            else:                                 # 16 x cells + 20-cell run
                unit = np.concatenate([x3[(pl - 1) * 16:pl * 16, :, ch],
                                       g3[(pl - 1) * 24:(pl - 1) * 24 + 20,
                                          :, ch]])
                rep_o, rep_t0 = 16, 9
            assert unit.shape[0] == 36
            ry_n = 4 // ysplit
            for xr, y0 in ((xr, yh * ry_n) for xr in range(4)
                           for yh in range(ysplit)):
                dx = pl - 1 - xr
                if not -1 <= dx <= 1:
                    continue
                for hy in range(y0 - 1, y0 + ry_n + 1):
                    for hz in range(-1, 5):
                        ry = min(max(hy, y0), y0 + ry_n - 1)
                        rz = min(max(hz, 0), 3)
                        slot = _staged_slot(_tap_source(
                            rep_o + ry * 4 + rz,
                            rep_t0 + (hy - ry + 1) * 3 + (hz - rz + 1)))
                        a = unit[slot]
                        for dy in (-1, 0, 1):
                            for dz in (-1, 0, 1):
                                y, z = hy - dy, hz - dz
                                if y0 <= y < y0 + ry_n and _inside(z):
                                    t = (dx + 1) * 9 + (dy + 1) * 3 + dz + 1
                                    # every real reader names this slot
                                    o = xr * 16 + y * 4 + z
                                    assert _staged_slot(
                                        _tap_source(o, t)) == slot
                                    r0 = ((dx + 1) * 9 + (dy + 1) * 3
                                          + dz + 1) * wc + kg * 16
                                    acc[xr, y * 4 + z] += a @ w_s[r0:r0 + 16]
    out = acc.reshape(64, bp, cout).transpose(1, 0, 2)[:b]
    return out.reshape(b, 64 * cout)


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


def _plan(cin):
    """The kernel's ``plan``: (chunks a weight group, stages, dynamic
    shared-memory bytes)."""
    nk, fixed = cin // 16, 2 * 1024 + 8 * 8 * 16 * 32
    chunk_w, unit, most = 27 * 16 * 48, 36 * 16 * 32, 227 * 1024
    gmax = (most - fixed - 2 * unit) // chunk_w
    groups = -(-nk // gmax)
    gk = -(-nk // groups)
    stages = min((most - fixed - gk * chunk_w) // unit, 6)
    return gk, stages, fixed + stages * unit + gk * chunk_w


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


def _staged_off(c, r, half):
    return c * 512 + r * 32 + ((half ^ ((r >> 2) & 1)) << 4)


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


# --- the route ---------------------------------------------------------------

@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
def test_sm_route_kernel_by_dtype(sparse_grid, monkeypatch, dtype):
    """bf16 and float32: forward and dx call the kernel's wrapper with
    raster weights (the flipped stencil for dx) and never build
    ``sm_weights``; the first version's wrapper is not on the route."""
    g, nbr = sparse_grid
    rng = np.random.default_rng(8)
    f = rng.normal(size=(g.b_cap, 64, 16)).astype(np.float32)
    x2 = _t((f * np.asarray(g.occ)[..., None]).reshape(g.b_cap, -1))
    w = _t(rng.normal(size=(27, 16, 16)).astype(np.float32) * 0.1)
    tn = _t(nbr)
    real_sm_weights = tb2d.sm_weights
    calls = {'taps': [], 'sm_weights': 0}

    def taps(x, gyz, gxm, gxp, wr, out_dtype):
        calls['taps'].append(wr)
        return banded_conv_sm_plain(x, gyz, gxm, gxp, *real_sm_weights(wr),
                                    out_dtype)

    def sm_weights(wr, *side):
        calls['sm_weights'] += 1
        return real_sm_weights(wr, *side)

    monkeypatch.setattr(tb2d, 'banded_conv_sm_taps', taps)
    monkeypatch.setattr(tb2d, 'sm_weights', sm_weights)
    assert not hasattr(tb2d, 'banded_conv_sm')
    xl = x2.to(dtype).requires_grad_(True)
    wl = w.clone().requires_grad_(True)
    out = tb2d.subm_conv3_2d(xl, _t(g.occ), tb2d.halo_index(tn), wl, dtype,
                             tb2d.sm_index(tn), 32, tn)
    out.float().sum().backward()
    assert calls['sm_weights'] == 0
    assert len(calls['taps']) == 2
    fwd_w, dx_w = calls['taps']
    assert torch.equal(fwd_w, w.to(dtype))
    assert torch.equal(dx_w, tb2d._flip_weights(w).to(dtype))
    assert all(t.is_contiguous() for t in calls['taps'])


def test_sm_route_takes_second_version_at_every_cin(monkeypatch):
    """The second version cuts a cin above 112 into weight groups, so a
    wide bf16 'sm' conv takes it too (the first version is on no
    route)."""
    calls = []
    monkeypatch.setattr(tb2d, 'banded_conv_sm_taps',
                        lambda *a: calls.append('taps'))
    rows = 2
    sm = torch.full((rows, 176), rows * 64, dtype=torch.int32)
    for cin in (112, 128):
        x2 = torch.zeros(rows, 64 * cin, dtype=torch.bfloat16)
        tb2d._subm_raw(x2, None, sm, torch.zeros(27, cin, 16),
                       torch.bfloat16, 128)
    assert calls == ['taps', 'taps']
