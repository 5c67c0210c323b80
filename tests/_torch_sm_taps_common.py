"""Shared inputs and numpy mirrors of K2's second version's tests
(tests/test_torch_sm_taps*.py): two JAX grids, built once a process, the
operands of a source-major conv, and the kernel's tap table.
"""

import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from doda_tpu.ops import bricks as jbricks

TOL = dict(rtol=1e-5, atol=1e-5)
F32 = jnp.float32


def _grid(coords, cap):
    valid = np.ones(len(coords), bool)
    g = jbricks.brickify(jnp.asarray(coords), jnp.asarray(valid), cap)
    return g, np.asarray(jbricks.build_brick_rulebook(g.table))


@functools.lru_cache(maxsize=None)
def _dense_grid():
    rng = np.random.default_rng(3)
    return _grid(rng.integers(0, 24, (4096, 3)).astype(np.int32), 256)


@pytest.fixture(scope='module')
def dense_grid():
    """Built once a process (its tests are split over several
    files)."""
    return _dense_grid()


@functools.lru_cache(maxsize=None)
def _sparse_grid():
    """Isolated voxels plus the corner contact whose x-halo cell only a
    diagonal brick supplies (see tests/test_torch_sm.py)."""
    rng = np.random.default_rng(11)
    coords = rng.integers(0, 96, (600, 3)).astype(np.int32)
    crafted = np.array([[4, 4, 4], [3, 3, 4], [3, 3, 7], [4, 7, 4]],
                       np.int32)
    return _grid(np.concatenate([coords, crafted]), 640)


@pytest.fixture(scope='module')
def sparse_grid():
    """Built once a process (its tests are split over several
    files)."""
    return _sparse_grid()


def _t(a):
    return torch.from_numpy(np.array(a))


def _operands(rng, b, cin, cout):
    ops = [rng.normal(size=(b, cells * cin)).astype(np.float32)
           for cells in (64, 96, 40, 40)]
    w = rng.normal(size=(27, cin, cout)).astype(np.float32) * 0.1
    return ops, w


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


def _staged_off(c, r, half):
    return c * 512 + r * 32 + ((half ^ ((r >> 2) & 1)) << 4)


# --- the route ---------------------------------------------------------------
