"""Shared inputs of the narrow K1's tests (tests/test_torch_input_conv*.py):
three JAX grids, built once a process, the conv's inputs, and a numpy
mirror of the kernel's halo staging and implicit im2col.
"""

import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from doda_tpu.ops import bricks as jbricks

TOL = dict(rtol=1e-5, atol=1e-5)


def _grid(coords, cap):
    g = jbricks.brickify(jnp.asarray(coords),
                         jnp.ones(len(coords), bool), cap)
    return g, np.asarray(jbricks.build_brick_rulebook(g.table))


@functools.lru_cache(maxsize=None)
def _grids():
    """Dense; sparse with the corner contact whose x-halo cell only a
    diagonal brick supplies; more bricks than capacity (the surplus in the
    null slot)."""
    rng = np.random.default_rng(3)
    dense = _grid(rng.integers(0, 24, (4096, 3)).astype(np.int32), 512)
    rng = np.random.default_rng(11)
    coords = rng.integers(0, 96, (1500, 3)).astype(np.int32)
    crafted = np.array([[4, 4, 4], [3, 3, 4], [3, 3, 7], [4, 7, 4]],
                       np.int32)
    sparse = _grid(np.concatenate([coords, crafted]), 2048)
    rng = np.random.default_rng(5)
    over = _grid(rng.integers(0, 64, (3000, 3)).astype(np.int32), 256)
    assert int(over[0].table.n) == 256 and (over[1] == 256).any()
    return {'dense': dense, 'sparse': sparse, 'overflowed': over}


@pytest.fixture(scope='module')
def grids():
    """Built once a process (its tests are split over several
    files)."""
    return _grids()


def _inputs(rng, g, cin, cout=16):
    x = rng.normal(size=(g.b_cap, 64, cin)).astype(np.float32)
    x = (x * np.asarray(g.occ)[..., None]).reshape(g.b_cap, -1)
    w = (rng.normal(size=(27, cin, cout)) / np.sqrt(27 * cin)).astype(
        np.float32)
    return x, w


def _t(a):
    return torch.from_numpy(np.array(a))


# --- numpy mirror of csrc/subm_conv_narrow.cu --------------------------------

def _hdir(h):
    return 0 if h == 0 else (2 if h == 5 else 1)


def _hpos(h):
    return (h + 3) & 3


def _koff(k, cp):
    """``koff<CP>``: the word of column k inside a cell's halo
    neighbourhood; padded columns read the centre cell's first word."""
    tap, c = divmod(k, cp)
    if tap >= 27:
        tap, c = 13, 0
    dx, dy, dz = tap // 9, tap // 3 % 3, tap % 3
    return (dx * 36 + dy * 6 + dz) * (cp // 2) + c // 2


def _kernel_im2col(x2, nbr, w, cin, cout):
    """What the kernel multiplies, built by its own index arithmetic: the
    (rows, 64, K) A tile each warp reads from its staged halo and the
    (K, cout) B fragments it holds, K = 27*CP padded to 16."""
    rows = nbr.shape[0]
    cp, words = cin + cin % 2, (cin + cin % 2) // 2
    ks_n = -(-27 * cp // 16)
    # staging: lane + 32i -> halo cell -> (rulebook column, source cell);
    # word j of a halo cell holds channels 2j, 2j+1 (zero past cin)
    halo = np.zeros((rows, 216 * words, 2), np.float32)
    staged = np.zeros(216 * words, int)
    for lane in range(32):
        for i in range(7):
            hc = lane + 32 * i
            if hc >= 216:
                continue
            hx, r2 = divmod(hc, 36)
            hy, hz = divmod(r2, 6)
            col = _hdir(hx) * 9 + _hdir(hy) * 3 + _hdir(hz)
            cell = _hpos(hx) * 16 + _hpos(hy) * 4 + _hpos(hz)
            src = nbr[:, col].astype(np.int64)
            ok = (src >= 0) & (src < rows)
            vals = x2.reshape(rows * 64, cin)[np.where(ok, src * 64 + cell,
                                                       0)]
            vals = np.where(ok[:, None], vals, 0)
            vals = np.pad(vals, ((0, 0), (0, cp - cin)))
            for j in range(words):
                halo[:, hc * words + j] = vals[:, 2 * j:2 * j + 2]
                staged[hc * words + j] += 1
    assert (staged == 1).all()
    # A: the m16n8k16 fragments' words; B: the weights' (tap, channel) rows
    a = np.full((rows, 64, ks_n * 16), np.nan, np.float32)
    b = np.full((ks_n * 16, cout), np.nan, np.float32)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        abase = ((g >> 2) * 6 + (g & 3)) * words
        for ks in range(ks_n):
            for reg, (dr, dk) in enumerate(((0, 0), (8, 0), (0, 8), (8, 8))):
                k = ks * 16 + 2 * t + dk
                for m in range(4):
                    word = (m * 36 * words + abase + (12 * words if dr else 0)
                            + _koff(k, cp))
                    assert 0 <= word < 216 * words
                    a[:, m * 16 + g + dr, k:k + 2] = halo[:, word]
            for j in range(-(-cout // 8)):
                for dk in (0, 8):
                    for e in range(2):
                        k = ks * 16 + 2 * t + dk + e
                        tap, c = divmod(k, cp)
                        n = 8 * j + g
                        if n < cout:
                            b[k, n] = w[tap, c, n] if tap < 27 and c < cin \
                                else 0.0
    assert not np.isnan(a).any() and not np.isnan(b).any()
    return a, b


# --- the routing rule and the net ------------------------------------------
