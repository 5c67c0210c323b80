"""Plan tables of the PyTorch port vs the JAX package, integer for integer.

Covers brickify, the brick rulebook, the stride-2 downsample maps and the
flattened batch plan, on scenes with invalid points, a coordinate past the
packed key's range (dropped) and a capacity below the brick count (overflow
bricks fall into the null slot), plus the point -> cell reduction.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from doda_tpu.models import unet as junet
from doda_tpu.ops import bricks as jbricks
from doda_tpu_torch.models import unet as tunet
from doda_tpu_torch.ops import bricks as tbricks

N_PTS = 700


def _scenes():
    """2 scenes: random coords, 60 invalid points each, and one valid
    point at x = 5000 voxels (brick 1250 >= 1024: outside the packed key
    range, so it is dropped)."""
    rng = np.random.default_rng(5)
    coords = rng.integers(0, 44, (2, N_PTS, 3)).astype(np.int32)
    coords[0, 7] = (5000, 3, 3)
    coords[1, :200] = rng.integers(0, 12, (200, 3))   # a denser corner
    valid = np.ones((2, N_PTS), bool)
    valid[:, -60:] = False
    feats = rng.normal(size=(2, N_PTS, 3)).astype(np.float32)
    return coords, valid, feats


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _eq_table(jt, tt):
    _eq(jt.coords, tt.coords)
    _eq(jt.n, tt.n)
    _eq(jt.p2v, tt.p2v)


# (brick cap, parent cap): "fits" holds every brick; "overflow" holds
# fewer bricks than the scene has at both levels
CAPS = {'fits': (512, 256), 'overflow': (40, 16)}


@pytest.mark.parametrize('case', sorted(CAPS))
def test_brickify_rulebook_downsample_exact(case):
    coords, valid, _ = _scenes()
    b_cap, p_cap = CAPS[case]
    for s in range(2):
        c, v = coords[s], valid[s]
        jg = jbricks.brickify(jnp.asarray(c), jnp.asarray(v), b_cap)
        tg = tbricks.brickify(torch.from_numpy(c), torch.from_numpy(v),
                              b_cap)
        if case == 'overflow':
            assert int(jg.table.n) == b_cap     # the cap really binds
        _eq_table(jg.table, tg.table)
        _eq(jg.occ, tg.occ)
        _eq(jg.p2c, tg.p2c)
        _eq(jg.flat_index(), tg.flat_index())
        _eq(jbricks.build_brick_rulebook(jg.table),
            tbricks.build_brick_rulebook(tg.table))

        jd = jbricks.build_brick_downsample(jg.table, jg.occ, p_cap)
        td = tbricks.build_brick_downsample(tg.table, tg.occ, p_cap)
        _eq_table(jd.parent, td.parent)
        _eq(jd.parent_occ, td.parent_occ)
        _eq(jd.child_parent, td.child_parent)
        _eq(jd.parity, td.parity)
        _eq(jd.parent_children, td.parent_children)
    # the out-of-range point maps to the null brick
    assert int(tbricks.brickify(torch.from_numpy(coords[0]),
                                torch.from_numpy(valid[0]),
                                b_cap).table.p2v[7]) == b_cap


@pytest.mark.parametrize('case', ['fits', 'overflow'])
def test_flatten_plan_exact(case):
    coords, valid, _ = _scenes()
    caps = ((256, 128, 128) if case == 'fits' else (40, 16, 8))
    jl, jd = junet.flatten_plan(junet.build_level_plan(
        jnp.asarray(coords), jnp.asarray(valid), caps))
    tl, td = tunet.flatten_plan(tunet.build_level_plan(
        coords, valid, caps, device='cpu'))
    assert len(jl) == len(tl) == 3 and len(jd) == len(td) == 2
    for a, b in zip(jl, tl):
        _eq(a.occ, b.occ)
        _eq(a.nbr, b.nbr)
    for a, b in zip(jd, td):
        _eq(a.child_parent, b.child_parent)
        _eq(a.parity, b.parity)
        _eq(a.parent_children, b.parent_children)


@pytest.mark.parametrize('mode', [3, 4])
def test_brick_feats_2d(mode):
    coords, valid, feats = _scenes()
    for s in range(2):
        jg = jbricks.brickify(jnp.asarray(coords[s]), jnp.asarray(valid[s]),
                              512)
        tg = tbricks.brickify(torch.from_numpy(coords[s]),
                              torch.from_numpy(valid[s]), 512)
        want = np.asarray(jbricks.brick_feats_2d(jnp.asarray(feats[s]), jg,
                                                 mode))
        got = tbricks.brick_feats_2d(torch.from_numpy(feats[s]), tg,
                                     mode).numpy()
        assert got.shape == want.shape == (512, 64 * 3)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        # empty cells stay exactly zero (engine invariant)
        empty = ~np.repeat(np.asarray(tg.occ), 3, axis=1)
        assert (got[empty] == 0).all()
