"""Kernel K2 and the source-major conv path of the PyTorch port vs the JAX
package.

On the CPU ``banded_conv_sm`` is its plain version; here it is held against
the Pallas kernel itself (``pallas_sm.banded_conv_sm`` runs in interpret
mode off the TPU) and against the XLA form ``_sm_xla``, at float32 with
rtol = atol = 1e-5 (sums in another order). The operands and weights are
placement only and must equal the JAX package's bit for bit. The JAX
functions are called directly; no ``DODA_SM*`` variable is set.
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
                                               banded_conv_sm_taps)

TOL = dict(rtol=1e-5, atol=1e-5)
F32 = jnp.float32


def _grid(coords, cap):
    valid = np.ones(len(coords), bool)
    g = jbricks.brickify(jnp.asarray(coords), jnp.asarray(valid), cap)
    return g, jbricks.build_brick_rulebook(g.table)


@pytest.fixture(scope='module')
def dense_grid():
    rng = np.random.default_rng(3)
    return _grid(rng.integers(0, 24, (4096, 3)).astype(np.int32), 256)


@pytest.fixture(scope='module')
def sparse_grid():
    """Isolated voxels plus a crafted corner contact: bricks (1,1,1) and
    (0,0,1) are present, the face x-neighbour (0,1,1) is not, so the
    x-halo plane of (1,1,1) has a cell only a diagonal brick supplies."""
    rng = np.random.default_rng(11)
    coords = rng.integers(0, 96, (600, 3)).astype(np.int32)
    crafted = np.array([[4, 4, 4], [3, 3, 4], [3, 3, 7], [4, 7, 4]],
                       np.int32)
    return _grid(np.concatenate([coords, crafted]), 640)


def _feats(rng, g, cin):
    f = rng.normal(size=(g.b_cap, 64, cin)).astype(np.float32)
    return (f * np.asarray(g.occ)[..., None]).reshape(g.b_cap, -1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _operands(rng, b, cin, cout):
    ops = [rng.normal(size=(b, cells * cin)).astype(np.float32)
           for cells in (64, 96, 40, 40)]
    w = rng.normal(size=(27, cin, cout)).astype(np.float32) * 0.1
    return ops, w


@pytest.mark.parametrize('cin,cout', [(16, 16), (32, 16), (16, 24)])
def test_sm_weights_exact(cin, cout):
    w = np.random.default_rng(cin + cout).normal(
        size=(27, cin, cout)).astype(np.float32)
    want = jb2d.sm_weights(jnp.asarray(w), F32)
    got = tb2d.sm_weights(_t(w))
    for g, j in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(j))


@pytest.mark.parametrize('grid_name,cin', [
    ('dense_grid', 16), ('sparse_grid', 32)])
def test_assemble_sm_exact(request, grid_name, cin):
    g, nbr = request.getfixturevalue(grid_name)
    x2 = _feats(np.random.default_rng(cin), g, cin)
    want = jb2d._assemble_sm(jnp.asarray(x2), nbr, F32)
    sm = tb2d.sm_index(_t(nbr))
    assert sm.shape == (g.b_cap, 176) and sm.dtype == torch.int32
    got = tb2d._assemble_sm(_t(x2), sm, torch.float32)
    for name, a, j in zip(('x', 'gyz', 'gxm', 'gxp'), got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(j), err_msg=name)
    if grid_name == 'sparse_grid':
        # the crafted corner contact really is in this grid: some brick has
        # no -x face neighbour and yet a non-zero x-minus plane
        face = np.asarray(nbr)[:, tb2d.dir3_index(-1, 0, 0)] >= g.b_cap
        assert (np.abs(got[2].numpy())[face].sum(1) > 0).any()


@pytest.mark.parametrize('b,cin,cout', [(64, 16, 16), (64, 32, 8),
                                        (72, 16, 24)])
def test_banded_conv_sm_plain_matches_pallas_and_xla(b, cin, cout):
    rng = np.random.default_rng(b + cin + cout)
    ops, w = _operands(rng, b, cin, cout)
    jw = jb2d.sm_weights(jnp.asarray(w), F32)
    jops = [jnp.asarray(o) for o in ops]
    want_xla = np.asarray(jb2d._sm_xla(*jops, *jw, cin, cout))
    tw = tb2d.sm_weights(_t(w))
    got = banded_conv_sm(*map(_t, ops), *tw, torch.float32)
    assert got.dtype == torch.float32 and got.shape == (b, 64 * cout)
    np.testing.assert_allclose(got.numpy(), want_xla, **TOL)
    if b % 8 == 0 and pallas_sm.fits_sm(b, cin, cout, 4):
        want_pl = np.asarray(pallas_sm.banded_conv_sm(*jops, *jw, F32))
        np.testing.assert_allclose(got.numpy(), want_pl, **TOL)
    # the CPU never reaches a kernel
    assert banded_conv_sm_taps.launches == banded_conv_sm_taps.f32_launches \
        == 0


def test_banded_conv_sm_takes_row_strided_operands():
    """gyz/gxm/gxp arrive as column slices of one gathered buffer."""
    rng = np.random.default_rng(5)
    (x, gyz, gxm, gxp), w = _operands(rng, 40, 16, 8)
    tw = tb2d.sm_weights(_t(w))
    buf = _t(np.concatenate([gyz, gxm, gxp], axis=1))
    a, b = 96 * 16, 136 * 16
    got = banded_conv_sm(_t(x), buf[:, :a], buf[:, a:b], buf[:, b:], *tw,
                         torch.float32)
    want = banded_conv_sm_plain(*map(_t, (x, gyz, gxm, gxp)), *tw,
                                torch.float32)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize('grid_name,cin,cout,jax_too', [
    ('dense_grid', 32, 16, True), ('sparse_grid', 16, 16, True),
    ('dense_grid', 16, 16, False), ('sparse_grid', 16, 32, False)])
def test_subm_conv3_2d_sm_engine(request, grid_name, cin, cout, jax_too):
    """K2's engine against K1's and, for two of the cases, the JAX 2D conv
    and the shell oracle (K1's engine is held to both for the other shapes
    in tests/test_torch_banded_conv.py)."""
    g, nbr = request.getfixturevalue(grid_name)
    rng = np.random.default_rng(cin * 100 + cout)
    x2 = _feats(rng, g, cin)
    w = rng.normal(size=(27, cin, cout)).astype(np.float32) * 0.1
    tn = _t(nbr)
    halo, sm = tb2d.halo_index(tn), tb2d.sm_index(tn)
    assert tb2d.uses_sm(cin, cout, 32)
    got_sm = tb2d.subm_conv3_2d(_t(x2), _t(g.occ), halo, _t(w),
                                torch.float32, sm, 32).numpy()
    got_k1 = tb2d.subm_conv3_2d(_t(x2), _t(g.occ), halo, _t(w),
                                torch.float32, nbr=tn).numpy()
    assert np.abs(got_k1).max() > 0.1
    np.testing.assert_allclose(got_sm, got_k1, **TOL)
    if jax_too:
        want_2d = np.asarray(jb2d.subm_conv3_2d(
            jnp.asarray(x2), g.occ, nbr, jnp.asarray(w), compute_dtype=F32))
        want_oracle = np.asarray(jbricks.subm_conv3(
            jnp.asarray(x2.reshape(g.b_cap, 64, cin)), g.occ, nbr,
            jnp.asarray(w), compute_dtype=F32)).reshape(g.b_cap, -1)
        np.testing.assert_allclose(got_sm, want_2d, **TOL)
        np.testing.assert_allclose(got_sm, want_oracle, **TOL)


@pytest.mark.parametrize('cin,cout,max_cin,want', [
    (16, 16, 32, True), (32, 16, 32, True), (32, 64, 32, True),
    (64, 32, 32, False), (3, 16, 32, False), (16, 3, 32, False),
    (16, 16, 0, False), (48, 48, 32, False), (48, 48, 64, True)])
def test_engine_rule(cin, cout, max_cin, want):
    assert tb2d.uses_sm(cin, cout, max_cin) is want


def test_sm_engine_without_table_or_on_wrong_device_raises(dense_grid):
    g, nbr = dense_grid
    x2 = _t(_feats(np.random.default_rng(0), g, 16))
    w = torch.zeros(27, 16, 16)
    with pytest.raises(ValueError, match='sm_index'):
        tb2d.subm_conv3_2d(x2, _t(g.occ), tb2d.halo_index(_t(nbr)), w,
                           torch.float32, None, 32)
    meta = [torch.zeros(4, c * 16, device='meta') for c in (64, 96, 40, 40)]
    wm = [torch.zeros(s, device='meta') for s in
          ((3, 256, 128), (3, 384, 128), (2, 640, 128))]
    with pytest.raises(ValueError, match='CUDA'):
        banded_conv_sm(*meta, *wm, torch.float32)
    assert banded_conv_sm_taps.launches == banded_conv_sm_taps.f32_launches \
        == 0
