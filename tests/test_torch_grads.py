"""Backward of the port's wide-lane convs vs ``jax.grad`` of the JAX ops.

Both packages give each conv its own backward (gathers and matrix products,
no scatter-add): dx of a subm conv is the conv on the flipped stencil, dW a
contraction of the re-assembled planes with the cotangent. The same numpy
inputs and cotangent go through both at float32; rtol = atol = 1e-4, the
bound of ``test_subm_conv_2d_sparse_grads`` (sums in another order). The
port's subm conv is run on both engines: K1 (``sm_max_cin=0``) and K2
(``sm_max_cin=32``), where the backward's dx picks its kernel from the
flipped shape, and on K1's fused route (``banded_conv_fused``, which takes
the rulebook instead of the assembled planes).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from doda_tpu.models.unet import FlatDown as JFlatDown
from doda_tpu.ops import bricks as jbricks
from doda_tpu.ops import bricks2d as jb2d
from doda_tpu_torch.models.unet import FlatDown
from doda_tpu_torch.ops import bricks2d as tb2d

TOL = dict(rtol=1e-4, atol=1e-4)
F32 = jnp.float32


@pytest.fixture(scope='module')
def grid():
    """Scattered voxels plus the corner contact whose x-halo cell only a
    diagonal brick supplies (see tests/test_torch_sm.py)."""
    rng = np.random.default_rng(11)
    coords = rng.integers(0, 40, (900, 3)).astype(np.int32)
    crafted = np.array([[44, 44, 44], [43, 43, 44], [43, 43, 47],
                        [44, 47, 44]], np.int32)
    coords = np.concatenate([coords, crafted])
    g = jbricks.brickify(jnp.asarray(coords),
                         jnp.ones(len(coords), bool), 384)
    return g, jbricks.build_brick_rulebook(g.table)


def _feats(rng, occ, c):
    occ = np.asarray(occ)
    f = rng.normal(size=occ.shape + (c,)).astype(np.float32)
    return (f * occ[..., None]).reshape(occ.shape[0], -1)


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def _torch_grads(fn, x, w, cot):
    tx, tw = _t(x, True), _t(w, True)
    out = fn(tx, tw)
    out.backward(_t(cot))
    return out.detach().numpy(), tx.grad.numpy(), tw.grad.numpy()


def _jax_grads(fn, x, w, cot):
    out, vjp = jax.vjp(fn, jnp.asarray(x), jnp.asarray(w))
    dx, dw = vjp(jnp.asarray(cot))
    return np.asarray(out), np.asarray(dx), np.asarray(dw)


def _compare(got, want):
    for name, g, j in zip(('out', 'dx', 'dw'), got, want):
        assert np.abs(j).max() > 1e-2, name      # the check is not vacuous
        np.testing.assert_allclose(g, j, err_msg=name, **TOL)


_JAX_SUBM = {}     # (cin, cout) -> inputs and JAX results, shared by engines


def _subm_reference(grid, cin, cout):
    if (cin, cout) not in _JAX_SUBM:
        g, nbr = grid
        rng = np.random.default_rng(cin * 100 + cout)
        x2 = _feats(rng, g.occ, cin)
        w = rng.normal(size=(27, cin, cout)).astype(np.float32) * 0.1
        # an unmasked cotangent: the backward must mask it itself
        cot = rng.normal(size=(g.b_cap, 64 * cout)).astype(np.float32)
        want = _jax_grads(
            lambda a, b: jb2d.subm_conv3_2d(a, g.occ, nbr, b, F32),
            x2, w, cot)
        _JAX_SUBM[cin, cout] = (x2, w, cot, want)
    return _JAX_SUBM[cin, cout]


@pytest.mark.parametrize('cin,cout,sm_max_cin', [
    (16, 16, 0), (16, 16, 32),
    (32, 16, 32),      # K2 forward at cin = 32, K2 dx on 16 -> 32
    (64, 32, 32),      # forward on K1, dx (32 -> 64) on K2
    (3, 16, 32),
    # the fused K1 route (activation + rulebook in), forward and dx; the
    # rule keeps float32 on the 'f32' route, so these cases widen it
    pytest.param(16, 16, 0, id='16-16-0-fused'),
    pytest.param(64, 32, 32, id='64-32-32-fused'),   # fused forward, K2 dx
    pytest.param(32, 16, 0, id='32-16-0-fused')])
def test_subm_conv_grads(request, monkeypatch, grid, cin, cout, sm_max_cin):
    g, nbr = grid
    x2, w, cot, want = _subm_reference(grid, cin, cout)
    tn = _t(nbr)
    halo, sm, occ = tb2d.halo_index(tn), tb2d.sm_index(tn), _t(g.occ)
    fused = request.node.callspec.id.endswith('fused')
    if fused:
        monkeypatch.setattr(
            tb2d, 'uses_fused',
            lambda cin, cout, dtype: cin % 8 == 0 and cout % 8 == 0)
        calls = []
        plain = tb2d.banded_conv_fused
        monkeypatch.setattr(tb2d, 'banded_conv_fused',
                            lambda *a: calls.append(1) or plain(*a))
    got = _torch_grads(lambda a, b: tb2d.subm_conv3_2d(
        a, occ, halo, b, torch.float32, sm, sm_max_cin, tn), x2, w, cot)
    _compare(got, want)
    if fused:      # forward and dx, less what the rule gives to K2
        assert len(calls) == 2 - tb2d.uses_sm(cin, cout, sm_max_cin) \
            - tb2d.uses_sm(cout, cin, sm_max_cin)


def test_subm_conv_skips_dx_of_a_leaf_input(grid, monkeypatch):
    """The input conv's x needs no gradient: no dx conv may run."""
    g, nbr = grid
    rng = np.random.default_rng(2)
    x2 = _t(_feats(rng, g.occ, 3))
    w = _t(rng.normal(size=(27, 3, 16)).astype(np.float32), True)
    calls = []
    raw = tb2d._subm_raw
    monkeypatch.setattr(tb2d, '_subm_raw',
                        lambda *a: calls.append(1) or raw(*a))
    out = tb2d.subm_conv3_2d(x2, _t(g.occ), tb2d.halo_index(_t(nbr)), w,
                             torch.float32, nbr=_t(nbr))
    out.sum().backward()
    assert len(calls) == 1 and w.grad is not None and x2.grad is None


@pytest.fixture(scope='module')
def down(grid):
    g, _ = grid
    ds = jbricks.build_brick_downsample(g.table, g.occ, 128)
    jmaps = JFlatDown(child_parent=ds.child_parent, parity=ds.parity,
                      parent_children=ds.parent_children)
    return ds, jmaps, FlatDown(*(_t(a) for a in jmaps))


def test_down_conv_grads(grid, down):
    g, _ = grid
    ds, jmaps, tmaps = down
    rng = np.random.default_rng(7)
    x2 = _feats(rng, g.occ, 16)
    w = rng.normal(size=(8, 16, 32)).astype(np.float32) * 0.2
    cot = rng.normal(size=(128, 64 * 32)).astype(np.float32)
    want = _jax_grads(lambda a, b: jb2d.down_conv2_2d(
        a, ds.parent_occ, jmaps, b, F32), x2, w, cot)
    occ_p = _t(ds.parent_occ)
    got = _torch_grads(lambda a, b: tb2d.down_conv2_2d(
        a, occ_p, tmaps, b, torch.float32), x2, w, cot)
    _compare(got, want)


def test_up_conv_grads(grid, down):
    g, _ = grid
    ds, jmaps, tmaps = down
    rng = np.random.default_rng(8)
    p2 = _feats(rng, ds.parent_occ, 32)
    w = rng.normal(size=(8, 32, 16)).astype(np.float32) * 0.2
    cot = rng.normal(size=(g.b_cap, 64 * 16)).astype(np.float32)
    want = _jax_grads(lambda a, b: jb2d.up_conv2_2d(a, g.occ, jmaps, b, F32),
                      p2, w, cot)
    occ = _t(g.occ)
    got = _torch_grads(lambda a, b: tb2d.up_conv2_2d(
        a, occ, tmaps, b, torch.float32), p2, w, cot)
    _compare(got, want)


def test_conv1x1_grads(grid):
    g, _ = grid
    rng = np.random.default_rng(9)
    x2 = _feats(rng, g.occ, 32)
    w = rng.normal(size=(32, 16)).astype(np.float32) * 0.2
    cot = rng.normal(size=(g.b_cap, 64 * 16)).astype(np.float32)
    want = _jax_grads(lambda a, b: jb2d.conv1x1_2d(a, g.occ, b, F32),
                      x2, w, cot)
    occ = _t(g.occ)
    got = _torch_grads(lambda a, b: tb2d.conv1x1_2d(a, occ, b,
                                                    torch.float32),
                       x2, w, cot)
    _compare(got, want)


def test_contract_rows_accumulates_in_float32():
    """bf16 operands: the weight gradient's contraction over many rows is
    summed and returned in float32, not rounded to bf16 as a bf16 matmul's
    output is."""
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.normal(size=(16384, 24)).astype(np.float32))
    b = torch.from_numpy(rng.normal(1.0, 1.0, (16384, 8)).astype(np.float32))
    a16, b16 = a.bfloat16(), b.bfloat16()
    exact = a16.double().T @ b16.double()
    got = tb2d._contract_rows(a16, b16)
    assert got.dtype == torch.float32
    rounded = (a16.T @ b16).double()
    err, err_rounded = ((t.double() - exact).abs().max().item()
                        for t in (got, rounded))
    # float32 summation of 16384 products errs by ~2e-6 of the sum's size
    assert err <= 1e-5 * exact.abs().max().item()
    assert err < 0.01 * err_rounded
    np.testing.assert_allclose(tb2d._contract_rows(a, b).numpy(),
                               (a.double().T @ b.double()).numpy(),
                               rtol=1e-4, atol=1e-3)
