"""Backward of the port's subm conv vs ``jax.vjp`` of the JAX op.

Both packages give each conv its own backward (gathers and matrix products,
no scatter-add): dx of a subm conv is the conv on the flipped stencil, dW a
contraction of the re-assembled planes with the cotangent. The same numpy
inputs and cotangent go through both at float32; rtol = atol = 1e-4, the
bound of ``test_subm_conv_2d_sparse_grads`` (sums in another order). The
port's subm conv is run on both engines: K1 (``sm_max_cin=0``) and K2
(``sm_max_cin=32``), where the backward's dx picks its kernel from the
flipped shape, and on K1's fused route (``banded_conv_fused``, which takes
the rulebook instead of the assembled planes). Here the convs of cin <= 16
(the wider ones are in tests/test_torch_grads_wide.py), the skipped dx of
a leaf input and the float32 accumulation of a bf16 dW.
"""

import numpy as np
import pytest
import torch

from _torch_threads import two_threads  # noqa: F401
from _torch_grads_common import grid  # noqa: F401
from _torch_grads_common import (_compare, _feats, _subm_reference, _t,
                                 _torch_grads)
from doda_tpu_torch.ops import bricks2d as tb2d


@pytest.mark.parametrize('cin,cout,sm_max_cin', [
    (16, 16, 0), (16, 16, 32),
    (3, 16, 32),
    # the fused K1 route (activation + rulebook in), forward and dx; the
    # rule keeps float32 on the 'f32' route, so this case widens it
    pytest.param(16, 16, 0, id='16-16-0-fused')])
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
