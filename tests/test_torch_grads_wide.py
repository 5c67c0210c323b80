"""Backward of the port's subm conv vs ``jax.vjp`` of the JAX op at cin
32 and 64, on K1, K2 and the fused K1, at float32 to rtol = atol = 1e-4
(see tests/test_torch_grads.py).
"""

import pytest
import torch

from _torch_threads import two_threads  # noqa: F401
from _torch_grads_common import grid  # noqa: F401
from _torch_grads_common import _compare, _subm_reference, _t, _torch_grads
from doda_tpu_torch.ops import bricks2d as tb2d


@pytest.mark.parametrize('cin,cout,sm_max_cin', [
    (32, 16, 32),      # K2 forward at cin = 32, K2 dx on 16 -> 32
    (64, 32, 32),      # forward on K1, dx (32 -> 64) on K2
    # the fused K1 route (activation + rulebook in), forward and dx; the
    # rule keeps float32 on the 'f32' route, so these cases widen it
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
