"""The 'sm' route of ``_subm_raw`` calls K2's second version with raster
weights and never ``sm_weights``, in bf16 and in float32, at every cin
(the first version's kernel, on ``sm_weights``, is deleted).
"""

import numpy as np
import pytest
import torch

from _torch_threads import two_threads  # noqa: F401
from _torch_sm_taps_common import sparse_grid  # noqa: F401
from _torch_sm_taps_common import _t
from doda_tpu_torch.ops import bricks2d as tb2d
from doda_tpu_torch.ops.banded_conv_sm import banded_conv_sm_plain


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
        tb2d._subm_raw(x2, sm, torch.zeros(27, cin, 16),
                       torch.bfloat16, 128)
    assert calls == ['taps', 'taps']
