"""K1's fused version (``banded_conv_fused``) of the PyTorch port, on the
CPU, where the wrapper runs its plain version; the CUDA kernel itself is
held against it on the card by ``chip_smoke.py``. Here the wrapper equals
``_assemble_p6`` + ``banded_weights`` + ``banded_conv_plain`` bit for bit,
and the JAX package's ``subm_conv3_2d`` to rtol = atol = 1e-5 at float32
(sums in another order), on the cases of
tests/test_torch_banded_conv_subm.py; and the bf16 route of
``subm_conv3_2d`` equals that plain arithmetic, forward and dx.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from _torch_threads import two_threads  # noqa: F401
from _torch_fused_common import dense_grid, sparse_grid  # noqa: F401
from _torch_fused_common import _feats, _t, F32, TOL
from doda_tpu.ops import bricks2d as jb2d
from doda_tpu_torch.ops import bricks2d as tb2d
from doda_tpu_torch.ops.banded_conv import (banded_conv_fused,
                                            banded_conv_fused_plain,
                                            banded_conv_plain)


@pytest.mark.parametrize('grid_name,cin,cout', [
    ('dense_grid', 16, 16), ('dense_grid', 3, 16), ('dense_grid', 32, 16),
    ('sparse_grid', 16, 16), ('sparse_grid', 4, 8)])
def test_fused_equals_assembled_and_jax(request, grid_name, cin, cout):
    g, nbr = request.getfixturevalue(grid_name)
    rng = np.random.default_rng(cin * 100 + cout)
    x2, tn = _t(_feats(rng, g, cin)), _t(nbr)
    w = _t(rng.normal(size=(27, cin, cout)).astype(np.float32) * 0.1)
    got = banded_conv_fused(x2, tn, w, torch.float32)
    assert got.dtype == torch.float32 and got.shape == (g.b_cap, 64 * cout)
    rows6 = tb2d._assemble_p6(x2, tb2d.halo_index(tn), torch.float32)
    want = banded_conv_plain(rows6, tb2d.banded_weights(w), torch.float32)
    assert torch.equal(got, want)
    assert torch.equal(got, banded_conv_fused_plain(x2, tn, w,
                                                    torch.float32))
    assert banded_conv_fused.launches == 0   # the CPU never reaches a kernel
    want_jax = np.asarray(jb2d.subm_conv3_2d(
        jnp.asarray(x2.numpy()), g.occ, jnp.asarray(nbr),
        jnp.asarray(w.numpy()), compute_dtype=F32))
    np.testing.assert_allclose(
        tb2d._mask(got, _t(g.occ), cout).numpy(), want_jax, **TOL)


def test_fused_bf16_route_equals_assembled_route(sparse_grid):
    """In bf16 ``subm_conv3_2d`` takes the fused route; on the CPU it is
    the arithmetic of K1's band (``banded_conv_plain``) on ``_assemble_p6``'s
    planes, bit for bit, forward and dx."""
    g, nbr = sparse_grid
    rng = np.random.default_rng(4)
    bf = torch.bfloat16
    x2, tn, occ = _t(_feats(rng, g, 16)).to(bf), _t(nbr), _t(g.occ)
    w = _t(rng.normal(size=(27, 16, 8)).astype(np.float32) * 0.1)
    halo = tb2d.halo_index(tn)
    assert tb2d.subm_route(16, 8, bf, 0) == 'fused'
    outs = []
    for route_nbr in (tn, None):
        xl, wl = x2.clone().requires_grad_(True), w.clone().requires_grad_(True)
        if route_nbr is None:      # the band on the planes of halo
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(tb2d, 'banded_conv_fused', lambda x, n, wr, dt, pro:
                           banded_conv_plain(tb2d._assemble_p6(x, halo, bf),
                                             tb2d.banded_weights(wr), dt))
                out = tb2d.subm_conv3_2d(xl, occ, halo, wl, bf, nbr=tn)
                out.float().sum().backward()
        else:
            out = tb2d.subm_conv3_2d(xl, occ, halo, wl, bf, nbr=route_nbr)
            out.float().sum().backward()
        outs.append((out.detach(), xl.grad, wl.grad))
    for a, b in zip(*outs):
        assert torch.equal(a, b)
