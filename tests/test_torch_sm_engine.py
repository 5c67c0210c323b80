"""K2's engine in ``subm_conv3_2d`` (``sm_max_cin=32``) against K1's
and, for two of the cases, the JAX 2D conv and the shell oracle, at
float32 with rtol = atol = 1e-5 (K1's engine is held to both for the
other shapes in tests/test_torch_banded_conv_subm.py).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from _torch_threads import two_threads  # noqa: F401
from _torch_sm_common import dense_grid, sparse_grid  # noqa: F401
from _torch_sm_common import _feats, _t, F32, TOL
from doda_tpu.ops import bricks as jbricks
from doda_tpu.ops import bricks2d as jb2d
from doda_tpu_torch.ops import bricks2d as tb2d


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
