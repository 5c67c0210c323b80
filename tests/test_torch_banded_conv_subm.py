"""The port's ``subm_conv3_2d`` (K1's routes, float32) vs the JAX
package's ``subm_conv3_2d`` and the ``bricks.subm_conv3`` oracle, at
float32 with the tolerance of tests/test_bricks2d.py (1e-5).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from _torch_threads import two_threads  # noqa: F401
from _torch_banded_conv_common import (  # noqa: F401
    _no_tf32, dense_grid, sparse_grid)
from _torch_banded_conv_common import _feats, _t, F32, TOL
from doda_tpu.ops import bricks as jbricks
from doda_tpu.ops import bricks2d as jb2d
from doda_tpu_torch.ops import bricks2d as tb2d


@pytest.mark.parametrize('grid_name,cin,cout', [
    ('dense_grid', 16, 16), ('dense_grid', 3, 16), ('dense_grid', 32, 16),
    ('sparse_grid', 16, 16), ('sparse_grid', 4, 8)])
def test_subm_conv3_2d(request, grid_name, cin, cout):
    g, nbr = request.getfixturevalue(grid_name)
    rng = np.random.default_rng(cin * 100 + cout)
    x2 = _feats(rng, g, cin)
    w = rng.normal(size=(27, cin, cout)).astype(np.float32) * 0.1
    want_2d = np.asarray(jb2d.subm_conv3_2d(
        jnp.asarray(x2), g.occ, nbr, jnp.asarray(w), compute_dtype=F32))
    want_oracle = np.asarray(jbricks.subm_conv3(
        jnp.asarray(x2.reshape(g.b_cap, 64, cin)), g.occ, nbr,
        jnp.asarray(w), compute_dtype=F32)).reshape(g.b_cap, -1)
    got = tb2d.subm_conv3_2d(_t(x2), _t(g.occ), tb2d.halo_index(_t(nbr)),
                             _t(w), torch.float32, nbr=_t(nbr)).numpy()
    np.testing.assert_allclose(got, want_2d, **TOL)
    np.testing.assert_allclose(got, want_oracle, **TOL)
