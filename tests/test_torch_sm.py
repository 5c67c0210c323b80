"""K2's operands in the PyTorch port vs the JAX package: ``sm_weights``
and ``_assemble_sm`` bit for bit (placement only), and the wrapper on
row-strided operands. The JAX functions are called directly; no
``DODA_SM*`` variable is set.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from _torch_threads import two_threads  # noqa: F401
from _torch_sm_common import dense_grid, sparse_grid  # noqa: F401
from _torch_sm_common import _feats, _operands, _t, F32
from doda_tpu.ops import bricks2d as jb2d
from doda_tpu_torch.ops import bricks2d as tb2d
from doda_tpu_torch.ops.banded_conv_sm import (banded_conv_sm,
                                               banded_conv_sm_plain)


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
