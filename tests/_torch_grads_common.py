"""Shared inputs of the backward tests (tests/test_torch_grads*.py): one JAX
grid, built once a process, its downsample maps, and the JAX subm conv's
gradients by (cin, cout), computed once a process.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from doda_tpu.models.unet import FlatDown as JFlatDown
from doda_tpu.ops import bricks as jbricks
from doda_tpu.ops import bricks2d as jb2d
from doda_tpu_torch.models.unet import FlatDown

TOL = dict(rtol=1e-4, atol=1e-4)
F32 = jnp.float32


@functools.lru_cache(maxsize=None)
def _grid():
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


@pytest.fixture(scope='module')
def grid():
    """Built once a process (its tests are split over several
    files)."""
    return _grid()


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


@pytest.fixture(scope='module')
def down(grid):
    g, _ = grid
    ds = jbricks.build_brick_downsample(g.table, g.occ, 128)
    jmaps = JFlatDown(child_parent=ds.child_parent, parity=ds.parity,
                      parent_children=ds.parent_children)
    return ds, jmaps, FlatDown(*(_t(a) for a in jmaps))
