"""Shared inputs of tests/test_torch_banded_conv.py and
test_torch_banded_conv_subm.py: two JAX grids, built once a process, and
the masked features.
"""

import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from doda_tpu.ops import bricks as jbricks

TOL = dict(rtol=1e-5, atol=1e-5)
F32 = jnp.float32


@pytest.fixture(scope='module', autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _grid(coords, cap):
    valid = np.ones(len(coords), bool)
    g = jbricks.brickify(jnp.asarray(coords), jnp.asarray(valid), cap)
    return g, jbricks.build_brick_rulebook(g.table)


@functools.lru_cache(maxsize=None)
def _dense_grid():
    rng = np.random.default_rng(3)
    return _grid(rng.integers(0, 24, (4096, 3)).astype(np.int32), 512)


@pytest.fixture(scope='module')
def dense_grid():
    """Built once a process (its tests are split over several
    files)."""
    return _dense_grid()


@functools.lru_cache(maxsize=None)
def _sparse_grid():
    """Isolated voxels plus a crafted corner contact: bricks (1,1,1) and
    (0,0,1) are present, the face x-neighbour (0,1,1) is not, so the
    x-halo plane of (1,1,1) has a cell only a diagonal brick supplies."""
    rng = np.random.default_rng(11)
    coords = rng.integers(0, 96, (1500, 3)).astype(np.int32)
    crafted = np.array([[4, 4, 4], [3, 3, 4], [3, 3, 7], [4, 7, 4]],
                       np.int32)
    return _grid(np.concatenate([coords, crafted]), 2048)


@pytest.fixture(scope='module')
def sparse_grid():
    """Built once a process (its tests are split over several
    files)."""
    return _sparse_grid()


def _feats(rng, g, cin):
    f = rng.normal(size=(g.b_cap, 64, cin)).astype(np.float32)
    return (f * np.asarray(g.occ)[..., None]).reshape(g.b_cap, -1)


def _t(a):
    return torch.from_numpy(np.array(a))
