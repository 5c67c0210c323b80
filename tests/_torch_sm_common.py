"""Shared inputs of the K2 tests of tests/test_torch_sm.py,
test_torch_sm_plain.py, test_torch_sm_engine.py and the rule files: two
JAX grids, built once a process, the masked features and the operands of a
source-major conv.
"""

import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from doda_tpu.ops import bricks as jbricks

TOL = dict(rtol=1e-5, atol=1e-5)
F32 = jnp.float32


def _grid(coords, cap):
    valid = np.ones(len(coords), bool)
    g = jbricks.brickify(jnp.asarray(coords), jnp.asarray(valid), cap)
    return g, jbricks.build_brick_rulebook(g.table)


@functools.lru_cache(maxsize=None)
def _dense_grid():
    rng = np.random.default_rng(3)
    return _grid(rng.integers(0, 24, (4096, 3)).astype(np.int32), 256)


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
    coords = rng.integers(0, 96, (600, 3)).astype(np.int32)
    crafted = np.array([[4, 4, 4], [3, 3, 4], [3, 3, 7], [4, 7, 4]],
                       np.int32)
    return _grid(np.concatenate([coords, crafted]), 640)


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


def _operands(rng, b, cin, cout):
    ops = [rng.normal(size=(b, cells * cin)).astype(np.float32)
           for cells in (64, 96, 40, 40)]
    w = rng.normal(size=(27, cin, cout)).astype(np.float32) * 0.1
    return ops, w
