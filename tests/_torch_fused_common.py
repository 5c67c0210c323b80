"""Shared inputs of the fused K1's tests (tests/test_torch_fused*.py): three
JAX grids, built once a process, the masked features and the flagship's
cfg.
"""

import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from doda_tpu.ops import bricks as jbricks
from doda_tpu_torch.config import CfgNode, cfg_from_yaml_file

TOL = dict(rtol=1e-5, atol=1e-5)
F32 = jnp.float32


def _grid(coords, cap):
    valid = np.ones(len(coords), bool)
    g = jbricks.brickify(jnp.asarray(coords), jnp.asarray(valid), cap)
    return g, np.asarray(jbricks.build_brick_rulebook(g.table))


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
    """Isolated voxels plus the corner contact whose x-halo cell only a
    diagonal brick supplies (see tests/test_torch_banded_conv.py)."""
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


@functools.lru_cache(maxsize=None)
def _overflowed_grid():
    """More bricks than capacity: the surplus falls into the null slot."""
    rng = np.random.default_rng(5)
    coords = rng.integers(0, 64, (3000, 3)).astype(np.int32)
    g, nbr = _grid(coords, 256)
    assert int(g.table.n) == 256 and (nbr == 256).any()
    return g, nbr


@pytest.fixture(scope='module')
def overflowed_grid():
    """Built once a process (its tests are split over several
    files)."""
    return _overflowed_grid()


def _feats(rng, g, cin):
    f = rng.normal(size=(g.b_cap, 64, cin)).astype(np.float32)
    return (f * np.asarray(g.occ)[..., None]).reshape(g.b_cap, -1)


def _t(a):
    return torch.from_numpy(np.array(a))


# --- numpy mirror of csrc/banded_conv_fused.cu's address arithmetic --------

def _halo_dir(h):
    return 0 if h == 0 else (2 if h == 5 else 1)


def _halo_pos(h):
    return (h + 3) & 3


def _kernel_halo_source(nbr, rows):
    """(rows, 216) flat source cell of every halo cell as ``issue_halo``
    derives it; absent or out-of-range neighbours -> rows*64."""
    flat = np.empty((rows, 216), np.int64)
    for hc in range(216):
        hx, r2 = divmod(hc, 36)
        hy, hz = divmod(r2, 6)
        col = _halo_dir(hx) * 9 + _halo_dir(hy) * 3 + _halo_dir(hz)
        cell = _halo_pos(hx) * 16 + _halo_pos(hy) * 4 + _halo_pos(hz)
        src = nbr[:, col].astype(np.int64)
        ok = (src >= 0) & (src < rows)
        flat[:, hc] = np.where(ok, src * 64 + cell, rows * 64)
    return flat


# --- the routing rule -------------------------------------------------------

@pytest.fixture(scope='module')
def flagship_cfg():
    return cfg_from_yaml_file('cfgs/scannet/spconv.yaml', CfgNode())
