"""The port's voxelization (``doda_tpu_torch/ops/voxelize.py``) and the
voxel-hash wrappers of its host library vs the JAX package's, on the cases
of tests/test_voxelize.py and tests/test_native.py.

Voxel tables (coords, point -> voxel map, count) must be equal; features
agree to rtol = atol = 1e-5. The host wrappers run on the port's own build
of ``host_ops.cc`` and on their numpy paths, against the JAX package's
wrappers.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from doda_tpu.native import host_ops as jhost
from doda_tpu.ops import voxelize as jvox
from doda_tpu_torch.native import host_ops as thost
from doda_tpu_torch.ops import voxelize as tvox

TOL = dict(rtol=1e-5, atol=1e-5)


def _setup(rng, n=120, n_valid=100, extent=5, c=4):
    coords = rng.integers(0, extent, size=(n, 3)).astype(np.int32)
    feats = rng.normal(size=(n, c)).astype(np.float32)
    return coords, feats, np.arange(n) < n_valid


def _grids(coords, valid, cap):
    return (jvox.voxelize_coords(jnp.asarray(coords), jnp.asarray(valid),
                                 cap),
            tvox.voxelize_coords(torch.from_numpy(coords),
                                 torch.from_numpy(valid), cap))


@pytest.mark.parametrize('cap', [256, 40])      # 40 < voxels: overflow
def test_voxel_grid_and_modes_match_jax(rng, cap):
    coords, feats, valid = _setup(rng)
    coords[:3] = [[32767, 0, 5], [0, 32767, 0], [1, 2, 32767]]  # MAX_COORD
    jg, tg = _grids(coords, valid, cap)
    for name in ('coords', 'p2v', 'num_voxels', 'valid'):
        np.testing.assert_array_equal(getattr(tg, name).numpy(),
                                      np.asarray(getattr(jg, name)), name)
    assert (tg.p2v[:100] == cap).any() == (cap == 40)   # valid points
    for mode in (1, 2, 3, 4):
        np.testing.assert_allclose(
            tvox.voxelize_feats(torch.from_numpy(feats), tg, mode).numpy(),
            np.asarray(jvox.voxelize_feats(jnp.asarray(feats), jg, mode)),
            err_msg=f'mode {mode}', **TOL)
    with pytest.raises(NotImplementedError):
        tvox.voxelize_feats(torch.from_numpy(feats), tg, 5)


def test_devoxelize_and_gradient_match_jax(rng):
    coords, feats, valid = _setup(rng)
    jg, tg = _grids(coords, valid, 256)
    cot = rng.normal(size=feats.shape).astype(np.float32)

    def jloss(f):
        return (jvox.devoxelize_feats(jvox.voxelize_feats(f, jg, 4), jg)
                * cot).sum()

    tf = torch.from_numpy(feats).requires_grad_(True)
    out = tvox.devoxelize_feats(tvox.voxelize_feats(tf, tg, 4), tg)
    np.testing.assert_allclose(
        out.detach().numpy(),
        np.asarray(jvox.devoxelize_feats(
            jvox.voxelize_feats(jnp.asarray(feats), jg, 4), jg)), **TOL)
    (out * torch.from_numpy(cot)).sum().backward()
    want = np.asarray(jax.grad(jloss)(jnp.asarray(feats)))
    np.testing.assert_allclose(tf.grad.numpy(), want, **TOL)
    assert np.abs(want[100:]).max() == 0 and np.abs(want[:100]).sum() > 0


def test_host_voxelize_unique_and_mean_match_jax(rng):
    assert thost.native_available()
    coords = rng.integers(0, 5, (500, 3)).astype(np.int32)
    feats = rng.normal(size=(500, 4)).astype(np.float32)
    jp2v, jvox_ = jhost.voxelize_unique(coords)
    for native in (True, False):
        p2v, vox = thost.voxelize_unique(coords, native=native)
        np.testing.assert_array_equal(p2v.reshape(-1), np.reshape(jp2v, -1))
        np.testing.assert_array_equal(vox, jvox_)
        np.testing.assert_array_equal(vox[p2v.reshape(-1)], coords)
        np.testing.assert_allclose(
            thost.voxelize_mean(feats, p2v, len(vox), native=native),
            jhost.voxelize_mean(feats, jp2v, len(jvox_)), **TOL)
