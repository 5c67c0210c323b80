"""The port's offset-convention point ops
(``doda_tpu_torch/ops/pointops_offsets.py``) vs the JAX package's, on the
cases of tests/test_pointops_offsets.py: two scenes far apart, offsets in
both conventions, a segment shorter than the neighbour count. Indices
(global into the flat arrays) must be equal; floats agree to
rtol = atol = 1e-5. The port runs with ``device='cpu'``.
"""

import numpy as np
import pytest
import torch

import doda_tpu.ops.pointops_offsets as jpof
from doda_tpu_torch.ops import pointops_offsets as tpof

TOL = dict(rtol=1e-5, atol=1e-5)
CPU = dict(device='cpu')


@pytest.fixture
def rng():
    return np.random.default_rng(11)


def _two_scenes(rng, n1=40, n2=25):
    xyz = rng.normal(size=(n1 + n2, 3)).astype(np.float32)
    xyz[n1:] += 50.0
    return xyz, np.array([n1, n1 + n2]), np.array([0, n1, n1 + n2])


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


def test_knnquery_matches_jax(rng):
    xyz, legacy, lead0 = _two_scenes(rng)
    q = xyz + rng.normal(scale=0.1, size=xyz.shape).astype(np.float32)
    for off in (legacy, lead0):
        for new_xyz in (None, q):
            ji, jd = jpof.knnquery(4, xyz, new_xyz, off, off)
            ti, td = tpof.knnquery(4, xyz, new_xyz, off, off, **CPU)
            assert ti.dtype == torch.int32 and td.dtype == torch.float32
            _eq(ti, ji)
            _close(td, jd)
    # a scene shorter than nsample repeats its nearest neighbour
    xyz, _, _ = _two_scenes(rng, n1=3, n2=10)
    off = np.array([3, 13])
    ji, jd = jpof.knnquery(8, xyz, None, off, off)
    ti, td = tpof.knnquery(8, xyz, None, off, off, **CPU)
    _eq(ti, ji)
    _close(td, jd)
    assert (ti[:3] < 3).all()


def test_furthestsampling_matches_jax(rng):
    xyz, legacy, lead0 = _two_scenes(rng)
    for off, new in ((legacy, np.array([5, 10])),
                     (lead0, np.array([0, 7, 19]))):
        got = tpof.furthestsampling(xyz, off, new, **CPU)
        _eq(got, jpof.furthestsampling(xyz, off, new))
        assert got.dtype == torch.int32


def test_queryandgroup_matches_jax(rng):
    xyz, legacy, _ = _two_scenes(rng)
    feat = rng.normal(size=(65, 6)).astype(np.float32)
    q = xyz[::2] + 0.01
    new_off = np.array([20, 33])
    for kw in ({}, {'use_xyz': False}, {'relative': False}):
        _close(tpof.queryandgroup(4, xyz, None, feat, None, legacy, legacy,
                                  **kw, **CPU),
               jpof.queryandgroup(4, xyz, None, feat, None, legacy, legacy,
                                  **kw))
    got_f, got_x = tpof.queryandgroup(4, xyz, q, feat, None, legacy,
                                      new_off, return_grouped_xyz=True,
                                      **CPU)
    want_f, want_x = jpof.queryandgroup(4, xyz, q, feat, None, legacy,
                                        new_off, return_grouped_xyz=True)
    _close(got_f, want_f)
    _close(got_x, want_x)
    idx = np.random.default_rng(1).integers(0, 65, (65, 3))
    _close(tpof.queryandgroup(3, xyz, None, feat, idx, legacy, legacy,
                              **CPU),
           jpof.queryandgroup(3, xyz, None, feat, idx, legacy, legacy))
    _eq(tpof.grouping(feat, idx, **CPU), jpof.grouping(feat, idx))


def test_interpolation_and_reexports_match_jax(rng):
    xyz, legacy, lead0 = _two_scenes(rng)
    feat = rng.normal(size=(65, 4)).astype(np.float32)
    q = xyz + rng.normal(scale=0.05, size=xyz.shape).astype(np.float32)
    for off in (legacy, lead0):
        _close(tpof.interpolation(xyz, q, feat, off, off, k=3, **CPU),
               jpof.interpolation(xyz, q, feat, off, off, k=3))
    assert tpof.interpolation2 is tpof.interpolation
    idx = rng.integers(0, 10, (10, 3))
    f = torch.from_numpy(feat[:10])
    _close(tpof.subtraction(f, f, torch.from_numpy(idx)),
           jpof.subtraction(feat[:10], feat[:10], idx))
    assert set(tpof.__all__) == set(jpof.__all__)
