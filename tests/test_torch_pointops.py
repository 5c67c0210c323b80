"""The port's point ops (``doda_tpu_torch/ops/pointops.py``) vs the JAX
package's, on the cases of tests/test_pointops.py.

The same numpy inputs go through both. Integer outputs (kNN and ball-query
ids, FPS picks, cluster labels, counts) must be equal; float outputs agree
to rtol = atol = 1e-5.
"""

import numpy as np
import jax.numpy as jnp
import torch

from _torch_threads import two_threads  # noqa: F401
from doda_tpu.ops import pointops as jpo
from doda_tpu_torch.ops import pointops as tpo

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


def test_knn_matches_jax(rng):
    base = rng.normal(size=(300, 3)).astype(np.float32)
    q = rng.normal(size=(50, 3)).astype(np.float32)
    qv = np.arange(50) % 7 != 3
    for kw_j, kw_t in (({}, {}),
                       ({'query_valid': jnp.asarray(qv)},
                        {'query_valid': _t(qv)})):
        ji, jd = jpo.knn(5, jnp.asarray(q), jnp.asarray(base), chunk=16,
                         **kw_j)
        ti, td = tpo.knn(5, _t(q), _t(base), chunk=16, **kw_t)
        assert ti.dtype == torch.int32
        _eq(ti, ji)
        _close(td, jd)
    # validity: only the first 10 base points count
    valid = np.arange(100) < 10
    base = base[:100]
    ji, jd = jpo.knn(3, jnp.asarray(base[:5]), jnp.asarray(base),
                     base_valid=jnp.asarray(valid), chunk=8)
    ti, td = tpo.knn(3, _t(base[:5]), _t(base), base_valid=_t(valid),
                     chunk=8)
    _eq(ti, ji)
    _close(td, jd)
    assert ti.max() < 10


def test_furthest_point_sampling_matches_jax(rng):
    a = rng.normal(size=(100, 3)).astype(np.float32)
    xyz = np.concatenate([a, a + 100.0])
    valid = np.arange(200) % 5 != 0
    _eq(tpo.furthest_point_sampling(_t(xyz), 10),
        jpo.furthest_point_sampling(jnp.asarray(xyz), 10))
    got = tpo.furthest_point_sampling(_t(xyz), 17, _t(valid))
    _eq(got, jpo.furthest_point_sampling(jnp.asarray(xyz), 17,
                                         jnp.asarray(valid)))
    assert got.dtype == torch.int32 and valid[got.numpy()[1:]].all()


def test_ballquery_and_bfs_cluster_match_jax(rng):
    xyz = rng.uniform(0, 4, (200, 3)).astype(np.float32)
    ji, jc = jpo.ballquery(jnp.asarray(xyz), 1.2, 16, chunk=32)
    ti, tc = tpo.ballquery(_t(xyz), 1.2, 16, chunk=32)
    _eq(ti, ji)
    _eq(tc, jc)
    assert (ti == -1).any() and (tc == 16).any()

    blob = lambda c: rng.normal(size=(40, 3)).astype(np.float32) * 0.1 + c
    xyz = np.concatenate([blob(0.0), blob(5.0), blob(10.0)])
    sem = np.concatenate([np.zeros(40), np.zeros(40),
                          np.ones(40)]).astype(np.int32)
    valid = np.arange(120) != 7
    ji, _ = jpo.ballquery(jnp.asarray(xyz), 1.0, 32, chunk=32)
    ti, _ = tpo.ballquery(_t(xyz), 1.0, 32, chunk=32)
    _eq(ti, ji)
    want = jpo.bfs_cluster(ji, jnp.asarray(sem), jnp.asarray(valid))
    got = tpo.bfs_cluster(ti, _t(sem), _t(valid))
    _eq(got, want)
    assert len(np.unique(got.numpy())) == 4      # three blobs and the -1


def test_interpolation_grouping_subtraction_aggregation_match_jax(rng):
    src = rng.normal(size=(50, 3)).astype(np.float32)
    dst = src + rng.normal(scale=0.05, size=src.shape).astype(np.float32)
    feats = rng.normal(size=(50, 4)).astype(np.float32)
    valid = np.arange(50) < 45
    _close(tpo.interpolation(_t(src), _t(dst), _t(feats),
                             src_valid=_t(valid)),
           jpo.interpolation(jnp.asarray(src), jnp.asarray(dst),
                             jnp.asarray(feats),
                             src_valid=jnp.asarray(valid)))

    f1 = rng.normal(size=(10, 6)).astype(np.float32)
    f2 = rng.normal(size=(10, 6)).astype(np.float32)
    idx = rng.integers(0, 10, (10, 4)).astype(np.int32)
    pos = rng.normal(size=(10, 4, 6)).astype(np.float32)
    w = rng.normal(size=(10, 4, 3)).astype(np.float32)
    _eq(tpo.grouping(_t(f1), _t(idx)),
        jpo.grouping(jnp.asarray(f1), jnp.asarray(idx)))
    _close(tpo.subtraction(_t(f1), _t(f2), _t(idx)),
           jpo.subtraction(jnp.asarray(f1), jnp.asarray(f2),
                           jnp.asarray(idx)))
    _close(tpo.aggregation(_t(f1), _t(pos), _t(w), _t(idx)),
           jpo.aggregation(jnp.asarray(f1), jnp.asarray(pos),
                           jnp.asarray(w), jnp.asarray(idx)))


def test_segment_reductions_roipool_and_iou_match_jax(rng):
    feats = rng.normal(size=(20, 3)).astype(np.float32)
    offsets = np.array([0, 5, 5, 12, 20], np.int32)     # one empty segment
    for name in ('sec_mean', 'sec_min', 'sec_max'):
        got = getattr(tpo, name)(_t(feats), _t(offsets))
        want = getattr(jpo, name)(jnp.asarray(feats), jnp.asarray(offsets))
        if name == 'sec_mean':
            _close(got, want)
        else:        # the empty segment: +-inf in the JAX package too
            _eq(got, want)

    feats = rng.normal(size=(30, 4)).astype(np.float32)
    pids = np.array([0] * 10 + [2] * 10 + [-1] * 10, np.int32)  # 1 empty
    _close(tpo.roipool(_t(feats), _t(pids), 3),
           jpo.roipool(jnp.asarray(feats), jnp.asarray(pids), 3))
    inst = np.array([0] * 10 + [1] * 5 + [0] * 5 + [-1] * 10, np.int32)
    _close(tpo.get_iou(_t(pids), _t(inst), 3, 2),
           jpo.get_iou(jnp.asarray(pids), jnp.asarray(inst), 3, 2))


def test_roipool_gradient_reaches_the_maximal_rows(rng):
    import jax
    feats = rng.normal(size=(30, 4)).astype(np.float32)
    pids = np.array([0] * 10 + [1] * 10 + [-1] * 10, np.int32)
    want = jax.grad(lambda f: (jpo.roipool(f, jnp.asarray(pids), 2)
                               * jnp.arange(8.0).reshape(2, 4)).sum())(
        jnp.asarray(feats))
    tf = _t(feats).requires_grad_(True)
    (tpo.roipool(tf, _t(pids), 2) * torch.arange(8.0).reshape(2, 4)
     ).sum().backward()
    _close(tf.grad, want)
    assert (tf.grad[20:] == 0).all()
