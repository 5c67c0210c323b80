"""The port's voxel-level sparse engine vs the JAX package's.

``pack_coords`` and ``lookup`` (two int32 keys; queries past the scene, at
-1 and MAX_COORD + 1, and invalid queries), both rulebooks (``lookup`` on a
``unique_coords`` table, the packed lookup on a brick table) and
``build_downsample`` (an out_cap that fits and one that drops parents)
must match integer for integer. ``subm_conv``, ``linear_conv``,
``downsample_conv`` and ``inverse_conv`` at float32 match to 1e-5, and
their gradients (autograd through the gathers on both sides) to 1e-4 of
``jax.vjp`` on the same cotangent.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from _torch_threads import two_threads  # noqa: F401
from doda_tpu.ops import coords as jcoords
from doda_tpu.ops import sparse as jsparse
from doda_tpu_torch.ops import coords as tcoords
from doda_tpu_torch.ops import sparse as tsparse

TOL = dict(rtol=1e-5, atol=1e-5)
GTOL = dict(rtol=1e-4, atol=1e-4)


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _scene(seed=0, n=900, extent=20, cap=512):
    """Random voxel coords with duplicates, 50 invalid rows and a cap
    that holds every voxel; both packages' tables."""
    rng = np.random.default_rng(seed)
    coords = rng.integers(0, extent, (n, 3)).astype(np.int32)
    valid = np.ones(n, bool)
    valid[-50:] = False
    jt = jcoords.unique_coords(jnp.asarray(coords), jnp.asarray(valid), cap)
    tt = tcoords.unique_coords(torch.from_numpy(coords),
                               torch.from_numpy(valid), cap)
    return rng, coords, valid, jt, tt


def test_pack_coords_and_lookup_exact():
    rng, coords, valid, jt, tt = _scene(extent=9)
    _eq(jt.coords, tt.coords)
    _eq(jt.p2v, tt.p2v)
    q = (coords[rng.integers(0, len(coords), (40, 7))]
         + rng.integers(-1, 2, (40, 7, 3))).astype(np.int32)
    q[0, 0] = (jcoords.MAX_COORD + 1, 3, 3)
    q[0, 1] = (3, jcoords.MAX_COORD + 1, 3)
    q[0, 2] = (3, 3, -1)
    q[1] = coords[:7]                       # present voxels
    qv = rng.random((40, 7)) > 0.1
    for a, b in zip(jcoords.pack_coords(jnp.asarray(q), jnp.asarray(qv)),
                    tcoords.pack_coords(torch.from_numpy(q),
                                        torch.from_numpy(qv))):
        _eq(a, b)
    want = np.asarray(jcoords.lookup(jt, jnp.asarray(q), jnp.asarray(qv)))
    got = tcoords.lookup(tt, torch.from_numpy(q), torch.from_numpy(qv))
    assert (want < jt.cap).sum() > 40 and (want == jt.cap).any()
    _eq(want, got)
    _eq(jcoords.lookup(jt, jnp.asarray(q)),
        tcoords.lookup(tt, torch.from_numpy(q)))


@pytest.mark.parametrize('packed', [False, True])
def test_rulebooks_exact(packed):
    _, coords, valid, jt, tt = _scene(seed=1, extent=14)
    if packed:                  # a brick table: one packed key
        jt = jcoords.unique_coords_packed(jnp.asarray(coords),
                                          jnp.asarray(valid), 512)
        tt = tcoords.unique_coords_packed(torch.from_numpy(coords),
                                          torch.from_numpy(valid), 512)
    want = np.asarray(jsparse.build_subm_rulebook(jt, 3, packed=packed))
    got = tsparse.build_subm_rulebook(tt, 3, packed=packed)
    assert got.dtype == torch.int32
    assert (want == jt.cap).any() and (want[:, 0] < jt.cap).any()
    _eq(want, got)


@pytest.mark.parametrize('out_cap', [256, 40])
def test_build_downsample_exact(out_cap):
    _, _, _, jt, tt = _scene(seed=2)
    jd = jsparse.build_downsample(jt, out_cap)
    td = tsparse.build_downsample(tt, out_cap)
    if out_cap == 40:
        assert int(jd.parent.n) == 40        # parents really drop
    for name in ('coords', 'n', 'p2v'):
        _eq(getattr(jd.parent, name), getattr(td.parent, name))
    for name in ('child_parent', 'child_offset', 'parent_children'):
        _eq(getattr(jd, name), getattr(td, name))


def _vjp_jax(fn, args, cot):
    """fn's output and its VJP of ``cot``, traced once (jitted)."""
    def run(args, cot):
        out, vjp = jax.vjp(fn, *args)
        return out, vjp(cot)

    out, grads = jax.jit(run)(tuple(jnp.asarray(a) for a in args),
                              jnp.asarray(cot))
    return [np.asarray(out)] + [np.asarray(g) for g in grads]


def _vjp_port(fn, args, cot):
    ts = [torch.from_numpy(a).requires_grad_(True) for a in args]
    out = fn(*ts)
    out.backward(torch.from_numpy(cot))
    return [out.detach().numpy()] + [t.grad.numpy() for t in ts]


def _check(got, want):
    assert np.abs(want[0]).max() > 1e-2
    np.testing.assert_allclose(got[0], want[0], **TOL)
    for g, w in zip(got[1:], want[1:]):
        assert np.abs(w).max() > 1e-2
        np.testing.assert_allclose(g, w, **GTOL)


def test_convs_and_grads_match_jax():
    rng, _, _, jt, tt = _scene(seed=3, extent=12)
    cap, n = jt.cap, int(jt.n)
    feats = rng.normal(size=(cap, 6)).astype(np.float32)
    feats[n:] = 0
    jrb = jsparse.build_subm_rulebook(jt, 3)
    trb = tsparse.build_subm_rulebook(tt, 3)
    w = (rng.normal(size=(27, 6, 5)) * 0.2).astype(np.float32)
    cot = rng.normal(size=(cap, 5)).astype(np.float32)
    _check(_vjp_port(lambda f, w: tsparse.subm_conv(f, trb, w),
                     (feats, w), cot),
           _vjp_jax(lambda f, w: jsparse.subm_conv(f, jrb, w), (feats, w),
                    cot))
    w1 = rng.normal(size=(6, 4)).astype(np.float32)
    cot1 = rng.normal(size=(cap, 4)).astype(np.float32)
    _check(_vjp_port(tsparse.linear_conv, (feats, w1), cot1),
           _vjp_jax(jsparse.linear_conv, (feats, w1), cot1))

    jd, td = jsparse.build_downsample(jt, 256), tsparse.build_downsample(
        tt, 256)
    w8 = (rng.normal(size=(8, 6, 7)) * 0.3).astype(np.float32)
    cot8 = rng.normal(size=(256, 7)).astype(np.float32)
    _check(_vjp_port(lambda f, w: tsparse.downsample_conv(f, td, w),
                     (feats, w8), cot8),
           _vjp_jax(lambda f, w: jsparse.downsample_conv(f, jd, w),
                    (feats, w8), cot8))
    pf = rng.normal(size=(256, 7)).astype(np.float32)
    pf[int(jd.parent.n):] = 0
    wi = (rng.normal(size=(8, 7, 3)) * 0.3).astype(np.float32)
    coti = rng.normal(size=(cap, 3)).astype(np.float32)
    _check(_vjp_port(lambda p, w: tsparse.inverse_conv(p, td, w),
                     (pf, wi), coti),
           _vjp_jax(lambda p, w: jsparse.inverse_conv(p, jd, w),
                    (pf, wi), coti))
