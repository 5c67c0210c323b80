"""The port's slab engine (slice-compacted window conv) vs the JAX package's.

``build_slab_maps`` and ``flatten_slab`` integer for integer on two scenes
flattened together, at a slice capacity that fits and at one that
overflows (the extra slices fall into the null row); the static layouts
and ``window_weights`` exactly; ``subm_conv3_slab`` forward to 1e-5 at
several (cin, cout), and its dx and dW to 1e-4 of the JAX package's own
custom VJP on the same masked input and cotangent (not of the dense
transpose: dx is zero at unoccupied slices by design).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from doda_tpu.ops import bricks as jbricks
from doda_tpu.ops import slabs as jslabs
from doda_tpu_torch.ops import bricks as tbricks
from doda_tpu_torch.ops import slabs as tslabs

TOL = dict(rtol=1e-5, atol=1e-5)
GTOL = dict(rtol=1e-4, atol=1e-4)
B_CAP = 256


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _scenes(s_cap):
    """Two scenes (a sparse one whose slices leave real gaps), each
    package's maps, flattened; the JAX side's occ and flat rulebook."""
    rng = np.random.default_rng(5)
    jmaps, tmaps, occs, nbrs = [], [], [], []
    for extent, n in ((24, 900), (64, 500)):
        c = rng.integers(0, extent, (n, 3)).astype(np.int32)
        v = np.ones(n, bool)
        jg = jbricks.brickify(jnp.asarray(c), jnp.asarray(v), B_CAP)
        nbr = jbricks.build_brick_rulebook(jg.table)
        tg = tbricks.brickify(torch.from_numpy(c), torch.from_numpy(v),
                              B_CAP)
        jmaps.append(jslabs.build_slab_maps(jg.occ, nbr, s_cap))
        tmaps.append(tslabs.build_slab_maps(
            tg.occ, tbricks.build_brick_rulebook(tg.table), s_cap))
        occs.append(np.asarray(jg.occ))
        nbrs.append(np.where(np.asarray(nbr) < B_CAP,
                             np.asarray(nbr) + len(nbrs) * B_CAP,
                             2 * B_CAP))
    jb = jax.tree.map(lambda *a: jnp.stack(a), *jmaps)
    tb = tslabs.SlabMaps(*(torch.stack(a) for a in zip(*tmaps)))
    return (jmaps, tmaps, jslabs.flatten_slab(jb, s_cap, B_CAP),
            tslabs.flatten_slab(tb, s_cap, B_CAP), np.concatenate(occs),
            np.concatenate(nbrs))


@pytest.mark.parametrize('s_cap', [1024, 96])
def test_slab_maps_exact(s_cap):
    jmaps, tmaps, jflat, tflat, occ, _ = _scenes(s_cap)
    n_occ = [int(m.occ_cells.any(-1).sum()) for m in jmaps]
    if s_cap == 96:
        assert max(n_occ) == 96      # slices overflow into the null row
        s_occ = occ.reshape(-1, 16).any(-1)
        assert (s_occ & (np.asarray(jflat.slice2row) == 2 * 96)).any()
    else:
        assert max(n_occ) < s_cap
    for j, t in zip(jmaps + [jflat], tmaps + [tflat]):
        for name, a, b in zip(j._fields, j, t):
            assert b.dtype == (torch.bool if name == 'occ_cells'
                               else torch.int32), name
            _eq(a, b)


def test_layouts_and_window_weights_exact():
    assert tslabs._tab_layout() == jslabs._tab_layout()
    assert tslabs._window_layout() == jslabs._window_layout()
    _eq(jslabs._window_np(), tslabs._window_np())
    w = np.random.default_rng(1).normal(size=(27, 3, 5)).astype(np.float32)
    _eq(jslabs.window_weights(jnp.asarray(w)),
        tslabs.window_weights(torch.from_numpy(w)))


@pytest.fixture(scope='module')
def flat():
    _, _, jflat, tflat, occ, nbr = _scenes(1024)
    return jflat, tflat, occ, nbr


def _x(rng, occ, cin):
    f = rng.normal(size=occ.shape + (cin,)).astype(np.float32)
    return (f * occ[..., None]).reshape(len(occ), -1)


def test_slab_conv_matches_jax(flat):
    jflat, tflat, occ, nbr = flat
    rng = np.random.default_rng(2)
    for cin, cout in ((16, 16), (3, 16), (8, 12), (4, 8)):
        x = _x(rng, occ, cin)
        w = (rng.normal(size=(27, cin, cout)) * 0.1).astype(np.float32)
        want = np.asarray(jax.jit(lambda x, w: jslabs.subm_conv3_slab(
            x, jflat, w, jnp.float32))(x, w))
        got = tslabs.subm_conv3_slab(torch.from_numpy(x), tflat,
                                     torch.from_numpy(w), torch.float32)
        assert np.abs(want).max() > 1e-2
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    # and the oracle, on the same flat rulebook
    oracle = tbricks.subm_conv3(torch.from_numpy(x).reshape(len(occ), 64,
                                                             cin),
                                torch.from_numpy(occ), torch.from_numpy(nbr),
                                torch.from_numpy(w), torch.float32)
    np.testing.assert_allclose(got.numpy(), oracle.reshape(len(occ),
                                                           -1).numpy(), **TOL)


def test_slab_conv_vjp_matches_jax_custom_vjp(flat):
    jflat, tflat, occ, _ = flat
    rng = np.random.default_rng(3)
    cin, cout = 8, 12
    x = _x(rng, occ, cin)
    w = (rng.normal(size=(27, cin, cout)) * 0.1).astype(np.float32)
    cot = rng.normal(size=(len(occ), 64 * cout)).astype(np.float32)

    def run(x, w, cot):
        _, vjp = jax.vjp(lambda x, w: jslabs.subm_conv3_slab(
            x, jflat, w, jnp.float32), x, w)
        return vjp(cot)

    jdx, jdw = (np.asarray(a) for a in jax.jit(run)(x, w, cot))
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    tslabs.subm_conv3_slab(xt, tflat, wt, torch.float32).backward(
        torch.from_numpy(cot))
    np.testing.assert_allclose(xt.grad.numpy(), jdx, **GTOL)
    np.testing.assert_allclose(wt.grad.numpy(), jdw, **GTOL)
    # dx is zero at the cells of unoccupied slices, as the JAX VJP's is
    s_occ = np.repeat(occ.reshape(-1, 16).any(-1), 16 * cin).reshape(
        len(occ), -1)
    assert (xt.grad.numpy()[~s_occ] == 0).all() and s_occ.any()
    assert np.abs(jdx).max() > 1e-2 and np.abs(jdw).max() > 1e-2
