"""The port's 3D brick convs and reductions vs the JAX package's.

``brick_feats`` (mean and sum) and ``unbrick_feats``; the shell-gather
oracle ``subm_conv3`` and the concat-assembly engine ``subm_conv3_v2`` at
cin != cout, forward to 1e-5 and gradients (autograd on both sides) to
1e-4; ``down_conv2`` and ``up_conv2`` against the JAX custom VJPs, with the
maps they read (``target_cells``, ``parent_src``) integer for integer; and
the oracle against the port's ``subm_conv3_2d`` on its CPU paths (the
'f32' route in float32, the fused K1's plain version in bf16), on a
grid where a brick's face neighbour is absent while a diagonal one is
present.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from _torch_threads import two_threads  # noqa: F401
from doda_tpu.ops import bricks as jbricks
from doda_tpu_torch.ops import bricks as tbricks
from doda_tpu_torch.ops import bricks2d as tb2d

F32 = jnp.float32
TOL = dict(rtol=1e-5, atol=1e-5)
GTOL = dict(rtol=1e-4, atol=1e-4)


def _grids(coords, cap):
    valid = np.ones(len(coords), bool)
    jg = jbricks.brickify(jnp.asarray(coords), jnp.asarray(valid), cap)
    tg = tbricks.brickify(torch.from_numpy(coords), torch.from_numpy(valid),
                          cap)
    return jg, tg, np.asarray(jbricks.build_brick_rulebook(jg.table))


@pytest.fixture(scope='module')
def grids():
    """A dense grid, and a sparse one with a corner contact whose x-halo
    cell only a diagonal brick supplies (tests/test_bricks2d.py's)."""
    rng = np.random.default_rng(3)
    dense = _grids(rng.integers(0, 20, (3000, 3)).astype(np.int32), 256)
    rng = np.random.default_rng(11)
    coords = rng.integers(0, 96, (1500, 3)).astype(np.int32)
    crafted = np.array([[4, 4, 4], [3, 3, 4], [3, 3, 7], [4, 7, 4]],
                       np.int32)
    sparse = _grids(np.concatenate([coords, crafted]), 2048)
    return {'dense': dense, 'sparse': sparse}


def _feats(rng, occ, cin):
    f = rng.normal(size=occ.shape + (cin,)).astype(np.float32)
    return f * np.asarray(occ)[..., None]


def _vjp_jax(fn, args, cot):
    """fn's output and its VJP of ``cot``, traced once (jitted)."""
    def run(args, cot):
        out, vjp = jax.vjp(fn, *args)
        return out, vjp(cot)

    out, grads = jax.jit(run)(tuple(jnp.asarray(a) for a in args),
                              jnp.asarray(cot))
    return [np.asarray(out)] + [np.asarray(g) for g in grads]


def _vjp_port(fn, args, cot):
    ts = [torch.from_numpy(np.array(a)).requires_grad_(True) for a in args]
    out = fn(*ts)
    out.backward(torch.from_numpy(cot))
    return [out.detach().numpy()] + [t.grad.numpy() for t in ts]


def _check(got, want):
    np.testing.assert_allclose(got[0], want[0], **TOL)
    for g, w in zip(got[1:], want[1:]):
        assert np.abs(w).max() > 1e-2       # the check is not vacuous
        np.testing.assert_allclose(g, w, **GTOL)


@pytest.mark.parametrize('mode', [3, 4])
def test_brick_feats_and_unbrick_match_jax(mode):
    rng = np.random.default_rng(mode)
    coords = rng.integers(0, 30, (900, 3)).astype(np.int32)   # duplicates
    valid = rng.random(900) > 0.1
    feats = rng.normal(size=(900, 5)).astype(np.float32)
    jg = jbricks.brickify(jnp.asarray(coords), jnp.asarray(valid), 512)
    tg = tbricks.brickify(torch.from_numpy(coords), torch.from_numpy(valid),
                          512)
    want = np.asarray(jbricks.brick_feats(jnp.asarray(feats), jg, mode))
    got = tbricks.brick_feats(torch.from_numpy(feats), tg, mode).numpy()
    assert got.shape == want.shape == (512, 64, 5)
    np.testing.assert_allclose(got, want, **TOL)
    back_j = np.asarray(jbricks.unbrick_feats(jnp.asarray(want), jg))
    back_t = tbricks.unbrick_feats(torch.from_numpy(got), tg).numpy()
    np.testing.assert_allclose(back_t, back_j, **TOL)
    assert (back_t[~valid] == 0).all()


def test_subm_conv3_oracles_match_jax(grids):
    for name in ('dense', 'sparse'):
        jg, tg, nbr = grids[name]
        rng = np.random.default_rng(len(name))
        occ, tocc, tnbr = jg.occ, tg.occ, torch.from_numpy(nbr)
        for cin, cout in ((3, 8), (8, 5)):
            x = _feats(rng, occ, cin)
            w = (rng.normal(size=(27, cin, cout)) * 0.2).astype(np.float32)
            cot = rng.normal(size=occ.shape + (cout,)).astype(np.float32)
            for jfn, tfn in ((jbricks.subm_conv3, tbricks.subm_conv3),
                             (jbricks.subm_conv3_v2, tbricks.subm_conv3_v2)):
                want = _vjp_jax(lambda x, w: jfn(x, occ, jnp.asarray(nbr), w,
                                                 F32), (x, w), cot)
                got = _vjp_port(lambda x, w: tfn(x, tocc, tnbr, w,
                                                 torch.float32), (x, w), cot)
                assert np.abs(want[0]).max() > 1e-2
                _check(got, want)


def test_down_up_conv2_match_jax_custom_vjp(grids):
    jg, tg, _ = grids['dense']
    jd = jbricks.build_brick_downsample(jg.table, jg.occ, 64)
    td = tbricks.build_brick_downsample(tg.table, tg.occ, 64)
    target, parent_src = tbricks.down_maps(td)
    np.testing.assert_array_equal(np.asarray(jd.target_cells), target)
    np.testing.assert_array_equal(np.asarray(jd.parent_src), parent_src)
    assert (parent_src < 256 * 8).any() and (parent_src == 256 * 8).any()

    rng = np.random.default_rng(7)
    x = _feats(rng, jg.occ, 6)
    w = (rng.normal(size=(8, 6, 4)) * 0.3).astype(np.float32)
    cot = rng.normal(size=(64, 64, 4)).astype(np.float32)
    _check(_vjp_port(lambda x, w: tbricks.down_conv2(x, td, w,
                                                     torch.float32),
                     (x, w), cot),
           _vjp_jax(lambda x, w: jbricks.down_conv2(x, jd, w, F32), (x, w),
                    cot))
    p = _feats(rng, jd.parent_occ, 4)
    w = (rng.normal(size=(8, 4, 6)) * 0.3).astype(np.float32)
    cot = rng.normal(size=(256, 64, 6)).astype(np.float32)
    _check(_vjp_port(lambda p, w: tbricks.up_conv2(p, tg.occ, td, w,
                                                   torch.float32),
                     (p, w), cot),
           _vjp_jax(lambda p, w: jbricks.up_conv2(p, jg.occ, jd, w, F32),
                    (p, w), cot))


def test_oracle_matches_subm_conv3_2d(grids):
    """The oracle's halo comes from the rulebook by another route than
    ``halo_index``; the two convs must agree where a face neighbour is
    absent and a diagonal one present."""
    _, tg, nbr = grids['sparse']
    face, diag = nbr[:, 4], nbr[:, [1, 7]]      # -x face; (-x, -+y) edges
    rows = tg.b_cap
    assert ((face == rows) & (diag < rows).any(1)
            & np.asarray(tg.occ).any(1)).any()
    rng = np.random.default_rng(5)
    x = torch.from_numpy(_feats(rng, tg.occ, 16))
    w = torch.from_numpy((rng.normal(size=(27, 16, 8)) * 0.1).astype(
        np.float32))
    tnbr = torch.from_numpy(nbr)
    halo = tb2d.halo_index(tnbr)
    want = tbricks.subm_conv3(x, tg.occ, tnbr, w, torch.float32)
    assert want.abs().max() > 1e-2
    assert tb2d.subm_route(16, 8, torch.float32, 0) == 'f32'
    got = tb2d.subm_conv3_2d(x.reshape(rows, -1), tg.occ, halo, w,
                             torch.float32, nbr=tnbr)
    torch.testing.assert_close(got.reshape(want.shape), want, **TOL)
    # the fused K1's plain version: bf16 operands, float32 output, against
    # the oracle on the same bf16-rounded operands
    xb, wb = x.bfloat16(), w.bfloat16()
    assert tb2d.subm_route(16, 8, torch.bfloat16, 0) == 'fused'
    got = tb2d.banded_conv_fused(xb.reshape(rows, -1), tnbr, wb,
                                 torch.float32)
    got = tb2d._mask(got, tg.occ, 8)
    want = tbricks.subm_conv3(xb.float(), tg.occ, tnbr, wb.float(),
                              torch.float32)
    torch.testing.assert_close(got.reshape(want.shape), want, **TOL)
