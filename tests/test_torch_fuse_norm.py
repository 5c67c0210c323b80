"""The fused norm + ReLU prologue engine of the port vs the JAX package's.

``subm_conv3_norm_2d``, ``down_conv2_norm_2d`` and ``up_conv2_norm_2d``
take raw activations (not pre-masked) and the per-channel scale and bias of
a folded batch norm, with bias > 0 on some channels, so that a missing
mask would light inactive cells. The same numpy inputs and cotangent go
through both packages:

* float32: outputs to rtol = atol = 1e-5, gradients of x, W, scale and
  bias to 2e-4 (the bound of tests/test_bricks2d.py's prologue tests),
  the subm conv on each of the port's routes ('f32', 'padded' by a
  patched rule, the fused K1's plain version, and pro_full + K2's plain
  version);
* bf16 against the JAX package's bf16, to 2e-2 of the largest output
  (the JAX package rounds each of its three shifted sums to bf16, the port
  once) and 5e-2 of the largest gradient (two bf16 products and a bf16
  cotangent on either side). The JAX package rounds x*scale to bf16 before
  it adds the bias, the port (and its kernel) once after: relu' may then
  differ where |x*scale + bias| <= 2^-8 |x*scale|, so dx is compared
  outside that band, which must hold fewer than 2e-3 of the lanes;
* a numpy mirror of the prologue kernel's occupancy staging (rulebook
  slot, neighbour word, cell bit) against the mask the JAX package's
  ``_assemble_p6`` applies, on three grids, absent neighbours included.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from _torch_threads import two_threads  # noqa: F401
from _torch_fuse_norm_common import down, grids  # noqa: F401
from _torch_fuse_norm_common import (_compare, _compare_bf16, _inputs,
                                     _jax_vjp, _kernel_halo_mask, _port_vjp,
                                     _t, F32, GTOL, TOL)
from doda_tpu.ops import bricks2d as jb2d
from doda_tpu_torch.ops import banded_conv as tbc
from doda_tpu_torch.ops import bricks2d as tb2d


def test_subm_conv3_norm_2d_matches_jax(grids, monkeypatch):
    """Every route of the port, on the dense and the sparse grid."""
    calls = []
    plain = tb2d.banded_conv_fused
    monkeypatch.setattr(tb2d, 'banded_conv_fused',
                        lambda *a: calls.append(a[-1]) or plain(*a))
    for name in ('dense', 'sparse'):
        g, nbr = grids[name]
        rng = np.random.default_rng(len(name))
        args = _inputs(rng, g.b_cap, 16, 16, 27)
        cot = rng.normal(size=(g.b_cap, 64 * 16)).astype(np.float32)
        want = _jax_vjp(lambda x, w, s, b: jb2d.subm_conv3_norm_2d(
            x, g.occ, nbr, w, s, b, F32), args, cot)
        tn, occ = _t(nbr), _t(g.occ)
        halo, sm = tb2d.halo_index(tn), tb2d.sm_index(tn)
        for route, sm_max_cin in (('f32', 0), ('padded', 0), ('sm', 32),
                                  ('fused', 0)):
            with pytest.MonkeyPatch.context() as mp:
                if route == 'fused':      # the rule keeps float32 off it
                    mp.setattr(tb2d, 'uses_fused', lambda *a: True)
                if route == 'padded':     # float32 takes 'f32' by the rule
                    mp.setattr(tb2d, 'subm_route', lambda *a: 'padded')
                assert tb2d.subm_route(16, 16, torch.float32,
                                       sm_max_cin) == route
                del calls[:]
                got = _port_vjp(lambda x, w, s, b: tb2d.subm_conv3_norm_2d(
                    x, occ, halo, w, s, b, torch.float32, sm, sm_max_cin,
                    tn), args, cot)
            _compare(got[:1], want[:1], TOL)
            _compare(got, want, GTOL)
            if route == 'fused':     # forward with the prologue, dx without
                assert len(calls) == 2 and calls[0] is not None \
                    and calls[1] is None


def test_down_up_norm_2d_match_jax(down):
    g, ds, jmaps, tmaps = down
    rng = np.random.default_rng(7)
    occ, occ_p = _t(g.occ), _t(ds.parent_occ)
    args = _inputs(rng, g.b_cap, 16, 8, 8)
    cot = rng.normal(size=(256, 64 * 8)).astype(np.float32)
    want = _jax_vjp(lambda x, w, s, b: jb2d.down_conv2_norm_2d(
        x, g.occ, ds.parent_occ, jmaps, w, s, b, F32), args, cot)
    got = _port_vjp(lambda x, w, s, b: tb2d.down_conv2_norm_2d(
        x, occ, occ_p, tmaps, w, s, b, torch.float32), args, cot)
    _compare(got[:1], want[:1], TOL)
    _compare(got, want, GTOL)

    args = _inputs(rng, 256, 16, 8, 8)
    cot = rng.normal(size=(g.b_cap, 64 * 8)).astype(np.float32)
    want = _jax_vjp(lambda p, w, s, b: jb2d.up_conv2_norm_2d(
        p, ds.parent_occ, g.occ, jmaps, w, s, b, F32), args, cot)
    got = _port_vjp(lambda p, w, s, b: tb2d.up_conv2_norm_2d(
        p, occ_p, occ, tmaps, w, s, b, torch.float32), args, cot)
    _compare(got[:1], want[:1], TOL)
    _compare(got, want, GTOL)


def test_norm_convs_bf16_match_jax_bf16(grids, down):
    """bf16 operands on both sides; the port's subm conv on its fused
    route (the prologue K1's plain version on the CPU)."""
    bf = jnp.bfloat16
    g, nbr = grids['sparse']
    rng = np.random.default_rng(9)
    args = _inputs(rng, g.b_cap, 16, 16, 27)
    cot = rng.normal(size=(g.b_cap, 64 * 16)).astype(np.float32)
    want = _jax_vjp(lambda x, w, s, b: jb2d.subm_conv3_norm_2d(
        x.astype(bf), g.occ, nbr, w, s, b, bf).astype(F32), args, cot)
    tn, occ = _t(nbr), _t(g.occ)
    assert tb2d.subm_route(16, 16, torch.bfloat16, 0) == 'fused'
    got = _port_vjp(lambda x, w, s, b: tb2d.subm_conv3_norm_2d(
        x.bfloat16(), occ, tb2d.halo_index(tn), w, s, b, torch.bfloat16,
        nbr=tn).float(), args, cot)
    _compare_bf16(got, want, *args[:1], *args[2:])

    g, ds, jmaps, tmaps = down
    occ, occ_p = _t(g.occ), _t(ds.parent_occ)
    args = _inputs(rng, g.b_cap, 16, 8, 8)
    cot = rng.normal(size=(256, 64 * 8)).astype(np.float32)
    want = _jax_vjp(lambda x, w, s, b: jb2d.down_conv2_norm_2d(
        x.astype(bf), g.occ, ds.parent_occ, jmaps, w, s, b,
        bf).astype(F32), args, cot)
    got = _port_vjp(lambda x, w, s, b: tb2d.down_conv2_norm_2d(
        x.bfloat16(), occ, occ_p, tmaps, w, s, b, torch.bfloat16).float(),
        args, cot)
    _compare_bf16(got, want, *args[:1], *args[2:])
    args = _inputs(rng, 256, 16, 8, 8)
    cot = rng.normal(size=(g.b_cap, 64 * 8)).astype(np.float32)
    want = _jax_vjp(lambda p, w, s, b: jb2d.up_conv2_norm_2d(
        p.astype(bf), ds.parent_occ, g.occ, jmaps, w, s, b,
        bf).astype(F32), args, cot)
    got = _port_vjp(lambda p, w, s, b: tb2d.up_conv2_norm_2d(
        p.bfloat16(), occ_p, occ, tmaps, w, s, b, torch.bfloat16).float(),
        args, cot)
    _compare_bf16(got, want, *args[:1], *args[2:])


@jax.jit
def _jax_mask_planes(x, nbr, occ):
    """The JAX package's ``_assemble_p6`` with the prologue of scale 1 and
    bias 1 (jitted: eager, its many small ops take seconds a grid)."""
    one = jnp.ones((1,), F32)
    return jb2d._assemble_p6(x, nbr, F32, (one, one, occ), pm=False)


def test_kernel_occupancy_staging_equals_jax_mask(grids):
    """The mask the JAX package's ``_assemble_p6`` applies with a prologue
    (read off as its output on x = 0 with scale 1, bias 1, cin = 1, whose
    every active cell is 1) against the mirror, at both tile sizes."""
    for name in ('dense', 'sparse', 'dropped'):
        g, nbr = grids[name]
        rows = g.b_cap
        planes = _jax_mask_planes(jnp.zeros((rows, 64), F32),
                                  jnp.asarray(nbr), g.occ)
        want = np.concatenate([np.asarray(p) for p in planes], 1) > 0
        assert (~want).any() and want.any()
        occw = tbc.occ_words(_t(g.occ)).numpy()
        assert np.array_equal(tbc.occ_from_words(_t(occw)).numpy(),
                              np.asarray(g.occ))
        absent = (nbr == rows) & np.asarray(g.occ).any(1)[:, None]
        assert absent.any(), name          # neighbours the kernel zero-fills
        for tb in (4, 8):
            np.testing.assert_array_equal(
                _kernel_halo_mask(nbr, occw, rows, tb), want)
