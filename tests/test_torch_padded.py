"""The route 'padded' of the PyTorch port (``banded_conv_padded``): the bf16
subm convs whose widths neither the fused nor the narrow K1 takes as they
are.

On the CPU the wrapper pads the operands with zero channels and runs the
fused version's plain version on them; on the card it launches the fused
(cin > 7) or narrow (cin <= 7) kernel on them, which ``chip_smoke.py``
holds to that plain version. Here:

* ``subm_route`` sends every bf16 width that is neither fused nor narrow
  to it, at sides 4 and 2, and the padded widths are ones the launched
  kernel takes;
* at cin -> cout 12 -> 20, 20 -> 12, 9 -> 5 and 3 -> 12, on a dense, a
  sparse and an overflowed grid, ``subm_conv3_2d`` on the route equals the
  JAX package's ``subm_conv3_2d``, forward and dx (``jax.jit`` of
  ``jax.vjp``): at float32 to rtol = atol = 1e-5 (sums in another order);
  at bf16 within one bf16 rounding of the float32 conv of the same rounded
  (and padded) operands, and to 2e-2 of the largest JAX bf16 output (the
  bound of tests/test_torch_input_conv.py);
* the padded operands give the bits of ``banded_conv_fused_plain`` on
  them, sliced back to cout;
* the wrapper raises off the CPU, at a side with no kernel and on shapes
  it does not take.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from _torch_threads import two_threads  # noqa: F401
from _torch_input_conv_common import grids  # noqa: F401
from _torch_input_conv_common import _inputs, _t, TOL
from _torch_train_common import FAST_COMPILE
from doda_tpu.ops import bricks2d as jb2d
from doda_tpu_torch.ops import bricks2d as tb2d
from doda_tpu_torch.ops.banded_conv import (NARROW_MAX_CIN,
                                            banded_conv_fused_plain,
                                            banded_conv_padded, pad_channels,
                                            padded_widths)

BF, F32 = torch.bfloat16, torch.float32
WIDTHS = ((12, 20), (20, 12), (9, 5), (3, 12))


def test_subm_route_sends_the_other_bf16_widths_to_padded():
    for side in (4, 2):
        for cin in range(1, 49):
            for cout in range(1, 49):
                fused = cin % 8 == 0 and cout % 8 == 0
                narrow = cin <= NARROW_MAX_CIN and cout % 8 == 0
                want = ('fused' if fused else 'narrow' if narrow
                        else 'padded')
                assert tb2d.subm_route(cin, cout, BF, 0, side) == want
                assert tb2d.subm_route(cin, cout, F32, 0, side) == 'f32'
                sm = tb2d.uses_sm(cin, cout, 32, side)
                assert tb2d.subm_route(cin, cout, BF, 32, side) == (
                    'sm' if sm else want)
                cin_p, cout_p = padded_widths(cin, cout)
                assert cin <= cin_p < max(cin + 8, 8) and cout <= cout_p \
                    < cout + 8
                assert tb2d.uses_fused(cin_p, cout_p, BF) \
                    or tb2d.uses_narrow(cin_p, cout_p, BF)
                if want != 'padded':
                    assert (cin_p, cout_p) == (cin, cout)


@functools.lru_cache(maxsize=None)
def _jax_vjp(dtype):
    """Forward and VJP of the JAX package's ``subm_conv3_2d``, jitted once
    a dtype (the grid's tables are arguments) with XLA's expensive passes
    off: its 24 compiles are most of this file's time."""
    def fwd_vjp(x, w, cot, occ, nbr):
        out, vjp = jax.vjp(lambda a, b: jb2d.subm_conv3_2d(
            a, occ, nbr, b, compute_dtype=dtype), x, w)
        return (out,) + vjp(cot)
    return jax.jit(fwd_vjp, compiler_options=FAST_COMPILE)


def _port(x, w, cot, occ, tn, dtype, monkeypatch):
    """``subm_conv3_2d`` on the route 'padded', forward and dx; the calls
    of ``banded_conv_padded`` counted by weight shape."""
    calls = []
    plain = tb2d.banded_conv_padded
    monkeypatch.setattr(tb2d, 'banded_conv_padded',
                        lambda *a: calls.append(tuple(a[2].shape))
                        or plain(*a))
    xl = x.clone().requires_grad_(True)
    out = tb2d.subm_conv3_2d(xl, occ, tb2d.halo_index(tn), w, dtype, nbr=tn)
    out.backward(cot)
    return out.detach().float().numpy(), xl.grad.float().numpy(), calls


def _f32_conv(x, tn, w):
    """The float32 conv of bf16 operands as the route computes it, before
    its one rounding: the fused plain version on the padded operands, in
    float32, sliced back to cout (bf16 products are exact in float32)."""
    xp, wp = pad_channels(x, w.contiguous())
    cout, cout_p = w.shape[2], wp.shape[2]
    out = banded_conv_fused_plain(xp.float(), tn, wp.float(), F32)
    return out.reshape(x.shape[0], -1, cout_p)[..., :cout].reshape(
        x.shape[0], -1)


@pytest.mark.parametrize('name', ['dense', 'sparse', 'overflowed'])
def test_padded_route_equals_jax(grids, name):
    g, nbr = grids[name]
    tn, occ = _t(nbr), _t(g.occ)
    for cin, cout in WIDTHS:
        rng = np.random.default_rng(cin * 100 + cout)
        x, w = _inputs(rng, g, cin, cout)
        cot = rng.normal(size=(g.b_cap, 64 * cout)).astype(np.float32)
        tables = (g.occ, jnp.asarray(nbr))
        shape = (27, cin, cout), (27, cout, cin)

        # float32: the rule gives it 'f32', so it is sent to 'padded'
        want = [np.asarray(a) for a in _jax_vjp(jnp.float32)(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(cot), *tables)]
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tb2d, 'subm_route', lambda *a: 'padded')
            out, dx, calls = _port(_t(x), _t(w), _t(cot), occ, tn, F32, mp)
        assert calls == list(shape)            # forward, then dx
        assert np.abs(want[0]).max() > 0.1
        np.testing.assert_allclose(out, want[0], **TOL)
        np.testing.assert_allclose(dx, want[1], **TOL)

        # bf16 on the rule's own route
        assert tb2d.subm_route(cin, cout, BF, 0) == 'padded'
        assert tb2d.subm_route(cout, cin, BF, 0) == 'padded'
        xb, wb, cb = (_t(a).to(BF) for a in (x, w, cot))
        with pytest.MonkeyPatch.context() as mp:
            out, dx, calls = _port(xb, wb.float(), cb, occ, tn, BF, mp)
        assert calls == list(shape)
        exact = tb2d._mask(_f32_conv(xb, tn, wb), occ, cout).numpy()
        exact_dx = _f32_conv(tb2d._mask(cb, occ, cout), tn,
                             tb2d._flip_weights(wb)).numpy()
        for got, ref in ((out, exact), (dx, exact_dx)):
            assert (np.abs(got - ref) <= 2.0 ** -8 * np.abs(got)).all()
        want = [np.asarray(a.astype(jnp.float32)) for a in _jax_vjp(
            jnp.bfloat16)(jnp.asarray(xb.float().numpy()).astype(
                jnp.bfloat16), jnp.asarray(wb.float().numpy()),
            jnp.asarray(cb.float().numpy()).astype(jnp.bfloat16), *tables)]
        for got, ref in ((out, want[0]), (dx, want[1])):
            assert np.abs(ref).max() > 0.1
            assert np.abs(got - ref).max() <= 2e-2 * np.abs(ref).max()


def test_padded_operands_give_the_fused_plain_bits(grids):
    g, nbr = grids['sparse']
    tn = _t(nbr)
    for cin, cout in WIDTHS:
        rng = np.random.default_rng(cin + cout)
        x, w = _inputs(rng, g, cin, cout)
        xb, wb = _t(x).to(BF), _t(w).to(BF)
        xp, wp = pad_channels(xb, wb)
        cin_p, cout_p = padded_widths(cin, cout)
        assert wp.shape == (27, cin_p, cout_p) and wp.is_contiguous()
        assert xp.shape == (g.b_cap, 64 * cin_p)
        x3 = xp.reshape(g.b_cap, 64, cin_p)
        assert torch.equal(x3[..., :cin], xb.reshape(g.b_cap, 64, cin))
        assert not x3[..., cin:].any() and not wp[:, cin:].any() \
            and not wp[:, :, cout:].any()
        assert torch.equal(wp[:, :cin, :cout], wb)
        for dt in (BF, F32):
            got = banded_conv_padded(xb, tn, wb, dt)
            ref = banded_conv_fused_plain(xp, tn, wp, dt).reshape(
                g.b_cap, 64, cout_p)[..., :cout].reshape(g.b_cap, -1)
            assert got.dtype == dt and torch.equal(got, ref)
    assert banded_conv_padded.launches == 0   # the CPU never reaches one


def test_padded_wrapper_raises_off_the_cpu_and_at_a_side_without_kernel():
    meta = dict(device='meta', dtype=BF)
    nbr = torch.zeros(4, 27, device='meta', dtype=torch.int32)
    w = torch.zeros(27, 12, 20, **meta)
    with pytest.raises(ValueError, match='CUDA'):
        banded_conv_padded(torch.zeros(4, 64 * 12, **meta), nbr, w, BF)
    with pytest.raises(ValueError, match='brick side 6 has no kernel'):
        banded_conv_padded(torch.zeros(4, 216 * 12, **meta), nbr, w, BF)
    with pytest.raises(ValueError, match=r'\(27, cin, cout\)'):
        banded_conv_padded(torch.zeros(4, 64 * 12, **meta), nbr,
                           torch.zeros(9, 12, 20, **meta), BF)
    with pytest.raises(ValueError, match='nbr'):
        banded_conv_padded(torch.zeros(4, 64 * 12, **meta), nbr[:3], w, BF)
    # a side without a kernel still runs on the CPU, as its plain version
    x6 = torch.zeros(2, 216 * 12, dtype=BF)
    nbr6 = torch.full((2, 27), 2, dtype=torch.int32)
    assert banded_conv_padded(x6, nbr6, torch.zeros(27, 12, 20, dtype=BF),
                              BF).shape == (2, 216 * 20)
    assert banded_conv_padded.launches == 0
