"""The fused norm + ReLU prologue engine in whole nets, and its kernel's
schedule:

* a pure-Python mirror of the prologue K1's one-barrier schedule (every
  (tile, chunk) staged once, its prologue applied before the MMAs read it,
  no buffer overwritten while read);
* a 2-level net with ``fuse_norm=True`` and weights from
  ``params_from_jax`` against the flax net under ``DODA_FUSE_NORM=1``
  (eval logits to 1e-3; the flax parameter tree is the same with the
  variable on and off);
* one train-mode forward and backward of the port, fused against unfused
  on the fused K1 route (float32, so gradients agree to 1e-4).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from _torch_threads import two_threads  # noqa: F401
from _torch_fuse_norm_common import (_batch, _cfg, _pro_schedule, _variables,
                                     CAPS, F32)
from doda_tpu.models import unet as junet
from doda_tpu.ops import bricks2d as jb2d
from doda_tpu_torch.models import model_fn as tmf
from doda_tpu_torch.ops import bricks2d as tb2d
from doda_tpu_torch.utils.convert import params_from_jax


def test_kernel_prologue_schedule():
    """The prologue K1's one-barrier schedule (csrc/banded_conv_fused.cu):
    every (tile, chunk) is staged exactly once, with its prologue applied
    and seen by every thread before the MMAs read it, in order; no stage,
    rulebook, occupancy or weight buffer is overwritten while a reader of
    its content may still hold it."""
    for nti in (1, 2, 3, 4, 7):
        for nk in (1, 2, 3):
            for w_resident in (True, False):
                staged, mma = _pro_schedule(nti, nk, w_resident)
                every = [(t, c) for t in range(nti) for c in range(nk)]
                assert staged == {k: 1 for k in every}
                assert mma == every
    # the mirror catches a schedule that reuses a buffer too early: with
    # the rulebook rows in two buffers, tile 2's rows land on tile 0's
    # before the block has staged tile 0
    with pytest.raises(AssertionError):
        _pro_schedule(3, 1, True, nbr_bufs=2)


def test_fused_net_matches_flax_fused_net(monkeypatch):
    coords, valid, feats = _batch()
    model = junet.SparseConvNet(mid_channel=8, num_levels=2, block_reps=1,
                                n_classes=5, dtype=F32)
    plan = junet.build_level_plan(jnp.asarray(coords), jnp.asarray(valid),
                                  CAPS)

    def init_shapes():
        return jax.eval_shape(lambda: model.init(
            jax.random.PRNGKey(0), feats, plan, train=False))

    off = init_shapes()
    monkeypatch.setenv('DODA_FUSE_NORM', '1')
    on = init_shapes()
    assert jax.tree_util.tree_structure(on) == \
        jax.tree_util.tree_structure(off)
    assert jax.tree_util.tree_leaves(jax.tree_util.tree_map(
        lambda a, b: a.shape == b.shape, on, off))
    variables = _variables(on, np.random.default_rng(1))
    traced = []                      # the flax net took the fused convs
    fused = jb2d.subm_conv3_norm_2d
    monkeypatch.setattr(jb2d, 'subm_conv3_norm_2d',
                        lambda *a: traced.append(1) or fused(*a))
    want = np.asarray(jax.jit(lambda v: model.apply(
        v, jnp.asarray(feats), plan, train=False))(variables))
    assert len(traced) == 6

    port = tmf.build_model(_cfg(), device='cpu', dtype=torch.float32,
                           fuse_norm=True)
    port.load_state_dict(params_from_jax(variables['params'],
                                         variables['batch_stats']),
                         strict=True)
    tplan = tmf.build_level_plan(coords, valid, CAPS, device='cpu')
    with torch.no_grad():
        got = port(torch.from_numpy(feats), tplan).numpy()
    err = np.abs(got - want)[valid].max()
    assert err <= 1e-3 * max(1.0, np.abs(want).max()), err
    assert port.subm_routes() == {'sm': 0, 'fused': 0, 'narrow': 0,
                                  'f32': 7, 'padded': 0, 'prologue': 0,
                                  'cell_mean': 1}


def test_train_fused_equals_unfused_on_the_fused_route(monkeypatch):
    """Train mode: the folded scale and bias come from batch statistics,
    so dscale and dbias must flow back through them to x and to the norms'
    parameters; every gradient as in the unfused net."""
    monkeypatch.setattr(tb2d, 'uses_fused',
                        lambda cin, cout, dtype: cin % 8 == 0
                        and cout % 8 == 0)
    calls = []
    plain = tb2d.banded_conv_fused
    monkeypatch.setattr(tb2d, 'banded_conv_fused',
                        lambda *a: calls.append(a[-1] is not None)
                        or plain(*a))
    coords, valid, feats = _batch(seed=2)
    plan = tmf.build_level_plan(coords, valid, CAPS, device='cpu')
    cot = torch.from_numpy(np.random.default_rng(3).normal(
        size=(2, 400, 5)).astype(np.float32))
    results = {}
    sd = None
    for fuse in (False, True):
        torch.manual_seed(0)
        model = tmf.build_model(_cfg(), device='cpu', dtype=torch.float32,
                                train=True, fuse_norm=fuse)
        if sd is None:
            sd = {k: v.clone() for k, v in model.state_dict().items()}
            for k, v in sd.items():      # bias > 0 where a mask matters
                if k.endswith('.bias') and v.dim() == 1 and 'linear' not in k:
                    v.copy_(torch.linspace(-0.4, 0.6, v.numel()))
        model.load_state_dict(sd)
        del calls[:]
        out = model(torch.from_numpy(feats), plan)
        (out * cot).sum().backward()
        results[fuse] = (out.detach(), {n: p.grad.clone() for n, p in
                                        model.named_parameters()},
                         {k: v.clone() for k, v in
                          model.state_dict().items()})
        want_pro = model.subm_routes().get('prologue', 0)
        # six block convs: forward (with the prologue when fused) and dx
        assert sum(calls) == want_pro and len(calls) == 12
    assert want_pro == 6
    (o0, g0, s0), (o1, g1, s1) = results[False], results[True]
    torch.testing.assert_close(o1, o0, rtol=1e-4, atol=1e-4)
    assert g0.keys() == g1.keys()
    for n in g0:
        scale = max(1.0, g0[n].abs().max().item())
        err = (g1[n] - g0[n]).abs().max().item()
        assert err <= 1e-4 * scale, (n, err)
    for k in s0:                        # running statistics moved alike
        torch.testing.assert_close(s1[k], s0[k], rtol=1e-5, atol=1e-6)
