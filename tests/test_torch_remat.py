"""The U-Net blocks' memory policy (``remat``) vs the JAX package's
``DODA_REMAT``.

The policy table is held to ``doda_tpu/models/unet.py::_remat_policy``
(with its ``UBlock``'s 'off') for every value and level. A policy changes
what a block keeps for the backward, never a value, so on the CPU a train
step under 'dots', 'all' or 'mix1' equals 'off''s exactly (loss,
gradients and running statistics, 1e-6), and each equals the JAX
value-and-grad (one 2-level trace with remat off, as in
tests/test_torch_train.py) to 1e-3. The kernel calls of a step follow
``subm_routes``' replay rule, and 'dots' replays none; a DSNorm st step
under 'all' moves each domain's running statistics once.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import two_threads  # noqa: F401
from _torch_st_common import CAPS as ST_CAPS
from _torch_st_common import W_SRC, W_TAR, st_batch, st_cfg, st_points
from test_torch_train import (CAPS, FAST_COMPILE, _batch, _cfg, _flat,
                              _random_variables)
from doda_tpu.models import model_fn as jmf
from doda_tpu.models import unet as junet
from doda_tpu_torch.models import model_fn as tmf
from doda_tpu_torch.models import unet as tunet
from doda_tpu_torch.ops import banded_conv as tbc
from doda_tpu_torch.ops import banded_conv_sm as tbcs
from doda_tpu_torch.ops import bricks2d as tb2d
from doda_tpu_torch.tools import st as tst
from doda_tpu_torch.tools import train as ttrain
from doda_tpu_torch.utils import optim as toptim
from doda_tpu_torch.utils.convert import params_from_jax, params_to_jax

POLICIES = ('off', 'dots', 'all', 'mix1')
LR = 0.05


def _points(seed):
    return tmf.PointBatch(*(torch.from_numpy(a) for a in _batch(seed)))


def _step(cfg, sd, remat, batch=None, dtype=torch.float32, **kw):
    """One train step of a fresh model from ``sd`` under ``remat``: the
    loss, the gradients and the running statistics after it."""
    model = tmf.build_model(cfg, device='cpu', dtype=dtype, train=True,
                            remat=remat, **kw)
    model.load_state_dict(sd, strict=True)
    opt = toptim.build_optimizer(cfg.OPTIMIZATION, model.parameters())
    out = tmf.make_train_step(cfg, model, opt, CAPS, 'cpu')(
        batch if batch is not None else _points(0), LR)
    return (float(out['loss']),
            {n: p.grad.clone() for n, p in model.named_parameters()},
            {k: v.clone() for k, v in model.state_dict().items()
             if k.rsplit('.', 1)[-1] in ('mean', 'var')}, model)


def _max_diff(a, b):
    assert a.keys() == b.keys()
    return max((a[k] - b[k]).abs().max().item() for k in a)


def test_policy_table_matches_jax(monkeypatch):
    """Each value's policy at each level, against the JAX package's
    ``_remat_policy`` under ``DODA_REMAT`` (None: save nothing) and its
    ``UBlock``, which wraps nothing under 'off'."""
    for value in ('off', 'dots', 'all', 'mix', 'mix0', 'mix1', 'mix2',
                  'mix3', 'mix7'):
        monkeypatch.setenv('DODA_REMAT', value)
        for level in range(7):
            if value == 'off':
                want = 'off'
            else:
                want = 'all' if junet._remat_policy(level) is None \
                    else 'dots'
            assert tunet.remat_policy(value, level) == want, (value, level)


def test_each_policy_equals_off_in_a_train_step():
    """A 2-level bf16 net (fused K1 on its plain version, the input conv
    on the assembled route, tail0's 1x1 shortcut): one step under each
    policy from the same state equals 'off''s."""
    cfg = _cfg()
    cfg.MODEL.BACKBONE.mid_channel = 8
    torch.manual_seed(0)
    sd = tmf.build_model(cfg, device='cpu').state_dict()
    ref = _step(cfg, sd, 'off', dtype=torch.bfloat16)
    assert max(g.abs().max().item() for g in ref[1].values()) > 1e-2
    for remat in POLICIES[1:]:
        got = _step(cfg, sd, remat, dtype=torch.bfloat16)
        assert abs(got[0] - ref[0]) <= 1e-6, remat
        assert _max_diff(got[1], ref[1]) <= 1e-6, remat
        assert _max_diff(got[2], ref[2]) <= 1e-6, remat


def test_steps_under_dots_and_all_match_jax():
    """The port's float32 step under 'dots' and 'all' against one JAX
    value-and-grad with remat off: loss, gradients and running statistics
    to 1e-3 (of the gradient's scale)."""
    cfg = _cfg()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('DODA_REMAT', 'off')
        model = jmf.build_model(cfg).clone(dtype=jnp.float32)
        coords, feats, labels, valid = _batch(0)
        plan = jax.jit(lambda c, v: junet.build_level_plan(c, v, CAPS))(
            jnp.asarray(coords), jnp.asarray(valid))
        shapes = jax.eval_shape(lambda: model.init(
            jax.random.PRNGKey(0), feats, plan, train=False))
        variables = _random_variables(shapes, np.random.default_rng(0))
        criterion = jmf.make_criterion(cfg)

        def loss_fn(params, stats):
            logits, upd = model.apply(
                {'params': params, 'batch_stats': stats},
                jnp.where(valid[..., None], feats, 0.0), plan, train=True,
                domain=0, mutable=['batch_stats'])
            return criterion(logits, jnp.where(valid, labels, 255)), \
                upd['batch_stats']

        (loss, stats), grads = jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True),
            compiler_options=FAST_COMPILE)(variables['params'],
                                           variables['batch_stats'])
    want_g, want_s = dict(_flat(grads)), dict(_flat(stats))
    sd = params_from_jax(variables['params'], variables['batch_stats'])
    for remat in ('dots', 'all'):
        got_loss, got_g, _, port = _step(cfg, sd, remat)
        assert abs(got_loss - float(loss)) <= 1e-3 * float(loss), remat
        g, _ = params_to_jax(got_g)
        _, s = params_to_jax(port.state_dict())
        for want, got in ((want_g, dict(_flat(g))), (want_s, dict(_flat(s)))):
            assert want.keys() == got.keys()
            for k, v in want.items():
                err = np.abs(got[k] - v).max()
                assert err <= 1e-3 * max(1.0, np.abs(v).max()), (remat, k)


def _counting(monkeypatch):
    """Count the kernel wrappers' calls by route where ``bricks2d`` makes
    them (on the CPU they run their plain versions)."""
    calls = {}

    def wrap(name, route_of):
        fn = getattr(tb2d, name)

        def counted(*a):
            route = route_of(a)
            calls[route] = calls.get(route, 0) + 1
            return fn(*a)
        monkeypatch.setattr(tb2d, name, counted)

    wrap('banded_conv_fused',
         lambda a: 'prologue' if len(a) > 4 and a[4] is not None
         else 'fused')
    wrap('banded_conv', lambda a: 'assembled')
    wrap('banded_conv_narrow', lambda a: 'narrow')
    wrap('banded_conv_sm_taps', lambda a: 'sm')
    wrap('banded_conv_f32', lambda a: 'f32')
    return calls


def test_kernel_calls_follow_the_replay_rule(monkeypatch):
    """Kernel calls of one bf16 step under each policy, on the default
    routes, with ``fuse_norm`` (the replay runs the prologue K1) and with
    ``sm_max_cin=32`` (K2's forward is replayed), against
    ``subm_routes``' rule: the forward, the dx convs and one forward launch
    of each block conv at a replaying level; 'dots' replays none. In eval
    mode and without grad no policy adds a call."""
    calls = _counting(monkeypatch)
    cfg = _cfg()
    torch.manual_seed(0)
    sd = tmf.build_model(cfg, device='cpu').state_dict()
    batch = _points(0)
    for kw in ({}, {'fuse_norm': True}, {'sm_max_cin': 32}):
        per_policy = {}
        for remat in POLICIES:
            calls.clear()
            model = _step(cfg, sd, remat, batch, torch.bfloat16, **kw)[3]
            fwd, bwd = model.subm_routes(), model.subm_routes(True)
            want = {k: fwd[k] + bwd[k] for k in fwd if fwd[k] + bwd[k]}
            assert calls == want, (kw, remat, calls, want)
            per_policy[remat] = want
            calls.clear()
            plan = tmf.build_level_plan(batch.coords, batch.valid, CAPS,
                                        'cpu')
            with torch.no_grad():
                model(tmf.model_input(cfg, batch), plan)
            model.eval()
            model(tmf.model_input(cfg, batch), plan)
            assert calls == {k: 2 * v for k, v in fwd.items() if v}, remat
        assert per_policy['dots'] == per_policy['off'], kw
        # 'all' replays the 6 block convs of the 2-level net, 'mix1' the 4
        # of level 0
        for remat, extra in (('all', 6), ('mix1', 4)):
            assert sum(per_policy[remat].values()) \
                == sum(per_policy['off'].values()) + extra, (kw, remat)
        if kw.get('fuse_norm'):
            assert per_policy['all']['prologue'] \
                == 2 * per_policy['off']['prologue'] == 12
        if kw.get('sm_max_cin'):
            assert per_policy['all']['sm'] > per_policy['off']['sm']


def test_st_step_under_all_moves_each_domain_once():
    """DSNorm: the source term on domain 0, the target's on domain 1, each
    block replayed under 'all'; every running statistic of each domain as
    under 'off' (moved once), and moved."""
    cfg = st_cfg()
    torch.manual_seed(0)
    sd = tmf.build_model(cfg, device='cpu').state_dict()
    src, tar = st_points(st_batch(0)), st_points(st_batch(1))
    runs = {}
    for remat in ('off', 'all'):
        model = tmf.build_model(cfg, device='cpu', dtype=torch.float32,
                                train=True, remat=remat, sm_max_cin=16)
        model.load_state_dict(sd, strict=True)
        opt = toptim.build_optimizer(cfg.OPTIMIZATION, model.parameters())
        out = tmf.make_st_step(cfg, model, opt, ST_CAPS, 'cpu')(
            src, tar, LR, W_SRC, W_TAR)
        runs[remat] = (out, model.state_dict())
    (out0, s0), (out1, s1) = runs['off'], runs['all']
    for k in ('loss_x', 'loss_u'):
        assert abs(float(out1[k]) - float(out0[k])) <= 1e-6
    stats = [k for k in sd if k.rsplit('.', 1)[-1] in ('mean', 'var')]
    assert stats and all(sd[k].shape[0] == 2 for k in stats)
    for k in stats:
        assert (s1[k] - s0[k]).abs().max().item() <= 1e-6, k
    for d in (0, 1):
        assert min((s1[k][d] - sd[k][d]).abs().max().item()
                   for k in stats) > 1e-4, d


def test_bad_policy_raises():
    cfg = _cfg()
    for bad in ('bogus', 'mixx', 'mix-1', 'Dots', None):
        with pytest.raises(ValueError, match='remat'):
            tmf.build_model(cfg, device='cpu', remat=bad)
        with pytest.raises(ValueError, match='remat'):
            tunet.remat_policy(bad, 0)
    for cli in (ttrain, tst):
        with pytest.raises(SystemExit):
            cli.parse_config(['--cfg_file', 'cfgs/scannet/spconv.yaml',
                              '--remat', 'bogus'])
        args, _ = cli.parse_config(['--cfg_file', 'cfgs/scannet/spconv.yaml',
                                    '--remat', 'mix3'])
        assert args.remat == 'mix3'
