"""The port's self-training step vs the JAX package.

``make_st_step`` takes the reference's form: the source term's forward and
backward on norm domain 0, then the target term's on domain 1, then one
SGD update. The JAX side is the same update the JAX ``st_step`` makes in
one graph, built from one jitted ``value_and_grad`` of the one-domain loss
(domain a traced argument, so one compile serves both terms; remat off,
XLA's expensive passes disabled, as in tests/test_torch_train.py) called
for domain 0 and then, on the statistics the source term left, for domain
1; the gradients are combined as ``w_s * g_s + w_t * g_t`` and the optax
SGD update applied. The net is the 2-level float32 net of
test_torch_train.py with DSNorm on, ``sm_max_cin=16`` so that both
kernels' plain versions run. Two steps (momentum, a learning rate each):
the weighted losses, the IoU counts, the gradients, the parameters and
each domain's running statistics must agree to 1e-3. The soft-label
target term is in tests/test_torch_soft_label.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_threads import two_threads  # noqa: F401
from _torch_st_common import (CAPS, LRS, N_CLASSES, TOL, W_SRC, W_TAR,
                              st_batch, st_cfg, st_points)
from doda_tpu.models import model_fn as jmf
from doda_tpu.models import unet as junet
from doda_tpu.utils import optim as joptim
from doda_tpu_torch.config import CfgNode
from doda_tpu_torch.models import model_fn as tmf
from doda_tpu_torch.utils import optim as toptim
from doda_tpu_torch.utils.convert import params_from_jax, params_to_jax

FAST_COMPILE = {'xla_backend_optimization_level': 0,
                'xla_llvm_disable_expensive_passes': True}


def _random_variables(shapes, rng):
    def fill(path, leaf):
        name = path[-1].key
        if name == 'mean':
            return rng.normal(0, 0.2, leaf.shape)
        if name == 'var':
            return rng.uniform(0.5, 1.5, leaf.shape)
        if name == 'scale':
            return 1 + rng.normal(0, 0.2, leaf.shape)
        if name == 'bias':
            return rng.normal(0, 0.2, leaf.shape)
        fan_in = leaf.shape[0] * (leaf.shape[1] if leaf.ndim == 3 else 1)
        b = (1.0 / fan_in) ** 0.5
        return rng.uniform(-b, b, leaf.shape)
    return jax.tree_util.tree_map_with_path(
        lambda p, x: fill(p, x).astype(np.float32), shapes)


def _flat(tree, prefix=''):
    for k, v in tree.items():
        if hasattr(v, 'items'):
            yield from _flat(v, f'{prefix}{k}.')
        else:
            yield f'{prefix}{k}', np.asarray(v)


def _steps():
    """Per step: (source batch, target batch, lr)."""
    return [(st_batch(2 * i), st_batch(2 * i + 1), lr)
            for i, lr in enumerate(LRS)]


@pytest.fixture(scope='module')
def reference():
    """Two JAX two-domain updates: per step the weighted losses, the
    valid counts and the combined gradients; at the end params and
    batch_stats."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('DODA_REMAT', 'off')
        cfg = st_cfg()
        model = jmf.build_model(cfg).clone(dtype=jnp.float32)
        criterion = jmf.make_criterion(cfg)
        build_plan = jax.jit(lambda c, v: junet.build_level_plan(c, v, CAPS))
        steps = _steps()
        shapes = jax.eval_shape(lambda: model.init(
            jax.random.PRNGKey(0), steps[0][0][1],
            build_plan(jnp.asarray(steps[0][0][0]),
                       jnp.asarray(steps[0][0][3])), train=False))
        variables = _random_variables(shapes, np.random.default_rng(0))

        def loss_fn(params, stats, plan, feats, labels, domain):
            logits, upd = model.apply(
                {'params': params, 'batch_stats': stats}, feats, plan,
                train=True, domain=domain, mutable=['batch_stats'])
            return criterion(logits, labels), upd['batch_stats']

        grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True),
                          compiler_options=FAST_COMPILE)

        def term(params, stats, batch, domain):
            coords, feats, labels, valid = batch
            plan = build_plan(jnp.asarray(coords), jnp.asarray(valid))
            feats = jnp.where(valid[..., None], feats, 0.0)
            lab = jnp.where(valid, labels, 255)
            (loss, stats), grads = grad_fn(params, stats, plan, feats, lab,
                                           jnp.int32(domain))
            return loss, stats, grads, int((np.asarray(lab) != 255).sum())

        tx = joptim.build_optimizer(cfg.OPTIMIZATION)
        params = jax.tree.map(jnp.asarray, variables['params'])
        stats = jax.tree.map(jnp.asarray, variables['batch_stats'])
        opt_state = tx.init(params)
        out = []
        for src, tar, lr in steps:
            loss_s, stats, g_s, n_s = term(params, stats, src, 0)
            loss_t, stats, g_t, n_t = term(params, stats, tar, 1)
            grads = jax.tree.map(lambda a, b: W_SRC * a + W_TAR * b,
                                 g_s, g_t)
            opt_state.hyperparams['learning_rate'] = jnp.asarray(
                lr, jnp.float32)
            upd, opt_state = tx.update(grads, opt_state, params)
            params = optax.apply_updates(params, upd)
            out.append({'loss_x': W_SRC * float(loss_s),
                        'loss_u': W_TAR * float(loss_t),
                        'count_x': n_s, 'count_u': n_t,
                        'grads': dict(_flat(grads))})
    return variables, out, dict(_flat(params)), dict(_flat(stats))


def _port_model(variables, cfg):
    model = tmf.build_model(cfg, device='cpu', dtype=torch.float32,
                            sm_max_cin=16, train=True)
    model.load_state_dict(params_from_jax(variables['params'],
                                          variables['batch_stats']),
                          strict=True)
    return model


@pytest.fixture(scope='module')
def port_run(reference):
    """The same two updates through the port's ``make_st_step``."""
    variables = reference[0]
    cfg = st_cfg()
    model = _port_model(variables, cfg)
    opt = toptim.build_optimizer(cfg.OPTIMIZATION, model.parameters())
    step = tmf.make_st_step(cfg, model, opt, CAPS, device='cpu')
    out = []
    for src, tar, lr in _steps():
        metrics = step(st_points(src), st_points(tar), lr, W_SRC, W_TAR)
        grads, _ = params_to_jax({n: p.grad for n, p in
                                  model.named_parameters()})
        out.append({'metrics': metrics, 'grads': dict(_flat(grads))})
    params, stats = params_to_jax(model.state_dict())
    return model, out, dict(_flat(params)), dict(_flat(stats))


def _assert_trees_close(got, want, what):
    assert set(got) == set(want), what
    for name in want:
        scale = max(1.0, np.abs(want[name]).max())
        err = np.abs(got[name] - want[name]).max()
        assert err <= TOL * scale, f'{what} {name}: {err}'


@pytest.mark.parametrize('i', [0, 1])
def test_st_step_losses_and_metrics(reference, port_run, i):
    want, got = reference[1][i], port_run[1][i]['metrics']
    keys = {f'{k}_{d}' for k in ('loss', 'intersection', 'union', 'target',
                                 'count') for d in 'xu'}
    assert set(got) == keys
    for k in ('loss_x', 'loss_u'):
        assert abs(float(got[k]) - want[k]) <= TOL * want[k], k
        assert not got[k].requires_grad
    for d in 'xu':
        assert int(got[f'count_{d}']) == want[f'count_{d}'] \
            == int(got[f'target_{d}'].sum())
        assert got[f'intersection_{d}'].shape == (N_CLASSES,)


@pytest.mark.parametrize('i', [0, 1])
def test_st_step_gradients(reference, port_run, i):
    want, got = reference[1][i]['grads'], port_run[1][i]['grads']
    assert max(np.abs(v).max() for v in want.values()) > 1e-2
    _assert_trees_close(got, want, f'step {i} gradient')


def test_st_step_parameters_and_domain_statistics(reference, port_run):
    variables, _, want_p, want_s = reference
    _, _, got_p, got_s = port_run
    _assert_trees_close(got_p, want_p, 'parameter')
    _assert_trees_close(got_s, want_s, 'running statistic')
    start = dict(_flat(variables['batch_stats']))
    for name, v in want_s.items():      # each domain's rows moved
        assert v.shape[0] == 2, name
        for d in (0, 1):
            assert np.abs(v[d] - start[name][d]).max() > 1e-6, (name, d)


def test_st_step_refusals(reference):
    model = _port_model(reference[0], st_cfg())
    cfg = st_cfg()
    opt = toptim.build_optimizer(cfg.OPTIMIZATION, model.parameters())
    cfg.DATA_CONFIG_TAR.DATA_AUG.device = True    # elastic is post-mix
    cfg.DATA_CONFIG_TAR.DATA_PROCESSOR = CfgNode({'voxel_scale': 50})
    # the device augmentation draws from the step count, so it needs one
    with pytest.raises(ValueError, match='step count'):
        tmf.make_st_step(cfg, model, opt, CAPS, device='cpu')(
            st_points(st_batch(0)), st_points(st_batch(1)), 0.01, 1.0, 1.0)
    step = tmf.make_st_step(st_cfg(), model, opt, CAPS, device='cpu')
    model.eval()
    with pytest.raises(RuntimeError, match='train mode'):
        step(st_points(st_batch(0)), st_points(st_batch(1)), 0.01, 1.0, 1.0)


