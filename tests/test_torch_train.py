"""The port's train step as a whole vs the JAX package, two steps.

One 2-level, mid-16 float32 net with one block per level has every op kind
of the flagship: the cin = 3 input conv, identity blocks, ``tail0`` with
its 1x1 shortcut, down, up, the skip concat, train-mode norms and the
folded output norm. ``sm_max_cin=16`` gives a net this small the flagship's
mix of kernels: the 16 -> 16 convs of level 0 go to K2, the input conv and
the 32 -> 32 convs of level 1 to K1, and the 32 -> 16 conv of ``tail0``
runs K1 forward and K2 (16 -> 32) backward. Both sides start from the same
numpy weights and take two SGD steps (momentum, weight decay, a different
learning rate and batch per step); loss, gradients, updated parameters and
running statistics must agree to 1e-3, the bound of the eval logits in
tests/test_torch_model.py.

The JAX side does not go through ``make_steps`` (whose compile takes
minutes on a CPU): the plan is built eagerly, ``jax.value_and_grad`` of the
loss over ``model.apply(..., train=True, mutable=['batch_stats'])`` is
jitted once with remat off and XLA's expensive passes disabled, and the
optax update is applied outside jit. The JAX convs run their default
engine; its engines agree to 1e-5.
"""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from doda_tpu.models import model_fn as jmf
from doda_tpu.models import unet as junet
from doda_tpu.utils import optim as joptim
from doda_tpu_torch.config import CfgNode
from doda_tpu_torch.models import model_fn as tmf
from doda_tpu_torch.ops import bricks2d as tb2d
from doda_tpu_torch.utils import optim as toptim
from doda_tpu_torch.utils.convert import params_from_jax, params_to_jax

N_CLASSES = 20
LEVELS = 2
SM_MAX_CIN = 16
CAPS = junet.default_brick_caps(192, LEVELS, floor=32)
LRS = (0.05, 0.02)
TOL = 1e-3
FAST_COMPILE = {'xla_backend_optimization_level': 0,
                'xla_llvm_disable_expensive_passes': True}


def _cfg(loss='cross_entropy'):
    return CfgNode({
        'COMMON_CLASSES': {'n_classes': N_CLASSES},
        'MODEL': {'BACKBONE': {'use_xyz': False, 'in_channel': 3,
                               'mid_channel': 16, 'block_residual': True,
                               'block_reps': 1, 'num_levels': LEVELS},
                  'dsnorm': False},
        'DATA_CONFIG': {'DATA_CLASS': {'ignore_label': 255,
                                       'n_classes': N_CLASSES},
                        'DATA_AUG': {'enabled': True, 'device': False,
                                     'aug_list': ['scene_aug', 'elastic'],
                                     'elastic': {'enabled': True}}},
        'OPTIMIZATION': {'loss': loss, 'optim': 'sgd', 'base_lr': 0.05,
                         'momentum': 0.9, 'weight_decay': 1e-4}})


def _batch(seed):
    rng = np.random.default_rng(seed)
    coords = rng.integers(0, 44, (2, 384, 3)).astype(np.int32)
    valid = np.zeros((2, 384), bool)
    valid[:, :300] = True
    feats = rng.normal(size=(2, 384, 3)).astype(np.float32)
    labels = rng.integers(0, N_CLASSES, (2, 384)).astype(np.int32)
    labels[rng.random((2, 384)) < 0.1] = 255
    return coords, feats, labels, valid


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


@pytest.fixture(scope='module')
def reference():
    """Two JAX train steps, computed once: per step the loss, the metrics'
    valid count and the gradients; at the end params and batch_stats."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('DODA_REMAT', 'off')
        cfg = _cfg()
        model = jmf.build_model(cfg)
        model = model.clone(dtype=jnp.float32)
        criterion = jmf.make_criterion(cfg)
        batches = [_batch(s) for s in (0, 1)]
        build_plan = jax.jit(lambda c, v: junet.build_level_plan(c, v, CAPS))
        plans = [build_plan(jnp.asarray(b[0]), jnp.asarray(b[3]))
                 for b in batches]
        shapes = jax.eval_shape(lambda: model.init(
            jax.random.PRNGKey(0), batches[0][1], plans[0], train=False))
        variables = _random_variables(shapes, np.random.default_rng(0))

        def loss_fn(params, stats, plan, feats, labels):
            logits, upd = model.apply(
                {'params': params, 'batch_stats': stats}, feats, plan,
                train=True, domain=0, mutable=['batch_stats'])
            return criterion(logits, labels), upd['batch_stats']

        grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True),
                          compiler_options=FAST_COMPILE)
        tx = joptim.build_optimizer(cfg.OPTIMIZATION)
        params = jax.tree.map(jnp.asarray, variables['params'])
        stats = jax.tree.map(jnp.asarray, variables['batch_stats'])
        opt_state = tx.init(params)
        steps = []
        for (coords, feats, labels, valid), plan, lr in zip(batches, plans,
                                                            LRS):
            feats = jnp.where(valid[..., None], feats, 0.0)
            lab = jnp.where(valid, labels, 255)
            (loss, stats), grads = grad_fn(params, stats, plan, feats, lab)
            opt_state.hyperparams['learning_rate'] = jnp.asarray(
                lr, jnp.float32)
            upd, opt_state = tx.update(grads, opt_state, params)
            params = optax.apply_updates(params, upd)
            steps.append({'loss': float(loss), 'grads': dict(_flat(grads)),
                          'count': int((np.asarray(lab) != 255).sum())})
    return batches, variables, steps, dict(_flat(params)), dict(_flat(stats))


@pytest.fixture(scope='module')
def port_run(reference):
    """The same two steps through the port's ``make_train_step``."""
    batches, variables, _, _, _ = reference
    cfg = _cfg()
    model = tmf.build_model(cfg, device='cpu', dtype=torch.float32,
                            sm_max_cin=SM_MAX_CIN, train=True)
    model.load_state_dict(params_from_jax(variables['params'],
                                          variables['batch_stats']),
                          strict=True)
    opt = toptim.build_optimizer(cfg.OPTIMIZATION, model.parameters())
    step = tmf.make_train_step(cfg, model, opt, CAPS, device='cpu')
    engines = []
    raw = tb2d._subm_raw

    def spy(x2, halo, sm, w, cd, smc):
        engines.append(tb2d.uses_sm(w.shape[1], w.shape[2], smc))
        return raw(x2, halo, sm, w, cd, smc)

    steps = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tb2d, '_subm_raw', spy)
        for (coords, feats, labels, valid), lr in zip(batches, LRS):
            batch = tmf.PointBatch(*(torch.from_numpy(a) for a in
                                     (coords, feats, labels, valid)))
            metrics = step(batch, lr)
            grads, _ = params_to_jax({n: p.grad for n, p in
                                      model.named_parameters()})
            steps.append({'metrics': metrics, 'grads': dict(_flat(grads))})
    params, stats = params_to_jax(model.state_dict())
    return model, steps, dict(_flat(params)), dict(_flat(stats)), engines


def _assert_trees_close(got, want, what):
    assert set(got) == set(want), what
    for name in want:
        scale = max(1.0, np.abs(want[name]).max())
        err = np.abs(got[name] - want[name]).max()
        assert err <= TOL * scale, f'{what} {name}: {err}'


@pytest.mark.parametrize('i', [0, 1])
def test_loss_and_metrics(reference, port_run, i):
    want, got = reference[2][i], port_run[1][i]['metrics']
    assert set(got) == {'loss', 'intersection', 'union', 'target', 'count'}
    assert abs(float(got['loss']) - want['loss']) <= TOL * want['loss']
    assert int(got['count']) == want['count'] == int(got['target'].sum())
    assert got['intersection'].shape == (N_CLASSES,)
    assert not got['loss'].requires_grad


@pytest.mark.parametrize('i', [0, 1])
def test_gradients(reference, port_run, i):
    want, got = reference[2][i]['grads'], port_run[1][i]['grads']
    assert max(np.abs(v).max() for v in want.values()) > 1e-2
    _assert_trees_close(got, want, f'step {i} gradient')


def test_updated_parameters_and_running_statistics(reference, port_run):
    _, variables, _, want_p, want_s = reference
    _, _, got_p, got_s, _ = port_run
    _assert_trees_close(got_p, want_p, 'parameter')
    _assert_trees_close(got_s, want_s, 'running statistic')
    start = {**dict(_flat(variables['params'])),
             **dict(_flat(variables['batch_stats']))}
    for name, v in {**want_p, **want_s}.items():    # everything moved
        assert np.abs(v - start[name]).max() > 1e-6, name


def test_both_engines_ran_forward_and_backward(port_run):
    """Per step: 1 input conv + 2 levels x 2 + 1 tail x 2 = 7 forward
    convs, 3 of them on K2, and 6 dx convs (the input conv's is skipped),
    4 of them on K2."""
    engines = port_run[4]
    assert len(engines) == 2 * (7 + 6)
    fwd, bwd = engines[:7], engines[7:13]
    assert sum(fwd) == 3 and sum(bwd) == 4, (fwd, bwd)


def test_state_dict_round_trip(reference, port_run):
    variables = reference[1]
    sd = params_from_jax(variables['params'], variables['batch_stats'])
    params, stats = params_to_jax(sd)
    back = params_from_jax(params, stats)
    assert set(back) == set(sd) == set(port_run[0].state_dict())
    for name in sd:
        assert torch.equal(back[name], sd[name]), name


def test_train_step_refusals(port_run):
    model = port_run[0]
    cfg = _cfg()
    opt = toptim.build_optimizer(cfg.OPTIMIZATION, model.parameters())
    cfg.DATA_CONFIG.DATA_AUG.device = True
    with pytest.raises(NotImplementedError, match='data-path'):
        tmf.make_train_step(cfg, model, opt, CAPS, device='cpu')
    step = tmf.make_train_step(_cfg(), model, opt, CAPS, device='cpu')
    batch = tmf.PointBatch(*(torch.from_numpy(a) for a in _batch(0)))
    model.eval()
    try:
        with pytest.raises(RuntimeError, match='train mode'):
            step(batch, 0.01)
    finally:
        model.train()


def test_lovasz_train_step_moves_the_weights():
    cfg = _cfg('lovasz')
    torch.manual_seed(0)
    model = tmf.build_model(cfg, device='cpu', dtype=torch.float32,
                            sm_max_cin=SM_MAX_CIN, train=True)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt = toptim.build_optimizer(cfg.OPTIMIZATION, model.parameters())
    step = tmf.make_train_step(cfg, model, opt, CAPS, device='cpu')
    out = step(tmf.PointBatch(*(torch.from_numpy(a) for a in _batch(3))),
               0.05)
    assert torch.isfinite(out['loss']) and 0 < float(out['loss']) <= 1
    assert all((p.detach() != before[n]).any()
               for n, p in model.named_parameters())
