"""Shared set-up of the train-step tests (tests/test_torch_train*.py).

One 2-level, mid-16 float32 net with one block per level has every op kind
of the flagship: the cin = 3 input conv, identity blocks, ``tail0`` with
its 1x1 shortcut, down, up, the skip concat, train-mode norms and the
folded output norm. ``sm_max_cin=16`` gives a net this small the flagship's
mix of kernels: the 16 -> 16 convs of level 0 go to K2, the input conv and
the 32 -> 32 convs of level 1 to K1, and the 32 -> 16 conv of ``tail0``
runs K1 forward and K2 (16 -> 32) backward. Both sides start from the same
numpy weights and take two SGD steps (momentum, weight decay, a different
learning rate and batch per step).

The JAX side does not go through ``make_steps`` (whose compile takes
minutes on a CPU): the plan is built eagerly, ``jax.value_and_grad`` of the
loss over ``model.apply(..., train=True, mutable=['batch_stats'])`` is
jitted once with remat off and XLA's expensive passes disabled, and the
optax update is applied outside jit. The JAX convs run their default
engine; its engines agree to 1e-5. The batches and weights, the JAX steps
and the port's steps are each computed once a process.
"""

import functools

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


@functools.lru_cache(maxsize=None)
def _setup():
    """The two batches, their JAX plans, the flax model, its criterion and
    seeded numpy weights, made once a process."""
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
    return cfg, model, criterion, batches, plans, variables


@functools.lru_cache(maxsize=None)
def _reference():
    cfg, model, criterion, batches, plans, variables = _setup()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('DODA_REMAT', 'off')

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


@functools.lru_cache(maxsize=None)
def _port_run():
    batches, variables = _setup()[3], _setup()[5]
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

    def spy(x2, sm, w, cd, smc, nbr=None):
        engines.append(tb2d.uses_sm(w.shape[1], w.shape[2], smc))
        return raw(x2, sm, w, cd, smc, nbr)

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


@pytest.fixture(scope='module')
def variables():
    """The seeded starting weights of both sides (flax trees of numpy
    arrays)."""
    return _setup()[5]


@pytest.fixture(scope='module')
def reference():
    """Two JAX train steps, computed once a process: per step the loss,
    the metrics' valid count and the gradients; at the end params and
    batch_stats."""
    return _reference()


@pytest.fixture(scope='module')
def port_run():
    """The same two steps through the port's ``make_train_step``, from the
    same batches and weights, computed once a process."""
    return _port_run()


def _assert_trees_close(got, want, what):
    assert set(got) == set(want), what
    for name in want:
        scale = max(1.0, np.abs(want[name]).max())
        err = np.abs(got[name] - want[name]).max()
        assert err <= TOL * scale, f'{what} {name}: {err}'
