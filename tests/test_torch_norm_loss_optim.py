"""Train-mode norm, the losses, the optimizers and the schedules of the
PyTorch port vs the JAX package (flax, optax), on shared numpy inputs.

Tolerances: norm output and gradients 1e-5, running statistics 1e-6 (float32
sums in another order); loss values and gradients 1e-5; ``soft_to_hard_labels``
exact on a shared uniform draw; three optimizer updates 1e-6; schedules
1e-7 (float64 here, float32 there).
"""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from doda_tpu.models import losses as jlosses
from doda_tpu.models import norm as jnorm
from doda_tpu.utils import optim as joptim
from doda_tpu_torch.config import CfgNode
from doda_tpu_torch.models import losses as tlosses
from doda_tpu_torch.models import model_fn as tmf
from doda_tpu_torch.models import norm as tnorm
from doda_tpu_torch.utils import optim as toptim


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


# ---------------------------------------------------------------- norm ----

@pytest.mark.parametrize('dsnorm,domain,affine,fold', [
    (False, 0, True, False), (True, 1, True, False), (True, 0, True, True),
    (False, 0, False, False)])
def test_masked_batch_norm_train(dsnorm, domain, affine, fold):
    rng = np.random.default_rng(9 + domain)
    c, rows = 8, 40
    x = rng.normal(0.5, 2.0, size=(rows, 64 * c)).astype(np.float32)
    mask = rng.random((rows, 64)) < 0.4
    cot = rng.normal(size=x.shape).astype(np.float32)
    nd = 2 if dsnorm else 1
    params = {'scale': (1 + rng.normal(0, 0.2, c)).astype(np.float32),
              'bias': rng.normal(0, 0.2, c).astype(np.float32)} \
        if affine else {}
    stats = {'mean': rng.normal(0, 0.5, (nd, c)).astype(np.float32),
             'var': rng.uniform(0.5, 1.5, (nd, c)).astype(np.float32)}
    jmod = jnorm.MaskedBatchNorm(c, dsnorm=dsnorm, affine=affine)
    jstats0 = {k: jnp.asarray(v) for k, v in stats.items()}

    def jfn(p, xx):
        out, upd = jmod.apply({'params': p, 'batch_stats': jstats0}, xx,
                              jnp.asarray(mask), True, domain, fold,
                              mutable=['batch_stats'])
        if fold:
            val = (out[0] * jnp.arange(1, c + 1)).sum() + out[1].sum()
        else:
            val = (out * jnp.asarray(cot)).sum()
        return val, (out, upd['batch_stats'])

    (_, (jout, jstats)), (jgp, jgx) = jax.value_and_grad(
        jfn, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))

    tmod = tnorm.MaskedBatchNorm(c, dsnorm=dsnorm, affine=affine).train()
    tmod.load_state_dict({k: _t(v) for k, v in {**params, **stats}.items()})
    tx = _t(x, True)
    tout = tmod(tx, _t(mask), domain, fold=fold)
    if fold:
        val = (tout[0] * torch.arange(1, c + 1)).sum() + tout[1].sum()
        for got, want in zip(tout, jout):
            np.testing.assert_allclose(got.detach().numpy(),
                                       np.asarray(want), rtol=1e-5,
                                       atol=1e-5)
    else:
        val = (tout * _t(cot)).sum()
        np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                                   rtol=1e-5, atol=1e-5)
        assert (tout.detach().numpy()[~np.repeat(mask, c, 1)] == 0).all()
    val.backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), rtol=1e-5,
                               atol=1e-5)
    for name in params:
        np.testing.assert_allclose(getattr(tmod, name).grad.numpy(),
                                   np.asarray(jgp[name]), rtol=1e-5,
                                   atol=1e-5)
    for name in ('mean', 'var'):
        got = getattr(tmod, name).numpy()
        np.testing.assert_allclose(got, np.asarray(jstats[name]), rtol=1e-6,
                                   atol=1e-6)
        assert np.abs(got[domain if dsnorm else 0]
                      - stats[name][domain if dsnorm else 0]).max() > 1e-3
        if dsnorm:                       # the other domain's row is untouched
            np.testing.assert_array_equal(got[1 - domain],
                                          stats[name][1 - domain])


def test_masked_batch_norm_empty_mask_keeps_count_at_one():
    c = 4
    x = np.ones((3, 64 * c), np.float32)
    mask = np.zeros((3, 64), bool)
    jmod = jnorm.MaskedBatchNorm(c)
    stats = {'mean': jnp.zeros((1, c)), 'var': jnp.ones((1, c))}
    params = {'scale': jnp.ones(c), 'bias': jnp.zeros(c)}
    _, upd = jmod.apply({'params': params, 'batch_stats': stats},
                        jnp.asarray(x), jnp.asarray(mask), True,
                        mutable=['batch_stats'])
    tmod = tnorm.MaskedBatchNorm(c).train()
    out = tmod(_t(x), _t(mask))
    assert torch.isfinite(out).all() and (out == 0).all()
    for name in ('mean', 'var'):
        np.testing.assert_allclose(getattr(tmod, name).numpy(),
                                   np.asarray(upd['batch_stats'][name]),
                                   rtol=1e-6, atol=1e-6)


# -------------------------------------------------------------- losses ----

@pytest.fixture(scope='module')
def points():
    rng = np.random.default_rng(4)
    n, k = 700, 13
    logits = (rng.normal(size=(n, k)) * 2).astype(np.float32)
    labels = rng.integers(0, k - 2, n).astype(np.int32)   # 2 classes absent
    labels[rng.random(n) < 0.2] = 255
    return logits, labels


def test_lovasz_softmax(points):
    logits, labels = points
    want, jg = jax.value_and_grad(
        lambda l: jlosses.lovasz_softmax(l, jnp.asarray(labels), 255))(
            jnp.asarray(logits))
    tl = _t(logits, True)
    got = tlosses.lovasz_softmax(tl, _t(labels), 255)
    got.backward()
    assert abs(got.item() - float(want)) <= 1e-5
    np.testing.assert_allclose(tl.grad.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-5)
    assert np.abs(tl.grad.numpy()[labels == 255]).max() == 0


@pytest.mark.parametrize('explicit_valid', [False, True])
def test_soft_cross_entropy(points, explicit_valid):
    logits, _ = points
    rng = np.random.default_rng(6)
    soft = rng.dirichlet(np.ones(logits.shape[1]),
                         len(logits)).astype(np.float32)
    soft[rng.random(len(logits)) < 0.3] = 0.0
    valid = (rng.random(len(logits)) < 0.7) if explicit_valid else None
    jv = None if valid is None else jnp.asarray(valid)
    want, jg = jax.value_and_grad(lambda l: jlosses.soft_cross_entropy(
        l, jnp.asarray(soft), jv))(jnp.asarray(logits))
    tl = _t(logits, True)
    got = tlosses.soft_cross_entropy(tl, _t(soft),
                                     None if valid is None else _t(valid))
    got.backward()
    assert abs(got.item() - float(want)) <= 1e-5
    np.testing.assert_allclose(tl.grad.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-5)


def test_soft_to_hard_labels_on_a_shared_draw():
    rng = np.random.default_rng(8)
    soft = rng.dirichlet(np.ones(9), 500).astype(np.float32)
    soft[::7] = 0.0
    key = jax.random.PRNGKey(3)
    u = np.asarray(jax.random.uniform(key, (500, 1)))
    want = np.asarray(jlosses.soft_to_hard_labels(jnp.asarray(soft), key))
    got = tlosses.soft_to_hard_labels(_t(soft), uniform=_t(u))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[::7] == 255).all() and len(np.unique(want)) > 5
    # without the draw it comes from an explicit generator, reproducibly
    a, b = (tlosses.soft_to_hard_labels(
        _t(soft), generator=torch.Generator().manual_seed(5))
        for _ in range(2))
    assert torch.equal(a, b) and (a[::7] == 255).all()
    with pytest.raises(ValueError, match='Generator'):
        tlosses.soft_to_hard_labels(_t(soft))


@pytest.mark.parametrize('kind', ['cross_entropy', 'lovasz'])
def test_criteria_from_cfg(points, kind):
    logits, labels = points
    cfg = CfgNode({'OPTIMIZATION': {'loss': kind},
                   'COMMON_CLASSES': {'n_classes': logits.shape[1]},
                   'DATA_CONFIG': {'DATA_CLASS': {
                       'ignore_label': 255, 'n_classes': logits.shape[1]}}})
    want = float(jlosses.build_criterion(cfg)(jnp.asarray(logits),
                                              jnp.asarray(labels)))
    assert abs(float(tlosses.build_criterion(cfg)(_t(logits), _t(labels)))
               - want) <= 1e-5
    # the step's criterion takes batched (B, N, C) logits
    got = tmf.make_criterion(cfg)(_t(logits).reshape(2, 350, -1),
                                  _t(labels).reshape(2, 350))
    assert abs(float(got) - want) <= 1e-5


# ---------------------------------------------------- optimizers, lr ----

@pytest.mark.parametrize('kind', ['sgd', 'adam', 'adamw'])
def test_three_updates_match_optax(kind):
    rng = np.random.default_rng(12)
    ocfg = CfgNode({'optim': kind, 'base_lr': 0.01, 'weight_decay': 1e-4,
                    'momentum': 0.9})
    params = {'a': rng.normal(size=(5, 3)).astype(np.float32),
              'b': rng.normal(size=(7,)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32)
              for k, v in params.items()} for _ in range(3)]
    lrs = [0.01, 0.02, 0.005]

    tx = joptim.build_optimizer(ocfg)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(_t(v)) for k, v in params.items()}
    opt = toptim.build_optimizer(ocfg, tp.values())
    for g, lr in zip(grads, lrs):
        state.hyperparams['learning_rate'] = jnp.asarray(lr, jnp.float32)
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                               state, jp)
        jp = optax.apply_updates(jp, upd)
        for group in opt.param_groups:
            group['lr'] = lr
        for k, p in tp.items():
            p.grad = _t(g[k])
        opt.step()
    for k in params:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-6)
        assert np.abs(tp[k].detach().numpy() - params[k]).max() > 1e-3


@pytest.mark.parametrize('decay', ['step', 'poly', 'cos'])
def test_lr_schedules(decay):
    ocfg = CfgNode({'lr_decay': decay, 'base_lr': 0.01, 'step_epoch': 3,
                    'multiplier': 0.5})
    jfn = joptim.make_lr_fn(ocfg, 10, 25)
    tfn = toptim.make_lr_fn(ocfg, 10, 25)
    seen = set()
    for epoch in range(1, 10):
        for it in (0, 7, 24):
            got = tfn(epoch, it)
            assert isinstance(got, float)
            assert abs(got - float(jfn(epoch, it))) <= 1e-7
            seen.add(round(got, 9))
    assert len(seen) > 2                       # the schedule really moves


def test_unknown_names_raise():
    with pytest.raises(NotImplementedError):
        toptim.build_optimizer(CfgNode({'optim': 'lamb', 'base_lr': 0.1}), [])
    with pytest.raises(NotImplementedError):
        toptim.make_lr_fn(CfgNode({'lr_decay': 'exp', 'base_lr': 0.1}), 1, 1)
