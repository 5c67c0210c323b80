"""Train-mode norm of the PyTorch port vs the JAX package (flax) on
shared numpy inputs: output and gradients to 1e-5, running statistics to
1e-6 (float32 sums in another order); and the unknown names of norms,
losses and optimizers raise.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from _torch_threads import two_threads  # noqa: F401
from _torch_norm_loss_optim_common import _t
from doda_tpu.models import norm as jnorm
from doda_tpu_torch.config import CfgNode
from doda_tpu_torch.models import norm as tnorm
from doda_tpu_torch.utils import optim as toptim


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


def test_unknown_names_raise():
    with pytest.raises(NotImplementedError):
        toptim.build_optimizer(CfgNode({'optim': 'lamb', 'base_lr': 0.1}), [])
    with pytest.raises(NotImplementedError):
        toptim.make_lr_fn(CfgNode({'lr_decay': 'exp', 'base_lr': 0.1}), 1, 1)
