"""The optimizers and schedules of the PyTorch port vs optax: three
updates to 1e-6, schedules to 1e-7 (float64 here, float32 there).
"""

import numpy as np
import jax.numpy as jnp
import optax
import pytest
import torch

from _torch_threads import two_threads  # noqa: F401
from _torch_norm_loss_optim_common import _t
from doda_tpu.utils import optim as joptim
from doda_tpu_torch.config import CfgNode
from doda_tpu_torch.utils import optim as toptim


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
