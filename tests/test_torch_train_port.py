"""The port's train step on the CPU: the state dict round trip through
the JAX parameter tree, the step's refusals, and a Lovasz step that moves
every weight (see tests/_torch_train_common.py).
"""

import pytest
import torch

from _torch_threads import two_threads  # noqa: F401
from _torch_train_common import port_run, variables  # noqa: F401
from _torch_train_common import _batch, _cfg, CAPS, SM_MAX_CIN
from doda_tpu_torch.config import CfgNode
from doda_tpu_torch.models import model_fn as tmf
from doda_tpu_torch.utils import optim as toptim
from doda_tpu_torch.utils.convert import params_from_jax, params_to_jax


def test_state_dict_round_trip(variables, port_run):
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
    cfg.DATA_CONFIG.DATA_PROCESSOR = CfgNode({'voxel_scale': 50})
    batch = tmf.PointBatch(*(torch.from_numpy(a) for a in _batch(0)))
    # the device augmentation draws from the step count, so it needs one
    with pytest.raises(ValueError, match='step count'):
        tmf.make_train_step(cfg, model, opt, CAPS, device='cpu')(batch,
                                                                 0.01)
    step = tmf.make_train_step(_cfg(), model, opt, CAPS, device='cpu')
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
