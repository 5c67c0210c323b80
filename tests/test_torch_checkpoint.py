"""The port's checkpoints: round trip, resume and auto-resume, rolling
deletion, ``strict``, and the DSNorm <-> plain-BN statistic adaptation,
held to the JAX package's loader on the same arrays (its msgpack format
beside the port's own)."""

import os

import numpy as np
import pytest
import torch

from _torch_threads import two_threads  # noqa: F401
from doda_tpu.utils import checkpoint as jckpt
from doda_tpu_torch import config as tconfig
from doda_tpu_torch.models import model_fn as tmf
from doda_tpu_torch.utils import checkpoint as tckpt
from doda_tpu_torch.utils import optim as toptim
from doda_tpu_torch.utils.convert import params_to_jax


def _model(cfg, seed=0, train=False):
    torch.manual_seed(seed)
    return tmf.build_model(cfg, device='cpu', dtype=torch.float32,
                           train=train)

# ---------------------------------------------------------------------------

def _net_cfg(dsnorm):
    cfg = tconfig.CfgNode({
        'COMMON_CLASSES': {'n_classes': 5},
        'MODEL': {'BACKBONE': {'in_channel': 3, 'mid_channel': 4,
                               'block_residual': True, 'block_reps': 1,
                               'num_levels': 2},
                  'dsnorm': dsnorm},
        'DATA_CONFIG': {'DATA_CLASS': {'n_classes': 5,
                                       'ignore_label': 255}},
        'OPTIMIZATION': {'optim': 'sgd', 'base_lr': 0.1, 'momentum': 0.9,
                         'weight_decay': 1e-4}})
    return cfg


def _moved(model, seed):
    """Every parameter and statistic away from its initial value."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for t in model.state_dict().values():
            t.add_(torch.rand(t.shape, generator=g))
    return model


def test_checkpoint_round_trip_resume_and_auto_resume(tmp_path):
    cfg = _net_cfg(True)
    model = _moved(_model(cfg, train=True), 1)
    opt = toptim.build_optimizer(cfg.OPTIMIZATION, model.parameters())
    for p in model.parameters():       # a momentum buffer to carry
        p.grad = torch.ones_like(p)
    opt.step()
    ckpt = tmp_path / 'ckpt'
    ckpt.mkdir()
    for epoch in (1, 2, 3, 10):
        tckpt.save_params(ckpt / f'train_epoch_{epoch}', model, opt, epoch,
                          step=7 * epoch)
    tckpt.save_params(ckpt / 'best_train', model, opt, 3, metric=0.25,
                      step=21)
    assert not list(ckpt.glob('*.tmp'))
    assert tckpt.auto_resume_path(ckpt).endswith('train_epoch_10')
    assert tckpt.load_metric_from_ckpt(ckpt / 'best_train') == (0.25, 3)
    fresh = _model(cfg, seed=5, train=True)
    fresh_opt = toptim.build_optimizer(cfg.OPTIMIZATION,
                                       fresh.parameters())
    epoch, step = tckpt.load_params_from_ckpt(
        tckpt.auto_resume_path(ckpt), fresh, fresh_opt)
    assert (epoch, step) == (10, 70)
    for name, t in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[name], t), name
    for p, q in zip(model.parameters(), fresh.parameters()):
        assert torch.equal(opt.state[p]['momentum_buffer'],
                           fresh_opt.state[q]['momentum_buffer'])
    tckpt.rolling_delete(ckpt, 3, 1)       # keeps the last two epochs
    assert not (ckpt / 'train_epoch_1').exists()
    assert (ckpt / 'train_epoch_2').exists()
    # the same lifecycle rules as the JAX package's
    assert os.path.basename(jckpt.auto_resume_path(ckpt)) == \
        'train_epoch_10'


def test_pretrain_strict(tmp_path):
    cfg = _net_cfg(False)
    model = _moved(_model(cfg), 1)
    path = tmp_path / 'w'
    tckpt.save_params(path, model, None, 1)
    wider = _net_cfg(False)
    wider.COMMON_CLASSES.n_classes = 7     # another head shape
    with pytest.raises(ValueError, match='shape mismatch at linear'):
        tckpt.load_params_from_pretrain(path, _model(wider), strict=True)
    other = _model(wider, seed=3)
    head = other.linear.weight.detach().clone()
    tckpt.load_params_from_pretrain(path, other, strict=False)
    assert torch.equal(other.linear.weight, head)        # kept init
    assert torch.equal(other.input_kernel, model.input_kernel)
    deeper = _net_cfg(False)
    deeper.MODEL.BACKBONE.num_levels = 3   # parameters the file lacks
    with pytest.raises(KeyError, match='missing key'):
        tckpt.load_params_from_pretrain(path, _model(deeper), strict=True)


@pytest.mark.parametrize('src_ds,dst_ds', [(False, True), (True, False)])
def test_pretrain_dsnorm_adaptation_matches_jax(tmp_path, src_ds, dst_ds):
    """A plain-BN checkpoint into a DSNorm net and back: the statistics
    adapt as the JAX loader adapts the same arrays."""
    from doda_tpu.models.model_fn import TrainState
    src = _moved(_model(_net_cfg(src_ds)), 1)
    dst = _moved(_model(_net_cfg(dst_ds), seed=2), 2)
    tckpt.save_params(tmp_path / 'port', src, None, 4, metric=0.5)

    def jax_state(model):
        params, stats = params_to_jax(model.state_dict())
        return TrainState(params=params, batch_stats=stats, opt_state={},
                          step=np.zeros((), np.int32))

    jckpt.save_params(str(tmp_path / 'jax'), jax_state(src), 4, metric=0.5)
    want = jckpt.load_params_from_pretrain(str(tmp_path / 'jax'),
                                           jax_state(dst), strict=True)
    tckpt.load_params_from_pretrain(tmp_path / 'port', dst, strict=True)
    params, stats = params_to_jax(dst.state_dict())
    for got, ref in ((params, want.params), (stats, want.batch_stats)):
        flat_got = dict(_flatten(got))
        flat_ref = dict(_flatten(ref))
        assert set(flat_got) == set(flat_ref)
        for name in flat_ref:
            np.testing.assert_array_equal(flat_got[name], flat_ref[name],
                                          name)
    mean = dst.unet.block0.MaskedBatchNorm_0.mean
    assert mean.shape[0] == (2 if dst_ds else 1)
    assert torch.equal(mean[-1], src.unet.block0.MaskedBatchNorm_0.mean[0])


def _flatten(tree, prefix=''):
    for k, v in tree.items():
        if hasattr(v, 'items'):
            yield from _flatten(v, f'{prefix}{k}.')
        else:
            yield f'{prefix}{k}', np.asarray(v)
