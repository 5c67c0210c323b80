"""Checkpoint import: the JAX package's msgpack files and converted
reference ``.pth`` files in the port (``doda_tpu_torch/utils/
{flax_msgpack,checkpoint}.py``, ``doda_tpu_torch/tools/convert_torch_ckpt.py``),
held to the JAX package's writer, converter and loader."""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from _torch_threads import two_threads  # noqa: F401
from test_convert import fake_reference_sd
from doda_tpu.models import unet as junet
from doda_tpu.models.model_fn import TrainState
from doda_tpu.utils import checkpoint as jckpt
from doda_tpu.utils.optim import build_optimizer as jbuild_optimizer
from doda_tpu_torch.config import CfgNode
from doda_tpu_torch.models import model_fn as tmf
from doda_tpu_torch.models import unet as tunet
from doda_tpu_torch.tools import convert_torch_ckpt as tconvert
from doda_tpu_torch.utils import checkpoint as tckpt
from doda_tpu_torch.utils import flax_msgpack
from doda_tpu_torch.utils import optim as toptim
from doda_tpu_torch.utils.convert import params_from_jax, params_to_jax

CAPS = junet.default_brick_caps(256, 3, floor=32)
LR, MOMENTUM, WD = 0.05, 0.9, 1e-4
CFG_YAML = '''
COMMON_CLASSES: {n_classes: 5}
MODEL:
  BACKBONE: {use_xyz: False, in_channel: 3, mid_channel: 4,
             block_residual: True, block_reps: %d, num_levels: %d}
  dsnorm: %s
DATA_CONFIG:
  DATA_CLASS: {ignore_label: 255, n_classes: 5}
OPTIMIZATION: {optim: sgd, base_lr: 0.05, momentum: 0.9,
               weight_decay: 0.0001, loss: cross_entropy}
'''


def _cfg(dsnorm=False, reps=2, levels=3):
    return CfgNode({
        'COMMON_CLASSES': {'n_classes': 5},
        'MODEL': {'BACKBONE': {'use_xyz': False, 'in_channel': 3,
                               'mid_channel': 4, 'block_residual': True,
                               'block_reps': reps, 'num_levels': levels},
                  'dsnorm': dsnorm},
        'DATA_CONFIG': {'DATA_CLASS': {'ignore_label': 255,
                                       'n_classes': 5}},
        'OPTIMIZATION': {'optim': 'sgd', 'base_lr': LR, 'momentum': MOMENTUM,
                         'weight_decay': WD, 'loss': 'cross_entropy'}})


def _model(dsnorm=False, seed=0, train=False, **net):
    torch.manual_seed(seed)
    return tmf.build_model(_cfg(dsnorm, **net), device='cpu',
                           dtype=torch.float32, train=train)


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    coords = rng.integers(0, 40, (2, 256, 3)).astype(np.int32)
    valid = np.zeros((2, 256), bool)
    valid[:, :200] = True
    feats = rng.normal(size=(2, 256, 3)).astype(np.float32)
    feats[~valid] = 0.0
    labels = np.where(valid, rng.integers(0, 5, (2, 256)), 255)
    return tmf.PointBatch(*(torch.from_numpy(a) for a in
                            (coords, feats, labels.astype(np.int32), valid)))


def _logits(model, batch):
    plan = tunet.build_level_plan(batch.coords, batch.valid, CAPS, 'cpu')
    with torch.no_grad():
        return model.eval()(batch.feats, plan)


def _state(model, opt_state=None, step=0):
    """A JAX TrainState of the port model's weights."""
    params, stats = params_to_jax(model.state_dict())
    tx = jbuild_optimizer(_cfg().OPTIMIZATION)
    return TrainState(params=params, batch_stats=stats,
                      opt_state=opt_state or tx.init(params),
                      step=jnp.asarray(step, jnp.int32)), tx


def _trees_equal(a, b, path=''):
    if isinstance(b, dict):
        assert set(a) == set(b), path
        for k in b:
            _trees_equal(a[k], b[k], f'{path}/{k}')
    else:
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)


def test_jax_train_state_loads_weights_and_resumes_momentum(tmp_path):
    """A TrainState from ``doda_tpu.utils.checkpoint.save_params`` decodes
    to flax's own tree (and a bfloat16 leaf to flax's bytes and back); the
    weights-only load gives the logits of ``params_from_jax`` (1e-5), the
    full resume carries SGD's momentum trace, and one port step after it
    is the update computed in numpy from that trace."""
    src = _model(seed=1, train=True)
    state, tx = _state(src)
    # one optax update from made-up gradients: a non-zero trace
    grads = jax.tree.map(lambda p: jnp.full_like(p, 0.3), state.params)
    state.opt_state.hyperparams['learning_rate'] = jnp.asarray(LR)
    _, opt_state = tx.update(grads, state.opt_state, state.params)
    state = state.replace(opt_state=opt_state, step=jnp.asarray(7))
    path = tmp_path / 'jax_ckpt'
    jckpt.save_params(path, state, epoch=3, metric=0.25)
    blob = path.read_bytes()
    body = flax_msgpack.restore(blob[8 + int.from_bytes(blob[:8], 'little'):])
    _trees_equal(body, serialization.to_state_dict(
        jax.tree.map(np.asarray, state)))
    # bfloat16 by name, both ways, as flax writes and reads it
    bf = jnp.arange(6, dtype=jnp.bfloat16).reshape(2, 3) / 3
    tree = {'w': torch.from_numpy(np.asarray(bf, np.float32)).bfloat16(),
            'n': np.int32(3), 'flag': True}
    raw = flax_msgpack.serialize(tree)
    assert raw == serialization.msgpack_serialize(
        {'w': bf, 'n': np.int32(3), 'flag': True})
    back = flax_msgpack.restore(raw)
    assert torch.equal(back['w'], tree['w']) and back['n'] == 3

    batch = _batch()
    want = _model()
    want.load_state_dict(params_from_jax(state.params, state.batch_stats))
    got = tckpt.load_params_from_pretrain(path, _model(seed=5))
    assert (_logits(got, batch) - _logits(want, batch)).abs().max() <= 1e-5

    model = _model(seed=5, train=True)
    opt = toptim.build_optimizer(_cfg().OPTIMIZATION, model.parameters())
    assert tckpt.load_params_from_ckpt(path, model, opt) == (3, 7)
    trace = params_from_jax(
        body['opt_state']['inner_state']['1']['0']['trace'], {})
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    tmf.make_train_step(_cfg(), model, opt, CAPS, 'cpu')(batch, LR)
    for n, p in model.named_parameters():
        g, p0 = p.grad.numpy(), before[n].numpy()
        buf = MOMENTUM * trace[n].numpy() + g + WD * p0
        np.testing.assert_allclose(p.detach().numpy(), p0 - LR * buf,
                                   atol=1e-6, rtol=0, err_msg=n)
    # an optimizer whose state does not map raises
    adam = torch.optim.Adam(model.parameters())
    with pytest.raises(ValueError, match='cannot resume'):
        tckpt.load_params_from_ckpt(path, model, adam)


@pytest.mark.parametrize('dsnorm', [False, True])
def test_converters_write_the_same_file(tmp_path, dsnorm):
    """The port's converter and the JAX package's, on the same reference
    ``.pth``: the same bytes, so the same decoded tree."""
    src = tmp_path / 'ref.pth'
    torch.save({'epoch': 7, 'state_dict': {
        'module.' + k: v for k, v in fake_reference_sd(dsnorm=dsnorm).items()},
        'metric': 0.5, 'commit_id': 'abc1234'}, src)
    cfg_file = tmp_path / 'cfg.yaml'
    cfg_file.write_text(CFG_YAML % (2, 3, dsnorm))
    out = subprocess.run(
        [sys.executable, 'tools/convert_torch_ckpt.py', '--src', str(src),
         '--dst', str(tmp_path / 'jax'), '--cfg_file', str(cfg_file),
         '--flip_kernel'], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    tconvert.main(['--src', str(src), '--dst', str(tmp_path / 'port'),
                   '--cfg_file', str(cfg_file), '--flip_kernel'])
    jax_bytes = (tmp_path / 'jax').read_bytes()
    assert (tmp_path / 'port').read_bytes() == jax_bytes
    n = int.from_bytes(jax_bytes[:8], 'little')
    _trees_equal(flax_msgpack.restore(jax_bytes[8 + n:]),
                 serialization.msgpack_restore(jax_bytes[8 + n:]))
    assert tckpt.load_metric_from_ckpt(tmp_path / 'port') == (0.5, 7)


def test_port_converted_file_loads_in_jax(tmp_path):
    """A reference file converted by the port loads strictly in both
    packages, and their logits agree to 1e-5 of their size (the
    reference's random weights are unscaled: logits reach 1e5) on a
    2-level net, whose JAX forward compiles in a few seconds."""
    net = dict(reps=1, levels=2)
    src = tmp_path / 'ref.pth'
    torch.save({'epoch': 2, 'state_dict': fake_reference_sd(
        levels=2, reps=1)}, src)
    cfg_file = tmp_path / 'cfg.yaml'
    cfg_file.write_text(CFG_YAML % (1, 2, False))
    dst = tmp_path / 'conv'
    tconvert.main(['--src', str(src), '--dst', str(dst), '--cfg_file',
                   str(cfg_file)])
    batch = _batch(3)
    port = tckpt.load_params_from_pretrain(dst, _model(seed=2, **net))
    template, _ = _state(_model(seed=4, **net))
    state = jckpt.load_params_from_pretrain(str(dst), template, strict=True)
    model = junet.SparseConvNet(mid_channel=4, num_levels=2, block_reps=1,
                                n_classes=5, dtype=jnp.float32)
    plan = junet.build_level_plan(jnp.asarray(batch.coords.numpy()),
                                  jnp.asarray(batch.valid.numpy()), CAPS)
    want = jax.jit(lambda v: model.apply(v, jnp.asarray(batch.feats.numpy()),
                                         plan, train=False))(
        {'params': state.params, 'batch_stats': state.batch_stats})
    got, want = _logits(port, batch).numpy(), np.asarray(want)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_bn_and_dsnorm_statistics_adapt_both_ways(tmp_path):
    """A DSNorm file into a plain-BN model takes the source row; a plain
    file into a DSNorm model broadcasts its row; both as the JAX loader
    adapts them."""
    for file_ds, model_ds in ((True, False), (False, True)):
        src = tmp_path / f'ref{file_ds}.pth'
        torch.save(fake_reference_sd(dsnorm=file_ds), src)
        cfg_file = tmp_path / 'cfg.yaml'
        cfg_file.write_text(CFG_YAML % (2, 3, file_ds))
        dst = tmp_path / f'conv{file_ds}'
        tconvert.main(['--src', str(src), '--dst', str(dst), '--cfg_file',
                       str(cfg_file)])
        got = tckpt.load_params_from_pretrain(dst, _model(model_ds, 3))
        template, _ = _state(_model(model_ds, 4))
        want = jckpt.load_params_from_pretrain(str(dst), template)
        sd = params_from_jax(want.params, want.batch_stats)
        for name, t in got.state_dict().items():
            assert torch.equal(t, sd[name]), name
        row = got.unet.block0.MaskedBatchNorm_0.mean
        assert row.shape[0] == (2 if model_ds else 1)
