"""The PyTorch port's U-Net and eval step vs the JAX package.

One 3-level, mid-8 float32 net (identity blocks, the 1x1 shortcut of
``tail0``, down, up and the skip concat) gets the same random weights and
running statistics on both sides through ``params_from_jax``; its logits
must agree to 1e-3 (the bound of ``bench.py::kernel_check``). The eval
step's post-processing is held to the JAX formulas on one shared logits
array, and DSNorm's domain select at the norm itself.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from _torch_threads import two_threads  # noqa: F401
from doda_tpu.models import norm as jnorm
from doda_tpu.models import unet as junet
from doda_tpu.models.losses import cross_entropy as j_cross_entropy
from doda_tpu.utils.metrics import intersection_and_union as j_iou
from doda_tpu_torch.config import CfgNode
from doda_tpu_torch.models import model_fn as tmf
from doda_tpu_torch.models import norm as tnorm
from doda_tpu_torch.models import unet as tunet
from doda_tpu_torch.utils.convert import params_from_jax

N_CLASSES = 20
CAPS = junet.default_brick_caps(256, 3, floor=32)


@pytest.fixture(scope='module', autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _cfg():
    return CfgNode({
        'COMMON_CLASSES': {'n_classes': N_CLASSES},
        'MODEL': {'BACKBONE': {'use_xyz': False, 'in_channel': 3,
                               'mid_channel': 8, 'block_residual': True,
                               'block_reps': 1, 'num_levels': 3},
                  'dsnorm': False},
        'DATA_CONFIG': {'DATA_CLASS': {'ignore_label': 255,
                                       'n_classes': N_CLASSES}},
        'OPTIMIZATION': {'loss': 'cross_entropy'}})


def _random_variables(shapes, rng):
    """numpy weights for every leaf of the flax tree; the running stats
    and affine params are far from identity so eval norm does work."""
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


@pytest.fixture(scope='module')
def reference():
    """The JAX side, computed once: batch, variables and logits."""
    rng = np.random.default_rng(0)
    coords = rng.integers(0, 60, (2, 512, 3)).astype(np.int32)
    valid = np.zeros((2, 512), bool)
    valid[:, :400] = True
    feats = rng.normal(size=(2, 512, 3)).astype(np.float32)
    feats[~valid] = 0.0
    labels = rng.integers(0, N_CLASSES, (2, 512)).astype(np.int32)
    labels[~valid] = 255

    model = junet.SparseConvNet(mid_channel=8, num_levels=3, block_reps=1,
                                dtype=jnp.float32)
    plan = junet.build_level_plan(jnp.asarray(coords), jnp.asarray(valid),
                                  CAPS)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), feats, plan, train=False))
    variables = _random_variables(shapes, rng)
    logits = jax.jit(lambda v: model.apply(v, jnp.asarray(feats), plan,
                                           train=False))(variables)
    batch = tmf.PointBatch(coords=torch.from_numpy(coords),
                           feats=torch.from_numpy(feats),
                           labels=torch.from_numpy(labels),
                           valid=torch.from_numpy(valid))
    return batch, variables, np.asarray(logits)


@pytest.fixture(scope='module')
def port_model(reference):
    _, variables, _ = reference
    model = tmf.build_model(_cfg(), device='cpu', dtype=torch.float32)
    model.load_state_dict(params_from_jax(variables['params'],
                                          variables['batch_stats']),
                          strict=True)
    return model


def test_logits_match_jax(reference, port_model):
    batch, _, want = reference
    plan = tunet.build_level_plan(batch.coords, batch.valid, CAPS,
                                  device='cpu')
    with torch.no_grad():
        got = port_model(tmf.model_input(_cfg(), batch), plan).numpy()
    assert got.shape == want.shape == (2, 512, N_CLASSES)
    assert np.abs(got - want).max() <= 1e-3
    top2 = np.sort(want, axis=-1)[..., -2:]
    sure = (top2[..., 1] - top2[..., 0]) > 1e-3
    assert sure.mean() > 0.9
    np.testing.assert_array_equal(got.argmax(-1)[sure], want.argmax(-1)[sure])


def test_eval_step_runs_the_model(reference, port_model):
    batch, _, want = reference
    out = tmf.make_eval_step(_cfg(), port_model, CAPS, device='cpu')(batch)
    assert set(out) == {'loss', 'preds', 'labels', 'output', 'intersection',
                        'union', 'target', 'count', 'pseudo_labels',
                        'weight', 'confidence'}
    assert np.abs(out['output'].numpy() - want).max() <= 1e-3
    assert int(out['count']) == int(batch.valid.sum())


@pytest.mark.parametrize('thres', [None, 0.35, 'per_class'])
def test_eval_outputs_match_jax_formulas(reference, thres):
    batch, _, _ = reference
    rng = np.random.default_rng(4)
    logits = (rng.normal(size=(2, 512, N_CLASSES)) * 3).astype(np.float32)
    if thres == 'per_class':
        thres = np.linspace(0.1, 0.6, N_CLASSES).astype(np.float32)
    got = tmf.eval_outputs(_cfg(), torch.from_numpy(logits), batch, thres)

    valid = batch.valid.numpy()
    labels = np.where(valid, batch.labels.numpy(), 255)
    jl = jnp.asarray(logits)
    loss = j_cross_entropy(jl.reshape(-1, N_CLASSES),
                           jnp.asarray(labels).reshape(-1), 255)[0]
    preds = np.asarray(jnp.argmax(jl, -1).astype(jnp.int32))
    inter, union, target = j_iou(jnp.asarray(preds), jnp.asarray(labels),
                                 N_CLASSES, 255)
    conf = np.asarray(jnp.max(jax.nn.softmax(jl, axis=-1), axis=-1))
    t = np.zeros(N_CLASSES, np.float32) if thres is None else \
        np.broadcast_to(np.asarray(thres, np.float32), (N_CLASSES,))
    ok = (conf > t[preds]) & valid

    assert abs(float(got['loss']) - float(loss)) <= 1e-5
    np.testing.assert_array_equal(got['preds'].numpy(), preds)
    np.testing.assert_array_equal(got['labels'].numpy(), labels)
    for key, want in (('intersection', inter), ('union', union),
                      ('target', target)):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want))
    np.testing.assert_array_equal(got['pseudo_labels'].numpy(),
                                  np.where(ok, preds, 255))
    np.testing.assert_allclose(got['confidence'].numpy(), conf, rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(got['weight'].numpy(),
                               np.where(ok, conf, 0.0), rtol=0, atol=1e-6)
    if thres is not None:
        assert 0 < ok.sum() < valid.sum()   # the threshold really selects


def test_dsnorm_domain_selects_stats_row():
    rng = np.random.default_rng(9)
    c, rows = 8, 40
    x = rng.normal(size=(rows, 64 * c)).astype(np.float32)
    mask = rng.random((rows, 64)) < 0.4
    params = {'scale': (1 + rng.normal(0, 0.2, c)).astype(np.float32),
              'bias': rng.normal(0, 0.2, c).astype(np.float32)}
    stats = {'mean': rng.normal(0, 0.5, (2, c)).astype(np.float32),
             'var': rng.uniform(0.5, 1.5, (2, c)).astype(np.float32)}
    jmod = jnorm.MaskedBatchNorm(c, dsnorm=True)
    tmod = tnorm.MaskedBatchNorm(c, dsnorm=True).eval()
    tmod.load_state_dict({k: torch.from_numpy(v)
                          for k, v in {**params, **stats}.items()})
    outs = []
    for domain in (0, 1):
        want = np.asarray(jmod.apply({'params': params,
                                      'batch_stats': stats},
                                     jnp.asarray(x), jnp.asarray(mask),
                                     False, domain))
        got = tmod(torch.from_numpy(x), torch.from_numpy(mask),
                   domain).detach().numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        js, jb = jmod.apply({'params': params, 'batch_stats': stats},
                            jnp.asarray(x), jnp.asarray(mask), False, domain,
                            fold=True)
        ts, tb = tmod(torch.from_numpy(x), torch.from_numpy(mask), domain,
                      fold=True)
        np.testing.assert_allclose(ts.detach().numpy(), np.asarray(js),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(tb.detach().numpy(), np.asarray(jb),
                                   rtol=1e-6, atol=1e-6)
        outs.append(got)
    assert np.abs(outs[0] - outs[1]).max() > 0.1     # rows really differ
