"""The losses of the PyTorch port vs the JAX package on shared numpy
inputs: values and gradients to 1e-5; ``soft_to_hard_labels`` exact on a
shared uniform draw.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from _torch_threads import two_threads  # noqa: F401
from _torch_norm_loss_optim_common import points  # noqa: F401
from _torch_norm_loss_optim_common import _t
from doda_tpu.models import losses as jlosses
from doda_tpu_torch.config import CfgNode
from doda_tpu_torch.models import losses as tlosses
from doda_tpu_torch.models import model_fn as tmf


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
