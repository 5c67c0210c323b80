"""The port's soft-label target loss vs the JAX package's pieces.

``soft_label_loss`` mirrors a closure of the JAX ``make_steps``
(``model_fn.py:203-237``) that cannot be called alone, so its three
branches are held to the JAX pieces it combines (``soft_cross_entropy``,
``soft_to_hard_labels``, ``cross_entropy``), combined here as that
closure does, to 1e-5; ``convert_to_hard``'s uniform draws are the port
generator's, handed to the JAX piece. One self-training step with soft
targets shows ``make_st_step`` takes that loss for its target term.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import two_threads  # noqa: F401
from _torch_st_common import (CAPS, N_CLASSES, W_SRC, W_TAR, st_batch,
                              st_cfg, st_points)
from doda_tpu.models import losses as jlosses
from doda_tpu_torch.models import model_fn as tmf
from doda_tpu_torch.utils import optim as toptim


def _soft_case(seed, n_classes=5, n=600):
    """Logits, soft labels (a third one-hot, a third mixes, a third
    empty), and a valid mask with padding."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(2, n, n_classes)).astype(np.float32)
    soft = rng.dirichlet(np.ones(n_classes), (2, n)).astype(np.float32)
    kind = rng.integers(0, 3, (2, n))
    soft[kind == 0] = np.eye(n_classes, dtype=np.float32)[
        soft[kind == 0].argmax(-1)]
    soft[kind == 2] = 0.0
    valid = np.ones((2, n), bool)
    valid[:, n - 50:] = False
    return logits, soft, valid


def _jax_soft_label_loss(sl, logits, soft, valid, key, ignore=255):
    """The JAX ``soft_label_loss`` closure (doda_tpu/models/model_fn.py:
    203-237), line for line, on the JAX pieces."""
    n_classes = logits.shape[-1]
    flat_logits = jnp.asarray(logits).reshape(-1, n_classes)
    soft = jnp.asarray(soft).reshape(-1, n_classes)
    has_label = (soft.sum(-1) > 0) & jnp.asarray(valid).reshape(-1)
    top1_conf = soft.max(-1)
    top1 = jnp.argmax(soft, -1).astype(jnp.int32)
    hard_mask = has_label & (top1_conf >= 1.0 - 1e-6)
    if sl.get('convert_to_hard', False):
        sampled = jlosses.soft_to_hard_labels(soft, key, ignore)
        hard_loss = jlosses.cross_entropy(
            flat_logits, jnp.where(hard_mask, sampled, ignore), ignore)[0]
        soft_loss = jlosses.cross_entropy(
            flat_logits, jnp.where(has_label & ~hard_mask, sampled, ignore),
            ignore)[0]
    elif sl.get('thres', {}).get('enabled', False):
        hard_loss = jlosses.cross_entropy(
            flat_logits, jnp.where(hard_mask, top1, ignore), ignore)[0]
        soft_loss = jlosses.soft_cross_entropy(flat_logits, soft,
                                               has_label & ~hard_mask)
    else:
        hard_loss = jnp.float32(0.0)
        soft_loss = jlosses.soft_cross_entropy(flat_logits, soft, has_label)
    return hard_loss + soft_loss, hard_loss, soft_loss


SOFT_MODES = {'plain': {'enabled': True},
              'thres': {'enabled': True, 'thres': {'enabled': True}},
              'hard': {'enabled': True, 'convert_to_hard': True}}


@pytest.mark.parametrize('mode', sorted(SOFT_MODES))
def test_soft_label_loss_matches_jax_pieces(mode, monkeypatch):
    cfg = st_cfg(SOFT_MODES[mode])
    cfg.COMMON_CLASSES.n_classes = 5
    logits, soft, valid = _soft_case(3)
    gen = torch.Generator().manual_seed(11)
    # the port's draws, one per row, handed to the JAX piece
    draws = torch.rand((soft.shape[0] * soft.shape[1], 1),
                       generator=torch.Generator().manual_seed(11))
    monkeypatch.setattr(jax.random, 'uniform',
                        lambda key, shape: jnp.asarray(draws.numpy()))
    got = tmf.soft_label_loss(cfg, torch.from_numpy(logits),
                              torch.from_numpy(soft),
                              torch.from_numpy(valid), gen)
    want = _jax_soft_label_loss(cfg.SOFT_LABEL, logits, soft, valid,
                                jax.random.PRNGKey(0))
    for g, w, what in zip(got, want, ('total', 'hard', 'soft')):
        assert abs(float(g) - float(w)) <= 1e-5 * max(1.0, abs(float(w))), \
            (what, float(g), float(w))
    assert float(got[2]) > 0
    if mode != 'plain':
        assert float(got[1]) > 0


def test_st_step_soft_target_term():
    """With SOFT_LABEL on and ``tar_soft`` given, the target term is
    ``soft_label_loss`` (``convert_to_hard`` draws from the generator)."""
    cfg = st_cfg(SOFT_MODES['hard'])
    torch.manual_seed(0)
    model = tmf.build_model(cfg, device='cpu', dtype=torch.float32,
                            sm_max_cin=16, train=True)
    opt = toptim.build_optimizer(cfg.OPTIMIZATION, model.parameters())
    step = tmf.make_st_step(cfg, model, opt, CAPS, device='cpu')
    rng = np.random.default_rng(5)
    soft = rng.dirichlet(np.ones(N_CLASSES), (2, 384)).astype(np.float32)
    src, tar = st_points(st_batch(0)), st_points(st_batch(1))
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    m = step(src, tar, 0.01, W_SRC, W_TAR, tar_soft=torch.from_numpy(soft),
             generator=torch.Generator().manual_seed(1))
    assert np.isfinite(float(m['loss_u'])) and float(m['loss_u']) > 0
    assert any(not torch.equal(p, before[n])
               for n, p in model.named_parameters())
    with pytest.raises(ValueError, match='Generator'):
        step(src, tar, 0.01, W_SRC, W_TAR, tar_soft=torch.from_numpy(soft))
