"""A run with the timed path broken underneath comes out not correct:
a step that leaves its state unchanged, half the batch left out with the
mean over the rest, an answer altered where it is produced. (A cell of
one chip has no exchange between chips to leave out.) Tiny size, the
CPU, the harness's look for a card skipped."""

import json

import numpy as np
import pytest
import torch

from doda_tpu_torch.models import model_fn
from portbench import bench, controls
from portbench.manifest import HERE


def _unchanged(monkeypatch):
    monkeypatch.setattr(torch.optim.SGD, 'step', lambda self, *a, **k: None)


def _half_loss(monkeypatch):
    ce = model_fn.cross_entropy

    def half(logits, labels, ignore, *a, **k):
        labels = labels.clone()
        labels[labels.shape[0] // 2:] = ignore
        return ce(logits, labels, ignore, *a, **k)
    monkeypatch.setattr(model_fn, 'cross_entropy', half)


def _altered_loss(monkeypatch):
    finish = model_fn._finish

    def altered(model, optimizer, loss, *rest):
        return finish(model, optimizer, loss * 1.01, *rest)
    monkeypatch.setattr(model_fn, '_finish', altered)


def _half_eval(monkeypatch):
    outputs = model_fn.eval_outputs

    def half(cfg, logits, batch, thres=None):
        logits = logits.clone()
        logits[logits.shape[0] // 2:] = 0
        return outputs(cfg, logits, batch, thres)
    monkeypatch.setattr(model_fn, 'eval_outputs', half)


def _altered_pred(monkeypatch):
    outputs = model_fn.eval_outputs

    def altered(cfg, logits, batch, thres=None):
        out = outputs(cfg, logits, batch, thres)
        worst = logits[0, 0].argmin().to(out['preds'].dtype)
        out['preds'][0, 0] = worst
        return out
    monkeypatch.setattr(model_fn, 'eval_outputs', altered)


FAULTS = [('tiny.train', _unchanged), ('tiny.train', _half_loss),
          ('tiny.train', _altered_loss), ('tiny.st', _unchanged),
          ('tiny.st', _half_loss), ('tiny.st', _altered_loss),
          ('tiny.eval', _half_eval), ('tiny.eval', _altered_pred)]


@pytest.mark.parametrize('cell,fault', FAULTS,
                         ids=[f'{c}-{f.__name__[1:]}' for c, f in FAULTS])
def test_a_broken_step_is_not_correct(tiny, monkeypatch, cell, fault):
    fault(monkeypatch)
    r, _ = bench.run_cell(cell, 99, 0.2, False, device='cpu',
                         manifest=tiny)
    assert r['correct'] is False
    assert any(c['value'] > c['limit'] for c in r['check'].values())


@pytest.mark.parametrize('cell,real', [
    ('tiny.eval', 'scannet.eval.rooms_b4'),
    ('tiny.train', 'scannet.train.rooms_b4'),
    ('tiny.st', 'da_front3d_scannet.st.rooms_b4')])
def test_the_control_fails_the_cells_limits(tiny, cell, real):
    """The reference in float8 in the program's place, at the tiny size,
    fails one of the real cell's limits (on the chip it does at the
    cell's own size: ``test_portbench_card.py``)."""
    limits = json.loads((HERE / 'limits' / f'{real}.json').read_text())
    fails = 0
    for seed in (1, 2, 3):
        nums = controls.numbers(cell, seed, 'fp8', 'cpu', tiny)
        fails += any(nums[k] > v for k, v in limits.items())
    assert fails == 3
    assert np.isfinite(list(nums.values())).all()
