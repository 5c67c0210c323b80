"""How ``correct`` is decided: the program's outputs from the timed path
against the plain reference's, number by number, each under its limit
(``limits/<workload>.json``).

Eval cells: the logits and predictions of a sample of the batches that
the window served, drawn from the seed, against the reference's float32
forward of the same batches. ``logit_rel_rms`` is the worst batch's
||program - reference|| / ||reference|| over the valid points' logits;
``pred_gap`` is the widest gap by which the reference's logit of a served
prediction lies below the reference's best, over the standard deviation
of the reference's logits.

Training cells: the program's first steps, driven in set-up through the
window's own call, against the reference's same steps from the same
weights on the same batches. ``loss_gap``: the worst relative gap of a
step's (term's) loss. ``grad_gap``, ``change_gap``, ``momentum_gap``,
``stats_gap``: by the worst leaf, the gap between the program's norm and
the reference's, over the larger of the reference's norm of that leaf
and of the median leaf, of the first step's gradient (the program's as
its optimizer got it: the first momentum trace less the weight decay),
of each parameter's change over the steps, of the momentum traces after
them, and of the running statistics' change; ``<name>.median`` is the
median leaf's gap of the same, a reading steadier from seed to seed.
Leaves whose reference gradient is under a thousandth of the median
leaf's move by round-off alone and are left out of the first three.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .reference.plan import build_plan
from .reference.sparse_unet import Net
from .reference.train import train_steps

TINY_GRAD = 1e-3


def valid_rows(batch: dict) -> np.ndarray:
    """Flat positions of a host batch's valid points, in the reference
    plan's order."""
    return np.flatnonzero(batch['valid'].reshape(-1))


def eval_reference(net: Net, weights: dict, batch: dict, domain: int,
                   device) -> torch.Tensor:
    """The reference's logits at the batch's valid points, float32."""
    with torch.no_grad():
        t = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
        plan = build_plan(t['coords'], t['valid'], net.levels)
        return net.forward(weights, plan, t['feats'], domain)


def eval_numbers(served: list, reference: list) -> dict:
    """served: (logits, preds) at the valid points of each checked batch;
    reference: its logits there."""
    rel, gap = 0.0, 0.0
    for (logits, preds), ref in zip(served, reference):
        logits = torch.as_tensor(logits, device=ref.device).float()
        preds = torch.as_tensor(preds, device=ref.device).long()
        rel = max(rel, float((logits - ref).norm() / ref.norm()))
        best = ref.max(1).values
        got = ref.gather(1, preds[:, None].clamp(0, ref.shape[1] - 1))[:, 0]
        bad = (preds < 0) | (preds >= ref.shape[1])
        g = torch.where(bad, torch.inf, best - got).max()
        gap = max(gap, float(g / ref.std()))
    return {'logit_rel_rms': rel, 'pred_gap': gap}


def _norms(d: dict) -> dict:
    return {k: float(v.double().norm()) for k, v in d.items()}


def leaf_gaps(program: dict, reference: dict, keep) -> dict:
    """Each leaf's |norm(program) - norm(reference)| over max(norm(
    reference), the median leaf's)."""
    p, r = _norms(program), _norms(reference)
    med = float(np.median([r[k] for k in keep]))
    out = {}
    for k in keep:
        den = max(r[k], med)
        gap = abs(p[k] - r[k]) / den if den > 0 else (
            0.0 if p[k] == 0 else math.inf)
        out[k] = gap if math.isfinite(p[k]) else math.inf
    return out


def _worst(program: dict, reference: dict, keep) -> tuple:
    """The worst leaf's gap and the median leaf's."""
    gaps = list(leaf_gaps(program, reference, keep).values())
    return max(gaps), float(np.median(gaps))


def train_reference(net: Net, weights: dict, steps, conf: dict,
                    device) -> dict:
    """The reference's run of ``steps`` (lists of (batch, domain,
    weight)) from ``weights``, at the configuration's SGD settings."""
    return train_steps(net, weights, steps, conf['base_lr'],
                       conf['momentum'], conf['weight_decay'],
                       conf['ignore_label'], device)


def train_numbers(program: dict, reference: dict, start: dict) -> dict:
    """program and reference as ``train_steps`` returns them; start: the
    weights both began from."""
    loss = 0.0
    for ps, rs in zip(program['losses'], reference['losses']):
        for p, r in zip(ps, rs):
            loss = max(loss, abs(p - r) / abs(r) if math.isfinite(p)
                       else math.inf)
    g_ref = _norms(reference['grad1'])
    med = float(np.median(list(g_ref.values())))
    keep = [k for k, v in g_ref.items() if v >= TINY_GRAD * med]
    dev = next(iter(reference['params'].values())).device

    def change(rec, group):
        return {k: rec[group][k].to(dev) - start[k].to(dev)
                for k in rec[group]}

    out = {'loss_gap': loss}
    for name, p, r, leaves in (
            ('grad_gap', program['grad1'], reference['grad1'], keep),
            ('change_gap', change(program, 'params'),
             change(reference, 'params'), keep),
            ('momentum_gap', program['momenta'], reference['momenta'], keep),
            ('stats_gap', change(program, 'stats'),
             change(reference, 'stats'), sorted(reference['stats']))):
        out[name], out[f'{name}.median'] = _worst(p, r, leaves)
    return out


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, {name: {'value', 'limit'}}) over the limited numbers."""
    out, ok = {}, True
    for name, limit in limits.items():
        value = numbers.get(name, math.inf)
        out[name] = {'value': value, 'limit': limit}
        ok &= bool(math.isfinite(value) and value <= limit)
    return ok, out
