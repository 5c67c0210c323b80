"""Training steps of the reference: the loss's gradient by autograd and
torch's SGD update written out.

One step sums the gradients of its terms (a train step: one batch on
domain 0, weight 1; a self-training step: the source batch on domain 0,
then the target batch on domain 1, each loss times its weight), then
updates every parameter: d = g + weight_decay * p; the momentum trace
b = d at the first step and momentum * b + d after; p -= lr * b. The
running statistics move in the forwards, in the terms' order.
"""

from __future__ import annotations

import torch

from .plan import build_plan
from .sparse_unet import Net, cross_entropy


def train_steps(net: Net, weights: dict, steps, lr: float, momentum: float,
                weight_decay: float, ignore: int, device) -> dict:
    """Run ``steps``, each a list of terms (batch, domain, weight); a batch
    is a dict of host arrays (coords, feats, labels, valid). Returns the
    weighted loss of every term of every step (``losses``: a list a
    step), the first step's gradients (``grad1``), and after the last
    step the parameters, momentum traces and statistics (``params``,
    ``momenta``, ``stats``), every tensor by name."""
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in weights.items() if not Net.is_stat(k)}
    stats = {k: v.detach().clone() for k, v in weights.items()
             if Net.is_stat(k)}
    names = sorted(params)
    momenta, losses, grad1 = {}, [], None
    for i, terms in enumerate(steps):
        grads = {k: torch.zeros_like(params[k]) for k in names}
        step_losses = []
        for batch, domain, weight in terms:
            t = {k: torch.as_tensor(v, device=device)
                 for k, v in batch.items()}
            plan = build_plan(t['coords'], t['valid'], net.levels)
            logits = net.forward({**params, **stats}, plan, t['feats'],
                                 domain, stats)
            labels = t['labels'].reshape(-1)[plan.points]
            loss = weight * cross_entropy(logits, labels, ignore)
            got = torch.autograd.grad(loss, [params[k] for k in names])
            for k, g in zip(names, got):
                grads[k] += g
            step_losses.append(float(loss.detach()))
            del plan, logits, loss, got
        losses.append(step_losses)
        if i == 0:
            grad1 = {k: g.clone() for k, g in grads.items()}
        with torch.no_grad():
            for k in names:
                d = grads[k] + weight_decay * params[k]
                momenta[k] = d.clone() if i == 0 \
                    else momentum * momenta[k] + d
                params[k] -= lr * momenta[k]
    return {'losses': losses, 'grad1': grad1,
            'params': {k: v.detach() for k, v in params.items()},
            'momenta': momenta, 'stats': stats}
