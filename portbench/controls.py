"""The readings that set a cell's limits, besides the program's own:
the control, the reference put in the program's place one precision
below the configuration's (bf16 -> float8 e4m3: ``'fp8'``), the
reference with bf16 operands (``'bf16'``: a witness of what rounding to
the configuration's own type costs), and for a
training cell the fault of a step that leaves half its batch out and
takes the mean over the rest (``'half_batch'``), planted in the
reference put in the program's place. Each is compared with the float32
reference exactly as the program's outputs are (``check.py``). The
benchmark's own runs never run these.
"""

from __future__ import annotations

import numpy as np
import torch

from . import check, scenes
from . import traffic as traffic_mod
from .bench import load_net, terms
from .manifest import Manifest

MODES = ('fp8', 'bf16', 'half_batch')


def _half(batch: dict) -> dict:
    keep = batch['valid'].shape[0] // 2
    return {k: v[:keep] for k, v in batch.items()}


def numbers(workload: str, seed: int, mode: str, device='cuda',
            manifest: Manifest | None = None) -> dict:
    """The check's numbers with ``mode`` in the program's place."""
    man = manifest or Manifest()
    cell = man.cell(workload)
    conf = man.config(cell['config'])
    traffic = man.traffic(cell['traffic'])
    kind = traffic['step']
    dev = torch.device(device)
    pool = traffic_mod.build_pool(traffic, conf['n_classes'], seed)
    net = load_net(conf)
    weights = scenes.seeded_weights(net.names(), seed, dev)
    if kind == 'eval':
        if mode not in ('fp8', 'bf16'):
            raise ValueError(f'an eval cell has no {mode!r} reading')
        control = load_net(conf, mode)
        domain = traffic['streams']['batch']['domain']
        pick = np.random.default_rng([int(seed), 1])
        served, refs = [], []
        for idx in pick.choice(len(pool), traffic['sample'], replace=False):
            batch = pool[idx]['batch']
            logits = check.eval_reference(control, weights, batch, domain,
                                          dev)
            served.append((logits, logits.argmax(1)))
            refs.append(check.eval_reference(net, weights, batch, domain,
                                             dev))
        return check.eval_numbers(served, refs)
    steps = [terms(kind, conf, traffic, pool[k])
             for k in range(traffic['checked'])]
    if mode in ('fp8', 'bf16'):
        placed = check.train_reference(load_net(conf, mode), weights,
                                       steps, conf, dev)
    elif mode == 'half_batch':
        placed = check.train_reference(
            net, weights, [[(_half(b), d, w) for b, d, w in terms]
                           for terms in steps], conf, dev)
    else:
        raise ValueError(f'mode {mode!r} is none of {MODES}')
    ref = check.train_reference(net, weights, steps, conf, dev)
    return check.train_numbers(placed, ref, weights)
