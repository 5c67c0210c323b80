"""The general generator: a traffic file (``traffic/<name>.json``) of
parameters -> a pool of host batches, drawn from the seed.

A traffic file holds:
  step      'eval' (the eval step), 'train' (the train step) or 'st' (the
            self-training step: a source and a target batch a step)
  pool      distinct batches (or pairs) a run cycles through
  streams   the batches of one call, by stream: 'batch' for eval and
            train, 'source' and 'target' for st. Each gives scenes (rooms a
            batch), side_m [lo, hi] (room sides, spread evenly over the
            range and dealt out in an order drawn from the seed), n_cap
            (points a padded scene), ignore_share (labels set to ignore:
            0 for ground truth, the share below the threshold for
            pseudo-labels) and domain (the norms' domain)
  warmup    eval: calls before the window (every shape is warm after one)
  checked   train and st: the first steps, driven in set-up, that the
            reference follows
  sample    eval: batches of the window whose outputs are checked
  slice     calls profiled after the window in a traced run
"""

from __future__ import annotations

import numpy as np

from . import scenes

STREAMS = {'eval': ('batch',), 'train': ('batch',), 'st': ('source',
                                                           'target')}


def validate(traffic: dict) -> None:
    step = traffic['step']
    if step not in STREAMS:
        raise ValueError(f'traffic step {step!r} is none of {list(STREAMS)}')
    if tuple(traffic['streams']) != STREAMS[step]:
        raise ValueError(f'a {step} traffic has the streams '
                         f'{STREAMS[step]}, not {tuple(traffic["streams"])}')
    need = ('warmup', 'sample') if step == 'eval' else ('checked',)
    for key in need + ('pool', 'slice'):
        if int(traffic[key]) < 1:
            raise ValueError(f'traffic {key} must be >= 1')
    if step != 'eval' and traffic['pool'] < traffic['checked']:
        raise ValueError('the checked steps need as many distinct batches')


def build_pool(traffic: dict, n_classes: int, seed: int) -> list:
    """``pool`` calls' inputs: each a dict stream -> host batch (numpy
    arrays coords, feats, labels, valid), the same for the same seed."""
    validate(traffic)
    rng = np.random.default_rng([int(seed), 0])
    pool = [{} for _ in range(traffic['pool'])]
    for name, st in traffic['streams'].items():
        per = int(st['scenes'])
        lo, hi = st['side_m']
        sides = scenes.room_sides(lo, hi, per * len(pool), rng)
        for i, item in enumerate(pool):
            item[name] = scenes.make_batch(
                rng, sides[i * per:(i + 1) * per], int(st['n_cap']),
                n_classes, float(st.get('ignore_share', 0.0)))
    return pool


def scenes_per_call(traffic: dict) -> int:
    return sum(int(st['scenes']) for st in traffic['streams'].values())
