"""Whether, and how fast, the flagship's train step fits a batch under a
memory policy.

    python -m doda_tpu_torch.tools.probe_train_mem [--batch N] [--remat P]
                                                   [--device cuda|cpu]

from the repo root; the counterpart of the JAX package's root
``tools/probe_train_mem.py``. Builds the flagship (cfgs/scannet/spconv.yaml:
mid 16, 7 levels, 20 classes) in bf16 with seeded weights and ``remat`` P
(``build_model``'s memory policy: off, dots, all, mix or mixN), takes one
warm-up train step on N bench scenes (``utils/synth.py::make_batch``: ~150k
points each, brick caps ``default_brick_caps(40960, 7)``) and then
``--steps`` (5) timed ones. Prints one JSON line: the card's name and power
limit, seconds a step, scenes/sec trained and the peak of
``torch.cuda.max_memory_allocated`` over the timed steps in GiB.

A step that runs out of memory is the answer "does not fit": the probe
prints the whole error and exits non-zero. ``--points``, ``--brick-cap``
and ``--levels`` cut the size, for a run on the CPU (``--device cpu``),
where the times are the host's and no peak is measured.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import traceback

import torch

from ..config import CfgNode, cfg_from_yaml_file
from ..models import model_fn
from ..models.unet import default_brick_caps
from ..utils import optim, synth
from ..utils.device import card_label, resolve_device


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--batch', type=int, default=4, help='scenes a step')
    ap.add_argument('--remat', default='off',
                    help='memory policy: off (default), dots, all, mix or '
                         'mixN')
    ap.add_argument('--device', default='cuda', help="'cuda' or 'cpu'")
    ap.add_argument('--steps', type=int, default=5, help='timed steps')
    ap.add_argument('--points', type=int, default=synth.N_REAL,
                    help='points a scene')
    ap.add_argument('--brick-cap', type=int, default=synth.BRICK_CAP,
                    help='level-0 brick cap a scene')
    ap.add_argument('--levels', type=int, default=7, help='U-Net levels')
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = cfg_from_yaml_file('cfgs/scannet/spconv.yaml', CfgNode())
    cfg.MODEL.BACKBONE.num_levels = args.levels
    b_caps = default_brick_caps(args.brick_cap, args.levels)
    batch = synth.bench_batch(args.batch, args.points, b_caps)
    batch = batch.to(dev)
    model = model_fn.build_model(cfg, device=dev, train=True,
                                 remat=args.remat)
    model.load_state_dict(synth.seeded_state_dict(model, seed=0))
    opt = optim.build_optimizer(cfg.OPTIMIZATION, model.parameters())
    step = model_fn.make_train_step(cfg, model, opt, b_caps, dev)
    lr = cfg.OPTIMIZATION.base_lr
    cuda = dev.type == 'cuda'
    result = {'card': card_label(dev), 'batch': args.batch,
              'remat': args.remat, 'points': args.points,
              'levels': args.levels}

    try:
        t0 = time.perf_counter()
        loss = float(step(batch, lr)['loss'])
        result['first_step_s'] = time.perf_counter() - t0
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        for _ in range(args.steps):
            out = step(batch, lr)
        loss = float(out['loss'])          # waits for the last step
        dt = (time.perf_counter() - t0) / args.steps
    except torch.OutOfMemoryError:
        traceback.print_exc()
        print(json.dumps({**result, 'fits': False}), flush=True)
        sys.exit(1)
    result.update(
        fits=True, steps=args.steps, clock='cuda-synchronized host clock'
        if cuda else 'host', step_s=dt, scenes_per_sec=args.batch / dt,
        loss=loss, peak_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30
        if cuda else 'not measured')
    print(json.dumps(result), flush=True)
    return result


if __name__ == '__main__':
    main()
