"""What the port's three CLIs share: the config, the flags that differ
from the JAX CLIs', the launcher, a rank's share of an eval loop and the
sums of its meters, the output tree and the host copy of a step's outputs.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import torch

from .. import config
from ..parallel import collectives
from ..utils.device import resolve_device


def add_port_args(parser):
    """The flags the port's CLIs add or read differently: ``--device``
    (the card unless asked) and the JAX CLIs' ``--launcher``."""
    parser.add_argument('--device', type=str, default='cuda',
                        help="'cuda' (default) or 'cpu'")
    parser.add_argument('--launcher', choices=['none', 'pytorch', 'slurm'],
                        default='none',
                        help='none: one process; pytorch (torchrun) or '
                             'slurm: one process per card')
    parser.add_argument('--tcp_port', type=int, default=18867)
    parser.add_argument('--local_rank', type=int, default=0)
    parser.add_argument('--set', dest='set_cfgs', default=None,
                        nargs=argparse.REMAINDER)


def load_cfg(args):
    """A fresh config from ``--cfg_file`` and ``--set`` (so that several
    CLI runs in one process do not share one), tagged as the JAX CLIs tag
    it."""
    cfg = config.CfgNode()
    cfg.ROOT_DIR = config.ROOT_DIR
    cfg.LOCAL_RANK = 0
    config.cfg_from_yaml_file(args.cfg_file, cfg)
    cfg.TAG = Path(args.cfg_file).stem
    cfg.EXP_GROUP_PATH = '/'.join(args.cfg_file.split('/')[1:-1])
    if args.set_cfgs is not None:
        config.cfg_from_list(args.set_cfgs, cfg)
    return cfg


def launch(args):
    """Join the launcher's process group (``--launcher``, ``--tcp_port``)
    and pick this rank's device: ``cuda:<local rank>`` with a card per
    rank over NCCL, or the CPU over gloo with ``--device cpu``. Returns
    (rank, world size, device)."""
    cpu = torch.device(args.device).type == 'cpu'
    rank, world, local = collectives.init_from_launcher(
        args.launcher, args.tcp_port, backend='gloo' if cpu else None)
    dev = resolve_device(args.device if cpu or world == 1
                         else f'cuda:{local}')
    return rank, world, dev


def output_dir_of(cfg, extra_tag):
    """output/<exp_group>/<tag>/<extra_tag> under the repo root."""
    return Path(cfg.ROOT_DIR) / 'output' / cfg.EXP_GROUP_PATH / cfg.TAG \
        / extra_tag


def host(out: dict, keys) -> dict:
    """The step outputs named in ``keys`` as numpy arrays, one device to
    host copy each."""
    return {k: out[k].detach().cpu().numpy() for k in keys}


def rank_share(loader):
    """The dataset's scenes this rank scores: its shard takes positions
    rank::world of the padded, tiled index list, and positions below the
    dataset's size are first occurrences (root tools/test.py:84-100)."""
    n_total = len(loader.dataset)
    samp = loader.sampler
    if samp.world_size > 1:
        n_total = max(0, -(-(n_total - samp.rank) // samp.world_size))
    return n_total


def reduce_meters(loss_meter, *hists):
    """Sum a loop's loss meter and histogram meters over the ranks, in
    place; a no-op in one process."""
    if collectives.world_size() == 1:
        return
    sums = collectives.host_sum([loss_meter.sum, loss_meter.count]
                                + [m.sum for m in hists])
    loss_meter.sum, loss_meter.count = sums[:2]
    loss_meter.avg = loss_meter.sum / max(loss_meter.count, 1)
    for m, total in zip(hists, sums[2:]):
        m.sum = total
