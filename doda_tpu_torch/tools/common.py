"""What the port's three CLIs share: the config, the flags that differ
from the JAX CLIs', the output tree and the host copy of a step's outputs.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from .. import config


def add_port_args(parser):
    """The flags the port's CLIs add or read differently: ``--device``
    (the card unless asked), ``--launcher`` (only ``none``)."""
    parser.add_argument('--device', type=str, default='cuda',
                        help="'cuda' (default) or 'cpu'")
    parser.add_argument('--launcher', type=str, default='none',
                        help="only 'none': one process, one device")
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


def check_launcher(launcher):
    if launcher != 'none':
        raise NotImplementedError(
            f'--launcher {launcher}: multi-process runs (DDP, SyncBN, '
            'all_gather of the cuboid queues) are the parallel slice of the '
            'port, not ported yet (ROADMAP, queue of the remaining slices)')


def output_dir_of(cfg, extra_tag):
    """output/<exp_group>/<tag>/<extra_tag> under the repo root."""
    return Path(cfg.ROOT_DIR) / 'output' / cfg.EXP_GROUP_PATH / cfg.TAG \
        / extra_tag


def host(out: dict, keys) -> dict:
    """The step outputs named in ``keys`` as numpy arrays, one device to
    host copy each."""
    return {k: out[k].detach().cpu().numpy() for k in keys}

