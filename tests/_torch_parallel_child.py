"""Two gloo ranks on the CPU against one process: run in a fresh
interpreter by tests/test_torch_parallel.py, because
``torch.multiprocessing.spawn`` re-imports the parent's main module.

The checks of tests/_sharded_child.py, for the port, on a 3-level net
(tests/_torch_equivalence.py): one train step (loss, IoU histograms,
gradients, updated weights), the batch statistics over the whole batch
(SyncBN: the scenes' features differ in scale by 10x, and the ranks hold
different point counts, so per-rank statistics or per-rank loss means
would show), one eval step (predictions, histograms), and one st step
with soft labels (both terms' losses and histograms, gradients, weights,
statistics). Then the CLIs' loops in every rank against one process
(``cli_loops``): ``test_one_epoch`` and ``set_pseudo_labels`` on three
rooms of 600 points at batch 1, so that the second rank scores a padded
scene in each, and ``update_split_sampler`` on the ranks' shares of a
mixed batch's tail cuboids. Prints the differences as one JSON line.
"""

import functools
import json
import logging
import sys
import tempfile
from argparse import Namespace
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))

CFG_ST = 'cfgs/da_front3d_scannet/spconv_st.yaml'
BRICK_CAP = 2560
N_QUEUE_CLASSES = 3


def make_cfg():
    from doda_tpu_torch.config import CfgNode
    return CfgNode({
        'COMMON_CLASSES': {'n_classes': 5},
        'MODEL': {'BACKBONE': {'use_xyz': False, 'in_channel': 3,
                               'mid_channel': 4, 'block_residual': True,
                               'block_reps': 2, 'num_levels': 3},
                  'dsnorm': False},
        'DATA_CONFIG': {'DATA_CLASS': {'ignore_label': 255,
                                       'n_classes': 5}},
        'OPTIMIZATION': {'optim': 'sgd', 'base_lr': 0.05, 'momentum': 0.9,
                         'weight_decay': 1e-4, 'loss': 'cross_entropy'},
    })


def make_batch(seed=1234, counts=(200, 120), n_cap=256):
    """Two scenes of ``counts`` points (the ranks' counts differ), the
    first with 10x the feature scale."""
    from doda_tpu_torch.models.model_fn import PointBatch
    rng = np.random.default_rng(seed)
    batch = len(counts)
    coords = rng.integers(0, 40, (batch, n_cap, 3)).astype(np.int32)
    labels = rng.integers(0, 5, (batch, n_cap)).astype(np.int32)
    valid = np.arange(n_cap)[None] < np.asarray(counts)[:, None]
    labels[~valid] = 255
    feats = rng.normal(size=(batch, n_cap, 3)).astype(np.float32)
    feats[0] *= 10.0
    return PointBatch(*(torch.from_numpy(a) for a in
                        (coords, feats, labels, valid)))


class _Queue:
    """Split-sampler stand-in that keeps its updates."""

    def __init__(self):
        self.updates, self.ratios = [], []

    def update(self, per_class):
        self.updates.append(per_class)

    def update_class_ratio(self, ratio):
        self.ratios.append(np.asarray(ratio).tolist())


def cli_loops(root, out):
    """In this process or this rank, with a seeded 2-level net of the st
    cfg: ``test_one_epoch`` on the 3 val rooms and ``set_pseudo_labels``
    on the 3 train rooms of ``root`` (batch 1, per-class thresholds from
    the confidence histogram), writing under ``out``;
    ``update_split_sampler`` on this rank's share of a 2-item batch's tail
    cuboids. Returns the mIoU and the queue's updates."""
    from doda_tpu_torch import config
    from doda_tpu_torch.data import build_dataloader
    from doda_tpu_torch.models import model_fn
    from doda_tpu_torch.models.unet import default_brick_caps
    from doda_tpu_torch.parallel import collectives
    from doda_tpu_torch.tools import st, test
    world, rank = collectives.world_size(), collectives.rank()
    cfg = config.cfg_from_yaml_file(str(HERE.parent / CFG_ST),
                                    config.CfgNode())
    config.cfg_from_list([
        'DATA_CONFIG_TAR.DATA_ROOT', str(root / 'scannetv2'),
        'DATA_CONFIG_TAR.DATA_SPLIT.training', 'train',
        'DATA_CONFIG_TAR.DATA_SPLIT.test', 'val',
        'DATA_CONFIG_TAR.DATA_PROCESSOR.brick_cap', str(BRICK_CAP),
        'MODEL.BACKBONE.mid_channel', '4', 'SELF_TRAIN.global_thres',
        'False'], cfg)
    cfg.MODEL.BACKBONE.num_levels = 2
    torch.manual_seed(1)
    model = model_fn.build_model(cfg, device='cpu', dtype=torch.float32)
    model.linear.bias.data.zero_()     # predictions of several classes
    step = model_fn.make_eval_step(cfg, model,
                                   default_brick_caps(BRICK_CAP, 2), 'cpu')
    log = logging.getLogger('cli_loops')
    kw = dict(dist=world > 1, world_size=world, rank=rank, workers=1)
    args = Namespace(eval_src=False, save_to_file=True, save_logit=False,
                     print_freq=100)
    _, loader, _ = build_dataloader(cfg.DATA_CONFIG_TAR, 1, split='test',
                                    training=False, **kw)
    miou = test.test_one_epoch(args, cfg, log, loader, step,
                               out / 'eval')['miou']
    tar_data, tar_loader, _ = build_dataloader(
        cfg.DATA_CONFIG_TAR, 1, split='training', training=True, **kw)
    assert st.set_pseudo_labels(args, cfg, log, tar_data, tar_loader, step,
                                out / 'pseudo_labels')
    items = range(rank * 2 // world, (rank + 1) * 2 // world)
    extras = {'tar_tail_splits': [[f'item{b}-class{c}']
                                  for b in items
                                  for c in range(N_QUEUE_CLASSES)],
              'tar_splits_class_ratio': [np.arange(N_QUEUE_CLASSES)
                                         * (b + 1.0) for b in items]}
    queue = _Queue()
    st.update_split_sampler(queue, extras, N_QUEUE_CLASSES,
                            update_ratio=True)
    return {'miou': miou, 'queue': queue.updates, 'ratios': queue.ratios}


def _files(d):
    return sorted(str(p.relative_to(d)) for p in d.rglob('*') if p.is_file())


def loop_diffs(got, one_dir, ranks_dir):
    """The CLI loops' checks: every rank's mIoU and queue equal the one
    process's; the ranks' dumps and pseudo labels, together, are the one
    process's files, byte for byte, apart from ``class_ratio.txt``, a sum
    of float64 terms in another order, held to 1e-12 relative."""
    one, ranks = got['loops_one'], got['loops_ranks']
    files = _files(one_dir)
    ratio = 'pseudo_labels/class_ratio.txt'
    want = np.loadtxt(one_dir / ratio)
    return {
        'loops_miou_equal': all(r['miou'] == one['miou'] for r in ranks),
        'loops_queue_equal': all(r['queue'] == one['queue']
                                 and r['ratios'] == one['ratios']
                                 for r in ranks),
        'loops_files': len(files),
        'loops_files_equal': files == _files(ranks_dir) and all(
            (one_dir / f).read_bytes() == (ranks_dir / f).read_bytes()
            for f in files if f != ratio),
        'class_ratio_rel': float(np.abs(np.loadtxt(ranks_dir / ratio) - want)
                                 .max() / np.abs(want).max())}


def main():
    from doda_tpu_torch.models import model_fn
    from doda_tpu_torch.tools.make_synth_data import make_scannet
    import _torch_equivalence as equivalence
    torch.manual_seed(0)
    cfg = make_cfg()
    sd = model_fn.build_model(cfg, device='cpu', dtype=torch.float32,
                              train=True).state_dict()
    with tempfile.TemporaryDirectory(prefix='doda_ranks_') as tmp:
        tmp = Path(tmp)
        make_scannet(str(tmp / 'rooms'), n_train=3, n_val=3, n_points=600,
                     rng=np.random.default_rng(0))
        out = equivalence.compare(
            cfg, sd, make_batch(), make_batch(99, (90, 170)), (128, 64, 32),
            loops=functools.partial(cli_loops, tmp / 'rooms'),
            loops_dir=tmp / 'loops')
        out.update(loop_diffs(out, tmp / 'loops/one', tmp / 'loops/ranks'))
    print(json.dumps(out), flush=True)


if __name__ == '__main__':
    main()
