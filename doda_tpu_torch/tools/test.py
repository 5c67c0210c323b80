"""Evaluator CLI of the port (ref: tool/test.py).

Port of ``tools/test.py``::

    python -m doda_tpu_torch.tools.test --cfg_file cfgs/... --ckpt <file>
        [--device cpu] [--save_to_file] [--save_logit] [--eval_src]

Prints the reference's per-class IoU table, writes the optional txt/npy
result dumps under output/<exp_group>/<tag>/<extra_tag>/eval, and does the
crop -> full-scene 1-NN label broadcast for S3DIS-style eval (subsampled
or region-split scenes, ref: model/unet.py:135-145). Under
``--launcher pytorch`` or ``slurm`` each rank scores its shard of the
scenes (sampler padding trimmed, root tools/test.py:84-100) and writes
its scenes' dumps; the metrics are summed over the ranks. ``--brick 2``
runs the net in bricks of side 2 (default 4; the JAX CLIs' ``DODA_BRICK``).
"""

from __future__ import annotations

import argparse
import datetime
import os
import time

import numpy as np
import torch

from ..data import build_dataloader
from ..models import model_fn as mf
from ..models.unet import default_brick_caps
from ..ops.pointops import knn_broadcast_labels
from ..utils import checkpoint as ckpt_utils
from ..parallel import collectives
from ..utils.logging import get_logger
from ..utils.metrics import (AverageMeter, calc_metrics,
                             intersection_and_union)
from .common import (add_brick_arg, add_port_args, brick_of, host, launch,
                     load_cfg, output_dir_of, rank_share, reduce_meters)


def parse_config(argv=None):
    """(ref: tool/test.py:27-56)"""
    parser = argparse.ArgumentParser(description='arg parser')
    parser.add_argument('--cfg_file', type=str, default=None)
    parser.add_argument('--batch_size', type=int, default=None)
    parser.add_argument('--workers', type=int, default=4)
    parser.add_argument('--extra_tag', type=str, default='default')
    parser.add_argument('--ckpt', type=str, default=None)
    parser.add_argument('--print_freq', type=int, default=5)
    parser.add_argument('--save_to_file', action='store_true')
    parser.add_argument('--save_logit', action='store_true')
    parser.add_argument('--eval_src', action='store_true',
                        help='evaluate with source-domain DSNorm stats')
    parser.add_argument('--split', type=str, default='test')
    add_brick_arg(parser)
    add_port_args(parser)
    args = parser.parse_args(argv)
    return args, load_cfg(args)


def _log_softmax(x):
    x = x - x.max(axis=-1, keepdims=True)
    return x - np.log(np.exp(x).sum(axis=-1, keepdims=True))


def _broadcast(batch, groups, n_real, out, n_classes, ignore):
    """Crop/regions -> full-resolution 1-NN broadcast of predictions and
    logits, with the loss of the broadcast logits against the full-res
    labels (ref model/unet.py:135-145). Returns (inter, union, target,
    loss, count, full preds, full logits)."""
    feats = batch.points.feats.numpy()
    preds, logits = out['preds'], out['output']
    inter = np.zeros(n_classes, np.int64)
    union = np.zeros(n_classes, np.int64)
    target = np.zeros(n_classes, np.int64)
    full_preds, full_logits = [], []
    loss_sum, count = 0.0, 0
    for b in range(min(len(groups), n_real)):
        rows = groups[b]
        crop_xyz = np.concatenate(
            [feats[r, :batch.lengths[r]] for r in rows])
        crop_pred = np.concatenate(
            [preds[r, :batch.lengths[r]] for r in rows])
        crop_logit = np.concatenate(
            [logits[r, :batch.lengths[r]] for r in rows])
        nn_idx = knn_broadcast_labels(
            crop_xyz, np.arange(len(crop_xyz), dtype=np.int32),
            batch.full['xyz_middle_all'][b])
        bp = crop_pred[nn_idx]
        labels_all = batch.full['label_all'][b].astype(np.int32)
        ii, uu, tt = (x.numpy() for x in intersection_and_union(
            torch.from_numpy(bp), torch.from_numpy(labels_all), n_classes,
            ignore))
        inter += ii
        union += uu
        target += tt
        full_preds.append(bp)
        full_logits.append(crop_logit[nn_idx])
        lp = _log_softmax(crop_logit.astype(np.float64))[nn_idx]
        keep = labels_all != ignore
        if keep.any():
            loss_sum += float(-lp[keep, labels_all[keep]].sum())
            count += int(keep.sum())
    return (inter, union, target, loss_sum / max(count, 1), count,
            full_preds, full_logits)


def test_one_epoch(args, cfg, logger, loader, eval_step, result_dir):
    """(ref: tool/test.py:103-200) Returns the mIoU and the timing:
    batches, scenes forwarded (sampler padding included), and the seconds
    of the batches, of waiting for data and of the steps."""
    n_classes = cfg.COMMON_CLASSES.n_classes
    ignore = cfg.DATA_CONFIG_TAR.DATA_CLASS.ignore_label
    loss_meter = AverageMeter()
    inter_m, union_m, target_m = (AverageMeter() for _ in range(3))
    batch_time, data_time, step_time = (AverageMeter() for _ in range(3))
    domain = 0 if args.eval_src else (
        1 if cfg.MODEL.get('dsnorm', False) else 0)
    n_total = rank_share(loader)
    n_seen = 0
    data_list = loader.dataset.get_data_list()
    end = time.time()
    for i, batch in enumerate(loader):
        data_time.update(time.time() - end)
        if i == 0:
            loader.dataset.check_brick_capacity(
                batch, cfg.DATA_CONFIG_TAR.DATA_PROCESSOR.get(
                    'brick_cap', 32768), logger,
                num_levels=cfg.MODEL.BACKBONE.get('num_levels', 7),
                brick=brick_of(args))
        # exact-count duplicate trimming: sampler-padded scenes at the tail
        # of the last batch are masked out of metrics and skipped in dumps
        # (ref tool/test.py:138-141). In region-eval mode a scene spans
        # several rows (batch.groups); trimming counts scenes, not rows.
        groups = batch.groups
        n_scenes = len(groups) if groups is not None \
            else batch.points.valid.shape[0]
        n_real = min(n_scenes, n_total - n_seen)
        n_seen += n_scenes
        points = batch.points
        if n_real < n_scenes:
            keep_rows = ([r for g in groups[:n_real] for r in g]
                         if groups is not None else range(n_real))
            mask = np.zeros((points.valid.shape[0], 1), bool)
            mask[list(keep_rows)] = True
            points = points._replace(
                valid=points.valid & torch.from_numpy(mask))
        t0 = time.time()
        keys = ['loss', 'preds', 'intersection', 'union', 'target', 'count']
        if batch.full is not None or args.save_logit:
            keys.append('output')
        out = host(eval_step(points, domain), keys)
        step_time.update(time.time() - t0)
        if batch.full is not None:
            if groups is None:
                groups = [[b] for b in range(out['preds'].shape[0])]
            inter, union, target, loss, count, preds_for_save, \
                full_logits = _broadcast(batch, groups, n_real, out,
                                         n_classes, ignore)
        else:
            inter, union, target = (out[k] for k in
                                    ('intersection', 'union', 'target'))
            loss, count = float(out['loss']), int(out['count'])
            preds_for_save = [out['preds'][b, :batch.lengths[b]] for b in
                              range(min(out['preds'].shape[0], n_real))]

        loss_meter.update(loss, max(count, 1))
        inter_m.update(inter)
        union_m.update(union)
        target_m.update(target)

        names = [os.path.basename(str(data_list[idx])).split('.')[0]
                 for idx in batch.ids[:n_real]]
        if args.save_to_file:
            os.makedirs(result_dir / 'txt', exist_ok=True)
            for b, name in enumerate(names):
                np.savetxt(result_dir / 'txt' / f'{name}.txt',
                           preds_for_save[b].astype(np.uint8), fmt='%d')
        if args.save_logit:
            os.makedirs(result_dir / 'logit', exist_ok=True)
            for b, name in enumerate(names):
                # broadcast (full-resolution) logits, like the ref's crop
                # branch output (model/unet.py:139)
                dump = full_logits[b] if batch.full is not None \
                    else out['output'][b, :batch.lengths[b]]
                np.save(result_dir / 'logit' / f'{name}.npy', dump)

        batch_time.update(time.time() - end)
        end = time.time()
        if (i + 1) % args.print_freq == 0:
            acc = inter_m.val.sum() / (target_m.val.sum() + 1e-10)
            logger.info('Test: [{}/{}] Batch {:.3f} ({:.3f}) '
                        'Loss {:.4f} ({:.4f}) Accuracy {:.4f}.'.format(
                            i + 1, len(loader), batch_time.val,
                            batch_time.avg, loss_meter.val, loss_meter.avg,
                            acc))

    reduce_meters(loss_meter, inter_m, union_m, target_m)
    miou, macc, allacc, iou_class, acc_class = calc_metrics(
        inter_m.sum, union_m.sum, target_m.sum)
    logger.info('Val result: mIoU/mAcc/allAcc {:.4f}/{:.4f}/{:.4f}.'.format(
        miou, macc, allacc))
    for c in range(n_classes):
        logger.info('Class {} : iou/accuracy {:.4f}/{:.4f}.'.format(
            cfg.COMMON_CLASSES.class_names[c], iou_class[c], acc_class[c]))
    return {'miou': miou, 'macc': macc, 'allacc': allacc,
            'batches': batch_time.count, 'scenes': n_seen,
            'batch_s': batch_time.sum, 'data_s': data_time.sum,
            'step_s': step_time.sum}


def main(argv=None):
    """Evaluate a checkpoint; returns the eval directory, the mIoU and
    the timing of ``test_one_epoch``."""
    args, cfg = parse_config(argv)
    rank, world, dev = launch(args)
    if args.batch_size is None:
        args.batch_size = cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU
    eval_dir = output_dir_of(cfg, args.extra_tag) / 'eval'
    eval_dir.mkdir(parents=True, exist_ok=True)
    log_file = eval_dir / ('log_test_%s.txt' % datetime.datetime.now()
                           .strftime('%Y%m%d-%H%M%S'))
    logger = get_logger(log_file=log_file if rank == 0 else None, rank=rank)
    logger.info('**************** Start Evaluation ****************')
    for key, val in vars(args).items():
        logger.info('{:16} {}'.format(key, val))
    from ..config import log_config_to_file
    log_config_to_file(cfg, logger=logger)

    model = mf.build_model(cfg, device=dev, brick=args.brick)
    b_caps = default_brick_caps(
        cfg.DATA_CONFIG_TAR.DATA_PROCESSOR.get('brick_cap', 32768),
        model.num_levels)
    eval_step = mf.make_eval_step(cfg, model, b_caps, dev)
    if args.ckpt:
        ckpt_utils.load_params_from_pretrain(args.ckpt, model, strict=True,
                                             logger=logger)
    collectives.broadcast_module(model)
    _, loader, _ = build_dataloader(
        cfg.DATA_CONFIG_TAR, args.batch_size, dist=world > 1,
        workers=args.workers, logger=logger, split=args.split,
        training=False, world_size=world, rank=rank)
    result = test_one_epoch(args, cfg, logger, loader, eval_step, eval_dir)
    return {'output_dir': eval_dir, **result}


if __name__ == '__main__':
    main()
