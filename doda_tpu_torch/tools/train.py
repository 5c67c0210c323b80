"""Supervised / UDA-pretrain trainer CLI of the port (ref: tool/train.py).

Port of ``tools/train.py``::

    python -m doda_tpu_torch.tools.train --cfg_file cfgs/... [--device cpu]
        [--epochs N] [--batch_size B] [--extra_tag T] [--set KEY VAL ...]

Same output tree, output/<exp_group>/<tag>/<extra_tag>/{ckpt,tensorboard},
the same log lines and per-class IoU tables. The loop drives the port's
``make_train_step`` (plan, U-Net, loss, backward and optimizer update on
the device) one padded batch at a time; validation runs ``make_eval_step``.
``--profile N`` captures a ``torch.profiler`` trace of the first N train
steps into <output_dir>/profile. ``--remat off|dots|all|mix|mixN``
(default off) is the U-Net blocks' memory policy (``build_model``'s
``remat``, the JAX CLIs' ``DODA_REMAT``) and ``--brick 2|4`` (default 4)
the brick side (``build_model``'s ``brick``, the JAX CLIs' ``DODA_BRICK``).

``--launcher pytorch`` (torchrun) or ``slurm`` runs one process per card
(``parallel/collectives.py``): each rank loads its shard of every batch,
the steps reduce the loss, gradients, norm statistics and metrics over
the ranks, validation sums its histograms over them, and rank 0 alone
writes the checkpoints, the log and tensorboard::

    torchrun --nproc_per_node=N -m doda_tpu_torch.tools.train \
        --launcher pytorch --cfg_file cfgs/... [--set ...]
"""

from __future__ import annotations

import argparse
import datetime
import shutil
import time

import numpy as np
import torch

from ..data import get_src_train_dataset, get_val_dataset
from ..models import model_fn as mf
from ..models.unet import default_brick_caps
from ..utils import checkpoint as ckpt_utils
from ..parallel import collectives
from ..utils.logging import get_logger, make_writer
from ..utils.metrics import AverageMeter, calc_metrics
from ..utils.optim import build_optimizer, make_lr_fn
from .common import (add_brick_arg, add_port_args, add_remat_arg, brick_of,
                     host, launch, load_cfg, output_dir_of, rank_share,
                     reduce_meters)

METRICS = ('loss', 'intersection', 'union', 'target', 'count')


def parse_config(argv=None):
    """(ref: tool/train.py:29-62)"""
    parser = argparse.ArgumentParser(description='arg parser')
    parser.add_argument('--cfg_file', type=str, default=None)
    parser.add_argument('--batch_size', type=int, default=None)
    parser.add_argument('--epochs', type=int, default=None)
    parser.add_argument('--workers', type=int, default=4)
    parser.add_argument('--extra_tag', type=str, default='default')
    parser.add_argument('--start_epoch', type=int, default=0)
    parser.add_argument('--resume', type=str, default=None)
    parser.add_argument('--weight', type=str, default=None)
    parser.add_argument('--pretrain_not_strict', action='store_true')
    parser.add_argument('--sync_bn', action='store_true',
                        help='accepted for CLI parity; the norms always '
                             'take the statistics of the whole batch')
    parser.add_argument('--reserve_old_ckpt', action='store_true')
    parser.add_argument('--manual_seed', type=int, default=None)
    parser.add_argument('--ckpt_save_freq', type=int, default=1)
    parser.add_argument('--print_freq', type=int, default=5)
    parser.add_argument('--max_ckpt_save_num', type=int, default=30)
    parser.add_argument('--pin_memory', action='store_true')
    parser.add_argument('--profile', type=int, default=0,
                        help='capture a torch.profiler trace of the first '
                             'N train steps into <output_dir>/profile')
    add_remat_arg(parser)
    add_brick_arg(parser)
    add_port_args(parser)
    args = parser.parse_args(argv)
    return args, load_cfg(args)


class StepProfiler:
    """torch.profiler over the first ``n`` steps of the first epoch,
    written as a Chrome trace into ``out_dir``."""

    def __init__(self, n, out_dir, logger):
        self.n, self.out_dir, self.logger = n, out_dir, logger
        self.prof = None

    def before(self, i):
        if self.n and i == 0 and self.prof is None:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.start()

    def after(self, i, n_iter):
        if self.prof is not None and i + 1 == min(self.n, n_iter):
            self.prof.stop()
            path = self.out_dir / 'trace.json'
            self.prof.export_chrome_trace(str(path))
            self.logger.info('profiler trace written to %s' % path)
            self.prof, self.n = None, 0


def mask_padded_scenes(points, n_real):
    """Exact-count duplicate trimming for padded eval batches: scenes at
    positions >= n_real are sampler padding (duplicates of already-scored
    scenes); blank their masks so metrics count every dataset sample
    exactly once (ref tool/test.py:138-141, tool/train.py:183-186)."""
    if n_real >= points.valid.shape[0]:
        return points
    keep = (np.arange(points.valid.shape[0]) < n_real)[:, None]
    return points._replace(valid=points.valid & torch.from_numpy(keep))


def train_epoch(args, cfg, logger, writer, train_loader, train_step, lr_fn,
                epoch, domain=0, profiler=None, step=0):
    """(ref: tool/train.py:69-158) Returns the epoch's timing: steps,
    scenes, and the seconds of the batches, of waiting for data and of
    the steps. ``step`` is the global step count at the epoch's start;
    the device augmentation draws from it."""
    batch_time = AverageMeter()
    data_time = AverageMeter()
    step_time = AverageMeter()
    loss_meter = AverageMeter()
    inter_m, union_m, target_m = (AverageMeter() for _ in range(3))
    end = time.time()
    n_iter = len(train_loader)
    max_iter = args.epochs * n_iter
    scene_meter = AverageMeter()
    n_scenes = 0
    for i, batch in enumerate(train_loader):
        data_time.update(time.time() - end)
        lr = float(lr_fn(epoch, i))
        if epoch == args.start_epoch and i == 0:
            train_loader.dataset.check_brick_capacity(
                batch, cfg.DATA_CONFIG.DATA_PROCESSOR.get(
                    'brick_cap', 32768), logger,
                num_levels=cfg.MODEL.BACKBONE.get('num_levels', 7),
                brick=brick_of(args))
        if profiler is not None and epoch == args.start_epoch:
            profiler.before(i)
        t0 = time.time()
        metrics = host(train_step(batch.points, lr, domain, step=step + i),
                       METRICS)
        step_time.update(time.time() - t0)
        if profiler is not None and epoch == args.start_epoch:
            profiler.after(i, n_iter)
        loss_meter.update(float(metrics['loss']), int(metrics['count']))
        inter_m.update(metrics['intersection'])
        union_m.update(metrics['union'])
        target_m.update(metrics['target'])
        accuracy = inter_m.val.sum() / (target_m.val.sum() + 1e-10)

        batch_time.update(time.time() - end)
        n_scenes += batch.points.valid.shape[0]
        scene_meter.update(
            batch.points.valid.shape[0] / max(batch_time.val, 1e-9))
        end = time.time()
        current_iter = epoch * n_iter + i + 1
        remain = (max_iter - current_iter) * batch_time.avg
        t_m, t_s = divmod(remain, 60)
        t_h, t_m = divmod(t_m, 60)
        remain_time = '{:02d}:{:02d}:{:02d}'.format(int(t_h), int(t_m),
                                                    int(t_s))
        if (i + 1) % args.print_freq == 0 or i == n_iter - 1:
            logger.info(
                'Epoch: [{}/{}][{}/{}] '
                'Data {:.3f} ({:.3f}) Batch {:.3f} ({:.3f}) '
                'Remain {} Loss {:.4f} Accuracy {:.4f} '
                'Scenes/sec/chip {:.2f} ({:.2f}).'.format(
                    epoch + 1, args.epochs, i + 1, n_iter,
                    data_time.val, data_time.avg, batch_time.val,
                    batch_time.avg, remain_time, loss_meter.val, accuracy,
                    scene_meter.val, scene_meter.avg))
        writer.add_scalar('loss_train_batch', loss_meter.val, current_iter)
        writer.add_scalar('mIoU_train_batch', float(np.mean(
            metrics['intersection'] / (metrics['union'] + 1e-10))),
            current_iter)
        writer.add_scalar('allAcc_train_batch', accuracy, current_iter)
        writer.add_scalar('lr', lr, current_iter)

    miou, macc, allacc, _, _ = calc_metrics(inter_m.sum, union_m.sum,
                                            target_m.sum)
    logger.info('Train result at epoch [{}/{}]: mIoU/mAcc/allAcc '
                '{:.4f}/{:.4f}/{:.4f}.'.format(epoch + 1, args.epochs,
                                               miou, macc, allacc))
    writer.add_scalar('loss_train', loss_meter.avg, epoch + 1)
    writer.add_scalar('mIoU_train', miou, epoch + 1)
    writer.add_scalar('mAcc_train', macc, epoch + 1)
    writer.add_scalar('allAcc_train', allacc, epoch + 1)
    return {'steps': batch_time.count, 'scenes': n_scenes,
            'batch_s': batch_time.sum, 'data_s': data_time.sum,
            'step_s': step_time.sum, 'losses_finite': bool(
                np.isfinite(loss_meter.sum)), 'miou': miou}


def validate_epoch(args, cfg, logger, writer, val_loader, eval_step, epoch,
                   domain=0):
    """(ref: tool/train.py:161-232) Returns the mIoU. In a process group
    each rank scores its shard, with the sampler's padding trimmed, and
    the sums go over the ranks before the mIoU."""
    logger.info('>>>>>>>>>>>>>>>> Start Evaluation >>>>>>>>>>>>>>>>')
    loss_meter = AverageMeter()
    inter_m, union_m, target_m = (AverageMeter() for _ in range(3))
    n_total = rank_share(val_loader)
    n_seen = 0
    for i, batch in enumerate(val_loader):
        points = mask_padded_scenes(batch.points, n_total - n_seen)
        n_seen += points.valid.shape[0]
        out = host(eval_step(points, domain), METRICS)
        loss_meter.update(float(out['loss']), int(out['count']))
        inter_m.update(out['intersection'])
        union_m.update(out['union'])
        target_m.update(out['target'])
        if (i + 1) % args.print_freq == 0:
            acc = inter_m.val.sum() / (target_m.val.sum() + 1e-10)
            logger.info('Test: [{}/{}] Loss {:.4f} ({:.4f}) '
                        'Accuracy {:.4f}.'.format(
                            i + 1, len(val_loader), loss_meter.val,
                            loss_meter.avg, acc))
    reduce_meters(loss_meter, inter_m, union_m, target_m)
    miou, macc, allacc, iou_class, acc_class = calc_metrics(
        inter_m.sum, union_m.sum, target_m.sum)
    logger.info('Val result: mIoU/mAcc/allAcc {:.4f}/{:.4f}/{:.4f}.'.format(
        miou, macc, allacc))
    n_classes = cfg.COMMON_CLASSES.n_classes
    class_names = cfg.COMMON_CLASSES.class_names
    for c in range(n_classes):
        logger.info('Class {} : iou/accuracy {:.4f}/{:.4f}.'.format(
            class_names[c], iou_class[c], acc_class[c]))
    logger.info('<<<<<<<<<<<<<<<<< End Evaluation <<<<<<<<<<<<<<<<<')
    writer.add_scalar('loss_val', loss_meter.avg, epoch + 1)
    writer.add_scalar('mIoU_val', miou, epoch + 1)
    writer.add_scalar('mAcc_val', macc, epoch + 1)
    writer.add_scalar('allAcc_val', allacc, epoch + 1)
    return miou


def save_epoch(args, logger, ckpt_dir, model, optimizer, epoch_log, step):
    """The epoch's checkpoint and the rolling deletion of old ones (rank 0
    alone)."""
    if epoch_log % args.ckpt_save_freq == 0 and collectives.is_main():
        filename = ckpt_dir / f'train_epoch_{epoch_log}'
        logger.info('Saving checkpoint to: ' + str(filename))
        ckpt_utils.save_params(filename, model, optimizer, epoch_log,
                               step=step)
        if not args.reserve_old_ckpt:
            ckpt_utils.rolling_delete(ckpt_dir, epoch_log,
                                      args.ckpt_save_freq)


def train(args, cfg, logger, writer, model, optimizer, train_step,
          eval_step, train_loader, val_loader, train_sampler, lr_fn,
          ckpt_dir, best_miou=None, best_epoch=0, step=0, profiler=None):
    """(ref: tool/train.py:235-268) Returns each epoch's timing."""
    dsnorm = cfg.MODEL.get('dsnorm', False)
    best_miou = best_miou if best_miou is not None else 0.0
    epochs = []
    for epoch in range(args.start_epoch, args.epochs):
        if train_sampler is not None:
            train_sampler.set_epoch(epoch)
        stats = train_epoch(args, cfg, logger, writer, train_loader,
                            train_step, lr_fn, epoch, domain=0,
                            profiler=profiler, step=step)
        step += stats['steps']
        epoch_log = epoch + 1
        save_epoch(args, logger, ckpt_dir, model, optimizer, epoch_log, step)
        if cfg.EVALUATION.evaluate \
                and epoch_log % cfg.EVALUATION.eval_freq == 0:
            miou_val = validate_epoch(args, cfg, logger, writer, val_loader,
                                      eval_step, epoch,
                                      domain=1 if dsnorm else 0)
            stats['miou_val'] = miou_val
            if miou_val > best_miou:
                best_miou = miou_val
                best_epoch = epoch_log
                filename = ckpt_dir / 'best_train'
                logger.info('Best Model Saving checkpoint to: '
                            + str(filename))
                if collectives.is_main():
                    ckpt_utils.save_params(filename, model, optimizer,
                                           epoch_log, metric=best_miou,
                                           step=step)
        logger.info('Best epoch: {}, best mIoU: {}'.format(best_epoch,
                                                           best_miou))
        epochs.append(stats)
    return epochs


def resume(args, logger, ckpt_dir, model, optimizer):
    """--weight, then --resume or the newest checkpoint, then the best
    metric so far (ref: tool/train.py:335-356); each in the port's format
    or the JAX package's. In a process group rank 0's weights then go to
    every rank. Returns (best mIoU, its epoch, the step count)."""
    step = 0
    if args.weight:
        ckpt_utils.load_params_from_pretrain(
            args.weight, model, strict=not args.pretrain_not_strict,
            logger=logger)
    path = args.resume or ckpt_utils.auto_resume_path(ckpt_dir)
    if path:
        args.start_epoch, step = ckpt_utils.load_params_from_ckpt(
            path, model, optimizer, logger=logger)
    collectives.broadcast_module(model)
    best_miou, best_epoch = None, 0
    if (ckpt_dir / 'best_train').exists():
        best_miou, best_epoch = ckpt_utils.load_metric_from_ckpt(
            ckpt_dir / 'best_train')
    return best_miou, best_epoch, step


def start(args, cfg, kind):
    """Join the launcher's group; the run's output tree, logger and writer
    (rank 0's alone write). Returns them with the device and the world
    size. ``kind`` names the log file (train, st)."""
    rank, world, dev = launch(args)
    if args.batch_size is None:
        args.batch_size = cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU
    args.epochs = cfg.OPTIMIZATION.NUM_EPOCHS if args.epochs is None \
        else args.epochs
    if args.manual_seed is not None:
        np.random.seed(args.manual_seed)
        torch.manual_seed(args.manual_seed)
    output_dir = output_dir_of(cfg, args.extra_tag)
    ckpt_dir = output_dir / 'ckpt'
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    log_file = output_dir / ('log_%s_%s.txt' % (
        kind, datetime.datetime.now().strftime('%Y%m%d-%H%M%S')))
    logger = get_logger(log_file=log_file if rank == 0 else None, rank=rank)
    logger.info('**************** Start Logging ****************')
    logger.info('device: %s; rank %d of %d' % (
        torch.cuda.get_device_name(dev) if dev.type == 'cuda' else dev,
        rank, world))
    for key, val in vars(args).items():
        logger.info('{:16} {}'.format(key, val))
    if args.pin_memory:
        logger.warning('--pin_memory has no effect: the loader collates '
                       'into ordinary host tensors (accepted for CLI '
                       'parity)')
    from ..config import log_config_to_file
    log_config_to_file(cfg, logger=logger)
    if rank == 0:
        shutil.copy(args.cfg_file, output_dir)
    writer = make_writer(output_dir / 'tensorboard', rank=rank)
    return dev, world, output_dir, ckpt_dir, logger, writer


def main(argv=None):
    """Run the trainer; returns the output directory and each epoch's
    timing and validation mIoU."""
    args, cfg = parse_config(argv)
    dev, world, output_dir, ckpt_dir, logger, writer = start(args, cfg,
                                                             'train')

    model = mf.build_model(cfg, device=dev, train=True, remat=args.remat,
                           brick=args.brick)
    optimizer = build_optimizer(cfg.OPTIMIZATION, model.parameters())
    b_caps = default_brick_caps(
        cfg.DATA_CONFIG.DATA_PROCESSOR.get('brick_cap', 32768),
        model.num_levels)
    train_step = mf.make_train_step(cfg, model, optimizer, b_caps, dev)
    eval_step = mf.make_eval_step(cfg, model, b_caps, dev)
    logger.info('#classifier parameters: {}'.format(
        sum(p.numel() for p in model.parameters())))
    best_miou, best_epoch, step = resume(args, logger, ckpt_dir, model,
                                         optimizer)

    shard = dict(world_size=world, rank=collectives.rank())
    _, train_loader, train_sampler = get_src_train_dataset(
        cfg, args, dist=world > 1, logger=logger, **shard)
    val_loader, _ = get_val_dataset(args, cfg.DATA_CONFIG_TAR,
                                    dist=world > 1, logger=logger, **shard)
    lr_fn = make_lr_fn(cfg.OPTIMIZATION, args.epochs, len(train_loader))
    profiler = None
    if args.profile:
        (output_dir / 'profile').mkdir(parents=True, exist_ok=True)
        profiler = StepProfiler(args.profile, output_dir / 'profile', logger)

    logger.info('********* Start training %s/%s(%s) *********' % (
        cfg.EXP_GROUP_PATH, cfg.TAG, args.extra_tag))
    epochs = train(args, cfg, logger, writer, model, optimizer, train_step,
                   eval_step, train_loader, val_loader, train_sampler, lr_fn,
                   ckpt_dir, best_miou=best_miou, best_epoch=best_epoch,
                   step=step, profiler=profiler)
    writer.close()
    return {'output_dir': output_dir, 'epochs': epochs}


if __name__ == '__main__':
    main()
