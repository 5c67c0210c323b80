"""Self-training CLI of the port — the full DODA loop (ref: tool/st.py).

Port of ``tools/st.py``::

    python -m doda_tpu_torch.tools.st --cfg_file cfgs/.../spconv_st.yaml
        --weight <source-only checkpoint> [--device cpu] [--set ...]

Per epoch: (once) generate pseudo labels for the target train set with
per-class confidence thresholds, then alternate source batches (norm
domain 0) and TACM-mixed target batches (domain 1) through the port's
``make_st_step``, updating the tail-cuboid queue from each mixed batch.
Checkpoints, eval, split-sampler persistence and the done.txt /
class_ratio.txt artifacts match the reference's output tree.

Under ``--launcher pytorch`` or ``slurm`` (one process per card, see
``tools/train.py``) the ranks also share the pseudo-label pass (the
confidence histogram and the class ratios summed over the ranks, each
rank writing the labels of its own scenes) and the tail cuboids that
each mixed batch harvests (root tools/st.py:155-180).
"""

from __future__ import annotations

import argparse
import os
import shutil
import time

import numpy as np
import torch

from ..data import get_dataset
from ..data.loader import DataReader
from ..models import model_fn as mf
from ..models.unet import default_brick_caps
from ..parallel import collectives
from ..utils import checkpoint as ckpt_utils
from ..utils import pseudo_labels as pl_utils
from ..utils.metrics import AverageMeter, calc_metrics
from ..utils.optim import build_optimizer, make_lr_fn
from .common import add_port_args, host, load_cfg, rank_share
from .train import resume, save_epoch, start, validate_epoch

ST_METRICS = ('loss_x', 'loss_u', 'intersection_x', 'union_x', 'target_x',
              'count_x', 'intersection_u', 'union_u', 'target_u', 'count_u')


def parse_config(argv=None):
    """(ref: tool/st.py:29-76)"""
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
    parser.add_argument('--sync_bn', action='store_true')
    parser.add_argument('--reserve_old_ckpt', action='store_true')
    parser.add_argument('--preserve_pseudo_labels', action='store_true')
    parser.add_argument('--manual_seed', type=int, default=None)
    parser.add_argument('--ckpt_save_freq', type=int, default=1)
    parser.add_argument('--print_freq', type=int, default=5)
    parser.add_argument('--pin_memory', action='store_true')
    add_port_args(parser)
    args = parser.parse_args(argv)
    return args, load_cfg(args)


def set_pseudo_labels(args, cfg, logger, tar_data, tar_loader, eval_step,
                      pseudo_labels_dir):
    """Generate + install pseudo labels
    (ref: util/pseudo_labels_util.py:157-176 set_pseudo_labels).

    Pass 1 (only for ratio thresholds): accumulate per-class confidence
    histograms; pass 2: write thresholded labels per scene. Both passes
    run full-resolution, no-aug (ref :49-55), and count each scene once:
    the rows that the sampler pads a batch with are left out of the
    histogram, the labels and the class ratios. In a process group the
    histogram and the class ratios are summed over the ranks, each rank
    writes the labels of its own share of the scenes, and rank 0 marks
    the store done once every rank has written. Returns whether it
    generated (False when the store's done.txt says it is complete)."""
    n_classes = cfg.COMMON_CLASSES.n_classes
    soft_enabled = bool(cfg.get('SOFT_LABEL', None)
                        and cfg.SOFT_LABEL.get('enabled', False))
    generated = False
    # need_soft: a store from a pre-SOFT_LABEL run (done.txt but no
    # soft/ dir) must regenerate, or __getitem__ raises mid-epoch
    if not pl_utils.generation_done(pseudo_labels_dir,
                                    need_soft=soft_enabled):
        os.makedirs(pseudo_labels_dir, exist_ok=True)
        tar_data.set_training_mode(False)
        ds = tar_data.get_downsampling_scale()
        if cfg.DATA_CONFIG_TAR.DATA_PROCESSOR.get('no_downsample_infer',
                                                  False):
            tar_data.set_downsampling_scale(1)
        keys = ['preds', 'confidence'] + (['output'] if soft_enabled else [])

        share = rank_share(tar_loader)

        def sweep(fn):
            # the rows past this rank's share repeat earlier scenes
            # (sampler padding): fn counts the first n_real rows alone,
            # so that every scene counts once, in any world
            seen = 0
            for batch in tar_loader:
                n_real = min(len(batch.ids), max(share - seen, 0))
                seen += len(batch.ids)
                fn(batch, host(eval_step(batch.points, 1), keys), n_real)

        def collect_hist():
            logger.info('*********** Get Pseudo Label Confidence ***********')
            hist = np.zeros((n_classes, pl_utils.N_BINS), np.int64)

            def acc(batch, out, n_real):
                valid = batch.points.valid.numpy().copy()
                valid[n_real:] = False
                pl_utils.accumulate_confidence_histogram(
                    out['preds'], out['confidence'], valid, n_classes, hist)
            sweep(acc)
            return collectives.host_sum([hist])[0]

        thres = pl_utils.get_perclass_thres(cfg, collect_hist)
        logger.info('per class thres: {} '.format(thres))

        logger.info('*********** Generating Pseudo Labels ***********')
        class_ratio = np.zeros(n_classes, np.float64)
        data_list = tar_data.get_data_list()
        thres_arr = np.asarray(thres, np.float32)

        def write(batch, out, n_real):
            preds, conf = out['preds'], out['confidence']
            valid = batch.points.valid.numpy()
            pseudo = np.where(conf > thres_arr[preds], preds, 255)
            softmax = None
            if soft_enabled:
                logits = out['output'].astype(np.float32)
                e = np.exp(logits - logits.max(-1, keepdims=True))
                softmax = e / e.sum(-1, keepdims=True)
            for b, idx in enumerate(batch.ids[:n_real]):
                n = batch.lengths[b]
                name = os.path.basename(str(data_list[idx])).split('.')[0]
                pl_utils.save_scene_labels(pseudo_labels_dir, name,
                                           pseudo[b, :n])
                if soft_enabled:
                    pl_utils.save_scene_soft_labels(
                        pseudo_labels_dir, name, softmax[b, :n],
                        pseudo[b, :n] != 255)
                lab = pseudo[b, :n][valid[b, :n]]
                class_ratio[:] += np.bincount(
                    lab[lab != 255], minlength=n_classes)[:n_classes] / 1e3

        sweep(write)
        class_ratio = collectives.host_sum([class_ratio])[0]
        class_ratio /= class_ratio.sum() + 1e-9
        collectives.barrier()
        if collectives.is_main():
            pl_utils.save_class_ratio(pseudo_labels_dir, class_ratio)
            pl_utils.mark_done(pseudo_labels_dir)
        collectives.barrier()
        tar_data.set_downsampling_scale(ds)
        tar_data.set_training_mode(True)
        generated = True
    tar_data.set_pseudo_labels_dir(pseudo_labels_dir)
    return generated


def update_split_sampler(split_sampler, extras, num_c, update_ratio):
    """Queue + EMA ratio updates from one mixed batch
    (ref: tool/st.py:82-97). In a process group the per-class tail
    cuboids and the ratio sums are gathered from every rank first (ref
    all_gather_object, tool/st.py:86-89), so that the ranks' queues stay
    equal."""
    tail_splits = extras.get('tar_tail_splits', [])
    per_class = [[x for item in tail_splits[i::num_c] for x in item]
                 for i in range(num_c)]
    ratios = extras.get('tar_splits_class_ratio', [])
    ratio_sum = np.sum(ratios, axis=0) if len(ratios) else None
    if collectives.world_size() > 1:
        gathered = collectives.all_gather_objects((per_class, ratio_sum))
        per_class = [sum((g[0][c] for g in gathered), [])
                     for c in range(num_c)]
        sums = [g[1] for g in gathered if g[1] is not None]
        ratio_sum = np.sum(sums, axis=0) if sums else None
    split_sampler.update(per_class)
    if update_ratio and ratio_sum is not None:
        split_sampler.update_class_ratio(ratio_sum)


def train_epoch(args, cfg, logger, writer, source_reader, tar_loader,
                split_sampler, st_step, lr_fn, epoch, device, step=0):
    """(ref: tool/st.py:100-271) Returns the epoch's timing: steps,
    scenes (source and target), and the seconds of the batches, of
    waiting for data and of the steps. ``device`` is the step's, where the
    soft-label draws' generator lives; ``step`` the global step count at
    the epoch's start, which the device augmentation draws from."""
    meters = {k: AverageMeter() for k in
              ('batch', 'data', 'step', 'loss', 'loss_x', 'loss_u')}
    ms = {k: AverageMeter() for k in
          ('ix', 'ux', 'tx', 'iu', 'uu', 'tu')}
    w_src = cfg.SELF_TRAIN.SRC.get('loss_weight', 1.0)
    w_tar = cfg.SELF_TRAIN.TAR.get('loss_weight', 1.0)
    cq_cfg = cfg.DATA_CONFIG_TAR.DATA_AUG.tacm.cuboid_queue
    n_iter = len(tar_loader)
    max_iter = args.epochs * n_iter
    finite, n_scenes = True, 0
    end = time.time()
    for i, batch in enumerate(tar_loader):
        if (i + 1) == n_iter:  # manually drop last (ref :121-122)
            continue
        tar_wait = time.time() - end
        if epoch == 0 and i == 0:
            tar_loader.dataset.check_brick_capacity(
                batch, cfg.DATA_CONFIG_TAR.DATA_PROCESSOR.get(
                    'brick_cap', 32768), logger,
                num_levels=cfg.MODEL.BACKBONE.get('num_levels', 7))
        t0 = time.time()
        source_batch = source_reader.read_data()
        # data wait: the target batch's and the source batch's
        meters['data'].update(tar_wait + time.time() - t0)
        lr = float(lr_fn(epoch, i))
        soft = batch.extras.get('soft_labels')
        soft_kw = {}
        if soft is not None:
            gen = torch.Generator(device=device)
            gen.manual_seed(collectives.rank_seed(
                (args.manual_seed or 0) * 1_000_003 + epoch * n_iter + i))
            soft_kw = dict(tar_soft=torch.from_numpy(soft), generator=gen)
        t0 = time.time()
        m = host(st_step(source_batch.points, batch.points, lr, w_src, w_tar,
                         step=step + i, **soft_kw), ST_METRICS)
        meters['step'].update(time.time() - t0)
        finite &= bool(np.isfinite(m['loss_x']) and np.isfinite(m['loss_u']))
        n_scenes += source_batch.points.valid.shape[0] \
            + batch.points.valid.shape[0]
        # weight meters by total point count like the reference
        # (labels.size(0), tool/st.py:155,182) — valid counts can be 0
        # when a mixed batch is all-ignore early in self-training
        meters['loss_x'].update(float(m['loss_x']),
                                max(int(m['count_x']), 1))
        meters['loss_u'].update(float(m['loss_u']),
                                max(int(m['count_u']), 1))
        meters['loss'].update(float(m['loss_x'] + m['loss_u']),
                              max(int(m['count_u']), 1))
        for k, mk in (('ix', 'intersection_x'), ('ux', 'union_x'),
                      ('tx', 'target_x'), ('iu', 'intersection_u'),
                      ('uu', 'union_u'), ('tu', 'target_u')):
            ms[k].update(m[mk])
        acc_x = ms['ix'].val.sum() / (ms['tx'].val.sum() + 1e-10)
        acc_u = ms['iu'].val.sum() / (ms['tu'].val.sum() + 1e-10)

        if cq_cfg.enabled and split_sampler is not None \
                and split_sampler.initialized:
            update_split_sampler(split_sampler, batch.extras,
                                 cq_cfg.num_class,
                                 cq_cfg.get('update_class_ratio', False))

        meters['batch'].update(time.time() - end)
        end = time.time()
        current_iter = epoch * n_iter + i + 1
        remain = (max_iter - current_iter) * meters['batch'].avg
        t_m, t_s = divmod(remain, 60)
        t_h, t_m = divmod(t_m, 60)
        # last processed iteration is n_iter - 2 (final batch is dropped)
        if (i + 1) % args.print_freq == 0 or i == n_iter - 2:
            logger.info(
                'Epoch: [{}/{}][{}/{}] Data {:.3f} ({:.3f}) '
                'Batch {:.3f} ({:.3f}) Remain {:02d}:{:02d}:{:02d} '
                'Loss {:.4f} Loss_x {:.4f} Loss_u {:.4f} '
                'SrcAccuracy {:.4f} TarAccuracy {:.4f}. '.format(
                    epoch + 1, args.epochs, i + 1, n_iter,
                    meters['data'].val, meters['data'].avg,
                    meters['batch'].val, meters['batch'].avg,
                    int(t_h), int(t_m), int(t_s), meters['loss'].val,
                    meters['loss_x'].val, meters['loss_u'].val,
                    acc_x, acc_u))
        writer.add_scalar('loss_x_train_batch', meters['loss_x'].val,
                          current_iter)
        writer.add_scalar('loss_u_train_batch', meters['loss_u'].val,
                          current_iter)
        writer.add_scalar('loss_train_batch', meters['loss'].val,
                          current_iter)
        writer.add_scalar('allAcc_x_train_batch', acc_x, current_iter)
        writer.add_scalar('allAcc_u_train_batch', acc_u, current_iter)
        writer.add_scalar('lr', lr, current_iter)

    miou_x, macc_x, allacc_x, _, _ = calc_metrics(
        ms['ix'].sum, ms['ux'].sum, ms['tx'].sum)
    miou_u, macc_u, allacc_u, _, _ = calc_metrics(
        ms['iu'].sum, ms['uu'].sum, ms['tu'].sum)
    logger.info('Train result at epoch [{}/{}]: Src mIoU/mAcc/allAcc '
                '{:.4f}/{:.4f}/{:.4f}, Tar mIoU/mAcc/allAcc '
                '{:.4f}/{:.4f}/{:.4f}.'.format(
                    epoch + 1, args.epochs, miou_x, macc_x, allacc_x,
                    miou_u, macc_u, allacc_u))
    writer.add_scalar('loss_train', meters['loss'].avg, epoch + 1)
    writer.add_scalar('mIoU_train', miou_u, epoch + 1)
    return {'steps': meters['batch'].count, 'scenes': n_scenes,
            'batch_s': meters['batch'].sum, 'data_s': meters['data'].sum,
            'step_s': meters['step'].sum, 'losses_finite': finite,
            'miou_x': miou_x, 'miou_u': miou_u}


def main(argv=None):
    """Run self-training; returns the output directory, the initial and
    each epoch's validation mIoU and timing, and whether pseudo labels
    were generated in each epoch."""
    args, cfg = parse_config(argv)
    dev, world, output_dir, ckpt_dir, logger, writer = start(args, cfg,
                                                             'st')
    pseudo_labels_dir = output_dir / 'pseudo_labels'

    model = mf.build_model(cfg, device=dev, train=True)
    optimizer = build_optimizer(cfg.OPTIMIZATION, model.parameters())
    b_caps = default_brick_caps(
        cfg.DATA_CONFIG_TAR.DATA_PROCESSOR.get('brick_cap', 32768),
        model.num_levels)
    st_step = mf.make_st_step(cfg, model, optimizer, b_caps, dev)
    eval_step = mf.make_eval_step(cfg, model, b_caps, dev)
    logger.info('#classifier parameters: {}'.format(
        sum(p.numel() for p in model.parameters())))
    best_miou, best_epoch, step = resume(args, logger, ckpt_dir, model,
                                         optimizer)
    best_miou = 0.0 if best_miou is None else best_miou

    (src_loader, src_sampler, tar_data, tar_loader, tar_sampler,
     val_loader, _) = get_dataset(cfg, args, dist=world > 1, logger=logger,
                                  world_size=world,
                                  rank=collectives.rank())
    source_reader = DataReader(src_loader, src_sampler)
    split_sampler = getattr(tar_data, 'split_sampler', None)
    sampler_path = output_dir / 'split_sampler.pkl'
    if split_sampler is not None and sampler_path.exists():
        split_sampler.load(sampler_path)  # (ref: tool/st.py:518-522)
        logger.info('resumed split sampler from %s' % sampler_path)
    lr_fn = make_lr_fn(cfg.OPTIMIZATION, args.epochs, len(tar_loader))

    logger.info('********* Start self-training %s/%s(%s) *********' % (
        cfg.EXP_GROUP_PATH, cfg.TAG, args.extra_tag))
    domain = 1 if cfg.MODEL.get('dsnorm', False) else 0
    # initial eval (ref: tool/st.py:349)
    miou = validate_epoch(args, cfg, logger, writer, val_loader, eval_step,
                          args.start_epoch - 1, domain=domain)
    logger.info('Initial val mIoU: {:.4f}'.format(miou))
    result = {'output_dir': output_dir, 'miou_initial': miou, 'epochs': []}

    tacm_cfg = cfg.DATA_CONFIG_TAR.DATA_AUG.tacm
    if cfg.get('SOFT_LABEL', None) and cfg.SOFT_LABEL.get('enabled', False):
        if tacm_cfg.get('enabled', False):
            # soft rows cannot survive cuboid mixing; the reference's
            # SOFT_LABEL branch (model/unet.py:174-194) has no data path
            # at all, so this combination was never defined upstream
            logger.warning('SOFT_LABEL.enabled requires tacm.enabled=False;'
                           ' ignoring soft labels for mixed batches')
        else:
            tar_data.set_soft_labels(True)
            logger.info('SOFT_LABEL mode: target batches carry soft '
                        'distributions from the pseudo-label store')
    for epoch in range(args.start_epoch, args.epochs):
        # pseudo labels (first epoch or resumed via done.txt sentinel)
        t0 = time.time()
        generated = set_pseudo_labels(args, cfg, logger, tar_data,
                                      tar_loader, eval_step,
                                      pseudo_labels_dir)
        pseudo_s = time.time() - t0
        if split_sampler is not None and not split_sampler.initialized:
            class_ratio = pl_utils.load_class_ratio(pseudo_labels_dir)
            split_sampler.init_class_ratio({'class_ratio': class_ratio})
            split_sampler.update_cfg(tacm_cfg.cuboid_queue)
            logger.info('split sampler initialized; tail classes: %s'
                        % (tacm_cfg.cuboid_queue['tail_class_idx'],))

        if tar_sampler is not None:
            tar_sampler.set_epoch(epoch)
        source_reader.set_cur_epoch(epoch)
        stats = train_epoch(args, cfg, logger, writer, source_reader,
                            tar_loader, split_sampler, st_step, lr_fn,
                            epoch, dev, step=step)
        stats.update(pseudo_labels_generated=generated, pseudo_s=pseudo_s)
        step += stats['steps']
        epoch_log = epoch + 1
        save_epoch(args, logger, ckpt_dir, model, optimizer, epoch_log, step)
        if cfg.EVALUATION.evaluate \
                and epoch_log % cfg.EVALUATION.eval_freq == 0:
            miou = validate_epoch(args, cfg, logger, writer, val_loader,
                                  eval_step, epoch, domain=domain)
            stats['miou_val'] = miou
            if miou > best_miou:
                best_miou, best_epoch = miou, epoch_log
                if collectives.is_main():
                    ckpt_utils.save_params(ckpt_dir / 'best_train', model,
                                           optimizer, epoch_log,
                                           metric=best_miou, step=step)
        logger.info('Best epoch: {}, best mIoU: {}'.format(best_epoch,
                                                           best_miou))
        if split_sampler is not None and collectives.is_main():
            split_sampler.save(sampler_path)  # (ref: tool/st.py:396-398)
        result['epochs'].append(stats)

    collectives.barrier()
    if not args.preserve_pseudo_labels and pseudo_labels_dir.exists() \
            and collectives.is_main():
        shutil.rmtree(pseudo_labels_dir)  # (ref: tool/st.py:403-405)
    writer.close()
    return result


if __name__ == '__main__':
    main()
