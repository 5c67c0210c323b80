"""Dataset registry + loader builders (ref: dataset/__init__.py).

A copy of ``doda_tpu/data/__init__.py``; with ``dist`` the samplers
stride across ``world_size`` ranks (the CLIs' ``--launcher``).
"""

from __future__ import annotations

from .dataset import CollatedBatch, Dataset
from .front3d import Front3dDataset
from .loader import DataLoader, DataReader, ShardedSampler
from .mix_dataset import CuboidMixingDataset
from .s3dis import S3DISDataset
from .scannet import ScanNetDataset

__all__ = {
    'front3d': Front3dDataset,
    's3dis': S3DISDataset,
    'scannet': ScanNetDataset,
}


def build_dataset(dataset_cfg, batch_size, split, training, logger=None,
                  seed=None):
    return __all__[dataset_cfg.DATASET](
        cfg=dataset_cfg,
        class_names=dataset_cfg.DATA_CLASS.class_names,
        batch_size=batch_size,
        split=split,
        training=training,
        logger=logger,
        seed=seed,
    )


def build_dataloader(dataset_cfg, batch_size, dist=False, workers=4,
                     logger=None, split='training', training=True,
                     drop_last=False, world_size=1, rank=0, seed=0,
                     dataset=None):
    """(ref: dataset/__init__.py:44-76)"""
    if dataset is None:
        dataset = build_dataset(dataset_cfg, batch_size, split, training,
                                logger, seed)
    sampler = ShardedSampler(len(dataset), batch_size, shuffle=training,
                             world_size=world_size if dist else 1,
                             rank=rank if dist else 0,
                             drop_last=drop_last, seed=seed)
    loader = DataLoader(dataset, batch_size, sampler, num_workers=workers)
    return dataset, loader, sampler


def build_mix_dataloader(cfg_tar, cfg_src, batch_size, dist=False,
                         workers=4, logger=None, split='training',
                         training=True, drop_last=False, world_size=1,
                         rank=0, seed=0, dataset2=None):
    """(ref: dataset/__init__.py:79-122)"""
    dataset1 = build_dataset(cfg_tar, batch_size, split, training, logger,
                             seed)
    if dataset2 is None:
        dataset2 = build_dataset(cfg_src, batch_size, split, training,
                                 logger, seed)
    mixed = CuboidMixingDataset(dataset1, dataset2, seed=seed)
    sampler = ShardedSampler(len(mixed), batch_size, shuffle=training,
                             world_size=world_size if dist else 1,
                             rank=rank if dist else 0,
                             drop_last=drop_last, seed=seed)
    loader = DataLoader(mixed, batch_size, sampler, num_workers=workers)
    return mixed, loader, sampler


def get_val_dataset(args, dataset_cfg, dist, logger, **kw):
    """(ref: dataset/__init__.py:125-129)"""
    _, loader, sampler = build_dataloader(
        dataset_cfg, args.batch_size, dist, training=False,
        workers=args.workers, logger=logger, split='validation',
        drop_last=False, **kw)
    return loader, sampler


def get_src_train_dataset(cfg, args, dist, logger, **kw):
    """(ref: dataset/__init__.py:132-137)"""
    return build_dataloader(
        cfg.DATA_CONFIG, args.batch_size, dist, training=True,
        workers=args.workers, logger=logger, drop_last=True, **kw)


def get_tar_train_dataset(cfg, args, dist, logger, src_train_data=None,
                          **kw):
    """(ref: dataset/__init__.py:140-150)"""
    if cfg.DATA_CONFIG_TAR.DATA_AUG.tacm.enabled:
        tar_data, loader, sampler = build_mix_dataloader(
            cfg.DATA_CONFIG_TAR, cfg.DATA_CONFIG, args.batch_size, dist,
            workers=args.workers, logger=logger, drop_last=False,
            dataset2=src_train_data, **kw)
    else:
        tar_data, loader, sampler = build_dataloader(
            cfg.DATA_CONFIG_TAR, args.batch_size, dist, training=True,
            workers=args.workers, logger=logger, drop_last=False, **kw)
    return tar_data, loader, sampler


def get_dataset(cfg, args, dist, logger, **kw):
    """Self-training loader triple (ref: dataset/__init__.py:153-164)."""
    src_data, src_loader, src_sampler = get_src_train_dataset(
        cfg, args, dist, logger, **kw)
    tar_data, tar_loader, tar_sampler = get_tar_train_dataset(
        cfg, args, dist, logger, src_train_data=src_data, **kw)
    val_loader, val_sampler = get_val_dataset(
        args, cfg.DATA_CONFIG_TAR, dist, logger, **kw)
    return (src_loader, src_sampler, tar_data, tar_loader, tar_sampler,
            val_loader, val_sampler)
