"""Cuboid-mixing dataset for self-training (ref: dataset/mix_dataset.py).

A copy of ``doda_tpu/data/mix_dataset.py``.

Wraps a target dataset (with pseudo labels) and a source dataset; each
item draws one scene from each, runs TACM, then the post-mix pipeline
(elastic, crop, shuffle) (ref: mix_dataset.py:8-82).
"""

from __future__ import annotations

import numpy as np

from .augmentor.augmentor import DataAugmentor
from .dataset import Dataset


class CuboidMixingDataset:

    def __init__(self, dataset1: Dataset, dataset2: Dataset, seed=None):
        self.dataset1 = dataset1  # target
        self.dataset2 = dataset2  # source
        self.mix = True
        self.rng = np.random.default_rng(seed)
        self._entropy = seed if seed is not None \
            else int(np.random.SeedSequence().entropy) % (1 << 63)
        self._epoch = 0
        aug = dataset1.augmentor
        self.post_augmentor = DataAugmentor(
            aug.cfg, aug.dataset_name, aug.class_names, aug.ignore_label,
            aug.voxel_scale, aug.voxel_mode, aug.full_scale,
            aug.point_range, aug.max_npoint, seed=seed)
        self.post_augmentor.init_queue(['elastic', 'crop', 'shuffle'])

    # ---- delegation (ref: mix_dataset.py:28-52) ----

    def __len__(self):
        return len(self.dataset1)

    @property
    def training(self):
        return self.dataset1.training

    @property
    def split_sampler(self):
        return self.dataset1.augmentor.split_sampler

    def collate_batch(self, items):
        return self.dataset1.collate_batch(items)

    def check_brick_capacity(self, *args, **kwargs):
        """The target dataset's audit (the JAX package's mix dataset lacks
        this delegation, so its ``tools/st.py`` raises on its first
        batch)."""
        return self.dataset1.check_brick_capacity(*args, **kwargs)

    def set_training_mode(self, training):
        self.dataset1.set_training_mode(training)
        self.dataset2.set_training_mode(training)

    def set_epoch(self, epoch):
        self._epoch = int(epoch)
        self.dataset1.set_epoch(epoch)
        self.dataset2.set_epoch(epoch)

    def item_rng(self, item):
        """Per-item Generator for the mix draw + post pipeline (the
        wrapped datasets derive their own from the same epoch)."""
        return np.random.default_rng(
            (self._entropy, self._epoch, int(item), 1))

    def set_pseudo_labels_dir(self, d):
        self.dataset1.set_pseudo_labels_dir(d)

    def get_data_list(self):
        return self.dataset1.get_data_list()

    def get_downsampling_scale(self):
        return self.dataset1.get_downsampling_scale()

    def set_downsampling_scale(self, ds):
        self.dataset1.set_downsampling_scale(ds)

    def __getitem__(self, item):
        """(ref: mix_dataset.py:63-82)"""
        if not self.mix or not self.dataset1.training:
            return self.dataset1[item]
        rng = self.item_rng(item)
        xyz1, mid1, lab1, idx1, _ = self.dataset1[item]
        xyz2, mid2, lab2, idx2, _ = self.dataset2[
            int(rng.integers(len(self)))]

        data = self.dataset1.augmentor.tacm(
            self.dataset1.aug['tacm'],
            {'xyz_middle1': mid1, 'label1': lab1,
             'xyz_middle2': mid2, 'label2': lab2}, rng)
        xyz_mid, label = data['xyz_middle'], data['label']
        info = data['tacm_info']

        post = self.post_augmentor.forward(
            {'xyz_middle': xyz_mid, 'label': label}, rng)
        if not post['valid']:
            return self.dataset1[int(rng.integers(len(self)))]
        return (post['xyz'], post['xyz_middle'], post['label'], idx1,
                {'tar_tail_splits': info['tar_tail_splits'],
                 'tar_splits_class_ratio': info['tar_splits_class_ratio']})
