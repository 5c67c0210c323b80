"""ScanNet v2 reader (ref: dataset/scannet.py).

A copy of ``doda_tpu/data/scannet.py``.

Scenes are ``.pth`` files holding (xyz, rgb, label) tuples; loaded with
torch (CPU). The reference's /dev/shm SharedArray cache is replaced by an
in-process LRU-ish dict cache (``DATA_PROCESSOR.cache``) — the prefetch
threads share the process, so shm gymnastics are unnecessary.
"""

from __future__ import annotations

import glob
import os

import numpy as np

from .dataset import Dataset


def _load_pth(path):
    import torch
    return torch.load(path, weights_only=False)


class ScanNetDataset(Dataset):

    def __init__(self, cfg, class_names, batch_size, split='training',
                 training=True, logger=None, seed=None):
        super().__init__(cfg, class_names, batch_size, split=split,
                         training=training, logger=logger, seed=seed)
        self.data_suffix = cfg.DATA_SPLIT.data_suffix
        self.split_file = cfg.DATA_SPLIT[split]
        self.data_list = sorted(glob.glob(os.path.join(
            self.data_root, self.split_file) + '/*' + self.data_suffix))
        self.cache_enabled = cfg.DATA_PROCESSOR.get('cache', False)
        self._cache = {}
        if self.logger:
            self.logger.info('Totally {} samples in {} set.'.format(
                len(self.data_list), self.split))

    def load_data(self, index):
        """(ref: dataset/scannet.py:36-58)"""
        fn = self.data_list[index]
        if self.cache_enabled and fn in self._cache:
            xyz, label = self._cache[fn]
            xyz, label = xyz.copy(), label.copy()
        else:
            data = _load_pth(fn)
            if self.split_file.find('test') < 0:
                xyz, rgb, label = data[0], data[1], data[2]
            else:
                xyz, rgb = data[0], data[1]
                label = np.full(xyz.shape[0], self.ignore_label, np.int64)
            xyz = np.asarray(xyz, np.float64)
            label = np.asarray(label, np.int64)
            if self.cache_enabled:
                self._cache[fn] = (xyz.copy(), label.copy())
        if self.class_mapper is not None:
            label = self.class_mapper[label.astype(np.int64)]
        if self.training and self.pseudo_labels_dir is not None:
            label = self.load_pseudo_labels(
                os.path.basename(fn)[:-len(self.data_suffix)])
        return xyz, label

    def soft_data_name(self, index):
        fn = self.data_list[index]
        return os.path.basename(fn)[:-len(self.data_suffix)]

    def __getitem__(self, item):
        """(ref: dataset/scannet.py:60-83)"""
        rng = self.item_rng(item)
        index = item % len(self.data_list)
        xyz, label = self.load_data(index)
        if self.soft_mode:
            # SOFT_LABEL mode: plain path keeps soft rows point-aligned
            return self.soft_item(index, xyz, label)
        if self.training and self.aug.get('enabled', False):
            # retry-on-empty with a random index (ref :72-73); the loop
            # continues the same per-item stream, so the chain is
            # deterministic and cannot cycle
            for _ in range(64):
                out = self.run_augmentor(xyz, label, rng)
                if out is not None:
                    break
                index = int(rng.integers(len(self)))
                xyz, label = self.load_data(index)
            else:
                raise RuntimeError('augmentor produced 64 empty scenes '
                                   'in a row — check DATA_AUG config')
            xyz_v, xyz_middle, label = out
        else:
            xyz_v, xyz_middle = self.plain_item(xyz)
        return xyz_v, xyz_middle, label, index, {}
