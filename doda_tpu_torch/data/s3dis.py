"""S3DIS reader (ref: dataset/s3dis.py).

A copy of ``doda_tpu/data/s3dis.py``.

Area .npy files (xyzrgbl); Area-``test_area`` is the eval split. Training
randomly subsamples 1/downsampling_scale of the points; test items carry
the full-resolution arrays so eval can 1-NN-broadcast predictions back
(ref: test_collate_fn, dataset/s3dis.py:89-130 + model/unet.py:135-145).
"""

from __future__ import annotations

import os

import numpy as np

from .dataset import CollatedBatch, Dataset


class S3DISDataset(Dataset):

    def __init__(self, cfg, class_names, batch_size, split='training',
                 training=True, logger=None, seed=None):
        super().__init__(cfg, class_names, batch_size, split=split,
                         training=training, logger=logger, seed=seed)
        data_list = sorted(os.listdir(self.data_root))
        data_list = [d[:-4] for d in data_list if 'Area_' in d]
        area = 'Area_{}'.format(cfg.DATA_SPLIT.test_area)
        if cfg.DATA_SPLIT[split] == 'training':
            self.data_list = [d for d in data_list if area not in d]
        else:
            self.data_list = [d for d in data_list if area in d]
        self.cache_enabled = cfg.DATA_PROCESSOR.get('cache', False)
        self._cache = {}
        if self.logger:
            self.logger.info('Totally {} samples in {} set.'.format(
                len(self.data_list), self.split))

    def load_data(self, index):
        """(ref: dataset/s3dis.py:35-52)"""
        fn = self.data_list[index]
        path = os.path.join(self.data_root, fn + '.npy')
        if self.cache_enabled and path in self._cache:
            data = self._cache[path].copy()
        else:
            data = np.load(path)
            if self.cache_enabled:
                self._cache[path] = data.copy()
        xyz_all = data[:, 0:3].astype(np.float64)
        label_all = data[:, 6].astype(np.int64)
        if self.class_mapper is not None:
            label_all = self.class_mapper[label_all]
        if self.training and self.pseudo_labels_dir is not None:
            label_all = self.load_pseudo_labels(fn)
        return xyz_all, label_all

    def soft_data_name(self, index):
        return self.data_list[index]

    def __getitem__(self, item):
        """(ref: dataset/s3dis.py:54-81)"""
        rng = self.item_rng(item)
        index = item % len(self.data_list)
        for _ in range(64):  # retry-on-empty (deterministic stream)
            xyz_all, label_all = self.load_data(index)
            xyz_all = xyz_all - xyz_all.mean(0)
            sel = None
            if self.downsampling_scale > 1:
                sel = self.subsample_idx(xyz_all.shape[0],
                                         self.downsampling_scale, rng)
                xyz, label = xyz_all[sel], label_all[sel]
            else:
                xyz, label = xyz_all.copy(), label_all.copy()
            if self.soft_mode:
                return self.soft_item(index, xyz, label, sel)
            if not (self.training and self.aug.get('enabled', False)):
                break
            out = self.run_augmentor(xyz, label, rng)
            if out is not None:
                xyz_v, xyz_middle, label = out
                return xyz_v, xyz_middle, label, index, {}
            index = int(rng.integers(len(self)))
        else:
            raise RuntimeError('augmentor produced 64 empty scenes in a '
                               'row — check DATA_AUG config')
        xyz_v, xyz_middle = self.plain_item(xyz)
        if self.training:
            return xyz_v, xyz_middle, label, index, {}
        return (xyz_v, xyz_middle, label, index,
                {'xyz_middle_all': xyz_all, 'label_all': label_all})

    def test_collate_fn(self, items):
        """Carry full-resolution arrays for KNN broadcast
        (ref: dataset/s3dis.py:89-130)."""
        points, ids, lengths, _, _ = self._pad_items(items)
        full = {
            'xyz_middle_all': [it[4]['xyz_middle_all'] for it in items],
            'label_all': [it[4]['label_all'] for it in items],
        }
        return CollatedBatch(points, ids, lengths, full=full)
