"""3D-FRONT synthetic-scene reader (ref: dataset/front3d.py).

A copy of ``doda_tpu/data/front3d.py``.

Scenes are ``.npy`` (or ``.ply``) xyzrgbl arrays listed by split files
(data/3dfront/{train,val}_list.txt). Includes the reference's
spatial-extent rejection ((xyz.max // 64).min() < 1, ref :80-81) and
random downsampling_scale subsampling.
"""

from __future__ import annotations

import os

import numpy as np

from .dataset import Dataset


def _load_points(path, suffix):
    if suffix == '.npy':
        return np.load(path, allow_pickle=True)
    if suffix == '.ply':
        try:
            import plyfile
        except ImportError as e:
            raise RuntimeError('.ply support requires plyfile') from e
        fn = plyfile.PlyData.read(path)
        return np.array([list(x) for x in fn.elements[0]])
    raise NotImplementedError(suffix)


class Front3dDataset(Dataset):

    def __init__(self, cfg, class_names, batch_size, split='training',
                 training=True, logger=None, seed=None):
        super().__init__(cfg, class_names, batch_size, split=split,
                         training=training, logger=logger, seed=seed)
        self.data_suffix = cfg.DATA_SPLIT.data_suffix
        list_file = os.path.normpath(os.path.join(
            self.data_root, cfg.DATA_SPLIT.split_files[split]))
        with open(list_file) as f:
            self.data_list = [line.strip() for line in f if line.strip()]
        self.cache_enabled = cfg.DATA_PROCESSOR.get('cache', False)
        self._cache = {}
        if self.logger:
            self.logger.info('Totally {} samples in {} set.'.format(
                len(self.data_list), self.split))

    def load_data(self, index):
        """(ref: dataset/front3d.py:42-58)"""
        fn = self.data_list[index]
        path = os.path.join(self.data_root, fn)[:-4] + self.data_suffix
        if self.cache_enabled and path in self._cache:
            points = self._cache[path].copy()
        else:
            points = _load_points(path, self.data_suffix)
            if self.cache_enabled:
                self._cache[path] = points.copy()
        xyz = np.ascontiguousarray(points[:, :3]).astype(np.float64)
        label = np.ascontiguousarray(points[:, 6]).astype(np.int64)
        if self.class_mapper is not None:
            label = self.class_mapper[label]
        if self.pseudo_labels_dir is not None:
            label = self.load_pseudo_labels(
                os.path.basename(fn)[:-4])
        return xyz, label

    def soft_data_name(self, index):
        return os.path.basename(self.data_list[index])[:-4]

    def __getitem__(self, item):
        """(ref: dataset/front3d.py:59-86)"""
        rng = self.item_rng(item)
        index = item % len(self.data_list)
        for _ in range(64):  # retry-on-empty (deterministic stream)
            xyz, label = self.load_data(index)
            xyz -= xyz.mean(0)
            sel = None
            if self.downsampling_scale > 1:
                sel = self.subsample_idx(xyz.shape[0],
                                         self.downsampling_scale, rng)
                xyz, label = xyz[sel], label[sel]
            if self.soft_mode:
                return self.soft_item(index, xyz, label, sel)
            if self.training and self.aug.get('enabled', False):
                out = self.run_augmentor(xyz, label, rng)
                if out is None:
                    index = int(rng.integers(len(self)))
                    continue
                xyz_v, xyz_middle, label = out
            else:
                xyz_v, xyz_middle = self.plain_item(xyz)
            # reject spatially degenerate augmented scenes (ref :80-81)
            if self.training and (xyz_v.max(0) // 64).min() < 1:
                index = int(rng.integers(len(self)))
                continue
            return xyz_v, xyz_middle, label, index, {}
        raise RuntimeError('augmentor produced 64 empty/degenerate scenes '
                           'in a row — check DATA_AUG config')
