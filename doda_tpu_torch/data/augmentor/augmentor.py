"""Augmentation pipeline + TACM state (cuboid queue, tail sampler).

A copy of ``doda_tpu/data/augmentor/augmentor.py``. It mirrors the
reference's ``DataAugmentor`` (config-ordered aug queue,
ref: dataset/augmentor/data_augmentor.py:111-236), ``Queue`` fixed-size
ring buffer (ref :15-40) and ``SplitSampler`` inverse-class-ratio tail
sampler with EMA updates and save/load (ref :43-108). State is plain
NumPy and persists via np.savez/pickle instead of torch.save.
"""

from __future__ import annotations

import pickle

import numpy as np

from . import aug_ops


class Queue:
    """Fixed-size ring buffer of arrays (ref: data_augmentor.py:15-40)."""

    def __init__(self, size):
        assert size > 0
        self.size = size
        self.queue = [None] * size
        self.ptr = 0
        self.cur_size = 0

    def update(self, items):
        if not items:
            return
        items = items[:self.size]
        new_ptr = self.ptr + len(items)
        wrap = min(new_ptr, self.size)
        self.queue[self.ptr:wrap] = items[:wrap - self.ptr]
        self.queue[:new_ptr - wrap] = items[wrap - self.ptr:]
        self.cur_size = min(self.cur_size + len(items), self.size)
        self.ptr = new_ptr % self.size

    def sample(self, n, rng):
        if self.cur_size == 0:
            return []
        n = min(n, self.cur_size)
        idx = rng.choice(self.cur_size, size=n, replace=False)
        return [self.queue[i] for i in idx]


class SplitSampler:
    """Per-tail-class cuboid queues with inverse-class-ratio sampling
    (ref: data_augmentor.py:43-108)."""

    def __init__(self, cfg):
        self.total_size = cfg['size']
        self.num_c = cfg['num_class']
        self.class_ratio = None

    @property
    def initialized(self):
        return self.class_ratio is not None

    def init_class_ratio(self, cfg):
        """cfg['class_ratio'] is the pseudo-label class distribution
        (ref :51-59)."""
        self.class_ratio = np.asarray(cfg['class_ratio'], np.float64)
        inv = np.where(self.class_ratio > 0,
                       1.0 / (self.class_ratio + 1e-9), 1e-9)
        self.inverse_class_ratio = inv
        order = np.argsort(-inv)
        self.tail_class_idx = order[:self.num_c]
        tail = np.sort(-inv)[:self.num_c]
        self.tail_class_ratio = tail / tail.sum()
        self.queues = [
            Queue(max(1, int(self.total_size * self.tail_class_ratio[c])))
            for c in range(self.num_c)]

    def update_cfg(self, cfg):
        """Publish thresholds into the tacm cuboid_queue cfg (ref :61-65)."""
        cfg['class_ratio'] = self.class_ratio
        thres = np.ones_like(self.class_ratio)
        thres[self.tail_class_idx] = self.class_ratio[self.tail_class_idx]
        cfg['class_thres'] = thres
        cfg['tail_class_idx'] = self.tail_class_idx

    def update(self, items):
        """items: list per tail class of cuboid arrays (ref :72-77)."""
        assert len(items) == self.num_c
        for c in range(self.num_c):
            self.queues[c].update(items[c])

    def get_split(self, n, rng):
        """Sample n cuboids, classes drawn by tail ratio (ref :79-88)."""
        if n == 0:
            return []
        cls = rng.choice(self.num_c, size=n, p=self.tail_class_ratio)
        out = []
        for c in cls:
            out.extend(self.queues[c].sample(1, rng))
        return out

    def update_class_ratio(self, class_ratio):
        """EMA drift of sampling ratios (ref :90-94)."""
        class_ratio = np.asarray(class_ratio, np.float64)
        if class_ratio.max() > 0:
            inv = 1.0 / (class_ratio + 1e-1)
            inv /= inv.sum()
            self.tail_class_ratio = 0.999 * self.tail_class_ratio + 0.001 * inv

    def save(self, path):
        with open(path, 'wb') as f:
            pickle.dump({'queues': self.queues,
                         'class_ratio': self.class_ratio,
                         'inverse_class_ratio': self.inverse_class_ratio,
                         'tail_class_ratio': self.tail_class_ratio,
                         'tail_class_idx': self.tail_class_idx}, f)

    def load(self, path):
        with open(path, 'rb') as f:
            state = pickle.load(f)
        self.queues = state['queues']
        self.class_ratio = state['class_ratio']
        self.inverse_class_ratio = state['inverse_class_ratio']
        self.tail_class_ratio = state['tail_class_ratio']
        self.tail_class_idx = state['tail_class_idx']


class DataAugmentor:
    """Config-ordered augmentation pipeline (ref: data_augmentor.py:111-236).

    Each stage consumes/produces a dict with 'xyz_middle' (float coords),
    'xyz' (voxel-unit coords), 'label', 'valid'."""

    def __init__(self, aug_cfg, dataset_name, class_names, ignore_label,
                 voxel_scale, voxel_mode, full_scale, point_range,
                 max_npoint, seed=None):
        self.cfg = aug_cfg
        self.dataset_name = dataset_name
        self.class_names = class_names
        self.ignore_label = ignore_label
        self.voxel_scale = voxel_scale
        self.voxel_mode = voxel_mode
        self.full_scale = full_scale
        self.point_range = point_range
        self.max_npoint = max_npoint
        self.rng = np.random.default_rng(seed)
        self.init_queue(self.cfg.get('aug_list', []))
        self.split_sampler = None
        tacm_cfg = self.cfg.get('tacm')
        if tacm_cfg and tacm_cfg.get('enabled', False) \
                and tacm_cfg.get('cuboid_queue', {}).get('enabled', False):
            self.split_sampler = SplitSampler(tacm_cfg['cuboid_queue'])

    def init_queue(self, aug_list):
        """Device mode (``DATA_AUG.device``): scene_aug + elastic move
        into the train and st steps (``data/device_aug.py``); the host keeps
        the stages that change the point set or need irregular state
        (vss/tacm/crop/shuffle). scene_aug drops out of the pipeline and
        elastic runs its pass-through branch (scale + min-shift only) so
        crop still sees voxel-unit coords."""
        device = bool(self.cfg.get('device', False))
        self.pipeline = []
        for name in aug_list:
            if device and name == 'scene_aug':
                continue
            stage_cfg = None if (device and name == 'elastic') \
                else self.cfg.get(name)
            self.pipeline.append((name, getattr(self, name), stage_cfg))

    def forward(self, data, rng=None):
        """``rng``: the per-item Generator (Dataset.item_rng). Falls back
        to the augmentor's own stream for single-threaded callers; loader
        worker threads MUST pass one (a shared np.random.Generator is not
        thread-safe and loses run-to-run determinism under workers>1)."""
        rng = self.rng if rng is None else rng
        data['valid'] = True
        for _, fn, cfg in self.pipeline:
            data = fn(cfg, data, rng)
        return data

    def _enabled(self, cfg, rng):
        return aug_ops.check_key(cfg) and aug_ops.check_p(cfg, rng)

    def _ok(self, data):
        return data.get('valid', True)

    @staticmethod
    def _select(data, idx):
        for key in ('xyz_middle', 'xyz', 'label'):
            if key in data:
                data[key] = data[key][idx]
        return data

    # ---- stages (names match cfg aug_list entries) ----

    def scene_aug(self, cfg, data, rng=None):
        """(ref: data_augmentor.py:188-193)"""
        rng = self.rng if rng is None else rng
        if self._enabled(cfg, rng) and self._ok(data):
            data['xyz_middle'] = aug_ops.scene_aug(cfg, data['xyz_middle'],
                                                   rng)
            if data['xyz_middle'].shape[0] == 0:
                data['valid'] = False
        return data

    def elastic(self, cfg, data, rng=None):
        """(ref: data_augmentor.py:171-186)"""
        rng = self.rng if rng is None else rng
        data['xyz'] = data['xyz_middle'] * self.voxel_scale
        if self._enabled(cfg, rng) and self._ok(data):
            try:
                for gran_fac, mag_fac in cfg['value']:
                    data['xyz'] = aug_ops.elastic(
                        data['xyz'], gran_fac * self.voxel_scale // 50,
                        mag_fac * self.voxel_scale / 50, rng)
                if cfg.get('apply_to_feat', False):
                    data['xyz_middle'] = data['xyz'] / self.voxel_scale
            except Exception:
                data['xyz'] = data['xyz_middle'] * self.voxel_scale
        data['xyz'] = data['xyz'] - data['xyz'].min(0)
        return data

    def vss(self, cfg, data, rng=None):
        """(ref: data_augmentor.py:195-204)"""
        rng = self.rng if rng is None else rng
        if self._enabled(cfg, rng) and self._ok(data):
            xyz, keep = aug_ops.virtual_scan_simulation(
                cfg, data['xyz_middle'], data['label'], self.class_names,
                rng, ignore_label=self.ignore_label)
            data['xyz_middle'] = xyz
            data = self._select(data, keep)
            if data['xyz_middle'].shape[0] == 0:
                data['valid'] = False
        return data

    def tacm(self, cfg, data, rng=None):
        """Two-cloud mixing entry (ref: data_augmentor.py:207-221)."""
        rng = self.rng if rng is None else rng
        if aug_ops.check_key(cfg):
            xyz, label, info = aug_ops.tacm(
                cfg, self.split_sampler, self.class_names,
                (data.pop('xyz_middle1'), data.pop('label1')),
                (data.pop('xyz_middle2'), data.pop('label2')), rng)
            data['xyz_middle'] = xyz
            data['label'] = label
            data['tacm_info'] = info
        return data

    def crop(self, cfg, data, rng=None):
        """(ref: data_augmentor.py:223-230)"""
        rng = self.rng if rng is None else rng
        data['xyz'], valid_idx = aug_ops.crop(
            data['xyz'], self.full_scale, self.point_range,
            self.max_npoint, rng)
        data = self._select(data, valid_idx)
        if data['xyz_middle'].shape[0] == 0:
            data['valid'] = False
        return data

    def shuffle(self, cfg, data, rng=None):
        """(ref: data_augmentor.py:232-235)"""
        rng = self.rng if rng is None else rng
        perm = rng.permutation(data['xyz_middle'].shape[0])
        return self._select(data, perm)
