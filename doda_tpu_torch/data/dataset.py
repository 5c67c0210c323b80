"""Dataset base: class mapping, pseudo-labels, padded collate.

Port of ``doda_tpu/data/dataset.py``: the same logic, with the collate
producing the port's ``PointBatch`` as CPU torch tensors over the same
numpy arrays. Reference counterpart: dataset/dataset.py. Key difference:
the reference collates ragged scenes into one concatenated (N, ...)
buffer plus offsets and voxelizes on the host CPU (dataset.py:121-187);
here each scene is padded to a per-scene capacity and stacked
(B, N_cap, ...) — the plan is built on the device inside the step.
Capacities come from the JAX package's bucket ladder, kept as it is so
that the point counts of a batch match its batches.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import torch

from ..models.model_fn import PointBatch
from .augmentor.augmentor import DataAugmentor
from .class_mapper import get_mapper


def pow2_bucket(n: int, buckets) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


class CollatedBatch:
    """A PointBatch plus host-side metadata the jitted step doesn't see.

    ``groups`` (region eval only): one entry per dataset scene, listing
    the batch rows holding that scene's crop regions."""

    def __init__(self, points: PointBatch, ids, lengths, extras=None,
                 full=None, groups=None):
        self.points = points
        self.ids = ids
        self.lengths = lengths
        self.extras = extras or {}
        self.full = full  # full-resolution arrays for crop_to_regions eval
        self.groups = groups


class Dataset:
    """Base dataset (ref: dataset/dataset.py:19-228)."""

    def __init__(self, cfg, class_names, batch_size, split='training',
                 training=True, logger=None, seed=None):
        self.cfg = cfg
        self.data_root = cfg.DATA_ROOT
        self.dataset = cfg.DATASET
        self.class_names = list(class_names)
        self.batch_size = batch_size
        self.logger = logger
        self.split = split
        self.training = training
        dp = cfg.DATA_PROCESSOR
        self.voxel_scale = dp.voxel_scale
        self.max_npoint = dp.max_npoint
        self.full_scale = dp.full_scale
        self.point_range = dp.point_range
        self.voxel_mode = dp.voxel_mode
        self.downsampling_scale = dp.get('downsampling_scale', 1)
        self.class_mapper, common = get_mapper(cfg.get('CLASS_MAPPER_FILE'))
        if common is not None:
            self.class_names = common
        self.ignore_label = cfg.DATA_CLASS.ignore_label
        self.pseudo_labels_dir = None
        self.use_soft_labels = False
        # self.rng serves the single-threaded collate path only; worker
        # threads draw from per-item generators (item_rng) — a shared
        # Generator is not thread-safe and loses determinism under the
        # loader's thread pool (ref analog: torch per-worker seeding,
        # util/common_utils.py:303-306).
        self.rng = np.random.default_rng(seed)
        self._entropy = seed if seed is not None \
            else int(np.random.SeedSequence().entropy) % (1 << 63)
        self._epoch = 0

        self.aug = cfg.DATA_AUG
        self.augmentor = DataAugmentor(
            self.aug, self.dataset, self.class_names, self.ignore_label,
            self.voxel_scale, self.voxel_mode, self.full_scale,
            self.point_range, self.max_npoint, seed=seed)

        # capacity ladder: train scenes are cropped to max_npoint; eval
        # scenes may be larger (no downsample/crop at inference,
        # ref util/pseudo_labels_util.py:49-51). sqrt(2)-spaced rungs
        # (2^k and 3*2^(k-1)), as the JAX package pads its batches.
        base = 1 << (int(self.max_npoint - 1).bit_length())
        rungs = []
        for b in (base // 4, base // 2, base, base * 2, base * 4):
            rungs += [b * 3 // 4, b]
        self.capacity_buckets = sorted(set(r for r in rungs
                                           if r >= base // 4))

    # ---- informational API mirrored from the reference ----

    def get_data_list(self):
        return self.data_list

    def set_training_mode(self, training):
        self.training = training

    def set_epoch(self, epoch):
        """Advance the per-item RNG streams (called by DataLoader)."""
        self._epoch = int(epoch)

    def item_rng(self, item):
        """Deterministic thread-local Generator for one ``__getitem__``
        call: keyed by (seed, epoch, item) so the augmentation stream is
        reproducible regardless of worker count or completion order."""
        return np.random.default_rng(
            (self._entropy, self._epoch, int(item)))

    def get_downsampling_scale(self):
        return self.downsampling_scale

    def set_downsampling_scale(self, ds):
        self.downsampling_scale = ds

    def set_pseudo_labels_dir(self, pseudo_labels_dir):
        """(ref: dataset/dataset.py:79-83)"""
        if os.path.exists(pseudo_labels_dir):
            self.pseudo_labels_dir = Path(pseudo_labels_dir)
        else:
            raise ValueError(
                f"pseudo label path {pseudo_labels_dir} doesn't exist.")

    def set_soft_labels(self, enabled: bool):
        """SOFT_LABEL mode: ``__getitem__`` skips augmentation (soft rows
        must stay point-aligned with the raw scene) and attaches the
        (N, C) distribution from the pseudo-label store."""
        self.use_soft_labels = bool(enabled)

    def load_soft_labels(self, data_name):
        from ..utils.pseudo_labels import load_scene_soft_labels
        return load_scene_soft_labels(self.pseudo_labels_dir, data_name)

    def soft_data_name(self, index):
        """File stem of scene ``index`` in the pseudo-label store —
        implemented by every concrete dataset so SOFT_LABEL mode works
        for any ST target, not just ScanNet."""
        raise NotImplementedError

    def soft_item(self, index, xyz, label, sel=None):
        """Shared SOFT_LABEL ``__getitem__`` branch: skip augmentation
        (soft rows must stay point-aligned with the raw scene), attach
        the stored (N, C) distribution. ``sel`` re-applies the caller's
        subsample indices so soft rows track a downsampled scene."""
        soft = self.load_soft_labels(self.soft_data_name(index))
        if sel is not None:
            soft = soft[sel]
        xyz_v, xyz_middle = self.plain_item(xyz)
        return xyz_v, xyz_middle, label, index, {'soft': soft}

    @property
    def soft_mode(self):
        return (self.training and self.use_soft_labels
                and self.pseudo_labels_dir is not None)

    def load_pseudo_labels(self, data_name):
        """int labels, one file per scene. Prefers the npy store; falls
        back to the reference's txt format (dataset/dataset.py:85-88)."""
        npy = self.pseudo_labels_dir / 'npy' / (data_name + '.npy')
        if npy.exists():
            return np.load(npy).astype(np.int64).reshape(-1)
        with open(self.pseudo_labels_dir / 'txt' / (data_name + '.txt')) as f:
            return np.loadtxt(f, dtype=np.int64).reshape(-1)

    def subsample_idx(self, n, ds_scale, rng=None):
        """Random 1/ds_scale subset, sorted (ref: dataset/dataset.py:73-77)."""
        rng = self.rng if rng is None else rng
        idx = rng.permutation(n)[:int(n / ds_scale)]
        idx.sort()
        return idx

    def crop_to_regions(self, xyz_all, threshold=6_000_000):
        """Overlapping quadrant masks (ref: dataset.py:99-113 — defined
        but never called upstream; wired here behind
        ``DATA_PROCESSOR.region_eval``)."""
        if xyz_all.shape[0] <= threshold:
            return []
        xyz_max, xyz_min = xyz_all.max(0), xyz_all.min(0)
        x_mid = (xyz_max[0] + xyz_min[0]) / 2.0
        y_mid = (xyz_max[1] + xyz_min[1]) / 2.0
        return [
            (xyz_all[:, 0] > x_mid - 0.5) & (xyz_all[:, 1] > y_mid - 0.5),
            (xyz_all[:, 0] > x_mid - 0.5) & (xyz_all[:, 1] < y_mid + 0.5),
            (xyz_all[:, 0] < x_mid + 0.5) & (xyz_all[:, 1] > y_mid - 0.5),
            (xyz_all[:, 0] < x_mid + 0.5) & (xyz_all[:, 1] < y_mid + 0.5),
        ]

    def split_to_regions(self, xyz_v, xyz_mid, label):
        """Recursively quadrant-split an oversized scene into regions
        that fit the largest capacity bucket; every point lands in at
        least one region (overlaps allowed), so eval drops nothing."""
        max_cap = self.capacity_buckets[-1]
        out = []
        stack = [(xyz_v, xyz_mid, label)]
        while stack:
            xv, xm, lb = stack.pop()
            masks = self.crop_to_regions(xm, threshold=max_cap)
            # degenerate split (all points inside the overlap band):
            # fall back to a random exact-cap subsample of this region
            if not masks or any(m.sum() >= xm.shape[0] for m in masks):
                if xm.shape[0] > max_cap:
                    sel = self.rng.permutation(xm.shape[0])[:max_cap]
                    sel.sort()
                    xv, xm, lb = xv[sel], xm[sel], lb[sel]
                out.append((xv, xm, lb))
                continue
            for m in masks:
                stack.append((xv[m], xm[m], lb[m]))
        return out

    def __len__(self):
        return len(self.data_list)

    def check_brick_capacity(self, batch, brick_cap, logger=None,
                             num_levels=1, brick=4):
        """One-shot overflow audit across ALL U-Net levels: count each
        scene's occupied bricks at every stride-2 level (host numpy)
        against the model's capacity schedule
        (``models.unet.default_brick_caps(brick_cap, num_levels)``).
        Bricks beyond capacity fall into the null slot silently (engine
        convention), so CLIs call this on their first batch to surface
        undersized ``brick_cap`` configs instead of quietly evaluating a
        truncated scene. Level 0 dominates on ScanNet-shaped data, but
        denser datasets (e.g. S3DIS) can overflow deep levels first.
        Bricks are counted as unique packed int64 keys, which gives the JAX
        package's counts ~30x faster than its row-wise ``np.unique``. They
        are bricks of side ``brick``, the model's (the JAX package's
        ``DODA_BRICK``); the schedule is the same at every side, as there,
        so at side 2 it drops bricks on rooms whose side-4 count it
        clears, and this audit warns."""
        from ..models.unet import default_brick_caps
        caps = default_brick_caps(brick_cap, max(num_levels, 1))
        coords = np.asarray(batch.points.coords)
        valid = np.asarray(batch.points.valid)
        worst = [0] * len(caps)
        for b in range(coords.shape[0]):
            c = coords[b][valid[b]]
            if len(c) == 0:
                continue
            bc = c.astype(np.int64) // brick
            for lvl in range(len(caps)):
                lc = bc >> lvl
                lc -= lc.min(0)
                dims = lc.max(0) + 1
                keys = (lc[:, 0] * dims[1] + lc[:, 1]) * dims[2] + lc[:, 2]
                worst[lvl] = max(worst[lvl], len(np.unique(keys)))
        over = [(lvl, w, caps[lvl]) for lvl, w in enumerate(worst)
                if w > caps[lvl]]
        if logger is not None:
            if over:
                for lvl, w, cap in over:
                    logger.warning(
                        'brick capacity overflow at level %d: a scene '
                        'occupies %d bricks but the cap is %d — %.0f%% '
                        'of bricks are being DROPPED; raise brick_cap '
                        '(DATA_PROCESSOR.brick_cap=%d)', lvl, w, cap,
                        100.0 * (w - cap) / w, brick_cap)
            else:
                util = ' '.join('L%d %d/%d' % (lvl, w, caps[lvl])
                                for lvl, w in enumerate(worst))
                logger.info('brick capacity ok (worst scene per level): '
                            '%s', util)
        return worst[0]

    def __getitem__(self, item):
        raise NotImplementedError

    def load_data(self, index):
        raise NotImplementedError

    def run_augmentor(self, xyz, label, rng=None):
        """Returns (xyz_voxel, xyz_middle, label) or None if invalid."""
        data = self.augmentor.forward({'xyz_middle': xyz, 'label': label},
                                      rng)
        if not data['valid']:
            return None
        return data['xyz'], data['xyz_middle'], data['label']

    def plain_item(self, xyz):
        """No-aug path: voxel coords from raw float coords
        (ref: dataset/scannet.py:76-79)."""
        xyz_middle = xyz.copy()
        v = xyz_middle * self.voxel_scale
        v = v - v.min(0)
        return v, xyz_middle

    # ---- collate ----

    def _pad_items(self, items):
        """Pad scenes into the next capacity bucket.

        Scenes beyond the largest bucket are randomly subsampled to fit;
        the caller carries the full-resolution arrays so eval can 1-NN
        broadcast predictions back (the fixed-capacity analog of the
        reference's crop_to_regions + KNN re-stitch,
        ref dataset/dataset.py:99-113 + model/unet.py:135-145).
        """
        max_cap = self.capacity_buckets[-1]
        items = list(items)
        overflow = {}
        for i, it in enumerate(items):
            n = it[0].shape[0]
            if n > max_cap:
                sel = self.rng.permutation(n)[:max_cap]
                sel.sort()
                overflow[i] = (it[1], it[2])  # full xyz_middle, labels
                info = it[4] if len(it) > 4 else {}
                if isinstance(info, dict) and 'soft' in info:
                    info = dict(info, soft=info['soft'][sel])
                items[i] = (it[0][sel], it[1][sel], it[2][sel], it[3],
                            info, *it[5:])
        lengths = [it[0].shape[0] for it in items]
        n_cap = pow2_bucket(max(lengths), self.capacity_buckets)
        b = len(items)
        coords = np.zeros((b, n_cap, 3), np.int32)
        feats = np.zeros((b, n_cap, 3), np.float32)
        labels = np.full((b, n_cap), self.ignore_label, np.int32)
        valid = np.zeros((b, n_cap), bool)
        ids = []
        for i, it in enumerate(items):
            xyz_v, xyz_mid, label, idx = it[:4]
            n = xyz_v.shape[0]
            coords[i, :n] = np.floor(xyz_v).astype(np.int32)
            feats[i, :n] = xyz_mid
            labels[i, :n] = label
            valid[i, :n] = True
            ids.append(idx)
        points = PointBatch(*(torch.from_numpy(a) for a in
                              (coords, feats, labels, valid)))
        return points, ids, lengths, overflow, items

    def collate_fn(self, items):
        """Train collate (ref: dataset/dataset.py:121-187). Extras carry
        TACM masks/queue payloads when present."""
        points, ids, lengths, _, items = self._pad_items(items)
        extras = {}
        for it in items:
            if len(it) > 4 and isinstance(it[4], dict) and it[4]:
                info = it[4]
                extras.setdefault('tar_tail_splits', []).extend(
                    info.get('tar_tail_splits', []))
                if 'tar_splits_class_ratio' in info:
                    extras.setdefault('tar_splits_class_ratio', []).append(
                        info['tar_splits_class_ratio'])
        if any(len(it) > 4 and isinstance(it[4], dict) and 'soft' in it[4]
               for it in items):
            n_cap = points.valid.shape[1]
            n_cls = next(it[4]['soft'].shape[-1] for it in items
                         if len(it) > 4 and 'soft' in it[4])
            soft = np.zeros((len(items), n_cap, n_cls), np.float32)
            for i, it in enumerate(items):
                s = it[4].get('soft') if len(it) > 4 else None
                if s is not None:
                    soft[i, :s.shape[0]] = s.astype(np.float32)
            extras['soft_labels'] = soft
        return CollatedBatch(points, ids, lengths, extras)

    def test_collate_fn(self, items):
        """(ref: dataset/dataset.py:189-222). Two oversized-scene modes:

        * default: subsample to the largest bucket, carry full-res arrays
          and 1-NN broadcast predictions back — this matches the
          reference's ACTUAL eval behavior (its ``crop_to_regions``
          method is dead code; the real path is the downsampling_scale
          subsample + knnquery broadcast, dataset/s3dis.py:60-63 +
          model/unet.py:135-145);
        * ``DATA_PROCESSOR.region_eval``: recursive quadrant split —
          every point is forwarded through the network in some region,
          then predictions restitch via 1-NN over the region union.
        """
        if self.cfg.DATA_PROCESSOR.get('region_eval', False):
            return self._region_collate(items)
        points, ids, lengths, overflow, items = self._pad_items(items)
        full = None
        if overflow:
            full = {'xyz_middle_all': [], 'label_all': []}
            feats, labels = points.feats.numpy(), points.labels.numpy()
            for i in range(len(items)):
                if i in overflow:
                    full['xyz_middle_all'].append(overflow[i][0])
                    full['label_all'].append(overflow[i][1])
                else:
                    n = lengths[i]
                    full['xyz_middle_all'].append(feats[i, :n])
                    full['label_all'].append(labels[i, :n])
        return CollatedBatch(points, ids, lengths, full=full)

    def _region_collate(self, items):
        """Region-split eval collate: oversized scenes expand into one
        row per quadrant region; ``groups[i]`` lists scene i's rows."""
        rows, groups, ids = [], [], []
        full = {'xyz_middle_all': [], 'label_all': []}
        for it in items:
            xyz_v, xyz_mid, label, idx = it[:4]
            ids.append(idx)
            full['xyz_middle_all'].append(xyz_mid)
            full['label_all'].append(label)
            regions = self.split_to_regions(xyz_v, xyz_mid, label)
            groups.append(list(range(len(rows), len(rows) + len(regions))))
            rows.extend((xv, xm, lb, idx) for xv, xm, lb in regions)
        points, _, lengths, _, _ = self._pad_items(rows)
        return CollatedBatch(points, ids, lengths, full=full,
                             groups=groups)

    def collate_batch(self, items):
        if not self.training:
            return self.test_collate_fn(items)
        return self.collate_fn(items)
