"""Shared pieces of the port's self-training tests
(tests/test_torch_st.py, tests/test_torch_soft_label.py): the 2-level
float32 net's config with DSNorm on, its batches, the step constants."""

import numpy as np
import torch

from doda_tpu.models import unet as junet
from doda_tpu_torch.config import CfgNode
from doda_tpu_torch.models import model_fn as tmf

N_CLASSES = 20
LEVELS = 2
CAPS = junet.default_brick_caps(192, LEVELS, floor=32)
LRS = (0.05, 0.02)
W_SRC, W_TAR = 0.5, 1.0
TOL = 1e-3


def st_cfg(soft=None):
    cfg = CfgNode({
        'COMMON_CLASSES': {'n_classes': N_CLASSES},
        'MODEL': {'BACKBONE': {'use_xyz': False, 'in_channel': 3,
                               'mid_channel': 16, 'block_residual': True,
                               'block_reps': 1, 'num_levels': LEVELS},
                  'dsnorm': True},
        'DATA_CONFIG': {'DATA_CLASS': {'ignore_label': 255,
                                       'n_classes': N_CLASSES},
                        'DATA_AUG': {'enabled': True, 'device': False,
                                     'aug_list': ['scene_aug', 'elastic']}},
        'DATA_CONFIG_TAR': {'DATA_AUG': {
            'enabled': True, 'device': False,
            'aug_list': ['scene_aug', 'elastic', 'crop', 'shuffle'],
            'elastic': {'enabled': True}}},
        'OPTIMIZATION': {'loss': 'cross_entropy', 'optim': 'sgd',
                         'base_lr': 0.05, 'momentum': 0.9,
                         'weight_decay': 1e-4}})
    if soft is not None:
        cfg.SOFT_LABEL = soft
    return cfg


def st_batch(seed):
    rng = np.random.default_rng(seed)
    coords = rng.integers(0, 44, (2, 384, 3)).astype(np.int32)
    valid = np.zeros((2, 384), bool)
    valid[:, :300] = True
    feats = rng.normal(size=(2, 384, 3)).astype(np.float32)
    labels = rng.integers(0, N_CLASSES, (2, 384)).astype(np.int32)
    labels[rng.random((2, 384)) < 0.1] = 255
    return coords, feats, labels, valid


def st_points(batch):
    return tmf.PointBatch(*(torch.from_numpy(a) for a in batch))
