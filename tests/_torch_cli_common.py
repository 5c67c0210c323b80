"""Shared pieces of the port's CLI tests (tests/test_torch_cli.py,
tests/test_torch_cli_main.py): synthetic rooms and the ``--set`` pairs
that point the DA configs at them with a small net."""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..', 'tools'))

from make_synth_data import (make_front3d, make_s3dis,  # noqa: E402
                             make_scannet)

BRICK_CAP = 2560
CFG_DA = 'cfgs/da_front3d_scannet/spconv.yaml'
CFG_ST = 'cfgs/da_front3d_scannet/spconv_st.yaml'
CFG_S3DIS = 'cfgs/da_front3d_s3dis/spconv.yaml'


def make_cli_rooms(root):
    """ScanNet (4 train, 3 val), 3D-FRONT (4 train, 1 val) and S3DIS (1
    train, 2 val) rooms of ~2,500 points under ``root``."""
    rng = np.random.default_rng(0)
    make_scannet(str(root), n_train=4, n_val=3, n_points=2500, rng=rng)
    make_front3d(str(root), n_train=4, n_val=1, n_points=2500, rng=rng)
    make_s3dis(str(root), n_train=1, n_val=2, n_points=2500, rng=rng)
    return root


def data_sets(root, s3dis=False):
    """--set pairs of the data roots and splits, and the small net."""
    tar = ['DATA_CONFIG_TAR.DATA_ROOT',
           str(root / 's3dis/trainval_fullarea')] if s3dis else [
        'DATA_CONFIG_TAR.DATA_ROOT', str(root / 'scannetv2'),
        'DATA_CONFIG_TAR.DATA_SPLIT.training', 'train',
        'DATA_CONFIG_TAR.DATA_SPLIT.validation', 'val',
        'DATA_CONFIG_TAR.DATA_SPLIT.test', 'val']
    return ['DATA_CONFIG.DATA_ROOT', str(root / '3dfront/density1250'),
            *tar, 'DATA_CONFIG.DATA_PROCESSOR.brick_cap', str(BRICK_CAP),
            'DATA_CONFIG_TAR.DATA_PROCESSOR.brick_cap', str(BRICK_CAP),
            'MODEL.BACKBONE.mid_channel', '4']
