"""Shared pieces of the port's data-path tests (tests/test_torch_data*.py):
synthetic rooms, the same config through both packages, and the
recursive equality the batches are held to (integers exact, floats to
1e-6)."""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..', 'tools'))

from make_synth_data import (make_front3d, make_s3dis,  # noqa: E402
                             make_scannet)

from doda_tpu import config as jconfig  # noqa: E402
from doda_tpu_torch import config as tconfig  # noqa: E402

N_POINTS = 2500
SEED = 7


def cfgs(path, root):
    """The cfg file through each package's config, data roots and sizes
    set alike: (JAX cfg, port cfg)."""
    out = []
    for config in (jconfig, tconfig):
        cfg = config.cfg_from_yaml_file(path, config.CfgNode())
        for key in ('DATA_CONFIG', 'DATA_CONFIG_TAR'):
            dc = cfg[key]
            dc.DATA_ROOT = str(root / {
                'scannet': 'scannetv2', 'front3d': '3dfront/density1250',
                's3dis': 's3dis/trainval_fullarea'}[dc.DATASET])
            dc.DATA_PROCESSOR.max_npoint = 2000
            if dc.DATASET == 'scannet':
                dc.DATA_SPLIT.update(training='train', validation='val',
                                     test='val')
        out.append(cfg)
    return out


def equal(got, want, what):
    """Recursive comparison: arrays exact, floats to 1e-6."""
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            equal(got[k], want[k], f'{what}.{k}')
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            equal(g, w, f'{what}[{i}]')
    elif want is None:
        assert got is None, what
    else:
        g, w = np.asarray(got), np.asarray(want)
        assert g.shape == w.shape, (what, g.shape, w.shape)
        if np.issubdtype(w.dtype, np.floating):
            err = np.abs(g.astype(np.float64) - w).max() if w.size else 0.0
            assert err <= 1e-6, (what, err)
        else:
            np.testing.assert_array_equal(g, w, err_msg=what)


def assert_batches_equal(got, want):
    assert len(got) == len(want) > 0
    for i, (tb, jb) in enumerate(zip(got, want)):
        for name in ('coords', 'feats', 'labels', 'valid'):
            t = getattr(tb.points, name)
            assert isinstance(t, torch.Tensor) and t.device.type == 'cpu'
            equal(t.numpy(), getattr(jb.points, name), f'{i}.{name}')
        equal([int(x) for x in tb.ids], [int(x) for x in jb.ids],
              f'{i}.ids')
        equal(tb.lengths, jb.lengths, f'{i}.lengths')
        equal(tb.extras, jb.extras, f'{i}.extras')
        equal(tb.full, jb.full, f'{i}.full')
        equal(tb.groups, jb.groups, f'{i}.groups')


def run_epoch(build, dc, epoch=0, **kw):
    _, loader, sampler = build(dc, 2, workers=2, seed=SEED, **kw)
    sampler.set_epoch(epoch)
    return list(loader)


def make_rooms(root):
    """ScanNet (4 train, 3 val), 3D-FRONT (4 train, 1 val) and S3DIS (1
    train, 3 val) rooms of ~2,500 points under ``root``."""
    rng = np.random.default_rng(0)
    make_scannet(str(root), n_train=4, n_val=3, n_points=N_POINTS, rng=rng)
    make_front3d(str(root), n_train=4, n_val=1, n_points=N_POINTS, rng=rng)
    make_s3dis(str(root), n_train=1, n_val=3, n_points=N_POINTS, rng=rng)
    return root
