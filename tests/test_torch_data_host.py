"""Host pieces of the port's data path vs the JAX package's: soft-label
items, a raising item, the split sampler's save/load, the native library
(built from the port's own source) against the plain NumPy/scipy paths
and the JAX package's library, and the brick audit's counts. Rooms and
comparisons as in tests/test_torch_data.py.
"""

import numpy as np
import pytest
import torch

from _torch_threads import two_threads  # noqa: F401
from _torch_data_common import (SEED, assert_batches_equal, cfgs, equal,
                                make_rooms, run_epoch)
from doda_tpu import data as jdata
from doda_tpu.native import host_ops as jhost
from doda_tpu.utils import pseudo_labels as jpl
from doda_tpu_torch import data as tdata
from doda_tpu_torch.data.augmentor import aug_ops as taug
from doda_tpu_torch.native import host_ops as thost
from doda_tpu_torch.utils import pseudo_labels as tpl


@pytest.fixture(scope='module')
def root(tmp_path_factory):
    return make_rooms(tmp_path_factory.mktemp('synth_data'))


@pytest.fixture
def same_native(monkeypatch):
    """The port's host ops on the JAX package's library."""
    monkeypatch.setattr(thost, '_load', jhost._load)


def test_loader_raises_what_an_item_raises(root):
    """An item that raises ends the port's epoch with that error (the JAX
    package's loader waits forever: ROADMAP §C)."""
    _, tcfg = cfgs('cfgs/scannet/spconv.yaml', root)
    ds, loader, _ = tdata.build_dataloader(tcfg.DATA_CONFIG, 2, workers=2,
                                           seed=SEED)
    ds.set_pseudo_labels_dir(root)          # holds no pseudo labels
    with pytest.raises(FileNotFoundError):
        list(loader)


def test_split_sampler_save_load_round_trip(tmp_path):
    from doda_tpu_torch.data.augmentor.augmentor import SplitSampler
    rng = np.random.default_rng(1)
    s = SplitSampler({'size': 8, 'num_class': 2})
    s.init_class_ratio({'class_ratio': np.array([0.5, 0.3, 0.15, 0.05])})
    s.update([[rng.normal(size=(5, 4))], [rng.normal(size=(3, 4))]])
    s.save(tmp_path / 'split_sampler.pkl')
    back = SplitSampler({'size': 8, 'num_class': 2})
    back.load(tmp_path / 'split_sampler.pkl')
    for name in ('class_ratio', 'tail_class_ratio', 'tail_class_idx'):
        equal(getattr(back, name), getattr(s, name), name)
    equal(back.queues[0].queue[:1], s.queues[0].queue[:1], 'queue')


def test_soft_label_items_match(root, same_native, tmp_path):
    """SOFT_LABEL mode: items skip augmentation and carry the stored
    (N, C) distributions; the collate stacks them into
    ``extras['soft_labels']``."""
    jcfg, tcfg = cfgs('cfgs/scannet/spconv.yaml', root)
    rng = np.random.default_rng(2)
    scenes = sorted((root / 'scannetv2' / 'train').glob('*.pth'))
    names = [p.name[:-4] for p in scenes]
    store = tmp_path / 'pseudo_labels'
    for scene, name in zip(scenes, names):
        n = len(torch.load(scene, weights_only=False)[0])
        soft = rng.dirichlet(np.ones(20), n).astype(np.float32)
        jpl.save_scene_labels(store, name, soft.argmax(-1))
        jpl.save_scene_soft_labels(store, name, soft, rng.random(n) < 0.3)
    batches = []
    for pkg, cfg in ((jdata, jcfg), (tdata, tcfg)):
        ds, loader, sampler = pkg.build_dataloader(
            cfg.DATA_CONFIG, 2, workers=2, seed=SEED)
        ds.set_pseudo_labels_dir(store)
        ds.set_soft_labels(True)
        batches.append(list(loader))
    want, got = batches
    assert_batches_equal(got, want)
    assert all(b.extras['soft_labels'].shape[-1] == 20 for b in got)
    equal(tpl.load_scene_soft_labels(store, names[0]),
           jpl.load_scene_soft_labels(store, names[0]), 'store')


def test_native_library_builds_and_matches_plain_paths():
    """The port's own build (g++ from native/src/host_ops.cc into build/)
    against the scipy/NumPy paths, and against the JAX package's library
    on one input: the elastic offsets to 1e-6, 1-NN and components
    exactly."""
    lib = thost._load()
    assert 'build' in lib._name and lib._name != jhost._load()._name
    rng = np.random.default_rng(3)
    xyz = rng.uniform(-40, 200, (20000, 3))
    xyz[:50] *= 10                  # queries outside the noise grid
    dims = np.maximum((np.abs(xyz).max(0).astype(np.int32) // 6 + 3) // 2,
                      4)
    noise = [rng.standard_normal(dims).astype(np.float32) for _ in range(3)]
    n3 = np.stack([n.reshape(-1) for n in noise])
    got = thost.elastic_interp(n3, dims, 6.0, 40.0, xyz)
    offsets = (got - xyz) / 40.0
    plain = taug._trilinear_regular(noise, dims, 6, xyz)
    assert np.abs(offsets - plain).max() <= 1e-6
    assert np.abs(offsets).max() > 0.5
    jax_lib = jhost.elastic_interp(n3, dims, 6.0, 40.0, xyz)
    assert np.abs(got - jax_lib).max() <= 1e-6 * np.abs(xyz).max()

    src = rng.uniform(0, 5, (4000, 3))
    queries = rng.uniform(0, 5, (3000, 3))
    np.testing.assert_array_equal(thost.nn1(src, queries),
                                  thost.nn1(src, queries, native=False))
    key = rng.integers(0, 3, 4000)
    np.testing.assert_array_equal(
        thost.connected_components(src, key, 0.2),
        thost.connected_components(src, key, 0.2, native=False))


class _Log:
    def __init__(self):
        self.lines = []

    def info(self, msg, *args):
        self.lines.append(msg % args)

    warning = info


@pytest.mark.parametrize('cap', [64, 16384])
def test_brick_audit_counts_match(root, cap):
    """The port's packed-key brick audit gives the JAX package's counts
    at every level, over and under the caps."""
    jcfg, tcfg = cfgs('cfgs/scannet/spconv.yaml', root)
    kw = dict(split='validation', training=False)
    logs = []
    for pkg, cfg in ((jdata, jcfg), (tdata, tcfg)):
        batch = run_epoch(pkg.build_dataloader, cfg.DATA_CONFIG, **kw)[0]
        log = _Log()
        worst = pkg.Dataset.check_brick_capacity(None, batch, cap, log,
                                                 num_levels=4)
        logs.append((worst, log.lines))
    assert logs[0] == logs[1]
    assert ('overflow' in logs[1][1][0]) == (cap == 64), logs[1][1]
