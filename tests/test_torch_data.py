"""The port's data path vs the JAX package's, on the same synthetic rooms.

``tools/make_synth_data.py`` writes ScanNet-, 3D-FRONT- and S3DIS-format
rooms of ~2,500 points. The same configs and seeds go through
``doda_tpu.data`` and ``doda_tpu_torch.data``; each loader runs an epoch
with two worker threads and the collated batches must agree: coords,
labels, valid, ids, lengths, extras, full-resolution arrays and region
groups exactly, feats to 1e-6. Cases: ScanNet train (scene_aug, elastic,
crop, shuffle) and eval, 3D-FRONT with VSS, S3DIS eval with its ``full``
arrays, region-split eval, and two TACM-mixed epochs whose split sampler
has a queue (its state compared after them). Soft-label items, the
loader's errors, the native library and the brick audit are in
tests/test_torch_data_host.py.

The elastic warp runs in each package's native library. To compare the
Python logic exactly, the port's ``host_ops`` is pointed at the JAX
package's library for the batch comparisons (a monkeypatch here only);
the port's own build is held to the JAX library and to the plain
NumPy/scipy paths separately (tests/test_torch_data_host.py).
"""

import numpy as np
import pytest

from _torch_data_common import (N_POINTS, SEED, assert_batches_equal,
                                cfgs, equal, make_rooms, run_epoch)
from doda_tpu import data as jdata
from doda_tpu.native import host_ops as jhost
from doda_tpu_torch import data as tdata
from doda_tpu_torch.native import host_ops as thost


@pytest.fixture(scope='module')
def root(tmp_path_factory):
    return make_rooms(tmp_path_factory.mktemp('synth_data'))


@pytest.fixture
def same_native(monkeypatch):
    """The port's host ops on the JAX package's library."""
    monkeypatch.setattr(thost, '_load', jhost._load)


CASES = {
    # cfg file, which data config, split, training
    'scannet_train': ('cfgs/scannet/spconv.yaml', 'DATA_CONFIG',
                      'training', True),
    'scannet_eval': ('cfgs/scannet/spconv.yaml', 'DATA_CONFIG',
                     'validation', False),
    'front3d_vss': ('cfgs/da_front3d_scannet/spconv.yaml', 'DATA_CONFIG',
                    'training', True),
    's3dis_eval_downsampled': ('cfgs/s3dis/spconv.yaml', 'DATA_CONFIG_TAR',
                               'validation', False),
}


@pytest.mark.parametrize('case', sorted(CASES))
def test_batches_match(root, same_native, case):
    path, key, split, training = CASES[case]
    jcfg, tcfg = cfgs(path, root)
    kw = dict(split=split, training=training, drop_last=training)
    want = run_epoch(jdata.build_dataloader, jcfg[key], **kw)
    got = run_epoch(tdata.build_dataloader, tcfg[key], **kw)
    assert_batches_equal(got, want)
    if case.startswith('s3dis'):
        assert all(b.full is not None for b in got)
    if case == 'front3d_vss':      # VSS dropped points before the crop
        assert max(max(b.lengths) for b in got) < N_POINTS


def test_region_eval_batches_match(root, same_native):
    """Region-split eval (``DATA_PROCESSOR.region_eval``): a room larger
    than the largest capacity bucket is quadrant-split into rows grouped
    by scene; ``full`` carries the full-resolution arrays for the 1-NN
    broadcast. (S3DIS's own eval collate always carries ``full``: the
    downsampled case above.)"""
    jcfg, tcfg = cfgs('cfgs/scannet/spconv.yaml', root)
    for cfg in (jcfg, tcfg):
        dp = cfg.DATA_CONFIG_TAR.DATA_PROCESSOR
        dp.region_eval, dp.max_npoint = True, 256
    kw = dict(split='validation', training=False)
    want = run_epoch(jdata.build_dataloader, jcfg.DATA_CONFIG_TAR, **kw)
    got = run_epoch(tdata.build_dataloader, tcfg.DATA_CONFIG_TAR, **kw)
    assert_batches_equal(got, want)
    assert any(len(g) > 1 for b in got for g in b.groups)


def _mix_epochs(pkg, cfg, update):
    """Two epochs of the TACM-mixed target set with its split sampler
    initialized and updated from each batch, as the st loop does; returns
    the batches and the sampler.

    The items are made on this thread, batch by batch in the sampler's
    order, as the loader would make them (its epoch hand-over, full
    batches, ``collate_batch``), each batch's update before the next
    batch's items. Through the threaded loader, which makes items up to
    (prefetch + 1) batches ahead, whether an item's TACM draw saw the
    queue before or after an earlier batch's update depended on thread
    timing (ROADMAP.md section C); the loader itself is covered by the
    other tests of this file."""
    mixed, loader, sampler = pkg.build_mix_dataloader(
        cfg.DATA_CONFIG_TAR, cfg.DATA_CONFIG, 2, workers=2, seed=SEED)
    split = mixed.split_sampler
    ratio = np.array([0.3, 0.3] + [0.4 / 9] * 9)
    split.init_class_ratio({'class_ratio': ratio})
    cq = cfg.DATA_CONFIG_TAR.DATA_AUG.tacm.cuboid_queue
    split.update_cfg(cq)
    batches = []
    for epoch in range(2):
        sampler.set_epoch(epoch)
        mixed.set_epoch(epoch)
        idx = sampler.indices()
        for i in range(0, len(idx) - loader.batch_size + 1,
                       loader.batch_size):
            batch = mixed.collate_batch(
                [mixed[int(j)] for j in idx[i:i + loader.batch_size]])
            update(split, batch.extras, cq.num_class, True)
            batches.append(batch)
    return batches, split


def test_tacm_mixed_epochs_and_split_sampler_match(root, same_native):
    from doda_tpu_torch.tools.st import update_split_sampler as tupdate
    import st as jst                      # tools/st.py (compiles nothing)
    jcfg, tcfg = cfgs('cfgs/da_front3d_scannet/spconv_st.yaml', root)
    for cfg in (jcfg, tcfg):
        cfg.DATA_CONFIG_TAR.DATA_AUG.tacm.p = 1.0
    want, jsplit = _mix_epochs(jdata, jcfg, jst.update_split_sampler)
    got, tsplit = _mix_epochs(tdata, tcfg, tupdate)
    assert_batches_equal(got, want)
    assert any(b.extras.get('tar_tail_splits') for b in got)
    state = ('class_ratio', 'inverse_class_ratio', 'tail_class_ratio',
             'tail_class_idx')
    for name in state:
        equal(getattr(tsplit, name), getattr(jsplit, name), name)
    assert sum(q.cur_size for q in tsplit.queues) > 0
    for tq, jq in zip(tsplit.queues, jsplit.queues):
        assert (tq.size, tq.ptr, tq.cur_size) == (jq.size, jq.ptr,
                                                  jq.cur_size)
        equal(tq.queue[:tq.cur_size], jq.queue[:jq.cur_size], 'queue')


