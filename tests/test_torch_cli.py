"""The port's CLI loops, checkpoints and three CLIs, against the JAX ones.

Loops: the port's own eval, train and self-training steps (a 2-level,
mid-4 float32 net on the CPU), wrapped to take and return numpy and to
ignore ``state``, are passed into *both* the JAX CLIs' loops
(``tools/test.py::test_one_epoch``, ``tools/train.py::train_epoch`` and
``validate_epoch``, ``tools/st.py::set_pseudo_labels`` and
``train_epoch``) and the port's loops, each fed by its own package's
loader on the same synthetic rooms (``tools/make_synth_data.py``, ~2,500
points) and seeds. The logged metrics, the written scalars, the txt/npy
dumps (S3DIS broadcast and region-split ones included), the pseudo-label
store with ``class_ratio.txt`` and ``done.txt``, the split sampler and the
trained weights must come out the same. This holds the CLI logic to the
reference without compiling the JAX ``make_steps``. The port's host ops
run on the JAX package's library here (see tests/test_torch_data.py).
The CLIs' ``main`` end to end: tests/test_torch_cli_main.py.
"""

import argparse
import os
import re
import sys
import types

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..', 'tools'))

import st as jst  # noqa: E402  (tools/st.py)
import test as jtest  # noqa: E402  (tools/test.py)
import train as jtrain  # noqa: E402  (tools/train.py)
from _torch_threads import two_threads  # noqa: E402,F401
from _torch_cli_common import (BRICK_CAP, CFG_DA, CFG_S3DIS,  # noqa: E402
                               CFG_ST, data_sets, make_cli_rooms)

from doda_tpu import config as jconfig  # noqa: E402
from doda_tpu import data as jdata  # noqa: E402
from doda_tpu.data.mix_dataset import CuboidMixingDataset  # noqa: E402
from doda_tpu.native import host_ops as jhost  # noqa: E402
from doda_tpu_torch import config as tconfig  # noqa: E402
from doda_tpu_torch import data as tdata  # noqa: E402
from doda_tpu_torch.models import model_fn as tmf  # noqa: E402
from doda_tpu_torch.models.unet import default_brick_caps  # noqa: E402
from doda_tpu_torch.native import host_ops as thost  # noqa: E402
from doda_tpu_torch.tools import st as tst  # noqa: E402
from doda_tpu_torch.tools import test as ttest  # noqa: E402
from doda_tpu_torch.tools import train as ttrain  # noqa: E402
from doda_tpu_torch.utils import optim as toptim  # noqa: E402

SEED = 7


@pytest.fixture(scope='module')
def root(tmp_path_factory):
    return make_cli_rooms(tmp_path_factory.mktemp('synth_cli'))


@pytest.fixture(autouse=True)
def same_native(monkeypatch):
    monkeypatch.setattr(thost, '_load', jhost._load)


def _cfgs(path, root, levels=2, s3dis=False):
    """(JAX cfg, port cfg) of ``path`` with ``data_sets``."""
    out = []
    for config in (jconfig, tconfig):
        cfg = config.cfg_from_yaml_file(path, config.CfgNode())
        cfg.MODEL.BACKBONE.num_levels = levels
        config.cfg_from_list(data_sets(root, s3dis), cfg)
        out.append(cfg)
    return out


class Log:
    """Logger stand-in that keeps every message."""

    def __init__(self):
        self.lines = []

    def info(self, msg, *args):
        self.lines.append(msg % args if args else msg)

    warning = info

    def metrics(self):
        """The lines that carry no wall-clock time."""
        return [ln for ln in self.lines if not re.search(
            r'Data \d|Batch \d|Remain|Scenes/sec', ln)]


class Writer:
    def __init__(self):
        self.scalars = []

    def add_scalar(self, tag, value, step):
        self.scalars.append((tag, float(value), int(step)))


def _assert_same_scalars(got, want):
    assert [(t, s) for t, _, s in got] == [(t, s) for t, _, s in want]
    for (t, g, _), (_, w, _) in zip(got, want):
        assert abs(g - w) <= 1e-6 * max(1.0, abs(w)), (t, g, w)


def _torch(points):
    return tmf.PointBatch(*(torch.from_numpy(np.asarray(a).copy())
                            for a in points))


def _numpy(out):
    return {k: v.detach().cpu().numpy() for k, v in out.items()}


STATE = types.SimpleNamespace(params=None, batch_stats=None)


def _jax_steps(eval_step=None, train_step=None, st_step=None):
    """The port's steps in the JAX loops' signatures: numpy in and out,
    ``state`` passed through untouched."""
    out = {}
    if eval_step is not None:
        out['eval'] = lambda params, stats, points, domain=0, thres=None: \
            _numpy(eval_step(_torch(points), int(domain), thres))
    if train_step is not None:
        out['train'] = lambda state, points, lr, domain=0: (
            state, _numpy(train_step(_torch(points), lr, int(domain))))
    if st_step is not None:
        out['st'] = lambda state, src, tar, lr, ws, wt, **kw: (
            state, _numpy(st_step(_torch(src), _torch(tar), lr, ws, wt)))
    return out


def _model(cfg, seed=0, train=False):
    torch.manual_seed(seed)
    return tmf.build_model(cfg, device='cpu', dtype=torch.float32,
                           train=train)


def _caps(cfg, model):
    return default_brick_caps(BRICK_CAP, model.num_levels)


def _args(**kw):
    base = dict(epochs=1, start_epoch=0, print_freq=1, profile=0,
                eval_src=False, save_to_file=True, save_logit=True,
                manual_seed=None, batch_size=2, workers=2)
    base.update(kw)
    return argparse.Namespace(**base)


def _same_tree(got_dir, want_dir):
    files = sorted(p.relative_to(want_dir) for p in want_dir.rglob('*')
                   if p.is_file())
    assert files and files == sorted(p.relative_to(got_dir) for p in
                                     got_dir.rglob('*') if p.is_file())
    for rel in files:
        if rel.suffix == '.npy':
            np.testing.assert_array_equal(np.load(got_dir / rel),
                                          np.load(want_dir / rel), str(rel))
        else:
            assert (got_dir / rel).read_bytes() == \
                (want_dir / rel).read_bytes(), str(rel)
    return files


TEST_CASES = {
    # cfg, S3DIS target, region eval
    'scannet_trimmed': (CFG_DA, False, False),
    's3dis_broadcast': (CFG_S3DIS, True, False),
    'scannet_regions': (CFG_DA, False, True),
}


@pytest.mark.parametrize('case', sorted(TEST_CASES))
def test_test_loop_matches(root, tmp_path, case):
    """``test_one_epoch``: 3 ScanNet rooms at batch 2 (one padded scene
    trimmed), 2 S3DIS rooms through the 1-NN broadcast, region-split
    rooms; the IoU table, the mIoU and every txt/npy dump."""
    path, s3dis, regions = TEST_CASES[case]
    jcfg, tcfg = _cfgs(path, root, s3dis=s3dis)
    for cfg in (jcfg, tcfg):
        if regions:
            cfg.DATA_CONFIG_TAR.DATA_PROCESSOR.region_eval = True
            cfg.DATA_CONFIG_TAR.DATA_PROCESSOR.max_npoint = 1024
    model = _model(tcfg)
    step = tmf.make_eval_step(tcfg, model, _caps(tcfg, model), 'cpu')
    results = []
    for pkg, cfg, run in (
            (jdata, jcfg, lambda a, c, lg, ld, d: jtest.test_one_epoch(
                a, c, lg, ld, STATE, _jax_steps(step)['eval'], d)),
            (tdata, tcfg, lambda a, c, lg, ld, d: ttest.test_one_epoch(
                a, c, lg, ld, step, d)['miou'])):
        _, loader, _ = pkg.build_dataloader(cfg.DATA_CONFIG_TAR, 2,
                                            workers=2, split='test',
                                            training=False, seed=SEED)
        log, out = Log(), tmp_path / pkg.__name__
        results.append((run(_args(), cfg, log, loader, out), log, out))
    (want, jlog, jdir), (got, tlog, tdir) = results
    assert got == want
    assert tlog.metrics() == jlog.metrics()
    files = _same_tree(tdir, jdir)
    assert len([f for f in files if f.suffix == '.txt']) == (
        2 if s3dis else 3)
    if s3dis:       # full-resolution dumps of downsampled rooms
        room = root / 's3dis/trainval_fullarea/Area_5_room_0.npy'
        assert len(np.loadtxt(tdir / 'txt/Area_5_room_0.txt')) == \
            len(np.load(room))


def test_train_and_validate_loops_match(root):
    """``train_epoch`` (two steps) then ``validate_epoch`` (one padded
    scene trimmed): logged metrics, scalars and the trained weights."""
    jcfg, tcfg = _cfgs(CFG_DA, root)
    runs = []
    for pkg, cfg, loops in ((jdata, jcfg, jtrain), (tdata, tcfg, ttrain)):
        model = _model(tcfg, train=True)
        opt = toptim.build_optimizer(tcfg.OPTIMIZATION, model.parameters())
        caps = _caps(tcfg, model)
        train_step = tmf.make_train_step(tcfg, model, opt, caps, 'cpu')
        eval_step = tmf.make_eval_step(tcfg, model, caps, 'cpu')
        args = _args()
        _, train_loader, sampler = pkg.get_src_train_dataset(
            cfg, args, False, None, seed=SEED)
        val_loader, _ = pkg.get_val_dataset(args, cfg.DATA_CONFIG_TAR,
                                            False, None, seed=SEED)
        lr_fn = toptim.make_lr_fn(tcfg.OPTIMIZATION, 1, len(train_loader))
        log, writer = Log(), Writer()
        sampler.set_epoch(0)
        if loops is jtrain:
            steps = _jax_steps(eval_step, train_step)
            loops.train_epoch(args, cfg, log, writer, train_loader, STATE,
                              steps['train'], lr_fn, 0)
            miou = loops.validate_epoch(args, cfg, log, writer, val_loader,
                                        STATE, steps['eval'], 0)
        else:
            stats = loops.train_epoch(args, cfg, log, writer, train_loader,
                                      train_step, lr_fn, 0)
            assert stats['steps'] == 2 and stats['losses_finite']
            miou = loops.validate_epoch(args, cfg, log, writer, val_loader,
                                        eval_step, 0)
        runs.append((miou, log, writer, model.state_dict()))
    (jmiou, jlog, jw, jsd), (tmiou, tlog, tw, tsd) = runs
    assert tmiou == jmiou
    assert tlog.metrics() == jlog.metrics()
    assert any('Train result' in ln for ln in tlog.lines)
    _assert_same_scalars(tw.scalars, jw.scalars)
    for name in jsd:
        assert torch.equal(tsd[name], jsd[name]), name


def test_self_training_loops_match(root, tmp_path, monkeypatch):
    """``set_pseudo_labels`` (per-class thresholds from the confidence
    histogram) then one ``train_epoch`` of TACM-mixed target batches on
    domain 1 and source batches on domain 0: the pseudo-label store, the
    split sampler after the epoch, logged metrics, scalars, weights."""
    # the JAX mix dataset lacks check_brick_capacity, which its st loop
    # calls on the first batch (ROADMAP §C); lend it the target's
    monkeypatch.setattr(
        CuboidMixingDataset, 'check_brick_capacity',
        lambda self, *a, **k: self.dataset1.check_brick_capacity(*a, **k),
        raising=False)
    jcfg, tcfg = _cfgs(CFG_ST, root)
    for cfg in (jcfg, tcfg):
        cfg.SELF_TRAIN.global_thres = False       # the histogram pass too
        cfg.DATA_CONFIG_TAR.DATA_AUG.tacm.p = 1.0
    runs = []
    for pkg, cfg, loops in ((jdata, jcfg, jst), (tdata, tcfg, tst)):
        model = _model(tcfg, train=True)
        opt = toptim.build_optimizer(tcfg.OPTIMIZATION, model.parameters())
        caps = _caps(tcfg, model)
        eval_step = tmf.make_eval_step(tcfg, model, caps, 'cpu')
        st_step = tmf.make_st_step(tcfg, model, opt, caps, 'cpu')
        args = _args(epochs=2)
        (src_loader, src_sampler, tar_data, tar_loader, tar_sampler, _,
         _) = pkg.get_dataset(cfg, args, False, None, seed=SEED)
        reader = pkg.DataReader(src_loader, src_sampler)
        split = tar_data.split_sampler
        store = tmp_path / pkg.__name__ / 'pseudo_labels'
        log, writer = Log(), Writer()
        steps = _jax_steps(eval_step, st_step=st_step)
        if loops is jst:
            loops.set_pseudo_labels(args, cfg, log, tar_data, tar_loader,
                                    STATE, steps['eval'], store)
        else:
            assert loops.set_pseudo_labels(args, cfg, log, tar_data,
                                           tar_loader, eval_step, store)
        ratio = np.loadtxt(store / 'class_ratio.txt')
        split.init_class_ratio({'class_ratio': ratio})
        split.update_cfg(cfg.DATA_CONFIG_TAR.DATA_AUG.tacm.cuboid_queue)
        lr_fn = toptim.make_lr_fn(tcfg.OPTIMIZATION, 2, len(tar_loader))
        tar_sampler.set_epoch(0)
        reader.set_cur_epoch(0)
        if loops is jst:
            loops.train_epoch(args, cfg, log, writer, reader, tar_loader,
                              split, STATE, steps['st'], lr_fn, 0)
        else:
            stats = loops.train_epoch(args, cfg, log, writer, reader,
                                      tar_loader, split, st_step, lr_fn, 0,
                                      'cpu')
            assert stats['steps'] == 1 and stats['losses_finite']
        split.save(store.parent / 'split_sampler.pkl')
        runs.append((store, log, writer, model.state_dict(), split))
    (jstore, jlog, jw, jsd, jsplit), (tstore, tlog, tw, tsd, tsplit) = runs
    files = _same_tree(tstore, jstore)
    assert {'done.txt', 'class_ratio.txt'} <= {str(f) for f in files}
    assert len([f for f in files if f.parts[0] == 'npy']) == 4
    assert tlog.metrics() == jlog.metrics()
    assert any('per class thres' in ln for ln in tlog.lines)
    _assert_same_scalars(tw.scalars, jw.scalars)
    for name in jsd:
        assert torch.equal(tsd[name], jsd[name]), name
    assert sum(q.cur_size for q in tsplit.queues) > 0
    for name in ('class_ratio', 'tail_class_ratio', 'tail_class_idx'):
        np.testing.assert_array_equal(getattr(tsplit, name),
                                      getattr(jsplit, name))
    for tq, jq in zip(tsplit.queues, jsplit.queues):
        assert (tq.ptr, tq.cur_size) == (jq.ptr, jq.cur_size)
        for a, b in zip(tq.queue[:tq.cur_size], jq.queue[:jq.cur_size]):
            np.testing.assert_array_equal(a, b)
