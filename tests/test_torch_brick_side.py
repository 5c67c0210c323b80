"""The brick side as an argument of the port (the JAX package's
``DODA_BRICK``), on the CPU at side 2:

* the plan (``brickify`` with its sorted stream, the rulebook,
  ``build_brick_downsample``, ``down_maps``) integer for integer, the
  sorted point -> cell reduction (modes 3 and 4) and the wide-lane convs
  (``subm_conv3_2d``, ``subm_conv3_norm_2d``, ``down_conv2_2d``,
  ``up_conv2_2d``) at float32 to 1e-5 against the JAX package run in a
  subprocess under ``DODA_BRICK=2`` (its side binds at import);
* a 3-level net at sides 2 and 4 on the same weights: float32 logits and
  one train step's gradients;
* K2's plain paths at side 2 against the shell-gather oracle;
* the raises: an odd side, and a kernel at a side it is not built for;
  K2's route accepted at side 2;
* ``tools/test.py`` at ``--brick 2`` against ``--brick 4`` on tiny rooms.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_threads import two_threads  # noqa: F401
from _torch_brick_side_common import rooms  # noqa: F401
from _torch_brick_side_common import _grid, _JAX, _net, _t, F32, ROOT, TOL
from _torch_cli_common import CFG_DA, data_sets
from doda_tpu_torch import config as tconfig
from doda_tpu_torch.models import model_fn as tmf
from doda_tpu_torch.models import unet as tunet
from doda_tpu_torch.models.unet import FlatDown
from doda_tpu_torch.ops import bricks as tbricks
from doda_tpu_torch.ops import bricks2d as tb2d
from doda_tpu_torch.ops.banded_conv import (banded_conv_fused,
                                            banded_conv_narrow)
from doda_tpu_torch.ops.cell_mean import cell_reduce_sorted
from doda_tpu_torch.ops.banded_conv_sm import (banded_conv_sm_plain,
                                               banded_conv_sm_taps,
                                               banded_conv_sm_taps_plain)
from doda_tpu_torch.tools import test as ttest
from doda_tpu_torch.utils import checkpoint as ckpt_utils


def test_side2_plan_and_convs_equal_the_jax_package(tmp_path):
    path = tmp_path / 'jax_side2.npz'
    env = dict(os.environ, DODA_BRICK='2', JAX_PLATFORMS='')
    env.pop('PYTHONPATH', None)
    run = subprocess.run([sys.executable, '-c', _JAX, str(path)],
                         capture_output=True, text=True, env=env, cwd=ROOT,
                         timeout=600)
    assert run.returncode == 0, run.stderr[-2000:]
    j = dict(np.load(path))

    coords = _t(j['coords'])
    g = tbricks.brickify(coords, torch.ones(len(coords), dtype=torch.bool),
                         512, brick=2)
    n = int(g.table.n)
    assert n == j['n'] and g.occ.shape == (512, 8)
    np.testing.assert_array_equal(g.table.coords[:n].numpy(),
                                  j['tcoords'][:n])
    np.testing.assert_array_equal(g.table.p2v.numpy(), j['p2v'])
    np.testing.assert_array_equal(g.occ.numpy(), j['occ'])
    np.testing.assert_array_equal(g.p2c.numpy(), j['p2c'])
    np.testing.assert_array_equal(g.sort_cell.numpy(), j['sort_cell'])
    np.testing.assert_array_equal(g.sort_pos.numpy(), j['sort_pos'])
    assert int(g.occ.sum()) == j['num_voxels']
    # the sorted reduction: within 1e-5 of the JAX default on normal
    # features; on colour-like ones (uniform in [0.3, 1]) within 1e-6 of
    # max|ref| of the float64 sums and means, and no further off them than
    # the JAX default, whose float32 prefix sum over the stream drifts
    # (1.0e-5 here: at side 2 a slice's 4 cells share the lanes)
    flat = g.flat_index().numpy()
    count = np.bincount(flat, minlength=512 * 8 + 1)[:-1, None]
    for kind in ('normal', 'uniform'):
        total = np.zeros((512 * 8 + 1, 3))
        np.add.at(total, flat, j[kind].astype(np.float64))
        for mode in (3, 4):
            got = cell_reduce_sorted(_t(j[kind]), g.sort_cell, g.sort_pos,
                                     512, 8, mode).numpy()
            want = j[f'{kind}_{mode}']
            ref = (total[:-1] if mode == 3 else
                   total[:-1] / np.maximum(count, 1)).reshape(512, 24)
            err = np.abs(got - ref).max()
            assert err <= 1e-6 * np.abs(ref).max(), (kind, mode, err)
            assert err <= np.abs(want - ref).max(), (kind, mode, err)
            if kind == 'normal':
                np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
            assert (got.reshape(512, 8, 3)[~g.occ.numpy()] == 0).all()
    nbr = tbricks.build_brick_rulebook(g.table)
    np.testing.assert_array_equal(nbr.numpy(), j['nbr'])
    ds = tbricks.build_brick_downsample(g.table, g.occ, 256)
    pn = int(ds.parent.n)
    assert pn == j['pn']
    np.testing.assert_array_equal(ds.parent.coords[:pn].numpy(),
                                  j['pcoords'][:pn])
    for name in ('child_parent', 'parity', 'parent_children'):
        np.testing.assert_array_equal(getattr(ds, name).numpy(), j[name])
    np.testing.assert_array_equal(ds.parent_occ.numpy(), j['pocc'])
    target, parent_src = tbricks.down_maps(ds)
    np.testing.assert_array_equal(target.numpy(), j['target_cells'])
    np.testing.assert_array_equal(parent_src.numpy(), j['parent_src'])

    x2, w = _t(j['x2']), _t(j['w'])
    halo = tb2d.halo_index(nbr, 2)
    assert halo.shape == (512, 64)
    got = tb2d.subm_conv3_2d(x2, g.occ, halo, w, F32, nbr=nbr)
    np.testing.assert_allclose(got.numpy(), j['subm'], **TOL)
    got = tb2d.subm_conv3_norm_2d(x2, g.occ, halo, w, _t(j['scale']),
                                  _t(j['bias']), F32, nbr=nbr)
    np.testing.assert_allclose(got.numpy(), j['subm_norm'], **TOL)
    fd = FlatDown(child_parent=ds.child_parent, parity=ds.parity,
                  parent_children=ds.parent_children)
    got = tb2d.down_conv2_2d(x2, ds.parent_occ, fd, _t(j['wd']), F32)
    np.testing.assert_allclose(got.numpy(), j['down'], **TOL)
    got = tb2d.up_conv2_2d(_t(j['p2']), g.occ, fd, _t(j['wu']), F32)
    np.testing.assert_allclose(got.numpy(), j['up'], **TOL)


def test_side2_net_equals_side4_on_the_same_weights():
    """A 3-level, mid-8 net: float32 logits of side 2 within
    1e-4*max(1, max|logit|) of side 4's, and one train step's gradients
    within 1e-4 of their scale (sums in another order)."""
    _, _, rng = _grid(0, 1, 1, 1)
    c = rng.integers(0, 40, (2, 3000, 3)).astype(np.int32)
    c[..., 2] = rng.integers(0, 6, (2, 3000))
    coords = torch.from_numpy(c)
    valid = torch.ones(2, 3000, dtype=torch.bool)
    valid[1, 2500:] = False
    feats = torch.from_numpy(rng.normal(size=(2, 3000, 3)).astype(
        np.float32))
    p4 = tunet.build_level_plan(coords, valid, (1024, 512, 256), 'cpu')
    p2 = tunet.build_level_plan(coords, valid, (2048, 1024, 512), 'cpu',
                                brick=2)
    for lvl in range(3):            # side 2's level l+1 is side 4's l
        assert p2.occs[lvl].shape[-1] == 8
        if lvl < 2:
            assert torch.equal(p2.downs[lvl].parent.n, p4.grid0.table.n
                               if lvl == 0 else p4.downs[0].parent.n)
    net4, net2 = _net(4), _net(2)
    net2.load_state_dict(net4.state_dict())
    with torch.no_grad():
        l4, l2 = net4.eval()(feats, p4), net2.eval()(feats, p2)
    assert torch.isfinite(l4).all()
    lim = 1e-4 * max(1.0, l4.abs().max().item())
    assert (l2 - l4).abs().max().item() <= lim
    net4.train()(feats, p4).square().mean().backward()
    net2.train()(feats, p2).square().mean().backward()
    for (name, a), b in zip(net4.named_parameters(), net2.parameters()):
        scale = max(1.0, a.grad.abs().max().item())
        assert (a.grad - b.grad).abs().max().item() <= 1e-4 * scale, name


def test_side2_k2_plain_paths_equal_the_oracle():
    """K2's operands, weights and both plain versions at side 2 (12-cell
    runs padded to 16, x-planes of 16 padded to 20) against the
    shell-gather oracle ``subm_conv3``."""
    g, nbr, rng = _grid(2, 400, 12, 256)
    rows, cin, cout = 256, 16, 24
    x = rng.normal(size=(rows, 8, cin)) * g.occ.numpy()[..., None]
    x3 = torch.from_numpy(x.astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(27, cin, cout)) * 0.1).astype(
        np.float32))
    want = tbricks.subm_conv3(x3, g.occ, nbr, w, F32)
    ops = tb2d._assemble_sm(x3.reshape(rows, -1), tb2d.sm_index(nbr, 2), F32,
                            2)
    assert [t.shape[1] for t in ops] == [8 * cin, 32 * cin, 20 * cin,
                                         20 * cin]
    for got in (banded_conv_sm_plain(*ops, *tb2d.sm_weights(w, 2), F32),
                banded_conv_sm_taps_plain(*ops, w, F32)):
        got = tb2d._mask(got, g.occ, cout).reshape(rows, 8, cout)
        np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def test_side_raises():
    """An odd side is refused everywhere it can be asked for, and a kernel
    asked for at a side it is not built for raises naming the side (K1's
    and K2's kernels: sides 2 and 4), never running the plain version on
    the card; K2's route is taken at side 2."""
    for side in (3, 1, 0):
        with pytest.raises(ValueError, match='side'):
            tbricks.geometry(side)
        with pytest.raises(ValueError, match='side'):
            _net(side)
    with pytest.raises(ValueError, match='side'):
        tbricks.brickify(torch.zeros(4, 3, dtype=torch.int32),
                         torch.ones(4, dtype=torch.bool), 8, brick=5)
    bf = torch.bfloat16
    nbr = torch.zeros(4, 27, device='meta', dtype=torch.int32)
    w8 = torch.zeros(27, 8, 8, device='meta', dtype=bf)
    x6 = torch.zeros(4, 216 * 8, device='meta', dtype=bf)  # side 6
    with pytest.raises(ValueError, match='side 6'):
        banded_conv_fused(x6, nbr, w8, bf)
    with pytest.raises(ValueError, match='side 6'):
        banded_conv_narrow(torch.zeros(4, 216 * 3, device='meta', dtype=bf),
                           nbr, torch.zeros(27, 3, 8, device='meta',
                                            dtype=bf), bf)
    assert banded_conv_fused.launches == banded_conv_narrow.launches == 0
    with pytest.raises(ValueError, match='side 6'):      # K2 at side 6
        banded_conv_sm_taps(*(torch.zeros(4, n * 16, device='meta', dtype=bf)
                              for n in (216, 192, 68, 68)),
                            torch.zeros(27, 16, 8, device='meta', dtype=bf),
                            bf)
    assert banded_conv_sm_taps.launches == 0
    # K2 at side 2 is accepted: the route, the rule and the net
    assert tb2d.uses_sm(16, 16, 32, side=2) is True
    assert tb2d.subm_route(16, 16, bf, 32, side=2) == 'sm'
    assert _net(2, sm_max_cin=32).sm_levels == (0, 1)
    assert tb2d.subm_route(16, 16, bf, 0, side=2) == 'fused'
    assert tb2d.subm_route(3, 16, bf, 0, side=2) == 'narrow'
    # a plan of another side than the net's
    g, nbr, rng = _grid(0, 50, 8, 64)
    p4 = tunet.build_level_plan(torch.zeros(1, 50, 3, dtype=torch.int32),
                                torch.ones(1, 50, dtype=torch.bool),
                                (64, 64, 64), 'cpu')
    with pytest.raises(ValueError, match='brick side 2'):
        _net(2)(torch.zeros(1, 50, 3), p4)


def test_cli_test_at_side2_equals_side4(rooms, tmp_path, monkeypatch):
    """``tools/test.py`` of one checkpoint with ``--brick 2`` and with
    ``--brick 4`` on tiny ScanNet rooms, at a brick cap whose schedule
    clears every level at both sides (the brick audit finds no overflow):
    the same mIoU to 1e-4, and the dumped predictions agree on 99% of the
    points (bf16 logits round differently at the two sides)."""
    shutil.copytree(tconfig.ROOT_DIR / 'cfgs', tmp_path / 'cfgs')
    cfg_file = tmp_path / CFG_DA
    cfg_file.write_text(cfg_file.read_text().replace(
        '    block_reps: 2\n', '    block_reps: 2\n    num_levels: 3\n'))
    monkeypatch.setattr(tconfig, 'ROOT_DIR', tmp_path)
    monkeypatch.chdir(tmp_path)
    sets = data_sets(rooms)
    for i, key in enumerate(sets):
        if key.endswith('brick_cap'):
            sets[i + 1] = '24576'
    cfg = tconfig.CfgNode()
    tconfig.cfg_from_yaml_file(CFG_DA, cfg)
    tconfig.cfg_from_list(sets, cfg)
    torch.manual_seed(3)
    model = tmf.build_model(cfg, device='cpu')
    ckpt = tmp_path / 'seeded.pth'
    ckpt_utils.save_params(ckpt, model, None, 0)
    res = {}
    for side in (4, 2):
        res[side] = ttest.main([
            '--cfg_file', CFG_DA, '--ckpt', str(ckpt), '--device', 'cpu',
            '--batch_size', '2', '--workers', '2', '--extra_tag',
            f'brick{side}', '--brick', str(side), '--save_to_file', '--set',
            *sets])
        log = ''.join(p.read_text() for p in (
            tmp_path / 'output').rglob(f'brick{side}/**/log_*.txt'))
        assert 'DROPPED' not in log and 'brick capacity ok' in log, side
    assert res[4]['scenes'] == res[2]['scenes'] == 4
    assert abs(res[2]['miou'] - res[4]['miou']) <= 1e-4
    dumps = {side: sorted((res[side]['output_dir'] / 'txt').iterdir())
             for side in (4, 2)}
    assert [p.name for p in dumps[4]] == [p.name for p in dumps[2]] != []
    pred = {side: np.concatenate([np.loadtxt(p) for p in dumps[side]])
            for side in (4, 2)}
    assert (pred[4] == pred[2]).mean() >= 0.99
