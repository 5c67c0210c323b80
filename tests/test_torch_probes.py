"""The port's probes on the CPU at a tiny size: ``probe_train_mem``,
``roofline`` and ``bench_conv`` (``doda_tpu_torch/tools``), each through
its ``main([... '--device', 'cpu'])``. The roofline's per-level bytes and
operations are held to a direct numpy count over the plan's rulebooks, at
brick sides 4 and 2; ``bench_conv`` prints one JSON line a route."""

import json

import numpy as np
import pytest
import torch

from _torch_threads import two_threads  # noqa: F401
from doda_tpu_torch.models import unet as tunet
from doda_tpu_torch.tools import bench_conv, probe_train_mem, roofline
from doda_tpu_torch.utils import roofline as bounds
from doda_tpu_torch.utils import synth

TINY = ['--device', 'cpu', '--batch', '2', '--points', '200',
        '--brick-cap', '512']


def _json_lines(text):
    return [json.loads(line) for line in text.splitlines()
            if line.startswith('{')]


def test_probe_train_mem_runs_and_reports(capsys, monkeypatch):
    out = probe_train_mem.main(TINY + ['--levels', '2', '--steps', '1',
                                       '--remat', 'all'])
    line = _json_lines(capsys.readouterr().out)[-1]
    assert line == out
    assert out['card'] == 'cpu' and out['fits'] and out['remat'] == 'all'
    assert out['peak_gib'] == 'not measured' and out['clock'] == 'host'
    assert np.isfinite(out['loss']) and out['step_s'] > 0

    # an out-of-memory step is the answer "does not fit": the whole error
    # is printed and the probe exits non-zero
    def oom(*a, **k):
        raise torch.OutOfMemoryError('CUDA out of memory. Tried to allocate')
    monkeypatch.setattr(probe_train_mem.model_fn, 'make_train_step',
                        lambda *a, **k: oom)
    with pytest.raises(SystemExit) as exit_:
        probe_train_mem.main(TINY + ['--levels', '2'])
    assert exit_.value.code != 0
    got = capsys.readouterr()
    assert 'Tried to allocate' in got.err
    assert _json_lines(got.out)[-1]['fits'] is False


def _numpy_level(occ, nbr, convs, side=4):
    """Bytes and operations of one level's subm convs, counted from the
    rulebook in numpy: a present neighbour in direction (dx, dy, dz)
    supplies the halo cells its offset reaches, read r(dx) r(dy) r(dz)
    times by the brick's (output cell, tap) pairs along each axis: r(-1) =
    r(+1) = 1 (one slice, read by one tap of the edge cell) and r(0) = 2 +
    3 + 3 + 2 = 10 (the brick's own four slices; 2 + 2 = 4 at side 2)."""
    rows = occ.shape[0]
    r = {-1: 1, 0: 10 if side == 4 else 4, 1: 1}
    reads = 0
    for col in range(27):
        dx, dy, dz = col // 9 - 1, col // 3 % 3 - 1, col % 3 - 1
        reads += int((nbr[:, col] < rows).sum()) * r[dx] * r[dy] * r[dz]
    moved = flops = 0
    for cin, cout in convs:
        # the fused K1 and, at the cin = 3 input conv, its narrow-input
        # version: activation, rulebook, taps
        moved += 2 * (rows * side ** 3 * (cin + cout) + 27 * cin * cout) \
            + 4 * rows * 27
        flops += 2 * cin * cout * reads
    return reads, moved, flops


def test_roofline_counts_equal_a_numpy_count(capsys):
    table = roofline.main(TINY + ['--levels', '2'])
    lines = _json_lines(capsys.readouterr().out)
    assert len(lines) == 3 and lines[-1]['level'] == 'all'
    batch = synth.make_batch(seed=0, batch=2, n_cap=200, n_real=200)
    plan = tunet.build_level_plan(batch.coords, batch.valid,
                                  tunet.default_brick_caps(512, 2), 'cpu')
    convs = ([(3, 16)] + [(16, 16)] * 7 + [(32, 16)], [(32, 32)] * 4)
    for lvl, row in enumerate(table[:2]):
        occ = plan.occs[lvl].reshape(-1, 64).numpy()
        nbr = tunet.flatten_plan(plan)[0][lvl].nbr.numpy()
        reads, moved, flops = _numpy_level(occ, nbr, convs[lvl])
        assert row['present_halo_reads'] == reads
        assert row['bytes'] == moved and row['flops'] == flops
        assert row['subm_convs'] == len(convs[lvl])
        assert row['active_cells'] == occ.sum()
        assert row['bricks'] == occ.any(1).sum()
        assert lines[lvl]['card'] == 'cpu'
    assert lines[-1]['bytes'] == sum(r['bytes'] for r in table[:2])
    assert lines[-1]['subm_convs'] == 13
    assert table[0]['routes'] == {'narrow': 1, 'fused': 8}


def test_roofline_side2_counts_equal_a_numpy_count(capsys):
    """The side-2 bound: the same forward counted in bricks of side 2
    (8 cells, a 4x4x4 halo), against the numpy count at that side."""
    table = roofline.main(TINY + ['--levels', '2', '--brick', '2'])
    lines = _json_lines(capsys.readouterr().out)
    batch = synth.make_batch(seed=0, batch=2, n_cap=200, n_real=200)
    plan = tunet.build_level_plan(batch.coords, batch.valid,
                                  tunet.default_brick_caps(512, 2), 'cpu',
                                  brick=2)
    convs = ([(3, 16)] + [(16, 16)] * 7 + [(32, 16)], [(32, 32)] * 4)
    for lvl, row in enumerate(table[:2]):
        occ = plan.occs[lvl].reshape(-1, 8).numpy()
        nbr = tunet.flatten_plan(plan)[0][lvl].nbr.numpy()
        reads, moved, flops = _numpy_level(occ, nbr, convs[lvl], side=2)
        assert row['brick'] == 2 and lines[lvl]['brick'] == 2
        assert row['present_halo_reads'] == reads
        assert row['bytes'] == moved and row['flops'] == flops
        assert row['active_cells'] == occ.sum()
        assert row['cell_occupancy'] == occ.sum() / occ.size
        assert row['bound_ms'] == pytest.approx(sum(
            bounds.fused_work(occ.shape[0], cin, cout, reads, 2)['bound_ms']
            for cin, cout in convs[lvl]))
    # a side-2 level holds the voxels of side 4's: the same active cells
    plan4 = tunet.build_level_plan(batch.coords, batch.valid,
                                   tunet.default_brick_caps(512, 2), 'cpu')
    assert table[0]['active_cells'] == int(plan4.occs[0].sum())


def test_bench_conv_prints_a_line_a_route(capsys):
    got = bench_conv.main(TINY + ['--reps', '1', '--levels', '1-1'])
    lines = _json_lines(capsys.readouterr().out)
    assert lines == got
    assert [(r['level'], r['cin'], r['route']) for r in lines] == [
        (1, 32, 'fused'), (1, 32, 'plain'), (1, 32, 'prologue'),
        (1, 32, 'unfused'), (1, 32, 'sm'), (1, 32, 'conv3d')]
    rows = lines[0]['rows']
    for r in lines:
        assert r['card'] == 'cpu' and r['clock'] == 'host' and r['ms'] > 0
    assert lines[0]['bound_ms'] == pytest.approx(bounds.bound(
        lines[0]['bytes'], lines[0]['flops'])['bound_ms'])
    assert lines[2]['bytes'] == lines[0]['bytes'] + rows * 8 + 2 * 32 * 2
    assert lines[4]['bytes'] == 2 * (rows * 216 * 32 + rows * 64 * 32
                                     + 27 * 32 * 32)
    assert lines[5]['bound_ms'] is None
