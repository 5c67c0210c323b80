"""The frozen yardstick: the conv's own work against a hand count, idle
as a union of intervals, shares at their bound, the bucket table."""

import numpy as np
import pytest
import torch

from portbench import scenes
from portbench.metrics import _common
from portbench.manifest import Manifest
from portbench.reference.plan import build_plan, level_sizes
from portbench.yardstick import buckets, counts, peaks, trace


def test_counts_match_a_hand_count():
    # one scene, three voxels: (0,0,0) and (0,0,1) touch, (4,4,4) alone;
    # level 1: (0,0,0) and (2,2,2); two valid points in the first voxel
    coords = torch.tensor([[[0, 0, 0], [0, 0, 0], [0, 0, 1], [4, 4, 4],
                            [9, 9, 9]]])
    valid = torch.tensor([[True, True, True, True, False]])
    plan = build_plan(coords, valid, 2)
    sizes = level_sizes(plan)
    # level 0: 3 voxels, pairs 2 + 2 + 1; level 1: 2 voxels, 1 + 1
    assert sizes == [(3, 5), (2, 2)]
    assert plan.parents[0].tolist() == [0, 0, 1]
    assert plan.parity[0].tolist() == [0, 1, 0]
    conf = {'in_channel': 3, 'mid_channel': 2, 'num_levels': 2,
            'block_reps': 1, 'n_classes': 5}
    cl = counts.convs(conf, sizes, 4)
    kinds = [(c.kind, c.cin, c.cout, c.pairs) for c in cl]
    assert kinds == [('subm', 3, 2, 5),                    # input conv
                     ('subm', 2, 2, 5), ('subm', 2, 2, 5),  # block0
                     ('down', 2, 4, 3), ('up', 4, 2, 3),
                     ('1x1', 4, 2, 3), ('subm', 4, 2, 5),   # tail0
                     ('subm', 2, 2, 5),
                     ('subm', 4, 4, 2), ('subm', 4, 4, 2),  # level 1
                     ('head', 2, 5, 4)]
    fwd = 2 * (3*2*5 + 2*2*5 * 2 + 2*4*3 + 4*2*3 + 4*2*3 + 4*2*5
               + 2*2*5 + 4*4*2 * 2 + 2*5*4)
    assert counts.flops(cl) == fwd
    assert counts.flops(cl, train=True) == 3 * fwd - 2 * 3*2*5
    first = 2 * (3 * 3 + 3 * 2 + 27 * 3 * 2)
    assert counts.subm_least_seconds(cl[:1]) == pytest.approx(
        max(first / peaks.PEAK_BYTES, 2 * 3 * 2 * 5 / peaks.PEAK_BF16_FLOPS))


def test_the_flagship_has_53_subm_convs():
    conf = {'in_channel': 3, 'mid_channel': 16, 'num_levels': 7,
            'block_reps': 2, 'n_classes': 20}
    cl = counts.convs(conf, [(10, 30)] * 7, 7)
    assert sum(c.kind == 'subm' for c in cl) == 53
    assert sum(c.kind in ('down', 'up') for c in cl) == 12


def _events(device, calls, host=()):
    ev = [{'ph': 'X', 'cat': 'user_annotation', 'name': trace.CALL_SPAN,
           'ts': s, 'dur': e - s} for s, e in calls]
    ev += [{'ph': 'X', 'cat': 'kernel', 'name': n, 'ts': s, 'dur': e - s}
           for n, s, e in device]
    ev += [{'ph': 'X', 'cat': 'cpu_op', 'name': n, 'ts': s, 'dur': e - s}
           for n, s, e in host]
    return ev


def test_idle_is_the_complement_of_a_union():
    # kernels overlap (10-30 and 20-40), one spills past the span (90-120),
    # gaps at 0-10, 40-60, 70-90; a call span 0-100
    device = [('elementwise_kernel', 10, 30), ('fused_tc<x>', 20, 40),
              ('gather', 60, 70), ('elementwise_kernel', 90, 120)]
    host = [('aten::nonzero', 35, 65), ('cudaStreamSynchronize', 0, 12)]
    got = trace.read(_events(device, [(0, 50), (50, 100)], host))
    assert got['window_s'] == pytest.approx(100e-6)
    assert got['busy_s'] == pytest.approx(50e-6)       # 10-40, 60-70, 90-100
    assert got['launches'] == 4 and got['calls'] == 2
    # bucket sums are sums of durations (overlap counted in each bucket)
    assert got['buckets_s'][buckets.ELEMENTWISE] == pytest.approx(50e-6)
    labels = dict(got['idle_gaps'])
    assert labels['aten::nonzero'] == pytest.approx(20e-6)   # gap 40-60
    assert labels['cudaStreamSynchronize'] == pytest.approx(10e-6)
    rec = {'trace': got, 'kind': 'eval'}
    assert _common.idle_pct(rec) == pytest.approx(50.0)


def test_a_trace_without_calls_or_kernels_reads_nothing():
    assert trace.read(_events([], [(0, 10)])) is None
    assert trace.read(_events([('k', 0, 1)], [])) is None


def test_shares_are_100_at_their_bound(tmp_path):
    man = Manifest()
    flops, least = 3.0e12, 0.25
    t = {'calls': 2, 'window_s': 1.0, 'busy_s': 1.0, 'launches': 10,
         'buckets_s': {buckets.SUBM_CONV[1]: 2 * least}}
    rec = {'kind': 'eval', 'trace': t, 'window_items': [0, 1],
           'slice_items': [0, 1], 'window_s': 2 * flops /
           peaks.PEAK_BF16_FLOPS,
           'work': {0: {'flops_fwd': flops, 'flops_train': 3 * flops,
                        'subm_least_s': least},
                    1: {'flops_fwd': flops, 'flops_train': 3 * flops,
                        'subm_least_s': least}}}
    assert man.reader('mfu.eval')(rec) == pytest.approx(100.0)
    assert man.reader('subm_conv_roofline.eval')(rec) == \
        pytest.approx(100.0)
    assert man.reader('device_idle_pct.eval')(rec) == pytest.approx(0.0)
    rec['kind'] = 'train'
    rec['window_s'] *= 3
    assert man.reader('mfu.train')(rec) == pytest.approx(100.0)
    # nothing to read: None, never 0
    assert man.reader('subm_conv_roofline.eval')(
        {**rec, 'kind': 'eval', 'trace': None}) is None


def test_buckets_of_the_port_kernels():
    assert buckets.bucket_of('void fused_tc<__nv_bfloat16, 4, 8, false, 4>'
                             ) in buckets.SUBM_CONV
    assert buckets.bucket_of('narrow_tc<3>') in buckets.SUBM_CONV
    assert buckets.bucket_of('vectorized_gather_kernel<16, int>') == \
        buckets.GATHER
    assert buckets.bucket_of('cell_rows') == \
        'cell_reduce_sorted (point -> cell)'
    assert buckets.bucket_of('Memcpy DtoH (Device -> Pageable)') == \
        'memcpy / memset'
    assert buckets.bucket_of('mystery') == buckets.OTHER


def test_scenes_repeat_for_a_seed_and_keep_the_room():
    a = scenes.make_batch(np.random.default_rng(7), [7.0, 3.5], 163840, 20)
    b = scenes.make_batch(np.random.default_rng(7), [7.0, 3.5], 163840, 20)
    for k in a:
        assert np.array_equal(a[k], b[k])
    assert a['valid'].sum(1).tolist() == [150_000, 37_500]
    assert (a['labels'][~a['valid']] == scenes.IGNORE).all()
    sides = scenes.room_sides(3.5, 7.0, 8, np.random.default_rng(1))
    assert sorted(sides) == pytest.approx(3.5 + 3.5 * (np.arange(8) + 0.5)
                                          / 8)


def test_seeded_weights_repeat_and_follow_their_leaves():
    shapes = {'a.kernel1': (27, 4, 8), 'a.MaskedBatchNorm_0.var': (1, 4),
              'linear.weight': (5, 8), 'linear.bias': (5,)}
    w1 = scenes.seeded_weights(shapes, 2 ** 33 + 5, 'cpu')
    w2 = scenes.seeded_weights(shapes, 2 ** 33 + 5, 'cpu')
    assert all(torch.equal(w1[k], w2[k]) for k in shapes)
    assert w1['a.kernel1'].abs().max() <= (27 * 4) ** -0.5
    assert w1['linear.weight'].abs().max() <= 8 ** -0.5
    v = w1['a.MaskedBatchNorm_0.var']
    assert (v >= 0.5).all() and (v <= 1.5).all()
    assert all(w1[k].dtype == torch.float32 for k in shapes)


def test_audit_raises_past_a_cap():
    coords = torch.tensor([[[0, 0, 0], [8, 0, 0], [16, 0, 0]]])
    valid = torch.ones(1, 3, dtype=torch.bool)
    scenes.audit(coords, valid, (3, 3, 2))      # bricks 3, 3, 2
    with pytest.raises(ValueError, match='level 0'):
        scenes.audit(coords, valid, (2, 3, 2))
    with pytest.raises(ValueError, match='level 2'):
        scenes.audit(coords, valid, (3, 3, 1))
