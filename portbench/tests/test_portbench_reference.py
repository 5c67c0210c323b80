"""The plain reference against doda_tpu_torch's eval, train and
self-training steps, at a tiny size in float32 on the CPU, through a
whole run of the harness (``bench.run_cell``)."""

import pytest

from portbench import bench

CASES = [('tiny.eval', {'logit_rel_rms': 1e-5, 'pred_gap': 1e-4}),
         ('tiny.train', {'loss_gap': 1e-5, 'grad_gap': 1e-4,
                         'change_gap': 1e-3, 'momentum_gap': 1e-4,
                         'stats_gap': 1e-5}),
         ('tiny.st', {'loss_gap': 1e-5, 'grad_gap': 1e-4,
                      'change_gap': 1e-4, 'momentum_gap': 1e-4,
                      'stats_gap': 1e-5})]


@pytest.mark.parametrize('cell,within', CASES, ids=[c for c, _ in CASES])
def test_reference_holds_the_program(tiny, cell, within):
    r, notes = bench.run_cell(cell, 2 ** 31 + 17, 0.2, False,
                              device='cpu', manifest=tiny)
    assert r['correct'] and r['failed'] == 0 and r['attempted'] >= 1
    for name, bound in within.items():
        assert notes['numbers'][name] <= bound, (name, notes['numbers'][name])
    assert list(r)[-1] == 'check'
    assert set(r['check']) == set(tiny.limits(cell))


def test_the_check_comes_last_and_the_units_follow_the_manifest(tiny):
    r, _ = bench.run_cell('tiny.eval', 5, 0.2, True, device='cpu',
                          manifest=tiny)
    assert list(r) == ['correct', 'attempted', 'failed', 'metrics', 'device',
                      'check']
    units = {m['name']: m['unit'] for m in tiny.metrics('tiny.eval', True)}
    assert all(v['unit'] == units[k] for k, v in r['metrics'].items())
