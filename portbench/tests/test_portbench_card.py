"""On the card: one short run of each cell, and the control at each
cell's own size on three seeds, which has to come out not correct. Run
on a machine with the card (``python3 -m pytest portbench/tests -m
card``); here they skip."""

import json

import pytest

from portbench.manifest import HERE, Manifest

CELLS = [w['name'] for w in Manifest().data['workloads']]


def _card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card')


@pytest.mark.card
@pytest.mark.parametrize('cell', CELLS)
def test_a_short_run_is_correct(cell):
    _card()
    from portbench import bench
    r, _ = bench.run_cell(cell, 2 ** 31 + 5, 2.0, False)
    assert r['correct'], r['check']


@pytest.mark.card
@pytest.mark.parametrize('cell', CELLS)
def test_the_control_is_not_correct_at_the_cells_size(cell):
    _card()
    from portbench import controls
    limits = json.loads((HERE / 'limits' / f'{cell}.json').read_text())
    for seed in (101, 102, 103):
        nums = controls.numbers(cell, seed, 'fp8')
        assert any(nums[k] > v for k, v in limits.items()), nums
