"""The port's distributed launcher (``doda_tpu_torch/parallel``): the
launchers' environments, two gloo ranks against one process (train step,
SyncBN statistics, eval step, st step with soft labels, and the CLIs'
eval, pseudo-label and queue loops), the cuboid queue merged across
ranks, and ``--launcher pytorch`` at a world of one. The reference for the
environments and the merge is the JAX package's
(``doda_tpu/parallel/collectives.py``, root ``tools/st.py``)."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from _torch_threads import two_threads  # noqa: F401
from _torch_cli_common import CFG_DA, data_sets, make_cli_rooms
from doda_tpu.parallel import collectives as jcoll
from doda_tpu_torch import config as tconfig
from doda_tpu_torch.parallel import collectives
from doda_tpu_torch.tools import st as tst
from doda_tpu_torch.tools import train as ttrain

HERE = os.path.dirname(os.path.abspath(__file__))


@pytest.mark.parametrize('launcher', ['pytorch', 'slurm'])
def test_init_from_launcher_reads_the_environment(launcher, monkeypatch):
    """Rank, world and the rendezvous host as the JAX function reads
    them; a world of one stays single-process."""
    seen = {}
    monkeypatch.setattr(
        collectives.dist, 'init_process_group',
        lambda backend, init_method, world_size, rank: seen.update(
            backend=backend, addr=init_method, world=world_size, rank=rank))
    monkeypatch.setattr(
        jcoll, 'init_distributed',
        lambda coord, world, rank: seen.update(coord=coord) or (rank, world))
    for var in ('WORLD_SIZE', 'SLURM_NTASKS'):
        monkeypatch.delenv(var, raising=False)
    assert collectives.init_from_launcher(launcher, 999) == (0, 1, 0)
    assert collectives.init_from_launcher('none', 999) == (0, 1, 0)
    assert not seen
    if launcher == 'pytorch':
        env = {'WORLD_SIZE': '4', 'RANK': '3', 'LOCAL_RANK': '1',
               'MASTER_ADDR': 'node7'}
        cases = [(env, 'node7')]
    else:
        env = {'SLURM_NTASKS': '2', 'SLURM_PROCID': '1', 'SLURM_LOCALID': '1'}
        cases = [(dict(env, SLURM_STEP_NODELIST=nodes), head)
                 for nodes, head in (('nd-[003-008]', 'nd-003'),
                                     ('hostA,hostB', 'hostA'),
                                     ('solo', 'solo'))]
    for env, head in cases:
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        got = collectives.init_from_launcher(launcher, 999, backend='gloo')
        assert got == (int(env.get('RANK', env.get('SLURM_PROCID'))),
                       int(env.get('WORLD_SIZE', env.get('SLURM_NTASKS'))),
                       1)
        assert seen['addr'] == f'tcp://{head}:999'
        assert seen['backend'] == 'gloo'
        jcoll.init_from_launcher(launcher, tcp_port=999)
        assert seen['coord'] == f'{head}:999'      # the JAX package's host
    with pytest.raises(ValueError, match='unknown launcher'):
        collectives.init_from_launcher('mpi', 999)


def _child(*argv):
    """tests/_torch_parallel_child.py's JSON line, in a fresh process."""
    env = dict(os.environ, OMP_NUM_THREADS='2')
    out = subprocess.run([sys.executable, os.path.join(
        HERE, '_torch_parallel_child.py'), *argv], capture_output=True,
        text=True, timeout=150, env=env, cwd=os.path.dirname(HERE))
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _assert_steps_equal(got):
    assert got['points_per_rank'] == [200, 120]
    assert got['tar_points_per_rank'] == [90, 170]
    for step in ('train', 'st'):
        assert got[f'{step}_loss_rel'] <= 1e-5, got
        assert got[f'{step}_grad'] <= 1e-5, got
        assert got[f'{step}_weights'] <= 1e-5, got
        assert got[f'{step}_stats'] <= 1e-5, got
        assert got[f'{step}_hist_equal'] is True, (step, got)
        assert got[f'{step}_ranks_equal'] is True, (step, got)
    for key in ('eval_preds_equal', 'eval_hist_equal', 'gathered_equal'):
        assert got[key] is True, (key, got)


def test_two_ranks_equal_one_process():
    """Two gloo ranks on the CPU, each taking one scene of a 2-scene batch
    (200 and 120 points, features 10x apart; st targets of 90 and 170),
    against one process on the batch, 3-level net, float32: the train,
    eval and st steps; then ``test_one_epoch``, ``set_pseudo_labels``
    and ``update_split_sampler`` in every rank against one process
    (tests/_torch_parallel_child.py)."""
    got = _child()
    _assert_steps_equal(got)
    for key in ('loops_miou_equal', 'loops_queue_equal',
                'loops_files_equal'):
        assert got[key] is True, (key, got)
    # 3 test dumps; 3 scenes' labels, npy and txt; class_ratio, done
    assert got['loops_files'] == 11, got
    assert got['class_ratio_rel'] <= 1e-12, got


def test_two_ranks_equal_one_process_under_remat():
    """The same steps with every model under ``remat='all'``: each block's
    replay in the backward runs SyncBN's all-reduce again, in the same
    order in both ranks, and holds the running statistics, so the ranks
    still equal one process (which also replays)."""
    _assert_steps_equal(_child('--remat', 'all'))


def test_update_split_sampler_merges_across_ranks(monkeypatch):
    """Every rank's tail cuboids and ratio sums reach the queue (ref
    tool/st.py:86-97 all_gather_object), as in the JAX CLI; a 2-rank
    world faked."""
    class RecordingSampler:
        def __init__(self):
            self.updates, self.ratios = [], []

        def update(self, per_class):
            self.updates.append(per_class)

        def update_class_ratio(self, r):
            self.ratios.append(np.asarray(r))

    extras = {'tar_tail_splits': [['a0'], ['b0'], ['a1'], ['b1']],
              'tar_splits_class_ratio': [np.array([1.0, 3.0])]}
    remote = ([['ra'], ['rb']], np.array([2.0, 1.0]))
    monkeypatch.setattr(collectives, 'world_size', lambda: 2)
    monkeypatch.setattr(collectives, 'all_gather_objects',
                        lambda obj: [obj, remote])
    samp = RecordingSampler()
    tst.update_split_sampler(samp, extras, 2, update_ratio=True)
    assert samp.updates == [[['a0', 'a1', 'ra'], ['b0', 'b1', 'rb']]]
    np.testing.assert_allclose(samp.ratios[0], [3.0, 4.0])
    samp2 = RecordingSampler()
    tst.update_split_sampler(samp2, extras, 2, update_ratio=False)
    assert samp2.updates and not samp2.ratios


def test_launcher_pytorch_at_world_one_runs(tmp_path, monkeypatch):
    """``--launcher pytorch`` with WORLD_SIZE=1 trains in one process,
    with the JAX CLI's warning, on a 3-level net."""
    shutil.copytree(tconfig.ROOT_DIR / 'cfgs', tmp_path / 'cfgs')
    cfg_file = tmp_path / CFG_DA
    cfg_file.write_text(cfg_file.read_text().replace(
        '    block_reps: 2\n', '    block_reps: 2\n    num_levels: 3\n'))
    monkeypatch.setattr(tconfig, 'ROOT_DIR', tmp_path)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv('WORLD_SIZE', '1')
    root = make_cli_rooms(tmp_path / 'rooms')
    out = ttrain.main(['--cfg_file', CFG_DA, '--launcher', 'pytorch',
                       '--epochs', '1', '--device', 'cpu', '--batch_size',
                       '2', '--workers', '2', '--extra_tag', 'world1',
                       '--set', *data_sets(root),
                       'EVALUATION.evaluate', 'False'])
    assert out['epochs'][0]['steps'] == 2
    assert out['epochs'][0]['losses_finite']
    assert (out['output_dir'] / 'ckpt/train_epoch_1').is_file()
    assert not collectives.dist.is_initialized()
