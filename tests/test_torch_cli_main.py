"""The port's three CLIs end to end on the CPU: ``main([...,
'--device', 'cpu'])`` of train (source-only, 3D-FRONT rooms validated on
ScanNet rooms), test with txt dumps, and st from that checkpoint (pseudo
labels, TACM-mixed batches, DSNorm), on a 3-level, mid-4 net and
synthetic rooms of ~2,500 points; the output trees. The launcher flag
refuses a launcher the JAX CLIs do not have.
"""

import shutil

import pytest

from _torch_threads import two_threads  # noqa: F401
from _torch_cli_common import CFG_DA, CFG_ST, data_sets, make_cli_rooms
from doda_tpu_torch import config as tconfig
from doda_tpu_torch.tools import st as tst
from doda_tpu_torch.tools import test as ttest
from doda_tpu_torch.tools import train as ttrain


# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def root(tmp_path_factory):
    return make_cli_rooms(tmp_path_factory.mktemp('synth_cli_main'))


def test_clis_end_to_end(root, tmp_path, monkeypatch):
    """Source-only train -> test with dumps -> st from that checkpoint,
    each through ``main([..., '--device', 'cpu'])`` on a 3-level, mid-4
    net; the output trees."""
    shutil.copytree(tconfig.ROOT_DIR / 'cfgs', tmp_path / 'cfgs')
    for path in (CFG_DA, CFG_ST):       # the configs at 3 levels
        cfg_file = tmp_path / path
        text = cfg_file.read_text()
        assert 'num_levels' not in text
        cfg_file.write_text(text.replace(
            '    block_reps: 2\n', '    block_reps: 2\n    num_levels: 3\n'))
    monkeypatch.setattr(tconfig, 'ROOT_DIR', tmp_path)
    monkeypatch.chdir(tmp_path)
    sets = ['--set', *data_sets(root)]
    common = ['--device', 'cpu', '--batch_size', '2', '--workers', '2',
              '--extra_tag', 'e2e']
    out = ttrain.main(['--cfg_file', CFG_DA, '--epochs', '1', *common,
                       *sets])
    run = tmp_path / 'output/da_front3d_scannet/spconv/e2e'
    assert out['output_dir'] == run
    assert out['epochs'][0]['steps'] == 2
    assert out['epochs'][0]['losses_finite']
    assert (run / 'ckpt/train_epoch_1').is_file()
    assert (run / 'spconv.yaml').is_file()
    assert len(list(run.glob('log_train_*.txt'))) == 1
    ckpt = run / 'ckpt/train_epoch_1'

    res = ttest.main(['--cfg_file', CFG_DA, '--ckpt', str(ckpt),
                      '--save_to_file', *common, *sets])
    assert res['output_dir'] == run / 'eval' and 0 <= res['miou'] <= 1
    assert res['scenes'] == 4      # forwarded: 3 and a sampler pad
    assert sorted(p.name for p in (run / 'eval/txt').iterdir()) == [
        f'scene000{i}_00.txt' for i in range(3)]

    res = tst.main(['--cfg_file', CFG_ST, '--weight', str(ckpt),
                    '--epochs', '1', '--preserve_pseudo_labels', *common,
                    *sets])
    st_run = tmp_path / 'output/da_front3d_scannet/spconv_st/e2e'
    ep = res['epochs'][0]
    assert ep['steps'] == 1 and ep['losses_finite']
    assert ep['pseudo_labels_generated']
    for rel in ('ckpt/train_epoch_1', 'split_sampler.pkl',
                'pseudo_labels/done.txt', 'pseudo_labels/class_ratio.txt'):
        assert (st_run / rel).is_file(), rel
    assert sorted(p.name for p in (st_run / 'pseudo_labels/npy').iterdir()
                  ) == [f'scene000{i}_00.npy' for i in range(4)]
    with pytest.raises(SystemExit):
        ttrain.main(['--cfg_file', CFG_DA, '--launcher', 'mpi',
                     *common, *sets])
