"""The port's PLY writers and visualize CLI vs the JAX package's.

Every file the port writes must be byte-equal to what
``doda_tpu.utils.visualize`` writes from the same arrays: ground truth and
predictions with ignore (255) and out-of-palette ids, height colouring, on
each dataset's palette. The CLI's ``main`` runs on a ScanNet-format room of
``make_synth_data`` with a prediction dump in ``test``'s txt format.
"""

import numpy as np

from doda_tpu.utils import visualize as jvis
from doda_tpu_torch.tools import make_synth_data
from doda_tpu_torch.tools import visualize as vis_cli
from doda_tpu_torch.utils import visualize as tvis

KINDS = ('input', 'gt', 'pred')


def _files(prefix):
    return [open(f'{prefix}_{k}.ply', 'rb').read() for k in KINDS]


def test_ply_bytes_equal_jax(tmp_path):
    rng = np.random.default_rng(0)
    xyz = rng.normal(size=(500, 3)) * [3.0, 3.0, 1.0]
    for dataset, n_cls in (('scannet', 20), ('s3dis', 13), ('front3d', 11)):
        labels = rng.integers(0, n_cls, 500)
        labels[::7] = 255                       # ignore -> gray
        preds = rng.integers(-1, n_cls + 3, 500)   # out of the palette too
        for pkg, vis in (('jax', jvis), ('port', tvis)):
            vis.visualize_scene(str(tmp_path / f'{pkg}_{dataset}'), xyz,
                                labels, preds, dataset=dataset)
        want = _files(tmp_path / f'jax_{dataset}')
        assert _files(tmp_path / f'port_{dataset}') == want, dataset
        assert want[1].count(b'128 128 128\n') >= 500 // 7
    for key in ('scannet', 's3dis', 13, 'front3d'):
        np.testing.assert_array_equal(tvis.class_palette(key),
                                      jvis.class_palette(key))


def test_cli_main_on_a_synthetic_room(tmp_path):
    rng = np.random.default_rng(1)
    make_synth_data.make_scannet(str(tmp_path), 0, 1, 3000, rng)
    root = tmp_path / 'scannetv2'
    xyz, labels = vis_cli.load_scene('scannet', str(root), 'val',
                                     'scene0000_00')
    n = len(xyz)
    dumps = tmp_path / 'txt'
    dumps.mkdir()
    preds = rng.integers(0, 20, n).astype(np.uint8)
    np.savetxt(dumps / 'scene0000_00.txt', preds, fmt='%d')   # test's dump
    prefix = vis_cli.main(['--dataset', 'scannet', '--data_root', str(root),
                           '--split', 'val', '--scene', 'scene0000_00',
                           '--result_dir', str(dumps), '--out',
                           str(tmp_path / 'vis')])
    got = _files(prefix)
    for data in got:
        head, body = data.split(b'end_header\n')
        assert f'element vertex {n}\n'.encode() in head
        assert body.count(b'\n') == n
    jvis.visualize_scene(str(tmp_path / 'jax'), xyz, labels,
                         preds.astype(np.int64), dataset='scannet')
    assert got == _files(tmp_path / 'jax')
