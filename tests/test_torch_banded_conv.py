"""Kernel K1 and the wide-lane convs of the PyTorch port vs the JAX package.

On the CPU, ``banded_conv`` is its plain version; here it is held against
the Pallas kernel itself (interpret mode off the TPU). The convs are held
against ``doda_tpu.ops.bricks2d`` and the ``bricks.subm_conv3`` oracle at
float32, with the tolerance of tests/test_bricks2d.py (1e-5).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from doda_tpu.models.unet import FlatDown as JFlatDown
from doda_tpu.ops import bricks as jbricks
from doda_tpu.ops import bricks2d as jb2d
from doda_tpu.ops import pallas_banded
from doda_tpu_torch.models import model_fn as tmf
from doda_tpu_torch.models.unet import FlatDown
from doda_tpu_torch.ops import bricks2d as tb2d
from doda_tpu_torch.ops.banded_conv import banded_conv

TOL = dict(rtol=1e-5, atol=1e-5)
F32 = jnp.float32


@pytest.fixture(scope='module', autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _grid(coords, cap):
    valid = np.ones(len(coords), bool)
    g = jbricks.brickify(jnp.asarray(coords), jnp.asarray(valid), cap)
    return g, jbricks.build_brick_rulebook(g.table)


@pytest.fixture(scope='module')
def dense_grid():
    rng = np.random.default_rng(3)
    return _grid(rng.integers(0, 24, (4096, 3)).astype(np.int32), 512)


@pytest.fixture(scope='module')
def sparse_grid():
    """Isolated voxels plus a crafted corner contact: bricks (1,1,1) and
    (0,0,1) are present, the face x-neighbour (0,1,1) is not, so the
    x-halo plane of (1,1,1) has a cell only a diagonal brick supplies."""
    rng = np.random.default_rng(11)
    coords = rng.integers(0, 96, (1500, 3)).astype(np.int32)
    crafted = np.array([[4, 4, 4], [3, 3, 4], [3, 3, 7], [4, 7, 4]],
                       np.int32)
    return _grid(np.concatenate([coords, crafted]), 2048)


def _feats(rng, g, cin):
    f = rng.normal(size=(g.b_cap, 64, cin)).astype(np.float32)
    return (f * np.asarray(g.occ)[..., None]).reshape(g.b_cap, -1)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize('b,cin,cout', [(64, 8, 8), (64, 3, 16),
                                        (72, 16, 8)])
def test_banded_conv_plain_matches_pallas(b, cin, cout):
    rng = np.random.default_rng(b + cin + cout)
    rows6 = rng.normal(size=(b, 6, 36 * cin)).astype(np.float32)
    wb = rng.normal(size=(3, 36 * cin, 16 * cout)).astype(np.float32) * 0.1
    want = np.asarray(pallas_banded.banded_conv(
        [jnp.asarray(rows6[:, j]) for j in range(6)], jnp.asarray(wb), F32))
    got = banded_conv(_t(rows6), _t(wb), torch.float32)
    assert got.dtype == torch.float32 and got.shape == (b, 64 * cout)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert banded_conv.launches == 0      # the CPU never reaches a kernel


def test_banded_weights_and_planes_exact(sparse_grid):
    g, nbr = sparse_grid
    rng = np.random.default_rng(1)
    w = rng.normal(size=(27, 5, 7)).astype(np.float32)
    np.testing.assert_array_equal(
        tb2d.banded_weights(_t(w)).numpy(),
        np.asarray(jb2d.banded_weights(jnp.asarray(w))))
    x2 = _feats(rng, g, 4)
    want = np.concatenate([np.asarray(r) for r in jb2d._assemble_p6(
        jnp.asarray(x2), nbr, F32, pm=False)], axis=1)
    got = tb2d._assemble_p6(_t(x2), tb2d.halo_index(_t(nbr)), torch.float32)
    np.testing.assert_array_equal(got.reshape(g.b_cap, -1).numpy(), want)


@pytest.mark.parametrize('grid_name,cin,cout', [
    ('dense_grid', 16, 16), ('dense_grid', 3, 16), ('dense_grid', 32, 16),
    ('sparse_grid', 16, 16), ('sparse_grid', 4, 8)])
def test_subm_conv3_2d(request, grid_name, cin, cout):
    g, nbr = request.getfixturevalue(grid_name)
    rng = np.random.default_rng(cin * 100 + cout)
    x2 = _feats(rng, g, cin)
    w = rng.normal(size=(27, cin, cout)).astype(np.float32) * 0.1
    want_2d = np.asarray(jb2d.subm_conv3_2d(
        jnp.asarray(x2), g.occ, nbr, jnp.asarray(w), compute_dtype=F32))
    want_oracle = np.asarray(jbricks.subm_conv3(
        jnp.asarray(x2.reshape(g.b_cap, 64, cin)), g.occ, nbr,
        jnp.asarray(w), compute_dtype=F32)).reshape(g.b_cap, -1)
    got = tb2d.subm_conv3_2d(_t(x2), _t(g.occ), tb2d.halo_index(_t(nbr)),
                             _t(w), torch.float32, nbr=_t(nbr)).numpy()
    np.testing.assert_allclose(got, want_2d, **TOL)
    np.testing.assert_allclose(got, want_oracle, **TOL)


def test_down_up_conv1x1(dense_grid):
    g, _ = dense_grid
    rng = np.random.default_rng(7)
    ds = jbricks.build_brick_downsample(g.table, g.occ, 256)
    jmaps = JFlatDown(child_parent=ds.child_parent, parity=ds.parity,
                      parent_children=ds.parent_children)
    tmaps = FlatDown(*(_t(a) for a in jmaps))

    x2 = _feats(rng, g, 16)
    wd = rng.normal(size=(8, 16, 32)).astype(np.float32)
    want = np.asarray(jb2d.down_conv2_2d(jnp.asarray(x2), ds.parent_occ,
                                         jmaps, jnp.asarray(wd), F32))
    got = tb2d.down_conv2_2d(_t(x2), _t(ds.parent_occ), tmaps, _t(wd),
                             torch.float32).numpy()
    np.testing.assert_allclose(got, want, **TOL)

    p2 = rng.normal(size=(256, 64, 32)).astype(np.float32)
    p2 = (p2 * np.asarray(ds.parent_occ)[..., None]).reshape(256, -1)
    wu = rng.normal(size=(8, 32, 16)).astype(np.float32)
    want = np.asarray(jb2d.up_conv2_2d(jnp.asarray(p2), g.occ, jmaps,
                                       jnp.asarray(wu), F32))
    got = tb2d.up_conv2_2d(_t(p2), _t(g.occ), tmaps, _t(wu),
                           torch.float32).numpy()
    np.testing.assert_allclose(got, want, **TOL)

    wi = rng.normal(size=(16, 24)).astype(np.float32)
    want = np.asarray(jb2d.conv1x1_2d(jnp.asarray(x2), g.occ,
                                      jnp.asarray(wi), F32))
    got = tb2d.conv1x1_2d(_t(x2), _t(g.occ), _t(wi), torch.float32).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_no_silent_cpu_fallback(monkeypatch):
    """Off the CPU the wrapper launches its kernel or raises; the entry
    points default to the card and refuse to run without one."""
    rows6 = torch.zeros(4, 6, 36, device='meta')
    wb = torch.zeros(3, 36, 16, device='meta')
    with pytest.raises(ValueError, match='CUDA'):
        banded_conv(rows6, wb, torch.float32)
    assert banded_conv.launches == 0
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    from doda_tpu_torch.config import CfgNode
    cfg = CfgNode({'COMMON_CLASSES': {'n_classes': 5},
                   'MODEL': {'BACKBONE': {'in_channel': 3, 'mid_channel': 4,
                                          'block_reps': 1,
                                          'block_residual': True,
                                          'num_levels': 2}},
                   'DATA_CONFIG': {'DATA_CLASS': {'ignore_label': 255,
                                                  'n_classes': 5}}})
    with pytest.raises(RuntimeError, match='no CUDA device'):
        tmf.build_model(cfg)
    model = tmf.build_model(cfg, device='cpu')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        tmf.make_eval_step(cfg, model, (64, 64))
