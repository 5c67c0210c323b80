"""K1's band and the wide-lane convs of the PyTorch port vs the JAX
package.

``banded_conv_plain``, K1's band in plain PyTorch, is held against the
Pallas kernel itself (interpret mode off the TPU); the planes, the banded
weights and the down, up and 1x1 convs against ``doda_tpu.ops.bricks2d``
at float32, with the tolerance of tests/test_bricks2d.py (1e-5); the
wrappers raise off the CPU and the entry points refuse to run without a
card.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from _torch_threads import two_threads  # noqa: F401
from _torch_banded_conv_common import (  # noqa: F401
    _no_tf32, dense_grid, sparse_grid)
from _torch_banded_conv_common import _feats, _t, F32, TOL
from doda_tpu.models.unet import FlatDown as JFlatDown
from doda_tpu.ops import bricks as jbricks
from doda_tpu.ops import bricks2d as jb2d
from doda_tpu.ops import pallas_banded
from doda_tpu_torch.models import model_fn as tmf
from doda_tpu_torch.models.unet import FlatDown
from doda_tpu_torch.ops import bricks2d as tb2d
from doda_tpu_torch.ops.banded_conv import (banded_conv_padded,
                                            banded_conv_plain)


@pytest.mark.parametrize('b,cin,cout', [(64, 8, 8), (64, 3, 16),
                                        (72, 16, 8)])
def test_banded_conv_plain_matches_pallas(b, cin, cout):
    rng = np.random.default_rng(b + cin + cout)
    rows6 = rng.normal(size=(b, 6, 36 * cin)).astype(np.float32)
    wb = rng.normal(size=(3, 36 * cin, 16 * cout)).astype(np.float32) * 0.1
    want = np.asarray(pallas_banded.banded_conv(
        [jnp.asarray(rows6[:, j]) for j in range(6)], jnp.asarray(wb), F32))
    got = banded_conv_plain(_t(rows6), _t(wb), torch.float32)
    assert got.dtype == torch.float32 and got.shape == (b, 64 * cout)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


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
    """Off the CPU a K1 wrapper launches its kernel or raises; the entry
    points default to the card and refuse to run without one."""
    meta = dict(device='meta', dtype=torch.bfloat16)
    x2, w = torch.zeros(4, 64 * 12, **meta), torch.zeros(27, 12, 20, **meta)
    nbr = torch.zeros(4, 27, device='meta', dtype=torch.int32)
    with pytest.raises(ValueError, match='CUDA'):
        banded_conv_padded(x2, nbr, w, torch.bfloat16)
    assert banded_conv_padded.launches == 0
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
