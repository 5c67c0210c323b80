"""K1's narrow-input version (``banded_conv_narrow``) of the PyTorch port:
the bf16 input conv (cin = 3) from the activation and the rulebook.

On the CPU the wrapper runs its plain version, the fused version's;
the CUDA kernel itself (``csrc/subm_conv_narrow.cu``) is held against it
on the card by ``chip_smoke.py``. Here the wrapper equals the JAX
package's ``subm_conv3_2d`` at cin = 1, 3, 5 -> 16 on a dense, a sparse
and an overflowed grid, to rtol = atol = 1e-5 at float32 (sums in another
order), and in bf16 within one bf16 rounding of the float32 conv of the
same operands and near the JAX bf16 conv; the routing rule sends the
bf16 input conv of the flagship to it; the wrapper raises off the CPU,
without a rulebook and on shapes it does not take.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from _torch_threads import two_threads  # noqa: F401
from _torch_input_conv_common import grids  # noqa: F401
from _torch_input_conv_common import _inputs, _t, TOL
from doda_tpu.ops import bricks2d as jb2d
from doda_tpu_torch.config import cfg_from_yaml_file, CfgNode
from doda_tpu_torch.models import model_fn as tmf
from doda_tpu_torch.ops import bricks2d as tb2d
from doda_tpu_torch.ops.banded_conv import (banded_conv_fused_plain,
                                            banded_conv_narrow, NARROW_MAX_CIN)


@pytest.mark.parametrize('name', ['dense', 'sparse', 'overflowed'])
def test_narrow_f32_equals_jax(grids, name):
    g, nbr = grids[name]
    for cin in (1, 3, 5):
        rng = np.random.default_rng(cin)
        x, w = _inputs(rng, g, cin)
        got = banded_conv_narrow(_t(x), _t(nbr), _t(w), torch.float32)
        assert got.shape == (g.b_cap, 64 * 16)
        assert banded_conv_narrow.launches == 0   # the CPU's plain version
        want = np.asarray(jb2d.subm_conv3_2d(
            jnp.asarray(x), g.occ, jnp.asarray(nbr), jnp.asarray(w),
            compute_dtype=jnp.float32))
        assert np.abs(want).max() > 0.1
        np.testing.assert_allclose(
            tb2d._mask(got, _t(g.occ), 16).numpy(), want, **TOL)


def test_narrow_bf16_equals_jax_bf16(grids):
    """bf16 operands on both sides, the port's conv on its narrow route.
    The bf16 products are exact in float32, so the port's output is the
    float32 conv of the same rounded operands rounded once: within one
    bf16 rounding (half a unit in the last place) of it. The JAX package
    rounds each of its three shifted products and their two sums to bf16,
    so against it the bound is 2e-2 of the largest output, as for the
    fused norm engine's bf16 convs (tests/test_torch_fuse_norm.py)."""
    bf = torch.bfloat16
    for name in ('dense', 'sparse'):
        g, nbr = grids[name]
        rng = np.random.default_rng(7)
        x, w = _inputs(rng, g, 3)
        xb = _t(x).to(bf)
        wb = _t(w).to(bf)
        tn, occ = _t(nbr), _t(g.occ)
        assert tb2d.subm_route(3, 16, bf, 0) == 'narrow'
        got = tb2d.subm_conv3_2d(xb, occ, tb2d.halo_index(tn), wb.float(),
                                 bf, nbr=tn).float().numpy()
        exact = tb2d._mask(banded_conv_fused_plain(
            xb.float(), tn, wb.float(), torch.float32), occ, 16).numpy()
        assert (np.abs(got - exact) <= 2.0 ** -8 * np.abs(got)).all()
        want = np.asarray(jb2d.subm_conv3_2d(
            jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16), g.occ,
            jnp.asarray(nbr), jnp.asarray(wb.float().numpy()),
            compute_dtype=jnp.bfloat16).astype(jnp.float32))
        assert np.abs(want).max() > 0.1
        assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()


def test_routing_rule_sends_the_input_conv_to_it():
    bf, f32 = torch.bfloat16, torch.float32
    cfg = cfg_from_yaml_file('cfgs/scannet/spconv.yaml', CfgNode())
    model = tmf.build_model(cfg, device='cpu', dtype=bf)
    assert model.subm_routes() == {'sm': 0, 'fused': 52, 'narrow': 1,
                                   'f32': 0, 'padded': 0, 'cell_mean': 1}
    # its input needs no gradient: no dx conv of the input conv
    assert model.subm_routes(True) == {'sm': 0, 'fused': 52, 'narrow': 0,
                                       'f32': 0, 'padded': 0,
                                       'cell_mean': 1}
    model = tmf.build_model(cfg, device='cpu', dtype=f32)
    assert model.subm_routes() == {'sm': 0, 'fused': 0, 'narrow': 0,
                                   'f32': 53, 'padded': 0, 'cell_mean': 1}
    for cin, cout, dtype, want in (
            (1, 16, bf, 'narrow'), (NARROW_MAX_CIN, 8, bf, 'narrow'),
            (8, 16, bf, 'fused'), (12, 16, bf, 'padded'),
            (3, 12, bf, 'padded'), (3, 16, f32, 'f32')):
        assert tb2d.subm_route(cin, cout, dtype, 32) == want, (cin, cout)


def test_wrapper_raises_off_the_cpu_and_on_shapes_it_does_not_take(grids):
    g, nbr = grids['sparse']
    bf = torch.bfloat16
    x2 = torch.zeros(4, 64 * 3, device='meta', dtype=bf)
    tn = torch.zeros(4, 27, device='meta', dtype=torch.int32)
    w = torch.zeros(27, 3, 16, device='meta', dtype=bf)
    with pytest.raises(ValueError, match='CUDA'):
        banded_conv_narrow(x2, tn, w, bf)
    assert banded_conv_narrow.launches == 0
    occ, tn = _t(g.occ), _t(nbr)
    xb = torch.zeros(g.b_cap, 64 * 3, dtype=bf)
    with pytest.raises(ValueError, match='rulebook'):
        tb2d.subm_conv3_2d(xb, occ, tb2d.halo_index(tn),
                           torch.zeros(27, 3, 16), bf)
    for x, n, wt in (
            (torch.zeros(g.b_cap, 64 * 8), tn, torch.zeros(27, 8, 16)),
            (torch.zeros(g.b_cap, 64 * 3), tn, torch.zeros(27, 3, 12)),
            (torch.zeros(g.b_cap, 64 * 3), tn.long(), torch.zeros(27, 3, 16)),
            (torch.zeros(g.b_cap, 64 * 3), tn[1:], torch.zeros(27, 3, 16)),
            (torch.zeros(g.b_cap, 64 * 4), tn, torch.zeros(27, 3, 16))):
        with pytest.raises(ValueError, match='banded_conv_narrow'):
            banded_conv_narrow(x, n, wt, torch.float32)
