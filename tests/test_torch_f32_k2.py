"""K2 in float32 (``banded_conv_sm_taps`` on float32 operands,
``sm_taps_f32`` of ``csrc/banded_conv_sm_taps.cu``) and the 'f32' route,
on the CPU: a numpy mirror of K2 float32's data flow (its TMA units of 8
channels under the 32-byte swizzle and their bank groups, the block's
table of slots from the tap table, the lanes' bricks and cout groups, the
dy rows and dz taps) equals ``banded_conv_sm_taps_plain`` in float32 at
sides 4 and 2; ``subm_route`` sends every float32 conv of the flagship to
'f32', and to 'sm' under ``sm_max_cin=32`` where ``uses_sm`` holds, at
both sides; the 'f32' route's forward and dx equal ``jax.vjp`` of the JAX
package's float32 ``subm_conv3_2d``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import two_threads  # noqa: F401
from _torch_f32_kernels_common import _close, _grid, _k2_mirror, F32, ROOT
from doda_tpu.ops import bricks as jbricks
from doda_tpu.ops import bricks2d as jb2d
from doda_tpu_torch.config import cfg_from_yaml_file, CfgNode
from doda_tpu_torch.models import model_fn as tmf
from doda_tpu_torch.ops import bricks2d as tb2d
from doda_tpu_torch.ops.banded_conv_sm import (banded_conv_sm_taps,
                                               banded_conv_sm_taps_plain)


@pytest.mark.parametrize('side,cin,cout', [(4, 32, 24), (2, 16, 16)])
def test_k2_f32_mirror_equals_the_plain_version(side, cin, cout):
    occ, nbr, rng = _grid(side, 3, 300, 12 if side == 4 else 8, 40)
    rows = nbr.shape[0]
    x2 = torch.from_numpy((rng.normal(size=(rows, side ** 3, cin))
                           * occ[..., None]).reshape(rows, -1).astype(
                               np.float32))
    w = torch.from_numpy((rng.normal(size=(27, cin, cout)) * 0.2).astype(
        np.float32))
    ops = tb2d._assemble_sm(x2, tb2d.sm_index(torch.from_numpy(nbr), side),
                            F32, side)
    want = banded_conv_sm_taps_plain(*ops, w, F32).numpy()
    got = _k2_mirror([t.numpy() for t in ops], w.numpy().astype(np.float64),
                     side)
    _close(got.reshape(rows, -1), want)
    assert banded_conv_sm_taps.launches == banded_conv_sm_taps.f32_launches \
        == 0                                  # the CPU reaches no kernel


def test_subm_route_sends_float32_to_f32():
    """Every float32 (cin, cout) of the flagship, 3 -> 16 to 192 -> 96,
    at both sides: 'f32', or 'sm' under sm_max_cin=32 where ``uses_sm``
    holds; the flagship's float32 forward and dx counts follow."""
    cfg = cfg_from_yaml_file(os.path.join(ROOT, 'cfgs/scannet/spconv.yaml'),
                             CfgNode())
    model = tmf.build_model(cfg, device='cpu', dtype=F32)
    shapes = sorted({tuple(p.shape[1:]) for p in model.parameters()
                     if p.dim() == 3 and p.shape[0] == 27})
    assert len(shapes) == 14 and shapes[0] == (3, 16) \
        and (192, 96) in shapes, shapes
    for side in (4, 2):
        for cin, cout in shapes:
            assert tb2d.subm_route(cin, cout, F32, 0, side) == 'f32'
            want = 'sm' if tb2d.uses_sm(cin, cout, 32, side) else 'f32'
            assert tb2d.subm_route(cin, cout, F32, 32, side) == want
    assert model.subm_routes() == {'sm': 0, 'fused': 0, 'narrow': 0,
                                   'f32': 53, 'padded': 0, 'cell_mean': 1}
    assert model.subm_routes(True) == {'sm': 0, 'fused': 0, 'narrow': 0,
                                       'f32': 52, 'padded': 0,
                                       'cell_mean': 1}


def test_f32_route_forward_and_dx_equal_jax(monkeypatch):
    """The 'f32' route on the CPU (``banded_conv_f32``'s plain version),
    forward and the dx conv on the flipped stencil, against ``jax.vjp`` of
    the JAX package's float32 ``subm_conv3_2d``, 1e-5 of max|ref|; dW
    too."""
    rng = np.random.default_rng(6)
    coords = rng.integers(0, 20, (900, 3)).astype(np.int32)
    g = jbricks.brickify(jnp.asarray(coords), jnp.ones(900, bool), 64)
    nbr = np.array(jbricks.build_brick_rulebook(g.table))
    occ = np.array(g.occ)
    cin, cout = 16, 24
    x2 = (rng.normal(size=(64, 64, cin)) * occ[..., None]).reshape(
        64, -1).astype(np.float32)
    w = (rng.normal(size=(27, cin, cout)) * 0.2).astype(np.float32)
    cot = rng.normal(size=(64, 64 * cout)).astype(np.float32)
    def conv(a, b):
        return jb2d.subm_conv3_2d(a, g.occ, nbr, b, jnp.float32)

    @jax.jit
    def fwd_vjp(a, b, c):
        out, vjp = jax.vjp(conv, a, b)
        return (out,) + vjp(c)

    want = [np.asarray(v) for v in fwd_vjp(jnp.asarray(x2), jnp.asarray(w),
                                           jnp.asarray(cot))]
    calls = []
    plain = tb2d.banded_conv_f32
    monkeypatch.setattr(tb2d, 'banded_conv_f32',
                        lambda *a: calls.append(a[2].shape) or plain(*a))
    tn, tocc = torch.from_numpy(nbr), torch.from_numpy(occ)
    xl = torch.from_numpy(x2).requires_grad_(True)
    wl = torch.from_numpy(w).requires_grad_(True)
    assert tb2d.subm_route(cin, cout, F32, 0) == 'f32'
    got = tb2d.subm_conv3_2d(xl, tocc, tb2d.halo_index(tn), wl, F32, nbr=tn)
    got.backward(torch.from_numpy(cot))
    assert calls == [(27, cin, cout), (27, cout, cin)]  # forward, then dx
    for a, b in zip((got.detach(), xl.grad, wl.grad), want):
        _close(a.numpy().reshape(b.shape), b)
    with pytest.raises(ValueError, match='nbr'):
        tb2d.subm_conv3_2d(xl, tocc, tb2d.halo_index(tn), wl, F32)
