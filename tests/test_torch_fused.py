"""K1's fused version (``banded_conv_fused``) of the PyTorch port.

On the CPU the wrapper runs its plain version, the assembled route on plain
PyTorch; the CUDA kernel itself is held against it on the card by
``chip_smoke.py``. Here:

* the wrapper equals ``_assemble_p6`` + ``banded_weights`` +
  ``banded_conv_plain`` bit for bit, and the JAX package's
  ``subm_conv3_2d`` to rtol = atol = 1e-5 at float32 (sums in another
  order), on the cases of tests/test_torch_banded_conv.py;
* a numpy mirror of the kernel's address arithmetic (rulebook entry +
  closed-form halo map -> flat cell id, null -> zero row) equals
  ``halo_index`` exactly, and its shared-memory swizzle is a bijection
  that ``ldmatrix``'s row addresses invert without bank conflicts;
* the routing rule gives the flagship's launch counts;
* the routing errors are raised, not swallowed.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from doda_tpu.ops import bricks as jbricks
from doda_tpu.ops import bricks2d as jb2d
from doda_tpu_torch.config import CfgNode, cfg_from_yaml_file
from doda_tpu_torch.models import model_fn as tmf
from doda_tpu_torch.ops import bricks2d as tb2d
from doda_tpu_torch.ops.banded_conv import (banded_conv_fused,
                                            banded_conv_fused_plain,
                                            banded_conv_plain)

TOL = dict(rtol=1e-5, atol=1e-5)
F32 = jnp.float32


def _grid(coords, cap):
    valid = np.ones(len(coords), bool)
    g = jbricks.brickify(jnp.asarray(coords), jnp.asarray(valid), cap)
    return g, np.asarray(jbricks.build_brick_rulebook(g.table))


@pytest.fixture(scope='module')
def dense_grid():
    rng = np.random.default_rng(3)
    return _grid(rng.integers(0, 24, (4096, 3)).astype(np.int32), 512)


@pytest.fixture(scope='module')
def sparse_grid():
    """Isolated voxels plus the corner contact whose x-halo cell only a
    diagonal brick supplies (see tests/test_torch_banded_conv.py)."""
    rng = np.random.default_rng(11)
    coords = rng.integers(0, 96, (1500, 3)).astype(np.int32)
    crafted = np.array([[4, 4, 4], [3, 3, 4], [3, 3, 7], [4, 7, 4]],
                       np.int32)
    return _grid(np.concatenate([coords, crafted]), 2048)


@pytest.fixture(scope='module')
def overflowed_grid():
    """More bricks than capacity: the surplus falls into the null slot."""
    rng = np.random.default_rng(5)
    coords = rng.integers(0, 64, (3000, 3)).astype(np.int32)
    g, nbr = _grid(coords, 256)
    assert int(g.table.n) == 256 and (nbr == 256).any()
    return g, nbr


def _feats(rng, g, cin):
    f = rng.normal(size=(g.b_cap, 64, cin)).astype(np.float32)
    return (f * np.asarray(g.occ)[..., None]).reshape(g.b_cap, -1)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize('grid_name,cin,cout', [
    ('dense_grid', 16, 16), ('dense_grid', 3, 16), ('dense_grid', 32, 16),
    ('sparse_grid', 16, 16), ('sparse_grid', 4, 8)])
def test_fused_equals_assembled_and_jax(request, grid_name, cin, cout):
    g, nbr = request.getfixturevalue(grid_name)
    rng = np.random.default_rng(cin * 100 + cout)
    x2, tn = _t(_feats(rng, g, cin)), _t(nbr)
    w = _t(rng.normal(size=(27, cin, cout)).astype(np.float32) * 0.1)
    got = banded_conv_fused(x2, tn, w, torch.float32)
    assert got.dtype == torch.float32 and got.shape == (g.b_cap, 64 * cout)
    rows6 = tb2d._assemble_p6(x2, tb2d.halo_index(tn), torch.float32)
    want = banded_conv_plain(rows6, tb2d.banded_weights(w), torch.float32)
    assert torch.equal(got, want)
    assert torch.equal(got, banded_conv_fused_plain(x2, tn, w,
                                                    torch.float32))
    assert banded_conv_fused.launches == 0   # the CPU never reaches a kernel
    want_jax = np.asarray(jb2d.subm_conv3_2d(
        jnp.asarray(x2.numpy()), g.occ, jnp.asarray(nbr),
        jnp.asarray(w.numpy()), compute_dtype=F32))
    np.testing.assert_allclose(
        tb2d._mask(got, _t(g.occ), cout).numpy(), want_jax, **TOL)


def test_fused_bf16_route_equals_assembled_route(sparse_grid):
    """In bf16 ``subm_conv3_2d`` takes the fused route; on the CPU it is
    the assembled route's arithmetic, bit for bit, forward and dx."""
    g, nbr = sparse_grid
    rng = np.random.default_rng(4)
    bf = torch.bfloat16
    x2, tn, occ = _t(_feats(rng, g, 16)).to(bf), _t(nbr), _t(g.occ)
    w = _t(rng.normal(size=(27, 16, 8)).astype(np.float32) * 0.1)
    halo = tb2d.halo_index(tn)
    assert tb2d.subm_route(16, 8, bf, 0) == 'fused'
    outs = []
    for route_nbr in (tn, None):
        xl, wl = x2.clone().requires_grad_(True), w.clone().requires_grad_(True)
        if route_nbr is None:      # the assembled route, by the rule's leave
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(tb2d, 'uses_fused', lambda *a: False)
                out = tb2d.subm_conv3_2d(xl, occ, halo, wl, bf)
                out.float().sum().backward()
        else:
            out = tb2d.subm_conv3_2d(xl, occ, halo, wl, bf, nbr=route_nbr)
            out.float().sum().backward()
        outs.append((out.detach(), xl.grad, wl.grad))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


# --- numpy mirror of csrc/banded_conv_fused.cu's address arithmetic --------

def _halo_dir(h):
    return 0 if h == 0 else (2 if h == 5 else 1)


def _halo_pos(h):
    return (h + 3) & 3


def _kernel_halo_source(nbr, rows):
    """(rows, 216) flat source cell of every halo cell as ``issue_halo``
    derives it; absent or out-of-range neighbours -> rows*64."""
    flat = np.empty((rows, 216), np.int64)
    for hc in range(216):
        hx, r2 = divmod(hc, 36)
        hy, hz = divmod(r2, 6)
        col = _halo_dir(hx) * 9 + _halo_dir(hy) * 3 + _halo_dir(hz)
        cell = _halo_pos(hx) * 16 + _halo_pos(hy) * 4 + _halo_pos(hz)
        src = nbr[:, col].astype(np.int64)
        ok = (src >= 0) & (src < rows)
        flat[:, hc] = np.where(ok, src * 64 + cell, rows * 64)
    return flat


@pytest.mark.parametrize('grid_name', ['dense_grid', 'sparse_grid',
                                       'overflowed_grid'])
def test_kernel_address_arithmetic_equals_halo_index(request, grid_name):
    g, nbr = request.getfixturevalue(grid_name)
    want = tb2d.halo_index(_t(nbr)).numpy()
    np.testing.assert_array_equal(_kernel_halo_source(nbr, g.b_cap), want)


def test_kernel_shared_memory_swizzle():
    """Where ``issue_halo`` writes the two 16-byte halves of a 32-byte cell
    chunk and where ``ldmatrix``'s per-lane row address reads them: every
    read finds the halo cell (x+dx, y+dy, z+dz) and its channel half, and
    the eight rows of each 8x8 matrix fall on eight distinct 16-byte bank
    groups (no conflict)."""
    cell_b = 32
    written = {}
    for hc in range(216):
        hy = (hc % 36) // 6
        for half in range(2):
            off = hc * cell_b + ((half ^ (hy & 1)) << 4)
            assert off not in written
            written[off] = (hc, half)
    assert sorted(written) == list(range(0, 216 * cell_b, 16))
    for dx in range(3):
        for dy in range(3):
            for dz in range(3):
                for m in range(4):
                    for mat in range(4):
                        groups = set()
                        for row8 in range(8):
                            lane = mat * 8 + row8
                            r = (lane & 7) + ((lane >> 3) & 1) * 8
                            ay, az = r >> 2, r & 3
                            a_half = (lane >> 4) ^ (ay & 1)
                            addr = ((ay * 6 + az) * cell_b
                                    + (dx * 36 + dy * 6 + dz) * cell_b
                                    + ((a_half ^ (dy & 1)) << 4)
                                    + m * 36 * cell_b)
                            hc = (m + dx) * 36 + (ay + dy) * 6 + az + dz
                            assert written[addr] == (hc, lane >> 4)
                            groups.add((addr // 16) % 8)
                        assert len(groups) == 8


# --- the routing rule -------------------------------------------------------

@pytest.fixture(scope='module')
def flagship_cfg():
    return cfg_from_yaml_file('cfgs/scannet/spconv.yaml', CfgNode())


@pytest.mark.parametrize('sm_max_cin,dtype,fwd,bwd', [
    (0, torch.bfloat16, dict(sm=0, fused=52, assembled=1),
     dict(sm=0, fused=52, assembled=0)),
    (32, torch.bfloat16, dict(sm=15, fused=37, assembled=1),
     dict(sm=16, fused=36, assembled=0)),
    (32, torch.float32, dict(sm=15, fused=0, assembled=38),
     dict(sm=16, fused=0, assembled=36))])
def test_flagship_routes(flagship_cfg, sm_max_cin, dtype, fwd, bwd):
    model = tmf.build_model(flagship_cfg, device='cpu', dtype=dtype,
                            sm_max_cin=sm_max_cin)
    assert model.subm_routes() == fwd
    assert model.subm_routes(backward=True) == bwd


@pytest.mark.parametrize('cin,cout,dtype,sm_max_cin,want', [
    (3, 16, torch.bfloat16, 32, 'assembled'),
    (16, 16, torch.bfloat16, 0, 'fused'),
    (16, 16, torch.bfloat16, 32, 'sm'),
    (16, 16, torch.float32, 0, 'assembled'),
    (192, 96, torch.bfloat16, 32, 'fused'),
    (24, 8, torch.bfloat16, 32, 'fused'),
    (12, 16, torch.bfloat16, 0, 'assembled')])
def test_subm_route(cin, cout, dtype, sm_max_cin, want):
    assert tb2d.subm_route(cin, cout, dtype, sm_max_cin) == want


def test_fused_raises_off_the_cpu_and_without_rulebook(sparse_grid):
    g, nbr = sparse_grid
    x2 = torch.zeros(4, 64 * 8, device='meta', dtype=torch.bfloat16)
    tn = torch.zeros(4, 27, device='meta', dtype=torch.int32)
    w = torch.zeros(27, 8, 8, device='meta', dtype=torch.bfloat16)
    with pytest.raises(ValueError, match='CUDA'):
        banded_conv_fused(x2, tn, w, torch.bfloat16)
    assert banded_conv_fused.launches == 0
    occ = _t(g.occ)
    xb = torch.zeros(g.b_cap, 64 * 8, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match='rulebook'):
        tb2d.subm_conv3_2d(xb, occ, tb2d.halo_index(_t(nbr)),
                           torch.zeros(27, 8, 8), torch.bfloat16)
