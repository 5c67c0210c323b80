"""The brick side as an argument of the port (the JAX package's
``DODA_BRICK``), on the CPU at side 2:

* the plan (``brickify``, the rulebook, ``build_brick_downsample``,
  ``down_maps``) integer for integer and the wide-lane convs
  (``subm_conv3_2d``, ``subm_conv3_norm_2d``, ``down_conv2_2d``,
  ``up_conv2_2d``) at float32 to 1e-5 against the JAX package run in a
  subprocess under ``DODA_BRICK=2`` (its side binds at import);
* a numpy mirror of the side-2 address arithmetic of K1's fused version
  (``csrc/banded_conv_fused.cu``: halo decode, m16 tiles that stack the
  same x-slice of four bricks, the swizzle) and of its narrow version
  (``csrc/subm_conv_narrow.cu``: two bricks an m16 tile, the implicit
  im2col), each computing the conv through those addresses and held to
  the plain version, with ``ldmatrix``'s eight rows on eight bank groups;
* a 3-level net at sides 2 and 4 on the same weights: float32 logits and
  one train step's gradients;
* K2's plain paths at side 2 against the shell-gather oracle;
* the raises: an odd side, and a kernel at a side it is not built for;
  K2's route accepted at side 2;
* ``tools/test.py`` at ``--brick 2`` against ``--brick 4`` on tiny rooms.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_threads import two_threads  # noqa: F401
from _torch_cli_common import CFG_DA, data_sets, make_cli_rooms
from doda_tpu_torch import config as tconfig
from doda_tpu_torch.models import model_fn as tmf
from doda_tpu_torch.models import unet as tunet
from doda_tpu_torch.models.unet import FlatDown, SparseConvNet
from doda_tpu_torch.ops import bricks as tbricks
from doda_tpu_torch.ops import bricks2d as tb2d
from doda_tpu_torch.ops.banded_conv import (banded_conv_fused,
                                            banded_conv_fused_plain,
                                            banded_conv_narrow)
from doda_tpu_torch.ops.banded_conv_sm import (banded_conv_sm_plain,
                                               banded_conv_sm_taps,
                                               banded_conv_sm_taps_plain)
from doda_tpu_torch.tools import test as ttest
from doda_tpu_torch.utils import checkpoint as ckpt_utils

TOL = dict(rtol=1e-5, atol=1e-5)
F32 = torch.float32
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the JAX package at DODA_BRICK=2: its plan and its wide-lane convs at
# float32 on a seeded grid, into the .npz named by argv[1]
_JAX = r"""
import os, sys
os.environ['XLA_FLAGS'] = '--xla_force_host_platform_device_count=1'
import jax
jax.config.update('jax_platforms', 'cpu')
import numpy as np
import jax.numpy as jnp
from doda_tpu.ops import bricks, bricks2d
from doda_tpu.models.unet import FlatDown

assert bricks.BRICK == 2, bricks.BRICK
rng = np.random.default_rng(7)
coords = np.concatenate([rng.integers(0, 14, (500, 3)),
                         [[5, 5, 5], [3, 3, 6], [3, 3, 9]]]).astype(np.int32)
n = len(coords)
b_cap, p_cap, cin, cout = 512, 256, 16, 8
g = bricks.brickify(jnp.asarray(coords), jnp.ones(n, bool), b_cap)
nbr = bricks.build_brick_rulebook(g.table)
ds = bricks.build_brick_downsample(g.table, g.occ, p_cap)
occ = np.asarray(g.occ)
x = rng.normal(size=(b_cap, 8, cin)).astype(np.float32) * occ[..., None]
x2 = jnp.asarray(x.reshape(b_cap, -1))
w = jnp.asarray(rng.normal(size=(27, cin, cout)).astype(np.float32) * 0.1)
scale = jnp.asarray(1 + 0.3 * rng.normal(size=cin).astype(np.float32))
bias = jnp.asarray(0.3 * rng.normal(size=cin).astype(np.float32))
wd = jnp.asarray(rng.normal(size=(8, cin, cout)).astype(np.float32) * 0.1)
pocc = np.asarray(ds.parent_occ)
p = rng.normal(size=(p_cap, 8, cout)).astype(np.float32) * pocc[..., None]
p2 = jnp.asarray(p.reshape(p_cap, -1))
wu = jnp.asarray(rng.normal(size=(8, cout, cin)).astype(np.float32) * 0.1)
fd = FlatDown(child_parent=ds.child_parent, parity=ds.parity,
              parent_children=ds.parent_children)
f32 = jnp.float32
out = dict(
    coords=coords, n=int(g.table.n), tcoords=np.asarray(g.table.coords),
    p2v=np.asarray(g.table.p2v), occ=occ, p2c=np.asarray(g.p2c),
    nbr=np.asarray(nbr), pn=int(ds.parent.n),
    pcoords=np.asarray(ds.parent.coords), pocc=pocc,
    child_parent=np.asarray(ds.child_parent), parity=np.asarray(ds.parity),
    parent_children=np.asarray(ds.parent_children),
    target_cells=np.asarray(ds.target_cells),
    parent_src=np.asarray(ds.parent_src),
    x2=np.asarray(x2), w=np.asarray(w), scale=np.asarray(scale),
    bias=np.asarray(bias), wd=np.asarray(wd), p2=np.asarray(p2),
    wu=np.asarray(wu),
    subm=np.asarray(bricks2d.subm_conv3_2d(x2, g.occ, nbr, w, f32)),
    subm_norm=np.asarray(bricks2d.subm_conv3_norm_2d(
        x2, g.occ, nbr, w, scale, bias, f32)),
    down=np.asarray(bricks2d.down_conv2_2d(x2, ds.parent_occ, fd, wd, f32)),
    up=np.asarray(bricks2d.up_conv2_2d(p2, g.occ, fd, wu, f32)))
np.savez(sys.argv[1], **out)
print('DODA_BRICK=2 OK')
"""


def _t(a):
    return torch.from_numpy(np.array(a))


def test_side2_plan_and_convs_equal_the_jax_package(tmp_path):
    path = tmp_path / 'jax_side2.npz'
    env = dict(os.environ, DODA_BRICK='2', JAX_PLATFORMS='')
    env.pop('PYTHONPATH', None)
    run = subprocess.run([sys.executable, '-c', _JAX, str(path)],
                         capture_output=True, text=True, env=env, cwd=ROOT,
                         timeout=600)
    assert run.returncode == 0, run.stderr[-2000:]
    j = dict(np.load(path))

    coords = _t(j['coords'])
    g = tbricks.brickify(coords, torch.ones(len(coords), dtype=torch.bool),
                         512, brick=2)
    n = int(g.table.n)
    assert n == j['n'] and g.occ.shape == (512, 8)
    np.testing.assert_array_equal(g.table.coords[:n].numpy(),
                                  j['tcoords'][:n])
    np.testing.assert_array_equal(g.table.p2v.numpy(), j['p2v'])
    np.testing.assert_array_equal(g.occ.numpy(), j['occ'])
    np.testing.assert_array_equal(g.p2c.numpy(), j['p2c'])
    nbr = tbricks.build_brick_rulebook(g.table)
    np.testing.assert_array_equal(nbr.numpy(), j['nbr'])
    ds = tbricks.build_brick_downsample(g.table, g.occ, 256)
    pn = int(ds.parent.n)
    assert pn == j['pn']
    np.testing.assert_array_equal(ds.parent.coords[:pn].numpy(),
                                  j['pcoords'][:pn])
    for name in ('child_parent', 'parity', 'parent_children'):
        np.testing.assert_array_equal(getattr(ds, name).numpy(), j[name])
    np.testing.assert_array_equal(ds.parent_occ.numpy(), j['pocc'])
    target, parent_src = tbricks.down_maps(ds)
    np.testing.assert_array_equal(target.numpy(), j['target_cells'])
    np.testing.assert_array_equal(parent_src.numpy(), j['parent_src'])

    x2, w = _t(j['x2']), _t(j['w'])
    halo = tb2d.halo_index(nbr, 2)
    assert halo.shape == (512, 64)
    got = tb2d.subm_conv3_2d(x2, g.occ, halo, w, F32, nbr=nbr)
    np.testing.assert_allclose(got.numpy(), j['subm'], **TOL)
    got = tb2d.subm_conv3_norm_2d(x2, g.occ, halo, w, _t(j['scale']),
                                  _t(j['bias']), F32, nbr=nbr)
    np.testing.assert_allclose(got.numpy(), j['subm_norm'], **TOL)
    fd = FlatDown(child_parent=ds.child_parent, parity=ds.parity,
                  parent_children=ds.parent_children)
    got = tb2d.down_conv2_2d(x2, ds.parent_occ, fd, _t(j['wd']), F32)
    np.testing.assert_allclose(got.numpy(), j['down'], **TOL)
    got = tb2d.up_conv2_2d(_t(j['p2']), g.occ, fd, _t(j['wu']), F32)
    np.testing.assert_allclose(got.numpy(), j['up'], **TOL)


# --- numpy mirrors of the side-2 kernels' address arithmetic ---------------

def _halo_dir(h, s=2):
    return 0 if h == 0 else (2 if h == s + 1 else 1)


def _halo_pos(h, s=2):
    return (h + s - 1) & (s - 1)


def _decode(hc):
    """Halo cell hc of a 4x4x4 halo -> (rulebook column, source cell, hy)
    as the kernels' closed form derives them."""
    hx, hy, hz = hc // 16, hc // 4 % 4, hc % 4
    col = _halo_dir(hx) * 9 + _halo_dir(hy) * 3 + _halo_dir(hz)
    cell = _halo_pos(hx) * 4 + _halo_pos(hy) * 2 + _halo_pos(hz)
    return col, cell, hy


def _grid(seed, n_pts, extent, cap):
    rng = np.random.default_rng(seed)
    coords = torch.from_numpy(rng.integers(0, extent, (n_pts, 3)).astype(
        np.int32))
    g = tbricks.brickify(coords, torch.ones(n_pts, dtype=torch.bool), cap,
                         brick=2)
    nbr = tbricks.build_brick_rulebook(g.table)
    return g, nbr, rng


def _fused_mirror(x2, nbr, w, wb=4):
    """fused_tc<S = 2>'s output computed through its own addresses: each
    tile of 4*wb bricks is copied 16 bytes (8 channels) at a time into a
    simulated stage at the swizzled offset, every A row is read back
    through the lane's ldmatrix address, and the m16n8k16 products are
    summed as the kernel sums them; one chunk of 16 channels per step."""
    rows, cin, cout = x2.shape[0], w.shape[1], w.shape[2]
    x = x2.numpy().reshape(rows, 8, cin)
    wt = w.numpy()
    tb, halo_b = 4 * wb, 64 * 32
    out = np.zeros((rows, 8, cout))
    for tile in range(-(-rows // tb)):
        acc = np.zeros((wb, 2, 16, cout))
        for kc in range(-(-cin // 16)):
            stage, written = {}, set()
            for e in range(tb * 64 * 2):
                b, rem = divmod(e, 128)
                hc, half = rem >> 1, rem & 1
                col, cell, hy = _decode(hc)
                dst = (b * halo_b + (hc ^ ((b & 1) << 1)) * 32
                       + ((half ^ (hy & 1)) << 4))
                assert dst % 16 == 0 and dst not in written
                written.add(dst)
                brick = tile * tb + b
                src = int(nbr[brick, col]) if brick < rows else -1
                ch = kc * 16 + half * 8
                vals = np.zeros(8)
                if 0 <= src < rows:
                    got = x[src, cell, ch:ch + 8]
                    vals[:len(got)] = got
                stage[dst] = vals
            assert written == set(range(0, tb * halo_b, 16))
            for warp in range(wb):
                for dy in range(3):
                    for dz in range(3):
                        a = np.zeros((4, 16, 16))    # planes x rows x k
                        for pl in range(4):
                            for mat in range(4):
                                groups = set()
                                for lane in range(mat * 8, mat * 8 + 8):
                                    r = (lane & 7) + ((lane >> 3) & 1) * 8
                                    rb, aq = r // 4, r % 4
                                    ay, az = aq // 2, aq % 2
                                    a_half = (lane >> 4) ^ (ay & 1)
                                    hbase = ((warp * 4 + rb) * halo_b
                                             + (ay * 4 + az) * 32)
                                    hz = az + dz
                                    addr = (hbase + (dy * 4 + (
                                        hz ^ ((rb & 1) << 1)) - az) * 32
                                        + ((a_half ^ (dy & 1)) << 4)
                                        + pl * 16 * 32)
                                    groups.add(addr // 16 % 8)
                                    k0 = (lane >> 4) * 8
                                    a[pl, r, k0:k0 + 8] = stage[addr]
                                assert len(groups) == 8
                        for dx in range(3):
                            tap = (dx * 3 + dy) * 3 + dz
                            wk = np.zeros((16, cout))
                            got = wt[tap, kc * 16:(kc + 1) * 16]
                            wk[:len(got)] = got
                            for m in range(2):
                                acc[warp, m] += a[m + dx] @ wk
        for warp in range(wb):
            for row in range(16):
                brick = tile * tb + warp * 4 + row // 4
                if brick < rows:
                    for m in range(2):
                        out[brick, m * 4 + row % 4] = acc[warp, m, row]
    return out.reshape(rows, -1)


def _narrow_mirror(x2, nbr, w):
    """narrow_tc<S = 2>'s output through its addresses: a warp stages the
    halos of two bricks side by side (4 cells a lane, each slot's brick
    32i / 64), and A[row, k] of its one m16 tile is the word at
    abase(g) (+ one halo for rows g + 8) + koff(k)."""
    rows, cin, cout = x2.shape[0], w.shape[1], w.shape[2]
    cp = cin + (cin & 1)
    words = cp // 2
    ks = -(-27 * cp // 16)
    x = np.zeros((rows, 8, cp))
    x[..., :cin] = x2.numpy().reshape(rows, 8, cin)
    wt = w.numpy()
    bk = np.zeros((ks * 16, cout))
    for k in range(27 * cp):
        if k % cp < cin:
            bk[k] = wt[k // cp, k % cp]

    def koff(k):
        tap, c = divmod(k, cp)
        if tap >= 27:
            tap, c = 13, 0
        dx, dy, dz = tap // 9, tap // 3 % 3, tap % 3
        return (dx * 16 + dy * 4 + dz) * words + c // 2

    out = np.zeros((rows, 8, cout))
    for b0 in range(0, rows, 2):
        hs = np.zeros((2 * 64 * words, 2))          # words of 2 channels
        for lane in range(32):
            for i in range(4):
                j = 32 * i // 64
                hc = lane + 32 * i - 64 * j
                col, cell, _ = _decode(hc)
                src = int(nbr[b0 + j, col]) if b0 + j < rows else -1
                v = x[src, cell] if 0 <= src < rows else np.zeros(cp)
                base = (lane + 32 * i) * words
                hs[base:base + words] = v.reshape(words, 2)
        for g in range(8):
            abase = ((g >> 2) * 16 + ((g >> 1) & 1) * 4 + (g & 1)) * words
            for h, row_base in ((0, abase), (1, abase + 64 * words)):
                a = np.array([hs[row_base + koff(k), k & 1]
                              for k in range(ks * 16)])
                if b0 + h < rows:
                    out[b0 + h, g] = a @ bk
    return out.reshape(rows, -1)


@pytest.mark.parametrize('kernel,cin,cout', [('fused', 32, 16),
                                             ('fused', 16, 24),
                                             ('narrow', 3, 16),
                                             ('narrow', 5, 8)])
def test_side2_kernel_addressing_mirror(kernel, cin, cout):
    """The mirrors' halo decode equals ``halo_index`` at side 2, and the
    convs they compute through the kernels' addresses equal the plain
    version (on a grid whose row count leaves a ragged last tile)."""
    g, nbr, rng = _grid(1, 300, 10, 37)
    rows = nbr.shape[0]
    flat = np.full((rows, 64), rows * 8)
    for hc in range(64):
        col, cell, _ = _decode(hc)
        src = nbr[:, col].numpy()
        flat[:, hc] = np.where(src < rows, src * 8 + cell, rows * 8)
    np.testing.assert_array_equal(flat, tb2d.halo_index(nbr, 2).numpy())
    x = rng.normal(size=(rows, 8, cin)) * g.occ.numpy()[..., None]
    x2 = torch.from_numpy(x.reshape(rows, -1).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(27, cin, cout)) * 0.1).astype(
        np.float32))
    mirror = _fused_mirror if kernel == 'fused' else _narrow_mirror
    want = banded_conv_fused_plain(x2, nbr, w, F32).numpy()
    np.testing.assert_allclose(mirror(x2, nbr, w), want, **TOL)


def _net(brick, **kw):
    torch.manual_seed(0)
    return SparseConvNet(3, 8, 5, 2, True, 3, dtype=F32, brick=brick, **kw)


def test_side2_net_equals_side4_on_the_same_weights():
    """A 3-level, mid-8 net: float32 logits of side 2 within
    1e-4*max(1, max|logit|) of side 4's, and one train step's gradients
    within 1e-4 of their scale (sums in another order)."""
    _, _, rng = _grid(0, 1, 1, 1)
    c = rng.integers(0, 40, (2, 3000, 3)).astype(np.int32)
    c[..., 2] = rng.integers(0, 6, (2, 3000))
    coords = torch.from_numpy(c)
    valid = torch.ones(2, 3000, dtype=torch.bool)
    valid[1, 2500:] = False
    feats = torch.from_numpy(rng.normal(size=(2, 3000, 3)).astype(
        np.float32))
    p4 = tunet.build_level_plan(coords, valid, (1024, 512, 256), 'cpu')
    p2 = tunet.build_level_plan(coords, valid, (2048, 1024, 512), 'cpu',
                                brick=2)
    for lvl in range(3):            # side 2's level l+1 is side 4's l
        assert p2.occs[lvl].shape[-1] == 8
        if lvl < 2:
            assert torch.equal(p2.downs[lvl].parent.n, p4.grid0.table.n
                               if lvl == 0 else p4.downs[0].parent.n)
    net4, net2 = _net(4), _net(2)
    net2.load_state_dict(net4.state_dict())
    with torch.no_grad():
        l4, l2 = net4.eval()(feats, p4), net2.eval()(feats, p2)
    assert torch.isfinite(l4).all()
    lim = 1e-4 * max(1.0, l4.abs().max().item())
    assert (l2 - l4).abs().max().item() <= lim
    net4.train()(feats, p4).square().mean().backward()
    net2.train()(feats, p2).square().mean().backward()
    for (name, a), b in zip(net4.named_parameters(), net2.parameters()):
        scale = max(1.0, a.grad.abs().max().item())
        assert (a.grad - b.grad).abs().max().item() <= 1e-4 * scale, name


def test_side2_k2_plain_paths_equal_the_oracle():
    """K2's operands, weights and both plain versions at side 2 (12-cell
    runs padded to 16, x-planes of 16 padded to 20) against the
    shell-gather oracle ``subm_conv3``."""
    g, nbr, rng = _grid(2, 400, 12, 256)
    rows, cin, cout = 256, 16, 24
    x = rng.normal(size=(rows, 8, cin)) * g.occ.numpy()[..., None]
    x3 = torch.from_numpy(x.astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(27, cin, cout)) * 0.1).astype(
        np.float32))
    want = tbricks.subm_conv3(x3, g.occ, nbr, w, F32)
    ops = tb2d._assemble_sm(x3.reshape(rows, -1), tb2d.sm_index(nbr, 2), F32,
                            2)
    assert [t.shape[1] for t in ops] == [8 * cin, 32 * cin, 20 * cin,
                                         20 * cin]
    for got in (banded_conv_sm_plain(*ops, *tb2d.sm_weights(w, 2), F32),
                banded_conv_sm_taps_plain(*ops, w, F32)):
        got = tb2d._mask(got, g.occ, cout).reshape(rows, 8, cout)
        np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def test_side_raises():
    """An odd side is refused everywhere it can be asked for, and a kernel
    asked for at a side it is not built for raises naming the side (K1's
    and K2's kernels: sides 2 and 4), never running the plain version on
    the card; K2's route is taken at side 2."""
    for side in (3, 1, 0):
        with pytest.raises(ValueError, match='side'):
            tbricks.geometry(side)
        with pytest.raises(ValueError, match='side'):
            _net(side)
    with pytest.raises(ValueError, match='side'):
        tbricks.brickify(torch.zeros(4, 3, dtype=torch.int32),
                         torch.ones(4, dtype=torch.bool), 8, brick=5)
    bf = torch.bfloat16
    nbr = torch.zeros(4, 27, device='meta', dtype=torch.int32)
    w8 = torch.zeros(27, 8, 8, device='meta', dtype=bf)
    x6 = torch.zeros(4, 216 * 8, device='meta', dtype=bf)  # side 6
    with pytest.raises(ValueError, match='side 6'):
        banded_conv_fused(x6, nbr, w8, bf)
    with pytest.raises(ValueError, match='side 6'):
        banded_conv_narrow(torch.zeros(4, 216 * 3, device='meta', dtype=bf),
                           nbr, torch.zeros(27, 3, 8, device='meta',
                                            dtype=bf), bf)
    assert banded_conv_fused.launches == banded_conv_narrow.launches == 0
    with pytest.raises(ValueError, match='side 6'):      # K2 at side 6
        banded_conv_sm_taps(*(torch.zeros(4, n * 16, device='meta', dtype=bf)
                              for n in (216, 192, 68, 68)),
                            torch.zeros(27, 16, 8, device='meta', dtype=bf),
                            bf)
    assert banded_conv_sm_taps.launches == 0
    # K2 at side 2 is accepted: the route, the rule and the net
    assert tb2d.uses_sm(16, 16, 32, side=2) is True
    assert tb2d.subm_route(16, 16, bf, 32, side=2) == 'sm'
    assert _net(2, sm_max_cin=32).sm_levels == (0, 1)
    assert tb2d.subm_route(16, 16, bf, 0, side=2) == 'fused'
    assert tb2d.subm_route(3, 16, bf, 0, side=2) == 'narrow'
    # a plan of another side than the net's
    g, nbr, rng = _grid(0, 50, 8, 64)
    p4 = tunet.build_level_plan(torch.zeros(1, 50, 3, dtype=torch.int32),
                                torch.ones(1, 50, dtype=torch.bool),
                                (64, 64, 64), 'cpu')
    with pytest.raises(ValueError, match='brick side 2'):
        _net(2)(torch.zeros(1, 50, 3), p4)


@pytest.fixture(scope='module')
def rooms(tmp_path_factory):
    return make_cli_rooms(tmp_path_factory.mktemp('synth_brick_side'))


def test_cli_test_at_side2_equals_side4(rooms, tmp_path, monkeypatch):
    """``tools/test.py`` of one checkpoint with ``--brick 2`` and with
    ``--brick 4`` on tiny ScanNet rooms, at a brick cap whose schedule
    clears every level at both sides (the brick audit finds no overflow):
    the same mIoU to 1e-4, and the dumped predictions agree on 99% of the
    points (bf16 logits round differently at the two sides)."""
    shutil.copytree(tconfig.ROOT_DIR / 'cfgs', tmp_path / 'cfgs')
    cfg_file = tmp_path / CFG_DA
    cfg_file.write_text(cfg_file.read_text().replace(
        '    block_reps: 2\n', '    block_reps: 2\n    num_levels: 3\n'))
    monkeypatch.setattr(tconfig, 'ROOT_DIR', tmp_path)
    monkeypatch.chdir(tmp_path)
    sets = data_sets(rooms)
    for i, key in enumerate(sets):
        if key.endswith('brick_cap'):
            sets[i + 1] = '24576'
    cfg = tconfig.CfgNode()
    tconfig.cfg_from_yaml_file(CFG_DA, cfg)
    tconfig.cfg_from_list(sets, cfg)
    torch.manual_seed(3)
    model = tmf.build_model(cfg, device='cpu')
    ckpt = tmp_path / 'seeded.pth'
    ckpt_utils.save_params(ckpt, model, None, 0)
    res = {}
    for side in (4, 2):
        res[side] = ttest.main([
            '--cfg_file', CFG_DA, '--ckpt', str(ckpt), '--device', 'cpu',
            '--batch_size', '2', '--workers', '2', '--extra_tag',
            f'brick{side}', '--brick', str(side), '--save_to_file', '--set',
            *sets])
        log = ''.join(p.read_text() for p in (
            tmp_path / 'output').rglob(f'brick{side}/**/log_*.txt'))
        assert 'DROPPED' not in log and 'brick capacity ok' in log, side
    assert res[4]['scenes'] == res[2]['scenes'] == 4
    assert abs(res[2]['miou'] - res[4]['miou']) <= 1e-4
    dumps = {side: sorted((res[side]['output_dir'] / 'txt').iterdir())
             for side in (4, 2)}
    assert [p.name for p in dumps[4]] == [p.name for p in dumps[2]] != []
    pred = {side: np.concatenate([np.loadtxt(p) for p in dumps[side]])
            for side in (4, 2)}
    assert (pred[4] == pred[2]).mean() >= 0.99
