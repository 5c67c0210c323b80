"""Shared inputs of the brick-side tests (tests/test_torch_brick_side*.py):
the JAX package run in a subprocess under ``DODA_BRICK=2`` (its plan, its
sorted stream and default point -> cell reduction, its convs), side-2 grids,
numpy mirrors of the side-2 fused and narrow K1, a net constructor and tiny
CLI rooms.
"""

import os

import numpy as np
import pytest
import torch

from _torch_cli_common import make_cli_rooms
from doda_tpu_torch.models.unet import SparseConvNet
from doda_tpu_torch.ops import bricks as tbricks

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
os.environ.pop('DODA_FEATS', None)           # the default, sorted reduction
feats = dict(uniform=rng.uniform(0.3, 1.0, (n, 3)).astype(np.float32),
             normal=rng.normal(size=(n, 3)).astype(np.float32))
out = dict(
    coords=coords, n=int(g.table.n), tcoords=np.asarray(g.table.coords),
    p2v=np.asarray(g.table.p2v), occ=occ, p2c=np.asarray(g.p2c),
    sort_cell=np.asarray(g.sort_cell), sort_pos=np.asarray(g.sort_pos),
    num_voxels=int(g.num_voxels),
    **{f'{k}{m}': v for k, f in feats.items() for m, v in (
        ('', f), ('_3', np.asarray(bricks.brick_feats_2d(jnp.asarray(f), g,
                                                          3))),
        ('_4', np.asarray(bricks.brick_feats_2d(jnp.asarray(f), g, 4))))},
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


def _net(brick, **kw):
    torch.manual_seed(0)
    return SparseConvNet(3, 8, 5, 2, True, 3, dtype=F32, brick=brick, **kw)


@pytest.fixture(scope='module')
def rooms(tmp_path_factory):
    return make_cli_rooms(tmp_path_factory.mktemp('synth_brick_side'))
