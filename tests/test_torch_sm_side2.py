"""K2 (``banded_conv_sm``, the source-major subm conv) at brick side 2, on
the CPU:

* the JAX package's Pallas kernel (interpret mode, in a subprocess under
  ``DODA_BRICK=2``, its side binding at import) on the port's side-2
  operands (``_assemble_sm(..., 2)``) and its own ``sm_weights`` equals the
  port's two plain versions to 1e-5 of max|ref|, and the port's
  ``sm_weights(w, 2)`` equals the JAX package's exactly;
* a numpy mirror of ``csrc/banded_conv_sm_taps.cu`` at ``S = 2``: its tap
  table reads the halo planes' windows and names no padding cell, its TMA
  boxes name no padding cell, and the conv computed through its staged
  slots and its block layout (``Layout<2>``: tiles of 16 bricks, one warp
  an output slice, four blocks an SM) equals the shell-gather oracle and
  the plain version;
* the 32-byte swizzle of a side-2 unit: eight bank groups an ``ldmatrix``
  phase, the epilogue's staging and the shared-memory plan;
* the band form's side-2 row maps (each slice's segments of the operands
  and ``sm_weights(w, 2)``, the plain band version's, over a walk of
  64 x 64 blocks, the deleted first kernel's) equal to
  ``banded_conv_sm_plain``;
* a side-2 net under ``sm_max_cin=32`` against ``sm_max_cin=0`` on the
  same weights: float32 logits, one step's gradients, and the kernel calls
  by route against ``subm_routes``.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_threads import two_threads  # noqa: F401
from doda_tpu_torch.models import unet as tunet
from doda_tpu_torch.models.unet import SparseConvNet
from doda_tpu_torch.ops import bricks as tbricks
from doda_tpu_torch.ops import bricks2d as tb2d
from doda_tpu_torch.ops.banded_conv_sm import (banded_conv_sm_plain,
                                               banded_conv_sm_taps_plain)

F32 = torch.float32
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the kernel's side-2 constants (Geo<2>, Layout<2> of banded_conv_sm_taps.cu)
S, SHIFT = 2, 1
SL, CELLS, PLANE = S * S, S ** 3, (S + 2) ** 2
RUN, XPAD = 4 * S + 8, PLANE + 4
GYZ0, GXM0 = CELLS, CELLS + S * RUN
GXP0 = GXM0 + XPAD
YSPLIT, BLOCKS = 1, 4
TB, RY = 16, S // YSPLIT
CW, CWARPS = S * RY, S * YSPLIT
SLOT_B, STAGED_B = TB * 32, CW * TB * 32
UNIT_B = PLANE * SLOT_B


def _grid(seed, n_pts, extent, cap):
    rng = np.random.default_rng(seed)
    coords = torch.from_numpy(rng.integers(0, extent, (n_pts, 3)).astype(
        np.int32))
    g = tbricks.brickify(coords, torch.ones(n_pts, dtype=torch.bool), cap,
                         brick=2)
    return g, tbricks.build_brick_rulebook(g.table), rng


def _operands(g, nbr, rng, cin, cout):
    rows = nbr.shape[0]
    x = rng.normal(size=(rows, CELLS, cin)) * g.occ.numpy()[..., None]
    x2 = torch.from_numpy(x.reshape(rows, -1).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(27, cin, cout)) * 0.1).astype(
        np.float32))
    ops = tb2d._assemble_sm(x2, tb2d.sm_index(nbr, 2), F32, 2)
    return x2, w, ops


def _close(got, want, rel=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    lim = rel * max(1.0, np.abs(want).max())
    assert np.abs(got - want).max() <= lim


# the JAX package at DODA_BRICK=2: its sm_weights and the Pallas kernel in
# interpret mode on the operands and raster weights in argv[1]
_JAX = r"""
import os, sys
os.environ['XLA_FLAGS'] = '--xla_force_host_platform_device_count=1'
import jax
jax.config.update('jax_platforms', 'cpu')
import numpy as np
import jax.numpy as jnp
from doda_tpu.ops import bricks, bricks2d, pallas_sm

assert bricks.BRICK == 2, bricks.BRICK
d = dict(np.load(sys.argv[1]))
ops = [jnp.asarray(d[k]) for k in ('x', 'gyz', 'gxm', 'gxp')]
wts = bricks2d.sm_weights(jnp.asarray(d['w']), jnp.float32)
assert pallas_sm.fits_sm(ops[0].shape[0], d['w'].shape[1], d['w'].shape[2])
out = pallas_sm.banded_conv_sm(*ops, *wts, jnp.float32)
np.savez(sys.argv[2], out=np.asarray(out),
         **{k: np.asarray(v) for k, v in zip(('wc', 'wh', 'wx'), wts)})
print('DODA_BRICK=2 OK')
"""


def test_side2_equals_the_pallas_kernel(tmp_path):
    g, nbr, rng = _grid(2, 400, 12, 256)
    _, w, ops = _operands(g, nbr, rng, 16, 24)
    assert [t.shape[1] for t in ops] == [8 * 16, 32 * 16, 20 * 16, 20 * 16]
    src, dst = tmp_path / 'ops.npz', tmp_path / 'out.npz'
    np.savez(src, w=w.numpy(), **{k: t.contiguous().numpy() for k, t in
                                  zip(('x', 'gyz', 'gxm', 'gxp'), ops)})
    env = dict(os.environ, DODA_BRICK='2', JAX_PLATFORMS='')
    env.pop('PYTHONPATH', None)
    run = subprocess.run([sys.executable, '-c', _JAX, str(src), str(dst)],
                         capture_output=True, text=True, env=env, cwd=ROOT,
                         timeout=600)
    assert run.returncode == 0, run.stderr[-2000:]
    j = dict(np.load(dst))
    for name, t in zip(('wc', 'wh', 'wx'), tb2d.sm_weights(w, 2)):
        np.testing.assert_array_equal(t.numpy(), j[name])
    want = j['out']
    assert want.shape == (256, CELLS * 24)
    _close(banded_conv_sm_plain(*ops, *tb2d.sm_weights(w, 2), F32), want)
    _close(banded_conv_sm_taps_plain(*ops, w, F32), want)


# --- numpy mirror of csrc/banded_conv_sm_taps.cu at S = 2 -------------------

def _inside(h):
    return 0 <= h < S


def _run_pos(hy, hz):
    if not _inside(hy) and not _inside(hz):
        return 4 * S + (hy == S) * 2 + (hz == S)
    if hz == -1:
        return hy
    if hz == S:
        return S + hy
    return 2 * S + hz if hy == -1 else 3 * S + hz


def _tap_source(o, t):
    sx = (o >> (2 * SHIFT)) + t // 9 - 1
    hy = ((o >> SHIFT) & (S - 1)) + (t // 3) % 3 - 1
    hz = (o & (S - 1)) + t % 3 - 1
    if sx in (-1, S):
        return (GXM0 if sx == -1 else GXP0) + (hy + 1) * (S + 2) + (hz + 1)
    if _inside(hy) and _inside(hz):
        return sx * SL + hy * S + hz
    return GYZ0 + sx * RUN + _run_pos(hy, hz)


def _staged_slot(src):
    if src < GYZ0:
        return src % SL
    return SL + (src - GYZ0) % RUN if src < GXM0 else (src - GXM0) % XPAD


PADS = ({GYZ0 + r * RUN + k for r in range(S) for k in range(4 * S + 4, RUN)}
        | {base + k for base in (GXM0, GXP0) for k in range(PLANE, XPAD)})


def _unit(x3, g3, m3, p3, pl, bricks, ch):
    """The staged unit (channel chunk ch, plane pl) of a tile as its TMA
    boxes place it, and the operand cells the boxes name."""
    if pl in (0, S + 1):
        base = GXM0 if pl == 0 else GXP0
        return (m3 if pl == 0 else p3)[:PLANE, bricks, ch], \
            set(range(base, base + PLANE))
    x0, g0 = (pl - 1) * SL, (pl - 1) * RUN
    unit = np.concatenate([x3[x0:x0 + SL, bricks, ch],
                           g3[g0:g0 + PLANE - SL, bricks, ch]])
    return unit, set(range(x0, x0 + SL)) | set(
        range(GYZ0 + g0, GYZ0 + g0 + PLANE - SL))


def _taps_walk(x, gyz, gxm, gxp, w):
    """sm_taps_tc<2>'s output through its data flow: tiles of TB bricks
    with TMA's zero fill, units (channel chunk, plane) staged as the boxes
    place them, consumer warp (xr, yh) reading each source cell of its
    rows once at the slot a representative reader names, multiplied by
    the resident weight rows, and stored at cell xr*S^2 + yh*CW + c of its
    bricks."""
    b, cin, cout = x.shape[0], w.shape[1], w.shape[2]
    bp = -(-b // TB) * TB

    def view(a):
        a = np.pad(np.asarray(a, np.float64), ((0, bp - b), (0, 0)))
        return a.reshape(bp, -1, cin).transpose(1, 0, 2)

    x3, g3, m3, p3 = map(view, (x, gyz, gxm, gxp))
    assert (x3.shape[0], g3.shape[0], m3.shape[0]) == (CELLS, S * RUN, XPAD)
    w_s = np.asarray(w, np.float64).reshape(27 * cin, cout)  # one group
    out = np.zeros((bp, CELLS, cout))
    named = set()
    for tile in range(bp // TB):
        bricks = slice(tile * TB, (tile + 1) * TB)
        acc = np.zeros((CWARPS, CW, TB, cout))
        for kc in range(cin // 16):
            ch = slice(kc * 16, kc * 16 + 16)
            for pl in range(S + 2):
                unit, cells = _unit(x3, g3, m3, p3, pl, bricks, ch)
                assert unit.shape[0] == PLANE and not cells & PADS
                named |= cells
                xplane = pl in (0, S + 1)
                for warp in range(CWARPS):
                    xr, yh = warp & (S - 1), warp >> SHIFT
                    dx, y0 = pl - 1 - xr, yh * RY
                    if not -1 <= dx <= 1:
                        continue
                    for hy in range(y0 - 1, y0 + RY + 1):
                        for hz in range(-1, S + 1):
                            ry = min(max(hy, y0), y0 + RY - 1)
                            rz = min(max(hz, 0), S - 1)
                            o = (0 if xplane else SL) + ry * S + rz
                            t = (0 if xplane else 9) + (hy - ry + 1) * 3 \
                                + (hz - rz + 1)
                            slot = _staged_slot(_tap_source(o, t))
                            a = unit[slot]
                            for dy in (-1, 0, 1):
                                for dz in (-1, 0, 1):
                                    y, z = hy - dy, hz - dz
                                    if not (y0 <= y < y0 + RY
                                            and _inside(z)):
                                        continue
                                    tap = (dx + 1) * 9 + (dy + 1) * 3 \
                                        + dz + 1
                                    real = xr * SL + y * S + z
                                    assert _staged_slot(
                                        _tap_source(real, tap)) == slot
                                    r0 = tap * cin + kc * 16
                                    c = (y - y0) * S + z
                                    acc[warp, c] += a @ w_s[r0:r0 + 16]
        for warp in range(CWARPS):
            xr, yh = warp & (S - 1), warp >> SHIFT
            for c in range(CW):
                out[bricks, xr * SL + yh * CW + c] = acc[warp, c]
    assert named == set(range(GXP0 + XPAD)) - PADS     # every halo cell
    return out[:b].reshape(b, -1)


@pytest.mark.parametrize('cin,cout', [(16, 16), (32, 24)])
def test_side2_taps_mirror_computes_the_conv(cin, cout):
    """The tap table names the 64 halo cells and no padding, and reads for
    every (output cell, tap) the window of ``_assemble_p6``'s side-2
    planes; the walk through the kernel's addresses equals the oracle
    (masked) and the plain version, on a grid whose row count leaves a
    ragged last tile of 16 bricks."""
    table = np.array([[_tap_source(o, t) for t in range(27)]
                      for o in range(CELLS)])
    assert set(table.ravel().tolist()) == set(range(GXP0 + XPAD)) - PADS
    assert (table[0, 0], table[CELLS - 1, 26], table[SL, 13],
            table[SL, 9]) == (GXM0, GXP0 + PLANE - 1, SL, GYZ0 + RUN + 4 * S)
    assert _staged_slot(GYZ0 + RUN + 4 * S + 3) == PLANE - 1
    g, nbr, rng = _grid(cin, 300, 8, 75)
    rows = nbr.shape[0]
    x2, w, ops = _operands(g, nbr, rng, cin, cout)
    src = torch.cat([t.reshape(rows, -1, cin) for t in ops], 1).numpy()
    p6 = tb2d._assemble_p6(x2, tb2d.halo_index(nbr, 2), F32).reshape(
        rows, S + 2, PLANE, cin).numpy()
    for o in range(CELLS):
        xo, yo, zo = o >> 2, (o >> 1) & 1, o & 1
        for t in range(27):
            dx, dy, dz = t // 9 - 1, t // 3 % 3 - 1, t % 3 - 1
            want = p6[:, xo + dx + 1, (yo + dy + 1) * (S + 2) + zo + dz + 1]
            np.testing.assert_array_equal(src[:, table[o, t]], want)
    got = _taps_walk(*(t.numpy() for t in ops), w.numpy())
    _close(got, banded_conv_sm_taps_plain(*ops, w, F32).numpy())
    oracle = tbricks.subm_conv3(x2.reshape(rows, CELLS, cin), g.occ, nbr, w,
                                F32).reshape(rows, -1).numpy()
    mask = np.repeat(g.occ.numpy(), cout, axis=1)
    _close(got * mask, oracle)


def _swz(off):
    """TMA's 32-byte swizzle: the 16-byte half index ^= bit 7."""
    return off ^ (((off >> 7) & 1) << 4)


def _staged_off(c, r, half):
    return c * TB * 32 + r * 32 + ((half ^ ((r >> 2) & 1)) << 4)


def _plan(cin):
    """The kernel's ``plan<2>``: (chunks a group, stages, bytes, resident
    blocks the ring was sized for)."""
    nk, fixed = cin // 16, 2 * 1024 + CWARPS * STAGED_B
    chunk_w, most = 27 * 16 * 48, 227 * 1024
    gmax = (most - fixed - 2 * UNIT_B) // chunk_w
    gk = -(-nk // -(-nk // gmax))
    for blocks in range(BLOCKS, 0, -1):
        free = min(228 * 1024 // blocks - 1024, most) - fixed - gk * chunk_w
        if free >= 2 * UNIT_B:
            break
    stages = min(free // UNIT_B, 6)
    return gk, stages, fixed + stages * UNIT_B + gk * chunk_w, blocks


def test_side2_swizzle_staging_and_plan():
    """A side-2 unit is 16 cells x 16 bricks x 32 bytes: every (cell,
    brick, half) has one swizzled place, each lane's ldmatrix address finds
    (cell, r, half), and the eight rows of each 8x8 matrix fall on eight
    bank groups; the epilogue's bf16 stores touch every bank once a warp
    store and each 16-byte copy-out read finds its (cell, brick, couts);
    four blocks of the ring fit an SM at cin 16 and three at 32, and every
    cin has two to six stages."""
    placed = {}
    for cell in range(PLANE):
        for brick in range(TB):
            for half in range(2):
                off = _swz(cell * SLOT_B + brick * 32 + half * 16)
                assert off not in placed
                placed[off] = (cell, brick, half)
    assert sorted(placed) == list(range(0, UNIT_B, 16))
    for cell in range(PLANE):
        for mat in range(4):
            groups = set()
            for lane in range(mat * 8, mat * 8 + 8):
                r = (lane & 7) + ((lane >> 3) & 1) * 8
                addr = (cell * SLOT_B + r * 32
                        + (((lane >> 4) ^ ((r >> 2) & 1)) << 4))
                assert placed[addr] == (cell, r, lane >> 4)
                groups.add(addr // 16 % 8)
            assert len(groups) == 8
    staged = {}
    for c in range(CW):
        for h in range(2):
            for j in range(2):
                banks = []
                for lane in range(32):
                    r = (lane >> 2) + 8 * h
                    off = _staged_off(c, r, j) + (lane & 3) * 4
                    assert off not in staged
                    staged[off] = (c, r, j * 8 + 2 * (lane & 3))
                    banks.append(off // 4 % 32)
                assert sorted(banks) == list(range(32))
    assert sorted(staged) == list(range(0, STAGED_B, 4))
    for c in range(CW):
        reads = [_staged_off(c, lane >> 1, lane & 1) for lane in range(32)]
        for lane, off in enumerate(reads):
            assert staged[off] == (c, lane >> 1, (lane & 1) * 8)
        lo = c * TB * 32
        assert sorted(reads) == list(range(lo, lo + 512, 16))
    for cin in range(16, 513, 16):
        gk, stages, smem, blocks = _plan(cin)
        assert 2 <= stages <= 6 and smem <= 227 * 1024
        assert (gk == cin // 16) == (cin <= 160)
        assert blocks * (smem + 1024) <= 228 * 1024
    assert [_plan(cin)[3] for cin in (16, 32)] == [4, 3]
    assert _plan(16) == (1, 3, 6144 + 3 * 8192 + 20736, 4)


# --- the band form's row maps at S = 2 ---------------------------------------

def test_side2_first_version_row_maps():
    """The band form's segments at side 2 (slice xr, tap i: gxm, gxp or
    x's slice cx and its gyz run, each with its block of ``sm_weights(w,
    2)``), summed over a grid of 64 x 64 blocks as the first version's
    kernel summed them (deleted: float32 runs ``sm_taps_f32`` on the raster
    weights), each (row, slice, column) written by one block, equal
    ``banded_conv_sm_plain``: the band form the plain version and the JAX
    contract tests keep."""
    g, nbr, rng = _grid(5, 300, 8, 70)
    cin, cout = 32, 16
    _, w, ops = _operands(g, nbr, rng, cin, cout)
    x, gyz, gxm, gxp = (t.numpy().astype(np.float64) for t in ops)
    wc, wh, wx = (t.numpy().astype(np.float64)
                  for t in tb2d.sm_weights(w, 2))
    n, kx, kr, kp = SL * cout, SL * cin, RUN * cin, XPAD * cin
    assert (wc.shape, wh.shape, wx.shape) == ((3, kx, n), (3, kr, n),
                                              (2, kp, n))
    segs = []
    for xr in range(S):
        row = []
        for i in range(3):
            cx = xr + i - 1
            if cx == -1:
                row.append((gxm, wx[0]))
            elif cx == S:
                row.append((gxp, wx[1]))
            else:
                row += [(x[:, cx * kx:(cx + 1) * kx], wc[i]),
                        (gyz[:, cx * kr:(cx + 1) * kr], wh[i])]
        assert len(row) <= 6 and all(a.shape[1] % 16 == 0 for a, _ in row)
        segs.append(row)
    rows, bm, bn = x.shape[0], 64, 64
    n_tiles = -(-n // bn)
    out = np.full((rows, S * n), np.nan)
    for bid in range(-(-rows // bm) * S * n_tiles):
        n0, xr = bid % n_tiles * bn, bid // n_tiles & (S - 1)
        m0 = bid // (S * n_tiles) * bm
        r, c = slice(m0, min(m0 + bm, rows)), slice(n0, min(n0 + bn, n))
        acc = sum(a[r] @ wt[:, c] for a, wt in segs[xr])
        cols = slice(xr * n + c.start, xr * n + c.stop)
        assert np.isnan(out[r, cols]).all()
        out[r, cols] = acc
    _close(out, banded_conv_sm_plain(*ops, *tb2d.sm_weights(w, 2),
                                     F32).numpy())


# --- the side-2 net under sm_max_cin = 32 ----------------------------------

def _net(**kw):
    torch.manual_seed(0)
    return SparseConvNet(3, 16, 5, 2, True, 3, dtype=F32, brick=2, **kw)


def test_side2_net_on_k2_equals_k1(monkeypatch):
    """A 3-level, mid-16 net at side 2, ``sm_max_cin=32`` (K2 at levels 0
    and 1) against ``sm_max_cin=0`` on the same weights: float32 logits
    within 1e-5 of their scale, one train step's gradients within 1e-4 of
    theirs, and the conv calls by route (forward and backward) equal to
    ``subm_routes``."""
    rng = np.random.default_rng(4)
    c = rng.integers(0, 40, (2, 3000, 3)).astype(np.int32)
    c[..., 2] = rng.integers(0, 6, (2, 3000))
    coords = torch.from_numpy(c)
    valid = torch.ones(2, 3000, dtype=torch.bool)
    valid[1, 2500:] = False
    feats = torch.from_numpy(rng.normal(size=(2, 3000, 3)).astype(
        np.float32))
    plan = tunet.build_level_plan(coords, valid, (2048, 1024, 512), 'cpu',
                                  brick=2)
    calls = {'sm': 0, 'f32': 0}
    for name, route in (('banded_conv_sm_taps', 'sm'),
                        ('banded_conv_f32', 'f32')):
        def counted(*a, _fn=getattr(tb2d, name), _route=route):
            calls[_route] += 1
            return _fn(*a)
        monkeypatch.setattr(tb2d, name, counted)
    k1, k2 = _net(), _net(sm_max_cin=32)
    assert k2.sm_levels == (0, 1) and k1.sm_levels == ()
    routes = {n: (m.subm_routes(), m.subm_routes(backward=True))
              for n, m in (('k1', k1), ('k2', k2))}
    with torch.no_grad():
        l1, l2 = k1.eval()(feats, plan), k2.eval()(feats, plan)
    assert torch.isfinite(l1).all()
    assert (l2 - l1).abs().max().item() <= 1e-5 * max(
        1.0, l1.abs().max().item())
    for name, model in (('k1', k1), ('k2', k2)):
        for k in calls:
            calls[k] = 0
        model.train()(feats, plan).square().mean().backward()
        fwd, bwd = routes[name]
        assert calls == {k: fwd[k] + bwd[k] for k in calls}, (name, calls)
    assert routes['k2'][0]['sm'] > 0 and routes['k2'][1]['sm'] > 0
    for (name, a), b in zip(k1.named_parameters(), k2.parameters()):
        scale = max(1.0, a.grad.abs().max().item())
        assert (a.grad - b.grad).abs().max().item() <= 1e-4 * scale, name
