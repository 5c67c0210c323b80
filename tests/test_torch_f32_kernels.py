"""The float32 subm-conv kernels of the PyTorch port, on the CPU.

K1 in float32 (``banded_conv_f32``, ``csrc/subm_conv_f32.cu``) and K2 in
float32 (``banded_conv_sm_taps`` on float32 operands, ``sm_taps_f32`` of
``csrc/banded_conv_sm_taps.cu``) run only on the card, where
``chip_smoke.py`` holds them to their plain versions. Here:

* a numpy mirror of K1 float32's data flow (the halo table of the (S+2)^3
  cells from the rulebook, chunks of 4 channels with the lanes past cin and
  the cells of absent neighbours zero-filled, the odd brick pitch of the
  stages and its bank groups, the thread -> (brick, cells, cout group)
  register tile of each block and the tap loop over (dx, dy) rows) equals
  the JAX package's oracle ``doda_tpu.ops.bricks.subm_conv3`` to 1e-5 of
  max|ref|, at sides 4 and 2 (side 2 in a subprocess under
  ``DODA_BRICK=2``);
* a numpy mirror of K2 float32's data flow (its TMA units of 8 channels
  under the 32-byte swizzle and their bank groups, the block's table of
  slots from the tap table, the lanes' bricks and cout groups, the dy rows
  and dz taps) equals
  ``banded_conv_sm_taps_plain`` in float32 at sides 4 and 2;
* ``subm_route`` sends every float32 conv of the flagship to 'f32', and to
  'sm' under ``sm_max_cin=32`` where ``uses_sm`` holds, at both sides;
* the 'f32' route's forward and dx equal ``jax.vjp`` of the JAX package's
  float32 ``subm_conv3_2d``;
* the wrappers raise off the CPU, and the deleted first versions' wrappers
  name the kernels that replaced them.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import two_threads  # noqa: F401
from doda_tpu.ops import bricks as jbricks
from doda_tpu.ops import bricks2d as jb2d
from doda_tpu_torch.config import CfgNode, cfg_from_yaml_file
from doda_tpu_torch.models import model_fn as tmf
from doda_tpu_torch.ops import bricks as tbricks
from doda_tpu_torch.ops import bricks2d as tb2d
from doda_tpu_torch.ops.banded_conv import banded_conv, banded_conv_f32
from doda_tpu_torch.ops.banded_conv_sm import (banded_conv_sm,
                                               banded_conv_sm_taps,
                                               banded_conv_sm_taps_plain)

F32 = torch.float32
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _grid(side, seed, n_pts, extent, cap):
    """A sparse brick grid at ``side`` (the port's brickify and rulebook,
    null id == rows), seeded activations masked to its active cells."""
    rng = np.random.default_rng(seed)
    coords = torch.from_numpy(rng.integers(0, extent, (n_pts, 3)).astype(
        np.int32))
    g = tbricks.brickify(coords, torch.ones(n_pts, dtype=torch.bool), cap,
                         brick=side)
    nbr = tbricks.build_brick_rulebook(g.table)
    assert (nbr == cap).any() and (nbr < cap).any()    # absent neighbours
    return g.occ.numpy(), nbr.numpy(), rng


def _close(got, want, rel=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.abs(want).max() > 1e-2                   # not vacuous
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), err


# --- numpy mirror of csrc/subm_conv_f32.cu --------------------------------

def _k1_plan(cin, cout, side):
    """``plan<S>``: couts a block, cout groups, chunks of 4, bricks a
    tile."""
    nchunks = -(-cout // 32)
    nc = -(-(-(-cout // nchunks)) // 8) * 8
    ng = nc // 8
    tb = 64 if side == 2 else (16 if ng <= 2 else 8)
    return nc, ng, -(-cin // 4), tb


def _k1_mirror(x2, nbr, w, side):
    """K1 float32 as its blocks compute it, unmasked (rows, S^3, cout)."""
    rows, cells = nbr.shape[0], side ** 3
    cin, cout = w.shape[1:]
    hs = side + 2
    plane, hcells = hs * hs, hs ** 3
    bp = hcells + 1                       # 16-byte slots a brick: odd
    nc, ng, nk, tb = _k1_plan(cin, cout, side)
    units = cells // 8
    p = tb * units
    xt, yt = (1, 2) if side == 4 else (2, 2)
    assert xt * yt * side == 8 and p % 32 == 0 and p * ng <= 256
    # the halo table: halo cell -> (rulebook column, source cell)
    d = [0] + [1] * side + [2]
    pos = [(h + side - 1) & (side - 1) for h in range(hs)]
    tab = np.array([(d[hx] * 9 + d[hy] * 3 + d[hz],
                     pos[hx] * side * side + pos[hy] * side + pos[hz])
                    for hx in range(hs) for hy in range(hs)
                    for hz in range(hs)])
    # threads: cout group, brick of the tile, first cell (x0, y0, 0); the
    # 8 lanes of a quarter warp are 8 bricks at one cell offset, so their
    # float4 loads take 8 distinct 16-byte bank groups
    t = np.arange(p * ng)
    gi, pi = t // p, t % p
    b, unit = pi & (tb - 1), pi // tb
    x0 = unit >> 1 if side == 4 else 0 * unit
    y0 = (unit & 1) * 2 if side == 4 else 0 * unit
    for q in range(0, len(t), 8):
        assert len(set(b[q:q + 8])) == 8 and len(set(unit[q:q + 8])) == 1
        assert len(set((b[q:q + 8] * bp) % 8)) == 8
    ntiles = -(-rows // tb)
    x = x2.reshape(rows, cells, cin)
    out = np.full((rows, cells, cout), np.nan)
    for yb in range(-(-cout // nc)):
        n0 = yb * nc
        acc = np.zeros((ntiles, len(t), 8, 8))
        for kc in range(nk):
            # the stage: every tile's bricks, slot b*bp + hc; the pad slot
            # of a brick is never written, and never read (NaN would show)
            st = np.full((ntiles, tb * bp, 4), np.nan)
            brick = np.arange(ntiles)[:, None] * tb + np.arange(tb)
            src = np.where((brick < rows)[..., None],
                           nbr[np.minimum(brick, rows - 1)], -1)
            for hc in range(hcells):
                col, cell = tab[hc]
                s = src[..., col]
                ok = (s >= 0) & (s < rows)
                for j in range(4):
                    ch = kc * 4 + j
                    v = x[np.clip(s, 0, rows - 1), cell, min(ch, cin - 1)]
                    st[:, np.arange(tb) * bp + hc, j] = np.where(
                        ok & (ch < cin), v, 0.0)
            # the chunk's weights, rows (tap, channel) of nc couts, zero
            # past cin and cout
            wk = np.zeros((27, 4, nc))
            m = min(nc, cout - n0)
            for c in range(min(4, cin - kc * 4)):
                wk[:, c, :m] = w[:, kc * 4 + c, n0:n0 + m]
            # the (dx, dy) rows of each thread, each cell's float4 read by
            # the dz taps of up to three of its cells
            for dx in range(3):
                for dy in range(3):
                    slot = (b * bp + x0 * plane + y0 * hs + dx * plane
                            + dy * hs)[:, None, None, None] \
                        + (np.arange(xt)[:, None, None] * plane
                           + np.arange(yt)[None, :, None] * hs
                           + np.arange(hs)[None, None, :])[None]
                    a = st[:, slot]            # (tiles, t, xt, yt, hs, 4)
                    for dz in range(3):
                        # each thread's 8 couts: (t, 4 channels, 8)
                        wv = wk[dx * 9 + dy * 3 + dz][
                            :, gi[:, None] * 8 + np.arange(8)].transpose(
                                1, 0, 2)
                        av = a[:, :, :, :, dz:dz + side]  # (.., xt, yt, S, 4)
                        acc += np.einsum('ntxyzc,tcj->ntxyzj', av, wv
                                         ).reshape(ntiles, len(t), 8, 8)
        # the stores: cell (x0 + xi, y0 + yi, z), couts of the group
        for k in range(len(t)):
            for xi in range(xt):
                for yi in range(yt):
                    for z in range(side):
                        c = (xi * yt + yi) * side + z
                        cell = ((x0[k] + xi) * side * side
                                + (y0[k] + yi) * side + z)
                        n = n0 + gi[k] * 8
                        m = min(8, cout - n)
                        if m <= 0:
                            continue
                        bricks = np.arange(ntiles) * tb + b[k]
                        live = bricks < rows
                        assert np.isnan(out[bricks[live], cell, n:n + m]).all()
                        out[bricks[live], cell, n:n + m] = acc[live, k, c, :m]
    assert not np.isnan(out).any()
    return out


# side 2's JAX oracle: the package binds its brick side at import
_JAX_SIDE2 = r"""
import os, sys
os.environ['XLA_FLAGS'] = '--xla_force_host_platform_device_count=1'
import jax
jax.config.update('jax_platforms', 'cpu')
import numpy as np
import jax.numpy as jnp
from doda_tpu.ops import bricks

assert bricks.BRICK == 2, bricks.BRICK
d = dict(np.load(sys.argv[1]))
out = bricks.subm_conv3(jnp.asarray(d['x']), jnp.asarray(d['occ']),
                        jnp.asarray(d['nbr']), jnp.asarray(d['w']),
                        jnp.float32)
np.save(sys.argv[2], np.asarray(out))
"""


@pytest.mark.parametrize('side,cin,cout', [(4, 3, 16), (4, 16, 16),
                                           (4, 40, 24), (2, 16, 16)])
def test_k1_f32_mirror_equals_the_jax_oracle(tmp_path, side, cin, cout):
    if side == 4:
        occ, nbr, rng = _grid(4, side + cin, 700, 40, 96)
    else:
        occ, nbr, rng = _grid(2, 9, 500, 16, 160)
    rows, cells = nbr.shape[0], side ** 3
    x = (rng.normal(size=(rows, cells, cin)) * occ[..., None]).astype(
        np.float32)
    w = (rng.normal(size=(27, cin, cout)) * 0.2).astype(np.float32)
    got = _k1_mirror(x.reshape(rows, -1).astype(np.float64), nbr,
                     w.astype(np.float64), side) * occ[..., None]
    if side == 4:
        want = np.asarray(jbricks.subm_conv3(
            jnp.asarray(x), jnp.asarray(occ), jnp.asarray(nbr),
            jnp.asarray(w), jnp.float32))
    else:
        np.savez(tmp_path / 'in.npz', x=x, occ=occ, nbr=nbr, w=w)
        env = {**os.environ, 'DODA_BRICK': '2', 'JAX_PLATFORMS': 'cpu',
               'PYTHONPATH': ROOT}
        subprocess.run([sys.executable, '-c', _JAX_SIDE2,
                        str(tmp_path / 'in.npz'), str(tmp_path / 'out.npy')],
                       check=True, env=env, cwd=ROOT, timeout=300)
        want = np.load(tmp_path / 'out.npy')
    _close(got, want)
    # and the route's plain version (the wrapper on the CPU) on the same
    _close(banded_conv_f32(torch.from_numpy(x.reshape(rows, -1)),
                           torch.from_numpy(nbr), torch.from_numpy(w),
                           F32).numpy().reshape(rows, cells, cout)
           * occ[..., None], want)


# --- numpy mirror of sm_taps_f32 (csrc/banded_conv_sm_taps.cu) -------------

def _geo(s):
    """Geo<S> and Layout<S> of the taps source."""
    sl, cells, plane = s * s, s ** 3, (s + 2) ** 2
    run, xpad = 4 * s + 8, plane + 4
    ysplit = 2 if s == 4 else 1
    return dict(S=s, SL=sl, CELLS=cells, PLANE=plane, RUN=run, XPAD=xpad,
                GYZ0=cells, GXM0=cells + s * run, GXP0=cells + s * run + xpad,
                YSPLIT=ysplit, RY=s // ysplit, CW=s * (s // ysplit),
                CWARPS=s * ysplit, TB=16, SLOT_B=512)


def _tap_source(gm, o, t):
    """The kernel's ``tap_source<S>``."""
    s = gm['S']
    sx = o // gm['SL'] + t // 9 - 1
    hy = (o // s) % s + (t // 3) % 3 - 1
    hz = o % s + t % 3 - 1
    if sx in (-1, s):
        return ((gm['GXM0'] if sx == -1 else gm['GXP0'])
                + (hy + 1) * (s + 2) + (hz + 1))
    if 0 <= hy < s and 0 <= hz < s:
        return sx * gm['SL'] + hy * s + hz
    if not 0 <= hy < s and not 0 <= hz < s:
        pos = 4 * s + (hy == s) * 2 + (hz == s)
    elif hz == -1:
        pos = hy
    elif hz == s:
        pos = s + hy
    else:
        pos = 2 * s + hz if hy == -1 else 3 * s + hz
    return gm['GYZ0'] + sx * gm['RUN'] + pos


def _staged_slot(gm, src):
    if src < gm['GYZ0']:
        return src % gm['SL']
    if src < gm['GXM0']:
        return gm['SL'] + (src - gm['GYZ0']) % gm['RUN']
    return (src - gm['GXM0']) % gm['XPAD']


def _k2_mirror(ops, w, side):
    """K2 float32 as its consumer lanes compute it, (B, S^3, cout)."""
    gm = _geo(side)
    s, tb, plane, sl = side, gm['TB'], gm['PLANE'], gm['SL']
    x, gyz, gxm, gxp = (np.asarray(t, np.float64) for t in ops)
    rows = x.shape[0]
    cin, cout = w.shape[1:]
    nk, ntiles = cin // 8, -(-rows // tb)
    # an operand viewed as (cells, rows, cin), rows past B zero (the TMA
    # boxes' out-of-bounds fill)
    def view(t, cells):
        v = np.zeros((cells, ntiles * tb, cin))
        v[:, :rows] = t.reshape(rows, cells, cin).transpose(1, 0, 2)
        return v
    vx, vg = view(x, gm['CELLS']), view(gyz, s * gm['RUN'])
    vm, vp = view(gxm, gm['XPAD']), view(gxp, gm['XPAD'])
    # the block's slot table: [plane kind][yh][dy][ry][hz] -> byte offset
    # of the source cell (y0 + ry + dy - 1, hz - 1) in a unit, through a
    # reader of the rows: slice 0 at dx = -1 stands for an x-plane, slice 1
    # at dx = 0 for a centre plane
    ry_n = gm['RY']
    table = np.zeros((2, gm['YSPLIT'], 3, ry_n, s + 2), int)
    for xp, yh, dyi, ry, hzi in np.ndindex(table.shape):
        y0, hy, hz = yh * ry_n, yh * ry_n + ry + dyi - 1, hzi - 1
        cy, cz = min(max(hy, y0), y0 + ry_n - 1), min(max(hz, 0), s - 1)
        o = (0 if xp else sl) + cy * s + cz
        t = (0 if xp else 9) + (hy - cy + 1) * 3 + hz - cz + 1
        table[xp, yh, dyi, ry, hzi] = _staged_slot(
            gm, _tap_source(gm, o, t)) * 512
    lane = np.arange(32)
    r, gq = lane & 15, lane >> 4
    sw = (r >> 2) & 1                  # the 32-byte swizzle of brick row r
    out = np.full((ntiles * tb, gm['CELLS'], cout), np.nan)
    for n0 in range(0, cout, 16):
        wts = np.zeros((27, cin, 16))
        wts[..., :min(16, cout - n0)] = w[..., n0:n0 + 16]
        for tile in range(ntiles):
            bricks = slice(tile * tb, tile * tb + tb)
            acc = np.zeros((gm['CWARPS'], 32, gm['CW'], 8))
            for kc in range(nk):
                for pl in range(s + 2):
                    # the unit in shared memory: 16-byte pieces at byte
                    # offset slot*512 + brick*32 + half*16, the halves of
                    # a brick's row swapped where bit 7 is set
                    unit = np.full((plane * 32, 4), np.nan)
                    if pl in (0, s + 1):
                        cells = (vm if pl == 0 else vp)[:plane, bricks]
                    else:
                        cells = np.concatenate([
                            vx[(pl - 1) * sl:pl * sl, bricks],
                            vg[(pl - 1) * gm['RUN']:
                               (pl - 1) * gm['RUN'] + plane - sl, bricks]])
                    ch = cells[..., kc * 8:kc * 8 + 8].reshape(plane, tb, 2,
                                                              4)
                    for half in range(2):
                        off = (np.arange(plane)[:, None] * 512
                               + np.arange(tb) * 32
                               + ((half ^ ((np.arange(tb) >> 2) & 1)) << 4))
                        unit[off // 16] = ch[:, :, half]
                    for warp in range(gm['CWARPS']):
                        xr, yh = warp % s, warp // s
                        dx = pl - 1 - xr
                        if not -1 <= dx <= 1:
                            continue
                        for q in range(2):
                            ab = r * 32 + ((q ^ sw) << 4)
                            for dy in (-1, 0, 1):
                                slots = table[int(pl in (0, s + 1)), yh,
                                              dy + 1]
                                piece = (slots[None]
                                         + ab[:, None, None]) // 16
                                # a quarter warp's 8 bricks: 8 bank groups
                                for lo in range(0, 32, 8):
                                    assert len(set(piece[lo:lo + 8, 0, 0]
                                                   % 8)) == 8
                                a = unit[piece]        # (32, RY, S+2, 4)
                                for dz in (-1, 0, 1):
                                    tap = (dx + 1) * 9 + (dy + 1) * 3 + dz + 1
                                    wv = wts[tap, kc * 8 + q * 4:
                                             kc * 8 + q * 4 + 4]
                                    wv = wv[:, gq[:, None] * 8
                                            + np.arange(8)]  # (4, 32, 8)
                                    av = a[:, :, dz + 1:dz + 1 + s]
                                    acc[warp] += np.einsum(
                                        'lyzc,clj->lyzj', av, wv).reshape(
                                            32, gm['CW'], 8)
            for warp in range(gm['CWARPS']):
                xr, yh = warp % s, warp // s
                for k in range(32):
                    n = n0 + gq[k] * 8
                    if n >= cout:
                        continue
                    cell0 = xr * sl + yh * gm['CW']
                    out[tile * tb + r[k], cell0:cell0 + gm['CW'], n:n + 8] = \
                        acc[warp, k]
    assert not np.isnan(out).any()
    return out[:rows]


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


# --- the route --------------------------------------------------------------

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
                                   'f32': 53, 'assembled': 0}
    assert model.subm_routes(True) == {'sm': 0, 'fused': 0, 'narrow': 0,
                                       'f32': 52, 'assembled': 0}


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


def test_f32_wrappers_raise_off_the_cpu():
    """Off the CPU ``banded_conv_f32`` launches its kernel or raises; the
    first versions' float32 wrappers name the kernels that took their
    convs; nothing counts a launch."""
    meta = dict(device='meta')
    x2 = torch.zeros(8, 64 * 16, **meta)
    nbr = torch.zeros(8, 27, dtype=torch.int32, **meta)
    w = torch.zeros(27, 16, 16, **meta)
    with pytest.raises(ValueError, match='CUDA'):
        banded_conv_f32(x2, nbr, w, F32)
    with pytest.raises(ValueError, match='CUDA'):
        banded_conv(torch.zeros(8, 6, 36 * 16, **meta),
                    torch.zeros(3, 36 * 16, 256, **meta), F32)
    ops = [torch.zeros(8, c * 16, **meta) for c in (64, 96, 40, 40)]
    with pytest.raises(ValueError, match='banded_conv_sm_taps'):
        banded_conv_sm(*ops, *(torch.zeros(s, **meta) for s in (
            (3, 256, 256), (3, 384, 256), (2, 640, 256))), F32)
    with pytest.raises(ValueError, match='CUDA'):
        banded_conv_sm_taps(*ops, w, F32)
    assert banded_conv_f32.launches == banded_conv.launches == 0
    assert banded_conv_sm_taps.launches == banded_conv_sm_taps.f32_launches \
        == 0
