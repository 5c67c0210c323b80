"""The port's fixed-order sums of the train and st steps against the JAX
package:

* the voxel -> point gather's backward (``unet.gather_cells``: each
  cell's point cotangents summed over the batch's sorted stream by
  ``cell_reduce_sorted``, mode 3) against ``index_select``'s autograd and
  ``jax.vjp`` of the JAX package's gather (``row_gather_128`` with the
  clamp and ``where`` of ``doda_tpu/models/unet.py``), at sides 4 and 2, on
  a batch with padded points and dropped bricks, 1e-6 of max|ref|;
* dW's band fold (``bricks2d._dwb_to_dw``: each tap's band cells gathered
  and summed) against the JAX ``_dwb_to_dw`` at side 4 and a float64
  ``index_add_`` fold at side 2, 1e-6 of max|ref|;
* the plain reduction at mode 3, C = 16, float32 and bf16 out (one
  rounding of the float64 sum);
* a numpy mirror of ``csrc/cell_mean.cu``'s schedule (a block's rows of
  one segment, its first and last slots by the warp's 32-way search, one
  thread a run, the tile written whole) on the batch's stream, against the
  plain version and bit-equal to a float32 ``index_add_`` in stream order.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from _torch_threads import two_threads  # noqa: F401
from doda_tpu.ops import bricks as jbricks
from doda_tpu.ops import bricks2d as jb2d
from doda_tpu_torch.models import unet as tunet
from doda_tpu_torch.ops import bricks2d as tb2d
from doda_tpu_torch.ops.cell_mean import (cell_reduce_sorted,
                                          cell_reduce_sorted_plain)

M = 16                       # the flagship's mid width
CAPS = {4: 48, 2: 256}       # level-0 bricks a scene: both drop bricks
TILE_BYTES = 36864           # csrc/cell_mean.cu kTileBytes
THREADS = 256                # and kThreads


def _batch(side, n=900, seed=0):
    """Three scenes: the second padded past 600 points, the third empty;
    a dense corner and a spread that overflows the cap. Returns the plan's
    level-0 grid, the flat cell ids and the stream viewed (Batch, N)."""
    rng = np.random.default_rng(seed)
    coords = rng.integers(0, 40, (3, n, 3)).astype(np.int32)
    coords[:, : n // 3] = rng.integers(0, 8, (3, n // 3, 3))
    valid = np.ones((3, n), bool)
    valid[1, 600:] = False
    valid[2] = False
    cap = CAPS[side]
    plan = tunet.build_level_plan(coords, valid, (cap,), 'cpu', brick=side)
    cells = side ** 3
    gidx = plan.grid0.flat_index()
    miss = gidx >= cap * cells
    assert (miss.numpy() & valid).any() and (miss.numpy() & ~valid).any()
    flat = tunet._flat_ids(gidx, cap * cells)
    sc, sp = (t.view(3, n) for t in tunet.batch_stream(plan.grid0))
    return plan.grid0, flat, miss.reshape(-1), sc, sp, 3 * cap, cells


@pytest.mark.parametrize('side', [4, 2])
def test_gather_backward_equals_index_select_and_jax(side):
    _, flat, miss, sc, sp, rows, cells = _batch(side)
    rng = np.random.default_rng(side)
    vox = rng.normal(size=(rows * cells, M)).astype(np.float32)
    ct = rng.normal(size=(flat.shape[0], M)).astype(np.float32)
    idx = flat.clamp(max=rows * cells - 1)

    def grad(gather):
        v = torch.from_numpy(vox).requires_grad_()
        out = torch.where(miss[:, None], 0, gather(v))
        out.backward(torch.from_numpy(ct))
        return v.grad.numpy()

    got = grad(lambda v: tunet.gather_cells(v, idx, sc, sp, cells))
    lib = grad(lambda v: v.index_select(0, idx).float())

    jmiss, jidx = jnp.asarray(miss.numpy()), jnp.asarray(idx.numpy())

    def jax_gather(table):
        g = jbricks.row_gather_128(table, jidx).astype(jnp.float32)
        return jnp.where(jmiss[:, None], 0, g)

    want = np.asarray(jax.jit(lambda t, c: jax.vjp(jax_gather, t)[1](c)[0])(
        jnp.asarray(vox), jnp.asarray(ct)))
    for ref in (lib, want):
        assert np.abs(ref).max() > 1.0
        assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max()
    # no cotangent reaches a cell that no point of the stream holds
    touched = np.zeros(rows * cells, bool)
    touched[flat[~miss].numpy()] = True
    assert (got[~touched] == 0).all()


@pytest.mark.parametrize('side', [4, 2])
def test_dw_fold_fixed_order(side):
    g = tb2d.geometry(side)
    cin, cout = 5, 7
    dwb = np.random.default_rng(side).normal(
        size=(3, g.plane * cin, g.slice_cells * cout)).astype(np.float32)
    got = tb2d._dwb_to_dw(torch.from_numpy(dwb), cin, cout, side).numpy()
    if side == 4:
        want = np.asarray(jb2d._dwb_to_dw(jnp.asarray(dwb), cin, cout,
                                          pm=False))
    else:
        i, q, r, k = (torch.as_tensor(a) for a in tb2d._band_nonzero(side))
        d5 = torch.from_numpy(dwb).double().reshape(
            3, g.plane, cin, g.slice_cells, cout)
        want = d5.new_zeros(27, cin, cout).index_add_(
            0, k, d5[i, q, :, r, :]).numpy()
    assert got.shape == (27, cin, cout)
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def test_plain_reduction_sum_in_bf16_and_f32():
    """Mode 3, C = 16: the float64 sum of each cell's points rounded once
    to the output type; the cells no point reaches exactly zero."""
    _, flat, miss, sc, sp, rows, cells = _batch(4)
    feats = np.random.default_rng(3).normal(
        size=(flat.shape[0], M)).astype(np.float32)
    total = np.zeros((rows * cells + 1, M))
    np.add.at(total, flat.numpy(), feats.astype(np.float64))
    ref = torch.from_numpy(total[:-1].reshape(rows, cells * M))
    for dt in (torch.float32, torch.bfloat16):
        got = cell_reduce_sorted(torch.from_numpy(feats), sc, sp, rows,
                                 cells, 3, dt)
        assert got.dtype == dt and got.shape == (rows, cells * M)
        assert torch.equal(got, ref.to(dt))
    untouched = np.ones(rows * cells, bool)
    untouched[flat[~miss].numpy()] = False
    assert untouched.any() and (ref.reshape(rows * cells, M)[untouched] == 0
                                ).all()


def _warp_lower_bound(sort_cell, lo, hi, key):
    """csrc/cell_mean.cu ``warp_lower_bound``: 32 probes a step."""
    while lo < hi:
        step = (hi - lo + 31) // 32
        p = lo + np.arange(32) * step
        ge = (p >= hi) | (sort_cell[np.minimum(p, hi - 1)] >= key)
        f = int(np.argmax(ge)) if ge.any() else 32
        if f == 0:
            return lo
        hi = min(lo + f * step, hi) if f < 32 else hi
        lo += (f - 1) * step + 1
    return lo


def _kernel_mirror(feats, sort_cell, sort_pos, rows, cells, mode):
    """``cell_rows``' schedule and arithmetic in numpy: every block's rows
    of one segment (a float32 tile of at most ``TILE_BYTES``, about one
    slot a thread), its slots by two
    searches, one run at a time summed in float32 in stream order, the
    tile written whole. Returns the output and how often each slot was
    summed."""
    scenes, seg = sort_cell.shape
    sc, sp = sort_cell.reshape(-1).numpy(), sort_pos.reshape(-1).numpy()
    c = feats.shape[1]
    seg_rows = rows // scenes
    block_rows = min(max(1, TILE_BYTES // (cells * c * 4)),
                     max(1, THREADS // max(1, len(sc) // rows)), seg_rows)
    out = np.full((rows * cells, c), np.nan, np.float32)
    summed = np.zeros(len(sc), int)
    for s in range(scenes):
        lo = s * seg
        for r0 in range(s * seg_rows, (s + 1) * seg_rows, block_rows):
            r1 = min(r0 + block_rows, (s + 1) * seg_rows)
            j0, j1 = (_warp_lower_bound(sc, lo, lo + seg, r * cells)
                      for r in (r0, r1))
            assert (j0, j1) == tuple(lo + np.searchsorted(
                sc[lo:lo + seg], (r0 * cells, r1 * cells)))
            tile = np.zeros(((r1 - r0) * cells, c), np.float32)
            for j in range(j0, j1):
                if j > j0 and sc[j - 1] == sc[j]:
                    continue
                end = j + 1
                while end < j1 and sc[end] == sc[j]:
                    end += 1
                acc = np.zeros(c, np.float32)
                for k in range(j, end):
                    acc += feats[sp[k]]
                tile[sc[j] - r0 * cells] = acc / np.float32(end - j) \
                    if mode == 4 else acc
                summed[j:end] += 1
            out[r0 * cells:r1 * cells] = tile
    return out.reshape(rows, cells * c), summed


def test_kernel_schedule_mirror():
    """The mirror at C = 3 and C = 16 (a few rows a block, the last
    ragged) at sides 4 and 2: every output element
    written, every valid slot summed once and no null one; modes 3 and 4
    within 1e-6 of max|ref| of the plain version; mode 3 bit-equal to a
    float32 ``index_add_`` over the stream (the same order of the same
    adds)."""
    for side, c in ((4, 3), (4, 16), (2, 3), (2, 16)):
        _, _, _, sc, sp, rows, cells = _batch(side, n=700, seed=side + c)
        feats = np.random.default_rng(c).normal(
            size=(sc.numel(), c)).astype(np.float32)
        valid = (sc < rows * cells).reshape(-1).numpy()
        for mode in (3, 4):
            got, summed = _kernel_mirror(feats, sc, sp, rows, cells, mode)
            assert not np.isnan(got).any()
            assert np.array_equal(summed, valid.astype(int))
            ref = cell_reduce_sorted_plain(torch.from_numpy(feats), sc, sp,
                                           rows, cells, mode).numpy()
            assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max()
            if mode == 3:
                total = got
        ids = sc.reshape(-1).long()[valid]
        seq = torch.zeros(rows * cells, c).index_add_(
            0, ids, torch.from_numpy(feats)[sp.reshape(-1).long()[valid]])
        assert np.array_equal(total, seq.reshape(rows, cells * c).numpy())
