"""The port's point -> cell reduction against the JAX package's default
(``bricks._brick_feats_sorted``, ``DODA_FEATS`` unset):

* ``brickify``'s sorted stream (``sort_cell``, ``sort_pos``) and its
  active-cell count integer for integer, on scenes with invalid points, a
  coordinate past the packed key's range, a capacity below the brick count
  and an empty scene; the table, p2v, occ and p2c unchanged;
* ``cell_reduce_sorted`` (modes 3 and 4; its plain version on the CPU)
  within 1e-5 of the JAX ``brick_feats_2d``, within 1e-6 of max|ref| of a
  float64 numpy mean and no further off it than the JAX default, cells no
  point reaches exactly zero;
* the batch's stream (``unet.batch_stream``) against the scenes' streams;
* a tiny net's logits within 1e-5 of the same net with the scatter route
  (``bricks.cell_feats_2d``) patched in, the launch rule; the raises.

Side 2 is held to the JAX package in ``tests/test_torch_brick_side.py``
(its ``DODA_BRICK=2`` subprocess).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from _torch_threads import two_threads  # noqa: F401
from doda_tpu.ops import bricks as jbricks
from doda_tpu_torch.models import unet as tunet
from doda_tpu_torch.ops import bricks as tbricks
from doda_tpu_torch.ops.cell_mean import cell_reduce_sorted

SENT = np.iinfo(np.int32).max
N_PTS = 5000


def _scene(seed, n=N_PTS, extent=40):
    """Random voxel coords with a denser corner, ~10% invalid points and
    one valid point past the packed key's range (dropped)."""
    rng = np.random.default_rng(seed)
    coords = rng.integers(0, extent, (n, 3)).astype(np.int32)
    coords[: n // 4] = rng.integers(0, 8, (n // 4, 3))
    coords[3] = (5000, 1, 1)
    valid = rng.random(n) < 0.9
    return coords, valid, rng


def _grids(coords, valid, cap):
    jg = jbricks.brickify(jnp.asarray(coords), jnp.asarray(valid), cap)
    tg = tbricks.brickify(torch.from_numpy(coords), torch.from_numpy(valid),
                          cap)
    return jg, tg


@pytest.mark.parametrize('cap', [2048, 64])     # 64: bricks overflow
def test_brickify_stream_equals_jax(cap):
    coords, valid, _ = _scene(9)
    for v in (valid, np.zeros_like(valid)):      # the second scene is empty
        jg, tg = _grids(coords, v, cap)
        for name in ('sort_cell', 'sort_pos', 'occ', 'p2c'):
            np.testing.assert_array_equal(getattr(tg, name).numpy(),
                                          np.asarray(getattr(jg, name)),
                                          err_msg=name)
        assert int(tg.occ.sum()) == int(jg.num_voxels)
        np.testing.assert_array_equal(tg.table.p2v.numpy(),
                                      np.asarray(jg.table.p2v))
        np.testing.assert_array_equal(tg.table.coords.numpy(),
                                      np.asarray(jg.table.coords))
        assert int(tg.table.n) == int(jg.table.n)
        # the table and p2v of a plain dedup of the brick coords
        plain = tbricks.unique_coords_packed(
            torch.div(torch.from_numpy(coords), 4, rounding_mode='floor'),
            torch.from_numpy(v), cap)
        assert torch.equal(plain.coords, tg.table.coords)
        assert torch.equal(plain.p2v, tg.table.p2v)
        sc, sp = tg.sort_cell.numpy(), tg.sort_pos.numpy()
        real = sc != SENT
        assert np.all(np.diff(sc[real]) >= 0) and not real[real.sum():].any()
        flat = tg.flat_index().numpy()
        np.testing.assert_array_equal(
            sc, np.where(flat[sp] >= cap * 64, SENT, flat[sp]))
        assert np.array_equal(np.sort(sp), np.arange(len(sp)))
    assert int(jg.num_voxels) == 0 and not real.any()


def test_sorted_reduction_equals_jax_default(monkeypatch):
    """Modes 3 and 4 on colour-like features (uniform in [0.3, 1]) and
    standard-normal ones: against the float64 mean of each cell's points
    within 1e-6 of max|ref| and no further off than the JAX default; exact
    zeros where no point lands; at 1,500 points within 1e-5 of the JAX
    default. (The JAX default's float32 prefix sum over the stream drifts
    as the stream grows: 2.3e-5 off the float64 sums of 5,000 uniform
    points, 1.0e-5 of 2,000; the port's run sums stay within 2.4e-7.)"""
    monkeypatch.delenv('DODA_FEATS', raising=False)
    cap = 2048
    for n in (1500, N_PTS):
        coords, valid, rng = _scene(3, n=n)
        jg, tg = _grids(coords, valid, cap)
        flat = tg.flat_index().numpy()
        for feats in (rng.uniform(0.3, 1.0, (n, 3)), rng.normal(size=(n, 5))):
            feats = feats.astype(np.float32)
            c = feats.shape[1]
            total = np.zeros((cap * 64 + 1, c))
            np.add.at(total, flat, feats.astype(np.float64))
            count = np.bincount(flat, minlength=cap * 64 + 1)
            untouched = np.repeat(count[:-1] == 0, c).reshape(cap, 64 * c)
            for mode in (3, 4):
                want = np.asarray(jbricks.brick_feats_2d(
                    jnp.asarray(feats), jg, mode))
                got = cell_reduce_sorted(torch.from_numpy(feats),
                                         tg.sort_cell, tg.sort_pos, cap, 64,
                                         mode)
                assert got.dtype == torch.float32
                assert got.shape == (cap, 64 * c)
                got = got.numpy()
                if n <= 1500:
                    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
                ref = total[:-1] if mode == 3 else \
                    total[:-1] / np.maximum(count[:-1], 1)[:, None]
                ref = ref.reshape(cap, 64 * c)
                err = np.abs(got - ref).max()
                assert err <= 1e-6 * np.abs(ref).max(), (n, mode, err)
                assert err <= np.abs(want - ref).max(), (n, mode, err)
                assert untouched.any() and (got[untouched] == 0).all()


def test_batch_stream_equals_scene_streams():
    """The batch's stream: scene s's ids offset by s*cap0*cells, rows by
    s*N, null ids Batch*cap0*cells; its reduction equals the scenes'
    reductions stacked."""
    scenes = [_scene(s, n=700, extent=30) for s in range(3)]
    coords = np.stack([s[0] for s in scenes])
    valid = np.stack([s[1] for s in scenes])
    valid[2] = False
    feats = np.random.default_rng(0).normal(size=(3, 700, 4)).astype(
        np.float32)
    for brick, cap in ((4, 256), (2, 1024), (4, 16)):
        cells = brick ** 3
        plan = tunet.build_level_plan(coords, valid, (cap,), 'cpu',
                                      brick=brick)
        sc, sp = tunet.batch_stream(plan.grid0)
        assert sc.dtype == sp.dtype == torch.int32
        assert sc.shape == sp.shape == (3 * 700,)
        parts = []
        for s in range(3):
            g = tbricks.brickify(torch.from_numpy(coords[s]),
                                 torch.from_numpy(valid[s]), cap, brick)
            ids = g.sort_cell.long()
            want = torch.where(ids == SENT, 3 * cap * cells,
                               ids + s * cap * cells)
            assert torch.equal(sc[s * 700:(s + 1) * 700].long(), want)
            assert torch.equal(sp[s * 700:(s + 1) * 700],
                               g.sort_pos + s * 700)
            parts.append(cell_reduce_sorted(torch.from_numpy(feats[s]),
                                            g.sort_cell, g.sort_pos, cap,
                                            cells))
        real = sc[sc < 3 * cap * cells].long()
        assert (real[1:] >= real[:-1]).all()          # still ascending
        got = cell_reduce_sorted(torch.from_numpy(feats.reshape(-1, 4)), sc,
                                 sp, 3 * cap, cells)
        assert torch.equal(got, torch.cat(parts))


def test_net_sorted_equals_scatter(monkeypatch):
    """A 3-level float32 net at sides 4 and 2 against the same net with
    the scatter route (``bricks.cell_feats_2d``, ``index_add_`` over each
    point's flat cell id) in the reduction's place: logits within 1e-5;
    the launch rule counts one 'cell_mean' a forward and one a backward
    (the voxel -> point gather's)."""
    rng = np.random.default_rng(1)
    coords = rng.integers(0, 30, (2, 1500, 3)).astype(np.int32)
    valid = np.ones((2, 1500), bool)
    valid[1, 1200:] = False
    feats = torch.from_numpy(rng.uniform(0.3, 1, (2, 1500, 3)).astype(
        np.float32))
    for brick, caps in ((4, (256, 128, 64)), (2, (1024, 512, 256))):
        plan = tunet.build_level_plan(coords, valid, caps, 'cpu',
                                      brick=brick)
        flat = tunet._flat_ids(plan.grid0.flat_index(), caps[0] * brick ** 3)
        calls = []

        def scatter(feats, sort_cell, sort_pos, rows, cells, mode=4):
            calls.append(rows)
            return tbricks.cell_feats_2d(feats, flat, rows, mode, cells)

        torch.manual_seed(0)
        model = tunet.SparseConvNet(3, 8, 5, 2, True, 3, dtype=torch.float32,
                                    brick=brick).eval()
        with torch.no_grad():
            got = model(feats, plan)
            with monkeypatch.context() as m:
                m.setattr(tunet, 'cell_reduce_sorted', scatter)
                want = model(feats, plan)
        assert calls == [2 * caps[0]]
        fwd, bwd = model.subm_routes(), model.subm_routes(True)
        assert (fwd['cell_mean'], bwd['cell_mean']) == (1, 1)
        assert torch.isfinite(got).all()
        err = (got - want).abs().max().item()
        assert err <= 1e-5 * max(1.0, want.abs().max().item())


def test_raises():
    """No backward: features that require a gradient raise; so does another
    mode."""
    sc = torch.tensor([0, 0, 5, SENT], dtype=torch.int32)
    sp = torch.arange(4, dtype=torch.int32)
    f = torch.ones(4, 2)
    got = cell_reduce_sorted(f, sc, sp, 2, 4, 4)
    assert got.shape == (2, 8) and got.sum().item() == 4.0
    with pytest.raises(ValueError, match='no backward'):
        cell_reduce_sorted(f.requires_grad_(), sc, sp, 2, 4)
    with pytest.raises(NotImplementedError, match='mode 5'):
        cell_reduce_sorted(torch.ones(4, 2), sc, sp, 2, 4, 5)
