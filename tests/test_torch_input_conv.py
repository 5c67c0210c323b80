"""K1's narrow-input version (``banded_conv_narrow``) of the PyTorch port:
the bf16 input conv (cin = 3) from the activation and the rulebook.

On the CPU the wrapper runs its plain version, the fused version's (the
assembled route on plain PyTorch); the CUDA kernel itself
(``csrc/subm_conv_narrow.cu``) is held against it on the card by
``chip_smoke.py``. Here:

* the wrapper equals the JAX package's ``subm_conv3_2d`` at cin = 1, 3, 5
  -> 16 on a dense, a sparse and an overflowed grid, to rtol = atol = 1e-5
  at float32 (sums in another order); in bf16 within one bf16 rounding
  of the float32 conv of the same operands, and near the JAX bf16 conv;
* a numpy mirror of the kernel's halo staging and implicit im2col (lane
  -> halo cell by the closed-form map, rulebook entry -> source cell, the
  m16n8k16 fragments' words -> (cell, tap, channel), the B fragments ->
  raster weights) selects exactly what ``halo_index`` and
  ``_assemble_p6`` select;
* the routing rule sends the bf16 input conv of the flagship to it;
* a bf16 net runs it once a forward, with the assembled route's bits;
* the wrapper raises off the CPU, without a rulebook and on shapes it
  does not take.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from _torch_threads import two_threads  # noqa: F401
from doda_tpu.ops import bricks as jbricks
from doda_tpu.ops import bricks2d as jb2d
from doda_tpu_torch.config import CfgNode, cfg_from_yaml_file
from doda_tpu_torch.models import model_fn as tmf
from doda_tpu_torch.models.unet import default_brick_caps
from doda_tpu_torch.ops import bricks2d as tb2d
from doda_tpu_torch.ops.banded_conv import (NARROW_MAX_CIN,
                                            banded_conv_fused_plain,
                                            banded_conv_narrow)

TOL = dict(rtol=1e-5, atol=1e-5)


def _grid(coords, cap):
    g = jbricks.brickify(jnp.asarray(coords),
                         jnp.ones(len(coords), bool), cap)
    return g, np.asarray(jbricks.build_brick_rulebook(g.table))


@pytest.fixture(scope='module')
def grids():
    """Dense; sparse with the corner contact whose x-halo cell only a
    diagonal brick supplies; more bricks than capacity (the surplus in the
    null slot)."""
    rng = np.random.default_rng(3)
    dense = _grid(rng.integers(0, 24, (4096, 3)).astype(np.int32), 512)
    rng = np.random.default_rng(11)
    coords = rng.integers(0, 96, (1500, 3)).astype(np.int32)
    crafted = np.array([[4, 4, 4], [3, 3, 4], [3, 3, 7], [4, 7, 4]],
                       np.int32)
    sparse = _grid(np.concatenate([coords, crafted]), 2048)
    rng = np.random.default_rng(5)
    over = _grid(rng.integers(0, 64, (3000, 3)).astype(np.int32), 256)
    assert int(over[0].table.n) == 256 and (over[1] == 256).any()
    return {'dense': dense, 'sparse': sparse, 'overflowed': over}


def _inputs(rng, g, cin, cout=16):
    x = rng.normal(size=(g.b_cap, 64, cin)).astype(np.float32)
    x = (x * np.asarray(g.occ)[..., None]).reshape(g.b_cap, -1)
    w = (rng.normal(size=(27, cin, cout)) / np.sqrt(27 * cin)).astype(
        np.float32)
    return x, w


def _t(a):
    return torch.from_numpy(np.array(a))


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


# --- numpy mirror of csrc/subm_conv_narrow.cu --------------------------------

def _hdir(h):
    return 0 if h == 0 else (2 if h == 5 else 1)


def _hpos(h):
    return (h + 3) & 3


def _koff(k, cp):
    """``koff<CP>``: the word of column k inside a cell's halo
    neighbourhood; padded columns read the centre cell's first word."""
    tap, c = divmod(k, cp)
    if tap >= 27:
        tap, c = 13, 0
    dx, dy, dz = tap // 9, tap // 3 % 3, tap % 3
    return (dx * 36 + dy * 6 + dz) * (cp // 2) + c // 2


def _kernel_im2col(x2, nbr, w, cin, cout):
    """What the kernel multiplies, built by its own index arithmetic: the
    (rows, 64, K) A tile each warp reads from its staged halo and the
    (K, cout) B fragments it holds, K = 27*CP padded to 16."""
    rows = nbr.shape[0]
    cp, words = cin + cin % 2, (cin + cin % 2) // 2
    ks_n = -(-27 * cp // 16)
    # staging: lane + 32i -> halo cell -> (rulebook column, source cell);
    # word j of a halo cell holds channels 2j, 2j+1 (zero past cin)
    halo = np.zeros((rows, 216 * words, 2), np.float32)
    staged = np.zeros(216 * words, int)
    for lane in range(32):
        for i in range(7):
            hc = lane + 32 * i
            if hc >= 216:
                continue
            hx, r2 = divmod(hc, 36)
            hy, hz = divmod(r2, 6)
            col = _hdir(hx) * 9 + _hdir(hy) * 3 + _hdir(hz)
            cell = _hpos(hx) * 16 + _hpos(hy) * 4 + _hpos(hz)
            src = nbr[:, col].astype(np.int64)
            ok = (src >= 0) & (src < rows)
            vals = x2.reshape(rows * 64, cin)[np.where(ok, src * 64 + cell,
                                                       0)]
            vals = np.where(ok[:, None], vals, 0)
            vals = np.pad(vals, ((0, 0), (0, cp - cin)))
            for j in range(words):
                halo[:, hc * words + j] = vals[:, 2 * j:2 * j + 2]
                staged[hc * words + j] += 1
    assert (staged == 1).all()
    # A: the m16n8k16 fragments' words; B: the weights' (tap, channel) rows
    a = np.full((rows, 64, ks_n * 16), np.nan, np.float32)
    b = np.full((ks_n * 16, cout), np.nan, np.float32)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        abase = ((g >> 2) * 6 + (g & 3)) * words
        for ks in range(ks_n):
            for reg, (dr, dk) in enumerate(((0, 0), (8, 0), (0, 8), (8, 8))):
                k = ks * 16 + 2 * t + dk
                for m in range(4):
                    word = (m * 36 * words + abase + (12 * words if dr else 0)
                            + _koff(k, cp))
                    assert 0 <= word < 216 * words
                    a[:, m * 16 + g + dr, k:k + 2] = halo[:, word]
            for j in range(-(-cout // 8)):
                for dk in (0, 8):
                    for e in range(2):
                        k = ks * 16 + 2 * t + dk + e
                        tap, c = divmod(k, cp)
                        n = 8 * j + g
                        if n < cout:
                            b[k, n] = w[tap, c, n] if tap < 27 and c < cin \
                                else 0.0
    assert not np.isnan(a).any() and not np.isnan(b).any()
    return a, b


@pytest.mark.parametrize('name', ['dense', 'sparse', 'overflowed'])
def test_kernel_im2col_equals_assembled_planes(grids, name):
    """For each (cell, tap, channel) column the mirror's A reads the value
    ``_assemble_p6``'s planes hold there (halo cell (x+dx, y+dy, z+dz)),
    exactly; padded columns meet zero weights; the product equals the
    plain version."""
    g, nbr = grids[name]
    for cin in (3, 4, 7):
        rng = np.random.default_rng(cin)
        x, w = _inputs(rng, g, cin, 8)
        a, b = _kernel_im2col(x, nbr, w, cin, 8)
        cp = cin + cin % 2
        rows6 = tb2d._assemble_p6(_t(x), tb2d.halo_index(_t(nbr)),
                                  torch.float32).numpy()
        rows6 = rows6.reshape(-1, 6, 6, 6, cin)
        cells = np.arange(64)
        cx, cy, cz = cells // 16, cells // 4 % 4, cells % 4
        for tap in range(27):
            dx, dy, dz = tap // 9, tap // 3 % 3, tap % 3
            want = rows6[:, cx + dx, cy + dy, cz + dz]     # (rows, 64, cin)
            got = a[:, :, tap * cp:(tap + 1) * cp]
            np.testing.assert_array_equal(got[..., :cin], want)
            np.testing.assert_array_equal(got[..., cin:], 0)
            np.testing.assert_array_equal(b[tap * cp:tap * cp + cin],
                                          w[tap])
        assert (b[27 * cp:] == 0).all()               # padded k
        for c in range(cin, cp):                      # pad channels
            assert (b[c:27 * cp:cp] == 0).all()
        out = np.einsum('rck,kn->rcn', a.astype(np.float64), b)
        plain = banded_conv_fused_plain(_t(x), _t(nbr), _t(w),
                                        torch.float32).numpy()
        np.testing.assert_allclose(out.reshape(plain.shape), plain, **TOL)


# --- the routing rule and the net ------------------------------------------

def test_routing_rule_sends_the_input_conv_to_it():
    bf, f32 = torch.bfloat16, torch.float32
    cfg = cfg_from_yaml_file('cfgs/scannet/spconv.yaml', CfgNode())
    model = tmf.build_model(cfg, device='cpu', dtype=bf)
    assert model.subm_routes() == {'sm': 0, 'fused': 52, 'narrow': 1,
                                   'f32': 0, 'assembled': 0}
    # its input needs no gradient: no dx conv of the input conv
    assert model.subm_routes(True) == {'sm': 0, 'fused': 52, 'narrow': 0,
                                       'f32': 0, 'assembled': 0}
    model = tmf.build_model(cfg, device='cpu', dtype=f32)
    assert model.subm_routes() == {'sm': 0, 'fused': 0, 'narrow': 0,
                                   'f32': 53, 'assembled': 0}
    for cin, cout, dtype, want in (
            (1, 16, bf, 'narrow'), (NARROW_MAX_CIN, 8, bf, 'narrow'),
            (8, 16, bf, 'fused'), (12, 16, bf, 'assembled'),
            (3, 12, bf, 'assembled'), (3, 16, f32, 'f32')):
        assert tb2d.subm_route(cin, cout, dtype, 32) == want, (cin, cout)


def test_bf16_net_runs_it_once_with_the_assembled_bits(monkeypatch):
    """A 2-level bf16 net, eval forward and a train-mode backward: the
    narrow route is called once a forward (the input conv) and gives the
    assembled route's logits and gradients bit for bit."""
    cfg = CfgNode({
        'COMMON_CLASSES': {'n_classes': 5},
        'MODEL': {'BACKBONE': {'use_xyz': False, 'in_channel': 3,
                               'mid_channel': 8, 'block_residual': True,
                               'block_reps': 1, 'num_levels': 2},
                  'dsnorm': False},
        'DATA_CONFIG': {'DATA_CLASS': {'ignore_label': 255,
                                       'n_classes': 5}},
        'OPTIMIZATION': {'loss': 'cross_entropy'}})
    rng = np.random.default_rng(0)
    coords = rng.integers(0, 40, (2, 400, 3)).astype(np.int32)
    valid = np.ones((2, 400), bool)
    feats = torch.from_numpy(rng.normal(size=(2, 400, 3)).astype(np.float32))
    plan = tmf.build_level_plan(coords, valid, default_brick_caps(256, 2),
                                device='cpu')
    calls = []
    plain = tb2d.banded_conv_narrow
    monkeypatch.setattr(tb2d, 'banded_conv_narrow',
                        lambda *a: calls.append(1) or plain(*a))
    torch.manual_seed(0)
    sd = tmf.build_model(cfg, device='cpu').state_dict()
    results = []
    for narrow in (True, False):
        with pytest.MonkeyPatch.context() as mp:
            if not narrow:
                mp.setattr(tb2d, 'uses_narrow', lambda *a: False)
            model = tmf.build_model(cfg, device='cpu', dtype=torch.bfloat16,
                                    train=True)
            model.load_state_dict(sd)
            del calls[:]
            out = model(feats, plan)
            assert len(calls) == (1 if narrow else 0)
            out.float().square().sum().backward()
            results.append((out.detach(), {n: p.grad.clone() for n, p in
                                           model.named_parameters()}))
    (o1, g1), (o0, g0) = results
    assert torch.equal(o1, o0)
    assert g1.keys() == g0.keys()
    for n in g0:
        assert torch.equal(g1[n], g0[n]), n
    assert g1['input_kernel'].abs().max() > 0


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
