"""The fused norm + ReLU prologue engine of the port vs the JAX package's.

``subm_conv3_norm_2d``, ``down_conv2_norm_2d`` and ``up_conv2_norm_2d``
take raw activations (not pre-masked) and the per-channel scale and bias of
a folded batch norm, with bias > 0 on some channels, so that a missing
mask would light inactive cells. The same numpy inputs and cotangent go
through both packages:

* float32: outputs to rtol = atol = 1e-5, gradients of x, W, scale and
  bias to 2e-4 (the bound of tests/test_bricks2d.py's prologue tests),
  the subm conv on each of the port's routes ('f32', 'assembled' by a
  patched rule, the fused K1's plain version, and pro_full + K2's plain
  version);
* bf16 against the JAX package's bf16, to 2e-2 of the largest output
  (the JAX package rounds each of its three shifted sums to bf16, the port
  once) and 5e-2 of the largest gradient (two bf16 products and a bf16
  cotangent on either side). The JAX package rounds x*scale to bf16 before
  it adds the bias, the port (and its kernel) once after: relu' may then
  differ where |x*scale + bias| <= 2^-8 |x*scale|, so dx is compared
  outside that band, which must hold fewer than 2e-3 of the lanes;
* a numpy mirror of the prologue kernel's occupancy staging (rulebook
  slot, neighbour word, cell bit) against the mask the JAX package's
  ``_assemble_p6`` applies, on three grids, absent neighbours included,
  and a pure-Python mirror of its one-barrier schedule (every (tile,
  chunk) staged once, its prologue applied before the MMAs read it, no
  buffer overwritten while read);
* a 2-level net with ``fuse_norm=True`` and weights from
  ``params_from_jax`` against the flax net under ``DODA_FUSE_NORM=1``
  (eval logits to 1e-3; the flax parameter tree is the same with the
  variable on and off);
* one train-mode forward and backward of the port, fused against unfused
  on the fused K1 route (float32, so gradients agree to 1e-4).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from _torch_threads import two_threads  # noqa: F401
from doda_tpu.models import unet as junet
from doda_tpu.models.unet import FlatDown as JFlatDown
from doda_tpu.ops import bricks as jbricks
from doda_tpu.ops import bricks2d as jb2d
from doda_tpu_torch.config import CfgNode
from doda_tpu_torch.models import model_fn as tmf
from doda_tpu_torch.models.unet import FlatDown
from doda_tpu_torch.ops import banded_conv as tbc
from doda_tpu_torch.ops import bricks2d as tb2d
from doda_tpu_torch.utils.convert import params_from_jax

F32 = jnp.float32
TOL = dict(rtol=1e-5, atol=1e-5)
GTOL = dict(rtol=2e-4, atol=2e-4)


def _grid(coords, cap):
    g = jbricks.brickify(jnp.asarray(coords),
                         jnp.ones(len(coords), bool), cap)
    return g, np.asarray(jbricks.build_brick_rulebook(g.table))


@pytest.fixture(scope='module')
def grids():
    """tests/test_bricks2d.py's dense grid and sparse grid (isolated
    voxels and a corner contact whose x-halo cell only a diagonal brick
    supplies), and a grid whose capacity drops bricks (absent
    neighbours inside the scene)."""
    rng = np.random.default_rng(3)
    dense = _grid(rng.integers(0, 24, (4096, 3)).astype(np.int32), 512)
    rng = np.random.default_rng(11)
    coords = rng.integers(0, 96, (1500, 3)).astype(np.int32)
    crafted = np.array([[4, 4, 4], [3, 3, 4], [3, 3, 7], [4, 7, 4]],
                       np.int32)
    sparse = _grid(np.concatenate([coords, crafted]), 2048)
    rng = np.random.default_rng(5)
    dropped = _grid(rng.integers(0, 40, (3000, 3)).astype(np.int32), 160)
    return {'dense': dense, 'sparse': sparse, 'dropped': dropped}


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def _inputs(rng, rows, cin, cout, taps):
    """Raw x (not masked), weights, a scale around 1 and a bias with some
    channels > 0, and an unmasked cotangent."""
    x = rng.normal(size=(rows, 64 * cin)).astype(np.float32)
    w = (rng.normal(size=(taps, cin, cout)) * 0.1).astype(np.float32)
    s = (1 + 0.3 * rng.normal(size=cin)).astype(np.float32)
    b = (0.3 * rng.normal(size=cin)).astype(np.float32)
    b[0], b[1] = 0.5, -0.5
    return x, w, s, b


def _jax_vjp(fn, args, cot):
    out, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in args))
    return [np.asarray(out)] + [np.asarray(g) for g in
                                vjp(jnp.asarray(cot))]


def _port_vjp(fn, args, cot, dtype=torch.float32):
    ts = [_t(a).to(dtype).requires_grad_(True) for a in args]
    out = fn(*ts)
    out.backward(_t(cot).to(out.dtype))
    return [out.detach().float().numpy()] + [t.grad.float().numpy()
                                             for t in ts]


NAMES = ('out', 'dx', 'dW', 'dscale', 'dbias')


def _compare(got, want, tol, rel=False):
    for name, g, j in zip(NAMES, got, want):
        assert np.abs(j).max() > 1e-2, name     # the check is not vacuous
        if rel:
            err = np.abs(g - j).max() / np.abs(j).max()
            assert err <= tol, (name, err)
        else:
            np.testing.assert_allclose(g, j, err_msg=name, **tol)


def test_subm_conv3_norm_2d_matches_jax(grids, monkeypatch):
    """Every route of the port, on the dense and the sparse grid."""
    calls = []
    plain = tb2d.banded_conv_fused
    monkeypatch.setattr(tb2d, 'banded_conv_fused',
                        lambda *a: calls.append(a[-1]) or plain(*a))
    for name in ('dense', 'sparse'):
        g, nbr = grids[name]
        rng = np.random.default_rng(len(name))
        args = _inputs(rng, g.b_cap, 16, 16, 27)
        cot = rng.normal(size=(g.b_cap, 64 * 16)).astype(np.float32)
        want = _jax_vjp(lambda x, w, s, b: jb2d.subm_conv3_norm_2d(
            x, g.occ, nbr, w, s, b, F32), args, cot)
        tn, occ = _t(nbr), _t(g.occ)
        halo, sm = tb2d.halo_index(tn), tb2d.sm_index(tn)
        for route, sm_max_cin in (('f32', 0), ('assembled', 0), ('sm', 32),
                                  ('fused', 0)):
            with pytest.MonkeyPatch.context() as mp:
                if route == 'fused':      # the rule keeps float32 off it
                    mp.setattr(tb2d, 'uses_fused', lambda *a: True)
                if route == 'assembled':  # float32 takes 'f32' by the rule
                    mp.setattr(tb2d, 'subm_route', lambda *a: 'assembled')
                assert tb2d.subm_route(16, 16, torch.float32,
                                       sm_max_cin) == route
                del calls[:]
                got = _port_vjp(lambda x, w, s, b: tb2d.subm_conv3_norm_2d(
                    x, occ, halo, w, s, b, torch.float32, sm, sm_max_cin,
                    tn), args, cot)
            _compare(got[:1], want[:1], TOL)
            _compare(got, want, GTOL)
            if route == 'fused':     # forward with the prologue, dx without
                assert len(calls) == 2 and calls[0] is not None \
                    and calls[1] is None


@pytest.fixture(scope='module')
def down(grids):
    g, _ = grids['dense']
    ds = jbricks.build_brick_downsample(g.table, g.occ, 256)
    jmaps = JFlatDown(child_parent=ds.child_parent, parity=ds.parity,
                      parent_children=ds.parent_children)
    return g, ds, jmaps, FlatDown(*(_t(a) for a in jmaps))


def test_down_up_norm_2d_match_jax(down):
    g, ds, jmaps, tmaps = down
    rng = np.random.default_rng(7)
    occ, occ_p = _t(g.occ), _t(ds.parent_occ)
    args = _inputs(rng, g.b_cap, 16, 8, 8)
    cot = rng.normal(size=(256, 64 * 8)).astype(np.float32)
    want = _jax_vjp(lambda x, w, s, b: jb2d.down_conv2_norm_2d(
        x, g.occ, ds.parent_occ, jmaps, w, s, b, F32), args, cot)
    got = _port_vjp(lambda x, w, s, b: tb2d.down_conv2_norm_2d(
        x, occ, occ_p, tmaps, w, s, b, torch.float32), args, cot)
    _compare(got[:1], want[:1], TOL)
    _compare(got, want, GTOL)

    args = _inputs(rng, 256, 16, 8, 8)
    cot = rng.normal(size=(g.b_cap, 64 * 8)).astype(np.float32)
    want = _jax_vjp(lambda p, w, s, b: jb2d.up_conv2_norm_2d(
        p, ds.parent_occ, g.occ, jmaps, w, s, b, F32), args, cot)
    got = _port_vjp(lambda p, w, s, b: tb2d.up_conv2_norm_2d(
        p, occ_p, occ, tmaps, w, s, b, torch.float32), args, cot)
    _compare(got[:1], want[:1], TOL)
    _compare(got, want, GTOL)


def _compare_bf16(got, want, x, s, b):
    xs = (_t(x).bfloat16().float() * _t(s).bfloat16().float()
          .repeat(x.shape[1] // s.shape[0])).numpy()
    pre = xs + _t(b).bfloat16().float().repeat(x.shape[1] // b.shape[0]
                                                ).numpy()
    band = np.abs(pre) <= 2.0 ** -8 * np.abs(xs)
    assert band.mean() < 2e-3, band.mean()
    _compare(got[:1], want[:1], 2e-2, rel=True)
    got, want = list(got), list(want)
    got[1], want[1] = np.where(band, 0, got[1]), np.where(band, 0, want[1])
    _compare(got, want, 5e-2, rel=True)


def test_norm_convs_bf16_match_jax_bf16(grids, down):
    """bf16 operands on both sides; the port's subm conv on its fused
    route (the prologue K1's plain version on the CPU)."""
    bf = jnp.bfloat16
    g, nbr = grids['sparse']
    rng = np.random.default_rng(9)
    args = _inputs(rng, g.b_cap, 16, 16, 27)
    cot = rng.normal(size=(g.b_cap, 64 * 16)).astype(np.float32)
    want = _jax_vjp(lambda x, w, s, b: jb2d.subm_conv3_norm_2d(
        x.astype(bf), g.occ, nbr, w, s, b, bf).astype(F32), args, cot)
    tn, occ = _t(nbr), _t(g.occ)
    assert tb2d.subm_route(16, 16, torch.bfloat16, 0) == 'fused'
    got = _port_vjp(lambda x, w, s, b: tb2d.subm_conv3_norm_2d(
        x.bfloat16(), occ, tb2d.halo_index(tn), w, s, b, torch.bfloat16,
        nbr=tn).float(), args, cot)
    _compare_bf16(got, want, *args[:1], *args[2:])

    g, ds, jmaps, tmaps = down
    occ, occ_p = _t(g.occ), _t(ds.parent_occ)
    args = _inputs(rng, g.b_cap, 16, 8, 8)
    cot = rng.normal(size=(256, 64 * 8)).astype(np.float32)
    want = _jax_vjp(lambda x, w, s, b: jb2d.down_conv2_norm_2d(
        x.astype(bf), g.occ, ds.parent_occ, jmaps, w, s, b,
        bf).astype(F32), args, cot)
    got = _port_vjp(lambda x, w, s, b: tb2d.down_conv2_norm_2d(
        x.bfloat16(), occ, occ_p, tmaps, w, s, b, torch.bfloat16).float(),
        args, cot)
    _compare_bf16(got, want, *args[:1], *args[2:])
    args = _inputs(rng, 256, 16, 8, 8)
    cot = rng.normal(size=(g.b_cap, 64 * 8)).astype(np.float32)
    want = _jax_vjp(lambda p, w, s, b: jb2d.up_conv2_norm_2d(
        p.astype(bf), ds.parent_occ, g.occ, jmaps, w, s, b,
        bf).astype(F32), args, cot)
    got = _port_vjp(lambda p, w, s, b: tb2d.up_conv2_norm_2d(
        p.bfloat16(), occ_p, occ, tmaps, w, s, b, torch.bfloat16).float(),
        args, cot)
    _compare_bf16(got, want, *args[:1], *args[2:])


# --- numpy mirror of the prologue kernel's occupancy staging ----------------

def _kernel_halo_mask(nbr, occw, rows, tb):
    """(rows, 216) bool: the bit each halo cell's 16-byte copies test in
    the prologue pass of csrc/banded_conv_fused.cu. Tiles of ``tb``
    bricks; ``load_nbr`` writes -1 past the last brick; ``issue_occ``
    copies occw[nb[e]] to slot e, zero-filled for a neighbour that is
    absent or out of range; each copy's packed slot (b*27 + col) and
    source cell select the bit."""
    out = np.zeros((rows, 216), bool)
    words = occw.view(np.uint64)
    for tile in range(-(-rows // tb)):
        nb = np.full(tb * 27, -1, np.int64)
        n_in = min(tb, rows - tile * tb)
        nb[:n_in * 27] = nbr[tile * tb:tile * tb + n_in].reshape(-1)
        ok = (nb >= 0) & (nb < rows)
        occ_s = np.where(ok, words[np.where(ok, nb, 0)], np.uint64(0))
        for b in range(n_in):
            for hc in range(216):
                hx, r2 = divmod(hc, 36)
                hy, hz = divmod(r2, 6)
                col = (_hdir(hx) * 9 + _hdir(hy) * 3 + _hdir(hz))
                cell = _hpos(hx) * 16 + _hpos(hy) * 4 + _hpos(hz)
                word = int(occ_s[b * 27 + col])
                out[tile * tb + b, hc] = (word >> cell) & 1
    return out


def _hdir(h):
    return 0 if h == 0 else (2 if h == 5 else 1)


def _hpos(h):
    return (h + 3) & 3


def test_kernel_occupancy_staging_equals_jax_mask(grids):
    """The mask the JAX package's ``_assemble_p6`` applies with a prologue
    (read off as its output on x = 0 with scale 1, bias 1, cin = 1, whose
    every active cell is 1) against the mirror, at both tile sizes."""
    for name in ('dense', 'sparse', 'dropped'):
        g, nbr = grids[name]
        rows = g.b_cap
        one = jnp.ones((1,), F32)
        planes = jb2d._assemble_p6(jnp.zeros((rows, 64), F32),
                                   jnp.asarray(nbr), F32,
                                   (one, one, g.occ), pm=False)
        want = np.concatenate([np.asarray(p) for p in planes], 1) > 0
        assert (~want).any() and want.any()
        occw = tbc.occ_words(_t(g.occ)).numpy()
        assert np.array_equal(tbc.occ_from_words(_t(occw)).numpy(),
                              np.asarray(g.occ))
        absent = (nbr == rows) & np.asarray(g.occ).any(1)[:, None]
        assert absent.any(), name          # neighbours the kernel zero-fills
        for tb in (4, 8):
            np.testing.assert_array_equal(
                _kernel_halo_mask(nbr, occw, rows, tb), want)


# --- pure-Python mirror of the prologue kernel's schedule -------------------

class _Smem:
    """A block's shared-memory buffers under the kernel's one barrier a
    step. Each buffer holds a tag and the epoch (barriers passed) from
    which every thread sees it: a write, synchronous or a cp.async that the
    next step's wait lands, is seen from the next epoch on; it may replace
    content only if that content was last read in an earlier epoch, since
    a thread past the barrier cannot know that the others finished reading
    in this one. ``rewrite`` is a thread's pass over the cells it copied
    itself: it needs only its own wait, so it may follow the copy in the
    same epoch, and it must find the copy's content."""

    def __init__(self):
        self.tag, self.seen, self.read_at = {}, {}, {}

    def write(self, buf, tag, epoch):
        assert self.read_at.get(buf, -1) < epoch, ('overwritten', buf, tag)
        self.tag[buf], self.seen[buf], self.read_at[buf] = tag, epoch + 1, -1

    def read(self, buf, tag, epoch):
        assert self.tag.get(buf) == tag, (buf, self.tag.get(buf), tag)
        assert self.seen[buf] <= epoch, ('not yet seen', buf, tag)
        self.read_at[buf] = epoch

    def rewrite(self, buf, old, new, epoch):
        assert self.tag.get(buf) == old, (buf, self.tag.get(buf), old)
        assert self.read_at.get(buf, -1) < epoch, ('rewritten', buf, new)
        self.tag[buf], self.seen[buf] = new, epoch + 1


def _pro_schedule(nti, nk, w_resident, nbr_bufs=3):
    """``fused_tc<..., PRO=true>``'s steps over a block of ``nti`` tiles of
    ``nk`` cin chunks, in the kernel's order with its buffer indices:
    rulebook rows in ``nbr_bufs`` = 3 buffers (tile i in i % 3),
    occupancy words in two (i % 2), two halo stages (step s % 2), the
    weights resident (one buffer a chunk) or streamed through two. Each
    (tile, chunk) is copied raw into a stage (``issue_halo``) and rewritten
    with its prologue by the threads that copied it (``prologue_cells``).
    Returns how often each (tile, chunk) was staged and the MMAs' order."""
    smem, staged, mma = _Smem(), {}, []

    def prologue(tile, kc, stage, e):        # prologue_cells
        smem.read(('occ', tile % 2), ('occ', tile), e)
        smem.rewrite(('stage', stage), ('raw', tile, kc),
                     ('prologue', (tile, kc)), e)
        staged[tile, kc] = staged.get((tile, kc), 0) + 1

    e = 0
    for t in range(3):                             # load_nbr(0..2)
        smem.write(('nbr', t % nbr_bufs), ('nbr', t), e)
    if w_resident:
        for kc in range(nk):
            smem.write(('w', kc), ('w', kc), e)
    e += 1                                         # wait, barrier
    for t in range(2):                             # issue_occ(0), (1)
        smem.read(('nbr', t % nbr_bufs), ('nbr', t), e)
        smem.write(('occ', t), ('occ', t), e)
    smem.read(('nbr', 0), ('nbr', 0), e)           # issue_halo(0, 0, 0)
    smem.write(('stage', 0), ('raw', 0, 0), e)
    if not w_resident:
        smem.write(('w', 0), ('w', 0), e)
    e += 1                                         # wait, barrier
    prologue(0, 0, 0, e)
    i = kc = 0
    steps = nti * nk
    for s in range(steps):
        e += 1                                     # wait, the barrier
        stage = s % 2
        last = kc == nk - 1
        kc1, i1 = (0, i + 1) if last else (kc + 1, i)
        if s + 1 < steps:                          # issue_halo(kc1, ...)
            smem.read(('nbr', i1 % nbr_bufs), ('nbr', i1), e)
            smem.write(('stage', stage ^ 1), ('raw', i1, kc1), e)
            if not w_resident:
                smem.write(('w', stage ^ 1), ('w', kc1), e)
        if last:                                   # issue_occ(i + 2) and
            smem.read(('nbr', (i + 2) % nbr_bufs), ('nbr', i + 2), e)
            smem.write(('occ', i % 2), ('occ', i + 2), e)
            smem.write(('nbr', (i + 3) % nbr_bufs), ('nbr', i + 3), e)
        # the MMAs read a stage the prologue was applied to
        smem.read(('stage', stage), ('prologue', (i, kc)), e)
        smem.read(('w', kc if w_resident else stage), ('w', kc), e)
        mma.append((i, kc))
        if s + 1 < steps:
            prologue(i1, kc1, stage ^ 1, e)
        i, kc = i1, kc1
    return staged, mma


def test_kernel_prologue_schedule():
    """The prologue K1's one-barrier schedule (csrc/banded_conv_fused.cu):
    every (tile, chunk) is staged exactly once, with its prologue applied
    and seen by every thread before the MMAs read it, in order; no stage,
    rulebook, occupancy or weight buffer is overwritten while a reader of
    its content may still hold it."""
    for nti in (1, 2, 3, 4, 7):
        for nk in (1, 2, 3):
            for w_resident in (True, False):
                staged, mma = _pro_schedule(nti, nk, w_resident)
                every = [(t, c) for t in range(nti) for c in range(nk)]
                assert staged == {k: 1 for k in every}
                assert mma == every
    # the mirror catches a schedule that reuses a buffer too early: with
    # the rulebook rows in two buffers, tile 2's rows land on tile 0's
    # before the block has staged tile 0
    with pytest.raises(AssertionError):
        _pro_schedule(3, 1, True, nbr_bufs=2)


# --- the engine in a net ----------------------------------------------------

CAPS = junet.default_brick_caps(256, 2, floor=32)


def _cfg():
    return CfgNode({
        'COMMON_CLASSES': {'n_classes': 5},
        'MODEL': {'BACKBONE': {'use_xyz': False, 'in_channel': 3,
                               'mid_channel': 8, 'block_residual': True,
                               'block_reps': 1, 'num_levels': 2},
                  'dsnorm': False},
        'DATA_CONFIG': {'DATA_CLASS': {'ignore_label': 255,
                                       'n_classes': 5}},
        'OPTIMIZATION': {'loss': 'cross_entropy'}})


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    coords = rng.integers(0, 40, (2, 400, 3)).astype(np.int32)
    valid = np.zeros((2, 400), bool)
    valid[:, :320] = True
    feats = rng.normal(size=(2, 400, 3)).astype(np.float32)
    feats[~valid] = 0.0
    return coords, valid, feats


def _variables(shapes, rng):
    def fill(path, leaf):
        name = path[-1].key
        if name == 'mean':
            return rng.normal(0, 0.2, leaf.shape)
        if name == 'var':
            return rng.uniform(0.5, 1.5, leaf.shape)
        if name == 'scale':
            return 1 + rng.normal(0, 0.2, leaf.shape)
        if name == 'bias':
            return rng.normal(0, 0.3, leaf.shape)
        fan_in = leaf.shape[0] * (leaf.shape[1] if leaf.ndim == 3 else 1)
        b = (1.0 / fan_in) ** 0.5
        return rng.uniform(-b, b, leaf.shape)
    return jax.tree_util.tree_map_with_path(
        lambda p, x: fill(p, x).astype(np.float32), shapes)


def test_fused_net_matches_flax_fused_net(monkeypatch):
    coords, valid, feats = _batch()
    model = junet.SparseConvNet(mid_channel=8, num_levels=2, block_reps=1,
                                n_classes=5, dtype=F32)
    plan = junet.build_level_plan(jnp.asarray(coords), jnp.asarray(valid),
                                  CAPS)

    def init_shapes():
        return jax.eval_shape(lambda: model.init(
            jax.random.PRNGKey(0), feats, plan, train=False))

    off = init_shapes()
    monkeypatch.setenv('DODA_FUSE_NORM', '1')
    on = init_shapes()
    assert jax.tree_util.tree_structure(on) == \
        jax.tree_util.tree_structure(off)
    assert jax.tree_util.tree_leaves(jax.tree_util.tree_map(
        lambda a, b: a.shape == b.shape, on, off))
    variables = _variables(on, np.random.default_rng(1))
    traced = []                      # the flax net took the fused convs
    fused = jb2d.subm_conv3_norm_2d
    monkeypatch.setattr(jb2d, 'subm_conv3_norm_2d',
                        lambda *a: traced.append(1) or fused(*a))
    want = np.asarray(jax.jit(lambda v: model.apply(
        v, jnp.asarray(feats), plan, train=False))(variables))
    assert len(traced) == 6

    port = tmf.build_model(_cfg(), device='cpu', dtype=torch.float32,
                           fuse_norm=True)
    port.load_state_dict(params_from_jax(variables['params'],
                                         variables['batch_stats']),
                         strict=True)
    tplan = tmf.build_level_plan(coords, valid, CAPS, device='cpu')
    with torch.no_grad():
        got = port(torch.from_numpy(feats), tplan).numpy()
    err = np.abs(got - want)[valid].max()
    assert err <= 1e-3 * max(1.0, np.abs(want).max()), err
    assert port.subm_routes() == {'sm': 0, 'fused': 0, 'narrow': 0,
                                  'f32': 7, 'assembled': 0, 'prologue': 0}


def test_train_fused_equals_unfused_on_the_fused_route(monkeypatch):
    """Train mode: the folded scale and bias come from batch statistics,
    so dscale and dbias must flow back through them to x and to the norms'
    parameters; every gradient as in the unfused net."""
    monkeypatch.setattr(tb2d, 'uses_fused',
                        lambda cin, cout, dtype: cin % 8 == 0
                        and cout % 8 == 0)
    calls = []
    plain = tb2d.banded_conv_fused
    monkeypatch.setattr(tb2d, 'banded_conv_fused',
                        lambda *a: calls.append(a[-1] is not None)
                        or plain(*a))
    coords, valid, feats = _batch(seed=2)
    plan = tmf.build_level_plan(coords, valid, CAPS, device='cpu')
    cot = torch.from_numpy(np.random.default_rng(3).normal(
        size=(2, 400, 5)).astype(np.float32))
    results = {}
    sd = None
    for fuse in (False, True):
        torch.manual_seed(0)
        model = tmf.build_model(_cfg(), device='cpu', dtype=torch.float32,
                                train=True, fuse_norm=fuse)
        if sd is None:
            sd = {k: v.clone() for k, v in model.state_dict().items()}
            for k, v in sd.items():      # bias > 0 where a mask matters
                if k.endswith('.bias') and v.dim() == 1 and 'linear' not in k:
                    v.copy_(torch.linspace(-0.4, 0.6, v.numel()))
        model.load_state_dict(sd)
        del calls[:]
        out = model(torch.from_numpy(feats), plan)
        (out * cot).sum().backward()
        results[fuse] = (out.detach(), {n: p.grad.clone() for n, p in
                                        model.named_parameters()},
                         {k: v.clone() for k, v in
                          model.state_dict().items()})
        want_pro = model.subm_routes().get('prologue', 0)
        # six block convs: forward (with the prologue when fused) and dx
        assert sum(calls) == want_pro and len(calls) == 12
    assert want_pro == 6
    (o0, g0, s0), (o1, g1, s1) = results[False], results[True]
    torch.testing.assert_close(o1, o0, rtol=1e-4, atol=1e-4)
    assert g0.keys() == g1.keys()
    for n in g0:
        scale = max(1.0, g0[n].abs().max().item())
        err = (g1[n] - g0[n]).abs().max().item()
        assert err <= 1e-4 * scale, (n, err)
    for k in s0:                        # running statistics moved alike
        torch.testing.assert_close(s1[k], s0[k], rtol=1e-5, atol=1e-6)
