"""Shared inputs of the fused norm + ReLU prologue tests
(tests/test_torch_fuse_norm*.py): three JAX grids and their downsample
maps, the conv inputs with bias > 0 on some channels, the VJPs of both
packages, and the 2-level net's cfg, batch and weights.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from doda_tpu.models import unet as junet
from doda_tpu.models.unet import FlatDown as JFlatDown
from doda_tpu.ops import bricks as jbricks
from doda_tpu_torch.config import CfgNode
from doda_tpu_torch.models.unet import FlatDown

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
    """``fn``'s output and its VJP at ``args`` for the cotangent ``cot``,
    traced and compiled as one function (eager JAX dispatches every op
    apart, several times slower)."""
    def fwd_vjp(args, cot):
        out, vjp = jax.vjp(fn, *args)
        return (out,) + vjp(cot)
    got = jax.jit(fwd_vjp)(tuple(jnp.asarray(a) for a in args),
                           jnp.asarray(cot))
    return [np.asarray(g) for g in got]


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


@pytest.fixture(scope='module')
def down(grids):
    g, _ = grids['dense']
    ds = jbricks.build_brick_downsample(g.table, g.occ, 256)
    jmaps = JFlatDown(child_parent=ds.child_parent, parity=ds.parity,
                      parent_children=ds.parent_children)
    return g, ds, jmaps, FlatDown(*(_t(a) for a in jmaps))


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
    col, cell = np.zeros(216, np.int64), np.zeros(216, np.uint64)
    for hc in range(216):
        hx, r2 = divmod(hc, 36)
        hy, hz = divmod(r2, 6)
        col[hc] = _hdir(hx) * 9 + _hdir(hy) * 3 + _hdir(hz)
        cell[hc] = _hpos(hx) * 16 + _hpos(hy) * 4 + _hpos(hz)
    for tile in range(-(-rows // tb)):
        nb = np.full(tb * 27, -1, np.int64)
        n_in = min(tb, rows - tile * tb)
        nb[:n_in * 27] = nbr[tile * tb:tile * tb + n_in].reshape(-1)
        ok = (nb >= 0) & (nb < rows)
        occ_s = np.where(ok, words[np.where(ok, nb, 0)], np.uint64(0))
        # slot b*27 + col of every halo cell of the tile's bricks, its bit
        slots = occ_s.reshape(tb, 27)[:n_in][:, col]
        out[tile * tb:tile * tb + n_in] = (slots >> cell) & np.uint64(1)
    return out


def _hdir(h):
    return 0 if h == 0 else (2 if h == 5 else 1)


def _hpos(h):
    return (h + 3) & 3


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
