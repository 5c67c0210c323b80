"""Backward of the port's down, up and 1x1 convs vs ``jax.vjp`` of the
JAX ops, at float32 to rtol = atol = 1e-4.
"""

import numpy as np
import torch

from _torch_threads import two_threads  # noqa: F401
from _torch_grads_common import down, grid  # noqa: F401
from _torch_grads_common import (_compare, _feats, _jax_grads, _t,
                                 _torch_grads, F32)
from doda_tpu.ops import bricks2d as jb2d
from doda_tpu_torch.ops import bricks2d as tb2d


def test_down_conv_grads(grid, down):
    g, _ = grid
    ds, jmaps, tmaps = down
    rng = np.random.default_rng(7)
    x2 = _feats(rng, g.occ, 16)
    w = rng.normal(size=(8, 16, 32)).astype(np.float32) * 0.2
    cot = rng.normal(size=(128, 64 * 32)).astype(np.float32)
    want = _jax_grads(lambda a, b: jb2d.down_conv2_2d(
        a, ds.parent_occ, jmaps, b, F32), x2, w, cot)
    occ_p = _t(ds.parent_occ)
    got = _torch_grads(lambda a, b: tb2d.down_conv2_2d(
        a, occ_p, tmaps, b, torch.float32), x2, w, cot)
    _compare(got, want)


def test_up_conv_grads(grid, down):
    g, _ = grid
    ds, jmaps, tmaps = down
    rng = np.random.default_rng(8)
    p2 = _feats(rng, ds.parent_occ, 32)
    w = rng.normal(size=(8, 32, 16)).astype(np.float32) * 0.2
    cot = rng.normal(size=(g.b_cap, 64 * 16)).astype(np.float32)
    want = _jax_grads(lambda a, b: jb2d.up_conv2_2d(a, g.occ, jmaps, b, F32),
                      p2, w, cot)
    occ = _t(g.occ)
    got = _torch_grads(lambda a, b: tb2d.up_conv2_2d(
        a, occ, tmaps, b, torch.float32), p2, w, cot)
    _compare(got, want)


def test_conv1x1_grads(grid):
    g, _ = grid
    rng = np.random.default_rng(9)
    x2 = _feats(rng, g.occ, 32)
    w = rng.normal(size=(32, 16)).astype(np.float32) * 0.2
    cot = rng.normal(size=(g.b_cap, 64 * 16)).astype(np.float32)
    want = _jax_grads(lambda a, b: jb2d.conv1x1_2d(a, g.occ, b, F32),
                      x2, w, cot)
    occ = _t(g.occ)
    got = _torch_grads(lambda a, b: tb2d.conv1x1_2d(a, occ, b,
                                                    torch.float32),
                       x2, w, cot)
    _compare(got, want)
