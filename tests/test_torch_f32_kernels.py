"""K1 in float32 (``banded_conv_f32``, ``csrc/subm_conv_f32.cu``) of the
PyTorch port, on the CPU; the kernel runs only on the card, where
``chip_smoke.py`` holds it to its plain version. Here a numpy mirror of
its data flow (the halo table of the (S+2)^3 cells from the rulebook,
chunks of 4 channels with the lanes past cin and the cells of absent
neighbours zero-filled, the odd brick pitch of the stages and its bank
groups, the thread -> (brick, cells, cout group) register tile of each
block and the tap loop over (dx, dy) rows) equals the JAX package's
oracle ``doda_tpu.ops.bricks.subm_conv3`` to 1e-5 of max|ref|, at sides 4
and 2 (side 2 in a subprocess under ``DODA_BRICK=2``); the wrappers raise
off the CPU, and K2's deleted first version's wrapper names the kernel
that replaced it.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import two_threads  # noqa: F401
from _torch_f32_kernels_common import (_close, _grid, _JAX_SIDE2, _k1_mirror,
                                       F32, ROOT)
from doda_tpu.ops import bricks as jbricks
from doda_tpu_torch.ops.banded_conv import (banded_conv_f32,
                                            banded_conv_padded)
from doda_tpu_torch.ops.banded_conv_sm import (banded_conv_sm,
                                               banded_conv_sm_taps)


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


def test_f32_wrappers_raise_off_the_cpu():
    """Off the CPU ``banded_conv_f32`` and ``banded_conv_padded`` launch
    their kernels or raise; K2's first version's wrapper names the kernel
    that took its convs; nothing counts a launch."""
    meta = dict(device='meta')
    x2 = torch.zeros(8, 64 * 16, **meta)
    nbr = torch.zeros(8, 27, dtype=torch.int32, **meta)
    w = torch.zeros(27, 16, 16, **meta)
    with pytest.raises(ValueError, match='CUDA'):
        banded_conv_f32(x2, nbr, w, F32)
    with pytest.raises(ValueError, match='CUDA'):
        banded_conv_padded(x2, nbr, torch.zeros(27, 16, 12, **meta), F32)
    ops = [torch.zeros(8, c * 16, **meta) for c in (64, 96, 40, 40)]
    with pytest.raises(ValueError, match='banded_conv_sm_taps'):
        banded_conv_sm(*ops, *(torch.zeros(s, **meta) for s in (
            (3, 256, 256), (3, 384, 256), (2, 640, 256))), F32)
    with pytest.raises(ValueError, match='CUDA'):
        banded_conv_sm_taps(*ops, w, F32)
    assert banded_conv_f32.launches == banded_conv_padded.launches == 0
    assert banded_conv_sm_taps.launches == banded_conv_sm_taps.f32_launches \
        == 0
