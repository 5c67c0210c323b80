"""K2's second version (``banded_conv_sm_taps``) of the PyTorch port, on
the CPU, where the wrapper runs its plain version, the first version's
plain arithmetic on ``sm_weights(w)``; the CUDA kernel itself is held
against it on the card by ``chip_smoke.py``. Here the wrapper equals
``banded_conv_sm_plain`` on ``sm_weights`` bit for bit, and the Pallas
kernel (interpret mode) on the JAX package's ``sm_weights`` of the same
raster weights to rtol = atol = 1e-5 at float32, ragged B included; it
takes row-strided operands and no rows, and raises off the CPU.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from _torch_threads import two_threads  # noqa: F401
from _torch_sm_taps_common import _operands, _t, F32, TOL
from doda_tpu.ops import bricks2d as jb2d
from doda_tpu.ops import pallas_sm
from doda_tpu_torch.ops import bricks2d as tb2d
from doda_tpu_torch.ops.banded_conv_sm import (banded_conv_sm_plain,
                                               banded_conv_sm_taps,
                                               banded_conv_sm_taps_plain)


@pytest.mark.parametrize('b,cin,cout', [(64, 16, 16), (36, 32, 16),
                                        (48, 16, 32)])
def test_taps_equals_first_version_and_pallas(b, cin, cout):
    rng = np.random.default_rng(b + cin + cout)
    ops, w = _operands(rng, b, cin, cout)
    tops, tw = [_t(o) for o in ops], _t(w)
    for dt in (torch.float32, torch.bfloat16):
        args = [o.to(dt) for o in tops]
        got = banded_conv_sm_taps(*args, tw.to(dt), dt)
        want = banded_conv_sm_plain(*args, *tb2d.sm_weights(tw.to(dt)), dt)
        assert got.dtype == dt and got.shape == (b, 64 * cout)
        assert torch.equal(got, want)
    assert banded_conv_sm_taps.launches == 0   # the CPU never reaches a kernel
    # the Pallas kernel tiles rows by 8: a ragged B runs zero-padded
    pad = -b % 8
    jops = [jnp.asarray(np.pad(o, ((0, pad), (0, 0)))) for o in ops]
    jw = jb2d.sm_weights(jnp.asarray(w), F32)
    assert pallas_sm.fits_sm(b + pad, cin, cout, 4)
    want_pl = np.asarray(pallas_sm.banded_conv_sm(*jops, *jw, F32))[:b]
    got = banded_conv_sm_taps(*tops, tw, torch.float32)
    np.testing.assert_allclose(got.numpy(), want_pl, **TOL)


def test_taps_takes_row_strided_operands_and_no_rows():
    """gyz/gxm/gxp arrive as column slices of one gathered buffer."""
    rng = np.random.default_rng(5)
    (x, gyz, gxm, gxp), w = _operands(rng, 40, 16, 8)
    buf = _t(np.concatenate([gyz, gxm, gxp], axis=1)).bfloat16()
    a, b = 96 * 16, 136 * 16
    xb, tw = _t(x).bfloat16(), _t(w).bfloat16()
    got = banded_conv_sm_taps(xb, buf[:, :a], buf[:, a:b], buf[:, b:], tw,
                              torch.float32)
    want = banded_conv_sm_taps_plain(
        xb, *(_t(o).bfloat16() for o in (gyz, gxm, gxp)), tw, torch.float32)
    assert torch.equal(got, want)
    empty = banded_conv_sm_taps(xb[:0], buf[:0, :a], buf[:0, a:b],
                                buf[:0, b:], tw, torch.bfloat16)
    assert empty.shape == (0, 64 * 8) and empty.dtype == torch.bfloat16


def test_taps_raises_off_the_cpu():
    meta = [torch.zeros(4, c * 16, device='meta', dtype=torch.bfloat16)
            for c in (64, 96, 40, 40)]
    w = torch.zeros(27, 16, 16, device='meta', dtype=torch.bfloat16)
    with pytest.raises(ValueError, match='CUDA'):
        banded_conv_sm_taps(*meta, w, torch.bfloat16)
    assert banded_conv_sm_taps.launches == 0
