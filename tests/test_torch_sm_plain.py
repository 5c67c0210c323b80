"""K2's first version's plain arithmetic (``banded_conv_sm`` on the CPU)
vs the Pallas kernel itself (``pallas_sm.banded_conv_sm`` in interpret
mode off the TPU) and the XLA form ``_sm_xla``, at float32 with rtol =
atol = 1e-5 (sums in another order); the raises without a table and off
the CPU.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from _torch_threads import two_threads  # noqa: F401
from _torch_sm_common import dense_grid  # noqa: F401
from _torch_sm_common import _feats, _operands, _t, F32, TOL
from doda_tpu.ops import bricks2d as jb2d
from doda_tpu.ops import pallas_sm
from doda_tpu_torch.ops import bricks2d as tb2d
from doda_tpu_torch.ops.banded_conv_sm import (banded_conv_sm,
                                               banded_conv_sm_taps)


@pytest.mark.parametrize('b,cin,cout', [(64, 16, 16), (64, 32, 8),
                                        (72, 16, 24)])
def test_banded_conv_sm_plain_matches_pallas_and_xla(b, cin, cout):
    rng = np.random.default_rng(b + cin + cout)
    ops, w = _operands(rng, b, cin, cout)
    jw = jb2d.sm_weights(jnp.asarray(w), F32)
    jops = [jnp.asarray(o) for o in ops]
    want_xla = np.asarray(jb2d._sm_xla(*jops, *jw, cin, cout))
    tw = tb2d.sm_weights(_t(w))
    got = banded_conv_sm(*map(_t, ops), *tw, torch.float32)
    assert got.dtype == torch.float32 and got.shape == (b, 64 * cout)
    np.testing.assert_allclose(got.numpy(), want_xla, **TOL)
    if b % 8 == 0 and pallas_sm.fits_sm(b, cin, cout, 4):
        want_pl = np.asarray(pallas_sm.banded_conv_sm(*jops, *jw, F32))
        np.testing.assert_allclose(got.numpy(), want_pl, **TOL)
    # the CPU never reaches a kernel
    assert banded_conv_sm_taps.launches == banded_conv_sm_taps.f32_launches \
        == 0


def test_sm_engine_without_table_or_on_wrong_device_raises(dense_grid):
    g, nbr = dense_grid
    x2 = _t(_feats(np.random.default_rng(0), g, 16))
    w = torch.zeros(27, 16, 16)
    with pytest.raises(ValueError, match='sm_index'):
        tb2d.subm_conv3_2d(x2, _t(g.occ), tb2d.halo_index(_t(nbr)), w,
                           torch.float32, None, 32)
    meta = [torch.zeros(4, c * 16, device='meta') for c in (64, 96, 40, 40)]
    wm = [torch.zeros(s, device='meta') for s in
          ((3, 256, 128), (3, 384, 128), (2, 640, 128))]
    with pytest.raises(ValueError, match='CUDA'):
        banded_conv_sm(*meta, *wm, torch.float32)
    assert banded_conv_sm_taps.launches == banded_conv_sm_taps.f32_launches \
        == 0
