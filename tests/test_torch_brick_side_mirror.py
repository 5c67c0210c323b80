"""A numpy mirror of the side-2 address arithmetic of K1's fused version
(``csrc/banded_conv_fused.cu``: halo decode, m16 tiles that stack the
same x-slice of four bricks, the swizzle) and of its narrow version
(``csrc/subm_conv_narrow.cu``: two bricks an m16 tile, the implicit
im2col), each computing the conv through those addresses and held to the
plain version, with ``ldmatrix``'s eight rows on eight bank groups.
"""

import numpy as np
import pytest
import torch

from _torch_threads import two_threads  # noqa: F401
from _torch_brick_side_common import (_decode, _fused_mirror, _grid,
                                      _narrow_mirror, F32, TOL)
from doda_tpu_torch.ops import bricks2d as tb2d
from doda_tpu_torch.ops.banded_conv import banded_conv_fused_plain


@pytest.mark.parametrize('kernel,cin,cout', [('fused', 32, 16),
                                             ('fused', 16, 24),
                                             ('narrow', 3, 16),
                                             ('narrow', 5, 8)])
def test_side2_kernel_addressing_mirror(kernel, cin, cout):
    """The mirrors' halo decode equals ``halo_index`` at side 2, and the
    convs they compute through the kernels' addresses equal the plain
    version (on a grid whose row count leaves a ragged last tile)."""
    g, nbr, rng = _grid(1, 300, 10, 37)
    rows = nbr.shape[0]
    flat = np.full((rows, 64), rows * 8)
    for hc in range(64):
        col, cell, _ = _decode(hc)
        src = nbr[:, col].numpy()
        flat[:, hc] = np.where(src < rows, src * 8 + cell, rows * 8)
    np.testing.assert_array_equal(flat, tb2d.halo_index(nbr, 2).numpy())
    x = rng.normal(size=(rows, 8, cin)) * g.occ.numpy()[..., None]
    x2 = torch.from_numpy(x.reshape(rows, -1).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(27, cin, cout)) * 0.1).astype(
        np.float32))
    mirror = _fused_mirror if kernel == 'fused' else _narrow_mirror
    want = banded_conv_fused_plain(x2, nbr, w, F32).numpy()
    np.testing.assert_allclose(mirror(x2, nbr, w), want, **TOL)
