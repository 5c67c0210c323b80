"""A numpy mirror of the narrow K1's halo staging and implicit im2col
(lane -> halo cell by the closed-form map, rulebook entry -> source cell,
the m16n8k16 fragments' words -> (cell, tap, channel), the B fragments ->
raster weights) selects exactly what ``halo_index`` and ``_assemble_p6``
select; a bf16 net runs the narrow K1 once a forward, with the bits of K1's
band on ``_assemble_p6``'s planes.
"""

import numpy as np
import pytest
import torch

from _torch_threads import two_threads  # noqa: F401
from _torch_input_conv_common import grids  # noqa: F401
from _torch_input_conv_common import _inputs, _kernel_im2col, _t, TOL
from doda_tpu_torch.config import CfgNode
from doda_tpu_torch.models import model_fn as tmf
from doda_tpu_torch.models.unet import default_brick_caps
from doda_tpu_torch.ops import bricks2d as tb2d
from doda_tpu_torch.ops.banded_conv import (banded_conv_fused_plain,
                                            banded_conv_plain)


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


def test_bf16_net_runs_it_once_with_the_assembled_bits(monkeypatch):
    """A 2-level bf16 net, eval forward and a train-mode backward: the
    narrow route is called once a forward (the input conv) and gives the
    logits and gradients of K1's band (``banded_conv_plain``) on
    ``_assemble_p6``'s planes in its place, bit for bit."""
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
            if not narrow:     # the band on the planes, on 'padded'
                mp.setattr(tb2d, 'uses_narrow', lambda *a: False)
                mp.setattr(tb2d, 'banded_conv_padded', lambda x, n, wr, dt:
                           banded_conv_plain(tb2d._assemble_p6(
                               x, tb2d.halo_index(n), wr.dtype),
                               tb2d.banded_weights(wr), dt))
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
