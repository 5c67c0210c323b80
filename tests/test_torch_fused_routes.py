"""The routing rule gives the flagship's launch counts by route, forward
and backward (the sorted point -> cell reduction once a forward, and once
a backward as the voxel -> point gather's), and
``subm_route`` sends the flagship's level-0 bf16 convs to their kernels
(its other cases are in tests/test_torch_fused_rule.py).
"""

import pytest
import torch

from _torch_threads import two_threads  # noqa: F401
from _torch_fused_common import flagship_cfg  # noqa: F401
from doda_tpu_torch.models import model_fn as tmf
from doda_tpu_torch.ops import bricks2d as tb2d


@pytest.mark.parametrize('sm_max_cin,dtype,fwd,bwd', [
    (0, torch.bfloat16,
     dict(sm=0, fused=52, narrow=1, f32=0, padded=0, cell_mean=1),
     dict(sm=0, fused=52, narrow=0, f32=0, padded=0, cell_mean=1)),
    (32, torch.bfloat16,
     dict(sm=15, fused=37, narrow=1, f32=0, padded=0, cell_mean=1),
     dict(sm=16, fused=36, narrow=0, f32=0, padded=0, cell_mean=1)),
    (32, torch.float32,
     dict(sm=15, fused=0, narrow=0, f32=38, padded=0, cell_mean=1),
     dict(sm=16, fused=0, narrow=0, f32=36, padded=0, cell_mean=1))])
def test_flagship_routes(flagship_cfg, sm_max_cin, dtype, fwd, bwd):
    model = tmf.build_model(flagship_cfg, device='cpu', dtype=dtype,
                            sm_max_cin=sm_max_cin)
    assert model.subm_routes() == fwd
    assert model.subm_routes(backward=True) == bwd


@pytest.mark.parametrize('cin,cout,dtype,sm_max_cin,want', [
    (3, 16, torch.bfloat16, 32, 'narrow'),
    (16, 16, torch.bfloat16, 0, 'fused'),
    (16, 16, torch.bfloat16, 32, 'sm')])
def test_subm_route(cin, cout, dtype, sm_max_cin, want):
    assert tb2d.subm_route(cin, cout, dtype, sm_max_cin) == want
