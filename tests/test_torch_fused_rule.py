"""``subm_route``'s other cases: float32, the widest conv and widths
outside the flagship's (the level-0 bf16 cases are in
tests/test_torch_fused_routes.py).
"""

import pytest
import torch

from _torch_threads import two_threads  # noqa: F401
from doda_tpu_torch.ops import bricks2d as tb2d


@pytest.mark.parametrize('cin,cout,dtype,sm_max_cin,want', [
    (16, 16, torch.float32, 0, 'f32'),
    (192, 96, torch.bfloat16, 32, 'fused'),
    (24, 8, torch.bfloat16, 32, 'fused'),
    (12, 16, torch.bfloat16, 0, 'padded')])
def test_subm_route(cin, cout, dtype, sm_max_cin, want):
    assert tb2d.subm_route(cin, cout, dtype, sm_max_cin) == want
