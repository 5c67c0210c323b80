"""The K2 selection rule (``uses_sm``) at ``sm_max_cin=32`` for cin <=
32 (the wider convs and the other switches are in
tests/test_torch_sm_rule_wide.py).
"""

import pytest

from _torch_threads import two_threads  # noqa: F401
from doda_tpu_torch.ops import bricks2d as tb2d


@pytest.mark.parametrize('cin,cout,max_cin,want', [
    (16, 16, 32, True), (32, 16, 32, True), (32, 64, 32, True),
    (3, 16, 32, False), (16, 3, 32, False)])
def test_engine_rule(cin, cout, max_cin, want):
    assert tb2d.uses_sm(cin, cout, max_cin) is want
