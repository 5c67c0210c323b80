"""The K2 selection rule (``uses_sm``) above cin = 32 and under other
``sm_max_cin`` switches (cin <= 32 at 32 is in
tests/test_torch_sm_rule.py).
"""

import pytest

from _torch_threads import two_threads  # noqa: F401
from doda_tpu_torch.ops import bricks2d as tb2d


@pytest.mark.parametrize('cin,cout,max_cin,want', [
    (64, 32, 32, False), (16, 16, 0, False), (48, 48, 32, False),
    (48, 48, 64, True)])
def test_engine_rule(cin, cout, max_cin, want):
    assert tb2d.uses_sm(cin, cout, max_cin) is want
