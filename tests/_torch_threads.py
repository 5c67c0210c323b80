"""A fixture the port's CPU tests of whole steps and loops share."""

import pytest
import torch


@pytest.fixture(autouse=True, scope='module')
def two_threads():
    """Two intra-op threads for the module: its nets are tiny and gain
    little from more, and beside the suite's other worker processes more
    threads only contend (with one per core, the CLI loop tests took over
    ten times as long inside the whole suite as alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
