"""The benchmark's CPU tests. Tests that need the card carry the marker
``card`` and skip inside the test where there is none."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        'markers', 'card: needs an NVIDIA card; skips inside the test on a '
        'machine without one')


@pytest.fixture
def tiny(tmp_path):
    """A tiny copy of the benchmark (``tiny.py``) in a temporary folder."""
    import torch
    from portbench.tests.tiny import tiny_manifest
    torch.set_num_threads(2)
    return tiny_manifest(tmp_path)
