"""Device selection for the port's entry points: the card unless asked."""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device="cuda") -> torch.device:
    """``torch.device`` for ``device``; raises when CUDA is asked for and
    there is no card, instead of carrying on on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port on the CPU")
    return dev


@contextlib.contextmanager
def deterministic():
    """PyTorch's deterministic algorithms inside the block, for checks
    that hold two runs bit for bit: on the card ``index_add_`` (the
    point-to-cell mean) otherwise sums with atomics in a varying order.
    Ops without a deterministic version warn instead of raising."""
    was, warn = (torch.are_deterministic_algorithms_enabled(),
                 torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was, warn_only=warn)
