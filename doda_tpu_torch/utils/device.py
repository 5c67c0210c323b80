"""Device selection for the port's entry points: the card unless asked."""

from __future__ import annotations

import contextlib
import subprocess

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


def card_label(dev: torch.device) -> str:
    """What a reading taken on ``dev`` ran on: for a card, its name and
    power limit as ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` prints them (a card set below its maximum
    runs slower under load); 'cpu' for the CPU, whose times are the
    host's and no device metric."""
    if dev.type != 'cuda':
        return 'cpu'
    index = torch.cuda.current_device() if dev.index is None else dev.index
    out = subprocess.run(
        ['nvidia-smi', f'--id={index}', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip()


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
