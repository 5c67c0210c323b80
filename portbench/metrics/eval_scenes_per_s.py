"""Scenes segmented a second: every scene whose predictions and logits
reached the host in the window, over the window's seconds (host clock;
a closed loop of one caller)."""

from portbench.metrics._common import rate


def read(rec):
    return rate(rec) if rec['kind'] == 'eval' else None
