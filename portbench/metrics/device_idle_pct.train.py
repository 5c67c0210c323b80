"""The share of the profiled slice of training steps in which no
operation ran on the device: the union of the device's intervals."""

from portbench.metrics._common import idle_pct


def read(rec):
    return idle_pct(rec) if rec['kind'] in ('train', 'st') else None
