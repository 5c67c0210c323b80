"""The share of the profiled slice of eval calls in which no operation
ran on the device: the union of the device's intervals, not their sum."""

from portbench.metrics._common import idle_pct


def read(rec):
    return idle_pct(rec) if rec['kind'] == 'eval' else None
