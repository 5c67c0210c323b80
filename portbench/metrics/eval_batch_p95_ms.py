"""The 95th percentile over all batches of the window of the time from
handing the host batch to the eval step until its outputs are on the
host (host clock)."""

from portbench.metrics._common import percentile


def read(rec):
    if rec['kind'] != 'eval' or not rec['calls']:
        return None
    return 1e3 * percentile([e - s for s, e in rec['calls']], 95)
