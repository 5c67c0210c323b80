"""What the metric readers share. A reader is ``read(rec) -> float |
None``; ``rec`` is the run's record (``bench.run_cell``): the window's
calls and seconds, the scenes a call, the peak, and in a traced run the
profiled slice (``trace``) and the conv's own work of each pool item
(``work``). A reader that finds nothing to read returns None."""

import math

from portbench.yardstick import peaks


def rate(rec) -> float | None:
    """Scenes whose outputs reached the host in the window, a second."""
    if not rec['calls'] or rec['window_s'] <= 0:
        return None
    return len(rec['calls']) * rec['scenes_per_call'] / rec['window_s']


def percentile(values, q: float) -> float:
    """The nearest-rank q-th percentile."""
    ordered = sorted(values)
    return ordered[max(math.ceil(q / 100 * len(ordered)) - 1, 0)]


def idle_pct(rec) -> float | None:
    t = rec['trace']
    if not t or t['window_s'] <= 0:
        return None
    return 100.0 * (1.0 - t['busy_s'] / t['window_s'])


def mfu(rec, key: str) -> float | None:
    if not rec['work'] or rec['window_s'] <= 0:
        return None
    done = sum(rec['work'][i][key] for i in rec['window_items'])
    return 100.0 * done / (rec['window_s'] * peaks.PEAK_BF16_FLOPS)


def per_call(rec, bucket: str) -> float | None:
    """Device milliseconds a call in one bucket over the slice."""
    t = rec['trace']
    if not t:
        return None
    return 1e3 * t['buckets_s'].get(bucket, 0.0) / t['calls']
