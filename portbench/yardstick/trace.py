"""The device's time in a profiled slice, from a ``torch.profiler``
Chrome trace: busy time as the union of the device's operation intervals
(kernels, copies, fills; overlapping ones counted once), the slice's
span from the first to the last ``portbench.call`` span on the host,
device time by bucket and kernel, kernel launches, and the idle time
summed by the host op that ran through each gap (the innermost one at
its middle).
"""

from __future__ import annotations

import heapq
import json
from collections import defaultdict

from .buckets import bucket_of

CALL_SPAN = 'portbench.call'
DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')
HOST_CATS = ('cpu_op', 'cuda_runtime', 'cuda_driver', 'user_annotation')
TOP = 10


def union(intervals, lo: float, hi: float) -> list:
    """The union of (start, end) intervals clipped to [lo, hi], as sorted
    disjoint intervals."""
    out = []
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(iv) for iv in out]


def gaps(busy, lo: float, hi: float) -> list:
    """The stretches of [lo, hi] that no interval of ``busy`` covers."""
    out, at = [], lo
    for s, e in busy:
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if hi > at:
        out.append((at, hi))
    return out


def _label(host, mids) -> list:
    """The innermost host op (the latest to start) running at each of
    ``mids``, in one sweep: ops that have started wait in a heap by their
    start, latest first, and one that has ended is dropped for good, as
    the points only move on."""
    host = sorted(host, key=lambda h: h[1])
    order = sorted(range(len(mids)), key=lambda i: mids[i])
    out = ['host: no op'] * len(mids)
    running, at = [], 0
    for i in order:
        m = mids[i]
        while at < len(host) and host[at][1] <= m:
            name, start, end = host[at]
            heapq.heappush(running, (-start, end, name))
            at += 1
        while running and running[0][1] < m:
            heapq.heappop(running)
        if running:
            out[i] = running[0][2]
    return out


def read(events: list) -> dict | None:
    """The slice's numbers from a Chrome trace's events; None where it
    holds no call span or no device operation."""
    calls = [(e['ts'], e['ts'] + e['dur']) for e in events
             if e.get('ph') == 'X' and e.get('name') == CALL_SPAN
             and e.get('cat') == 'user_annotation']
    device = [(e['name'], e['ts'], e['ts'] + e['dur'], e['cat'])
              for e in events if e.get('ph') == 'X'
              and e.get('cat') in DEVICE_CATS]
    if not calls or not device:
        return None
    lo, hi = min(c[0] for c in calls), max(c[1] for c in calls)
    inside = [d for d in device if d[1] < hi and d[2] > lo]
    busy = union([(d[1], d[2]) for d in inside], lo, hi)
    busy_us = sum(e - s for s, e in busy)
    buckets, ops = defaultdict(float), defaultdict(float)
    for name, s, e, _ in inside:
        b = bucket_of(name)
        buckets[b] += (e - s) / 1e6
        ops[f'{b}: {name[:80]}'] += (e - s) / 1e6
    idle = gaps(busy, lo, hi)
    host = [(e['name'], e['ts'], e['ts'] + e['dur']) for e in events
            if e.get('ph') == 'X' and e.get('cat') in HOST_CATS
            and e.get('name') != CALL_SPAN]
    by_label = defaultdict(float)
    for (s, e), lab in zip(idle, _label(host, [(s + e) / 2
                                                for s, e in idle])):
        by_label[lab] += (e - s) / 1e6
    idle_gaps = sorted(by_label.items(), key=lambda kv: -kv[1])[:TOP]
    return {
        'calls': len(calls),
        'window_s': (hi - lo) / 1e6,
        'busy_s': busy_us / 1e6,
        'buckets_s': dict(buckets),
        'launches': sum(1 for d in inside if d[3] == 'kernel'),
        'device_ops': [[k, v] for k, v in
                       sorted(ops.items(), key=lambda kv: -kv[1])[:TOP]],
        'idle_gaps': [[k, v] for k, v in idle_gaps],
    }


def read_file(path) -> dict | None:
    with open(path) as f:
        trace = json.load(f)
    events = trace['traceEvents'] if isinstance(trace, dict) else trace
    return read(events)
