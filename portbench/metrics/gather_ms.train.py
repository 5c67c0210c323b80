"""Device milliseconds a training step in the index / gather / scatter
bucket (the conv backward's plane gathers for dW) over the profiled
slice."""

from portbench.metrics._common import per_call
from portbench.yardstick import buckets


def read(rec):
    return per_call(rec, buckets.GATHER) if rec['kind'] in ('train', 'st') \
        else None
