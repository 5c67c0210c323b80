"""Device milliseconds an eval call in the elementwise / reduce bucket
(norms, masks, residual adds) over the profiled slice."""

from portbench.metrics._common import per_call
from portbench.yardstick import buckets


def read(rec):
    return per_call(rec, buckets.ELEMENTWISE) if rec['kind'] == 'eval' \
        else None
