"""The subm convs' share of their roofline in the eval step: the sum over
the profiled calls' 53 subm convs of the least time each needs (bytes:
each active input voxel, output voxel and weight once in bf16; operations:
2 cin cout a present (voxel, neighbour) pair) over the device time of the
subm-conv buckets (K1 in every version, K2)."""

from portbench.yardstick import buckets


def read(rec):
    t = rec['trace']
    if rec['kind'] != 'eval' or not t or not rec['work']:
        return None
    spent = sum(t['buckets_s'].get(b, 0.0) for b in buckets.SUBM_CONV)
    if spent <= 0:
        return None
    need = sum(rec['work'][i]['subm_least_s'] for i in rec['slice_items'])
    return 100.0 * need / spent
