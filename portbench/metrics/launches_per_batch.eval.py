"""Kernel launches an eval call in the profiled slice (host dispatch)."""


def read(rec):
    t = rec['trace']
    if rec['kind'] != 'eval' or not t:
        return None
    return t['launches'] / t['calls']
