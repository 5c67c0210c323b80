"""Seconds from the process's start to the first timed call: imports,
the CUDA context, the kernels' libraries (built on a checkout's first
run), scenes and their audit, weights, warm-up (host clock)."""


def read(rec):
    return rec['setup_s']
