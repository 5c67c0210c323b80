"""The eval step's share of the card's bf16 peak: the model's operations
on the window's batches (``yardstick/counts.py``: the conv's need on the
active voxels of the plain plan, and the head) over the window's seconds
times 989 TFLOP/s."""

from portbench.metrics._common import mfu


def read(rec):
    return mfu(rec, 'flops_fwd') if rec['kind'] == 'eval' else None
