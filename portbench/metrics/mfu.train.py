"""The training step's share of the card's bf16 peak: the forward's
count and both gradients of each conv (not the input conv's input
gradient, no recomputation) on the window's steps, over the window's
seconds times 989 TFLOP/s."""

from portbench.metrics._common import mfu


def read(rec):
    return mfu(rec, 'flops_train') if rec['kind'] in ('train', 'st') \
        else None
