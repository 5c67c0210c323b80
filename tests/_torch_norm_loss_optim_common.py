"""Shared inputs of tests/test_torch_norm_loss_optim.py, test_torch_loss.py
and test_torch_optim.py: numpy arrays as torch tensors and the points of
the loss tests.
"""

import numpy as np
import pytest
import torch


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


# ---------------------------------------------------------------- norm ----


# -------------------------------------------------------------- losses ----

@pytest.fixture(scope='module')
def points():
    rng = np.random.default_rng(4)
    n, k = 700, 13
    logits = (rng.normal(size=(n, k)) * 2).astype(np.float32)
    labels = rng.integers(0, k - 2, n).astype(np.int32)   # 2 classes absent
    labels[rng.random(n) < 0.2] = 255
    return logits, labels


# ---------------------------------------------------- optimizers, lr ----
