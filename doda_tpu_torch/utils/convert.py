"""Carry the JAX package's weights into the port's ``SparseConvNet``.

The port's module attributes follow the flax names (``input_kernel``,
``unet.block0.kernel1``, ``MaskedBatchNorm_0``, ``conv_norm``, ``u``, ...),
so the mapping is a walk over the two flax trees. Conv weights keep their
layouts, (27, cin, cout) and (8, cin, cout); the flax ``Dense`` kernel
(in, out) becomes ``nn.Linear.weight`` (out, in).
"""

from __future__ import annotations

import numpy as np
import torch


def _walk(tree, prefix=()):
    for key, val in tree.items():
        path = prefix + (key,)
        if hasattr(val, 'items'):
            yield from _walk(val, path)
        else:
            yield path, np.asarray(val)


def params_from_jax(params, batch_stats) -> dict:
    """flax ``params`` and ``batch_stats`` trees (nested dicts of arrays,
    e.g. ``jax.device_get(state.params)``) -> a state_dict for
    ``SparseConvNet.load_state_dict(strict=True)``."""
    sd = {}
    for path, arr in _walk(params):
        if path[:-1] == ('linear',) and path[-1] == 'kernel':
            sd['linear.weight'] = torch.from_numpy(arr.T.copy())
        else:
            sd['.'.join(path)] = torch.from_numpy(arr.copy())
    for path, arr in _walk(batch_stats):
        sd['.'.join(path)] = torch.from_numpy(arr.copy())
    return sd
