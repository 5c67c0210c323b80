"""Carry weights between the JAX package and the port's ``SparseConvNet``.

The port's module attributes follow the flax names (``input_kernel``,
``unet.block0.kernel1``, ``MaskedBatchNorm_0``, ``conv_norm``, ``u``, ...),
so the mapping is a walk over the two flax trees. Conv weights keep their
layouts, (27, cin, cout) and (8, cin, cout); the flax ``Dense`` kernel
(in, out) becomes ``nn.Linear.weight`` (out, in). ``params_to_jax`` is the
inverse walk, so a trained port model can be held against the flax trees.
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
            # a copy: numpy arrays, or torch tensors for the bfloat16
            # leaves of a decoded msgpack body (numpy has no bfloat16)
            yield path, val.clone() if torch.is_tensor(val) \
                else torch.from_numpy(np.array(val))


def params_from_jax(params, batch_stats) -> dict:
    """flax ``params`` and ``batch_stats`` trees (nested dicts of arrays,
    e.g. ``jax.device_get(state.params)``) -> a state_dict for
    ``SparseConvNet.load_state_dict(strict=True)``."""
    sd = {}
    for path, t in _walk(params):
        if path[:-1] == ('linear',) and path[-1] == 'kernel':
            sd['linear.weight'] = t.T.contiguous()
        else:
            sd['.'.join(path)] = t
    for path, t in _walk(batch_stats):
        sd['.'.join(path)] = t
    return sd


def params_to_jax(state_dict) -> tuple:
    """The inverse of ``params_from_jax``: a ``SparseConvNet`` state_dict
    -> (params, batch_stats), flax-shaped nested dicts of numpy arrays.
    The running statistics (leaves ``mean``/``var``) go to batch_stats."""
    params, batch_stats = {}, {}
    for name, t in state_dict.items():
        arr = t.detach().cpu().numpy().copy()
        path = name.split('.')
        if name == 'linear.weight':
            path, arr = ['linear', 'kernel'], arr.T.copy()
        node = batch_stats if path[-1] in ('mean', 'var') else params
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = arr
    return params, batch_stats
