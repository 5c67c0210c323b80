"""Convert a reference DODA torch checkpoint into the JAX package's format.

The port's copy of ``tools/convert_torch_ckpt.py``: the same key map, the
same ``--flip_kernel`` and ``module.`` handling, and the same output, a
JAX-package checkpoint (8-byte header length, JSON meta, flax msgpack
body of ``{'params', 'batch_stats'}``) written through
``utils/flax_msgpack.py``. One converted file serves both packages: the
JAX CLIs read it with ``--weight``/``--ckpt``, and so do the port's
(``utils/checkpoint.py``). The map, from the reference ``SparseConvNet``
state_dict (ref model/unet.py:15-69, model/unet_block.py; checkpoint
layout util/model_utils.py:87-94) onto the flax tree:

  input_conv.0.weight (3,3,3,Ci,Co)        -> input_kernel (27,Ci,Co)
  unet.blocks.block{i}.conv_branch.{0,3}   -> unet/block{i}/MaskedBatchNorm_{0,1}
  unet.blocks.block{i}.conv_branch.{2,5}   -> unet/block{i}/kernel{1,2}
  unet.blocks.block{i}.i_branch.0.weight   -> unet/block{i}/i_kernel
  unet.conv.{0,2}                          -> unet/conv_norm + down_kernel (8,..)
  unet.u...                                -> unet/u/... (recursively)
  unet.deconv.{0,2}                        -> unet/deconv_norm + up_kernel
  unet.blocks_tail.block{i}                -> unet/tail{i}
  output_layer.0                           -> output_norm
  linear.{weight,bias}                     -> linear/{kernel^T, bias}
  DSNorm running_{mean,var}_{source,target}-> batch_stats rows (2, C)

Kernel offsets: spconv v1.2 weights are (k0,k1,k2,Ci,Co) with input =
output + (k - 1) per axis, as the raster (dx,dy,dz) here, so the reshape
is direct. If a converted checkpoint evaluates near-random, the reference
build used the flipped convention: pass ``--flip_kernel``::

    python -m doda_tpu_torch.tools.convert_torch_ckpt --src ref.pth \
        --dst ckpt_conv --cfg_file cfgs/da_front3d_scannet/spconv.yaml
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from ..config import CfgNode, cfg_from_yaml_file
from ..utils import flax_msgpack


def to_np(t):
    return np.asarray(t.detach().cpu().numpy())


class Converter:
    """Takes reference tensors by key and records which were used."""

    def __init__(self, sd, flip):
        self.sd = {k[len('module.'):] if k.startswith('module.') else k: v
                   for k, v in sd.items()}
        self.flip = flip
        self.used = set()

    def take(self, key):
        self.used.add(key)
        return to_np(self.sd[key])

    def has(self, key):
        return key in self.sd

    def conv(self, key, k=3):
        w = self.take(key)  # (k,k,k,Ci,Co)
        if self.flip:
            w = w[::-1, ::-1, ::-1]
        return np.ascontiguousarray(w.reshape(k ** 3, w.shape[3],
                                              w.shape[4]))

    def norm(self, prefix):
        """torch BN / DSNorm -> (params, stats) dicts."""
        params = {'scale': self.take(prefix + '.weight'),
                  'bias': self.take(prefix + '.bias')}
        if self.has(prefix + '.running_mean_source'):  # DSNorm
            mean = np.stack([self.take(prefix + '.running_mean_source'),
                             self.take(prefix + '.running_mean_target')])
            var = np.stack([self.take(prefix + '.running_var_source'),
                            self.take(prefix + '.running_var_target')])
        else:
            mean = self.take(prefix + '.running_mean')[None]
            var = self.take(prefix + '.running_var')[None]
        self.used.add(prefix + '.num_batches_tracked')
        return params, {'mean': mean, 'var': var}

    def block(self, prefix):
        """ResidualBlock (ref model/unet_block.py:10-38)."""
        params, stats = {}, {}
        if self.has(prefix + '.i_branch.0.weight'):
            w = self.take(prefix + '.i_branch.0.weight')  # (1,1,1,Ci,Co)
            params['i_kernel'] = np.ascontiguousarray(
                w.reshape(w.shape[3], w.shape[4]))
        for i, branch in ((0, '.conv_branch.0'), (1, '.conv_branch.3')):
            p, s = self.norm(prefix + branch)
            params[f'MaskedBatchNorm_{i}'] = p
            stats[f'MaskedBatchNorm_{i}'] = s
        params['kernel1'] = self.conv(prefix + '.conv_branch.2.weight')
        params['kernel2'] = self.conv(prefix + '.conv_branch.5.weight')
        return params, stats

    def ublock(self, prefix, block_reps):
        """UBlock recursion (ref model/unet_block.py:55-100)."""
        params, stats = {}, {}
        for i in range(block_reps):
            params[f'block{i}'], stats[f'block{i}'] = self.block(
                f'{prefix}.blocks.block{i}')
        if self.has(f'{prefix}.conv.2.weight'):
            params['conv_norm'], stats['conv_norm'] = self.norm(
                f'{prefix}.conv.0')
            params['down_kernel'] = self.conv(f'{prefix}.conv.2.weight',
                                              k=2)
            params['u'], stats['u'] = self.ublock(f'{prefix}.u', block_reps)
            params['deconv_norm'], stats['deconv_norm'] = self.norm(
                f'{prefix}.deconv.0')
            params['up_kernel'] = self.conv(f'{prefix}.deconv.2.weight',
                                            k=2)
            for i in range(block_reps):
                params[f'tail{i}'], stats[f'tail{i}'] = self.block(
                    f'{prefix}.blocks_tail.block{i}')
        return params, stats


def state_dict_of(payload):
    """The model state_dict inside a reference checkpoint, whichever of
    its layouts (``model_state``, ``state_dict``, ``model``, or bare)."""
    sd = payload.get('model_state', payload.get('state_dict', payload))
    if not isinstance(sd, dict) or 'linear.weight' not in {
            k.replace('module.', '') for k in sd}:
        for key in ('state_dict', 'model_state_dict', 'model'):
            if key in payload:
                return payload[key]
    return sd


def convert(payload, block_reps, flip=False):
    """A reference checkpoint -> (the flax tree ``{'params',
    'batch_stats'}``, the meta, the reference keys left unused)."""
    cv = Converter(state_dict_of(payload), flip)
    params = {'input_kernel': cv.conv('input_conv.0.weight')}
    stats = {}
    params['unet'], stats['unet'] = cv.ublock('unet', block_reps)
    params['output_norm'], stats['output_norm'] = cv.norm('output_layer.0')
    params['linear'] = {
        'kernel': np.ascontiguousarray(cv.take('linear.weight').T),
        'bias': cv.take('linear.bias'),
    }
    meta = {'epoch': int(payload.get('epoch', 0)),
            'metric': float(payload.get('metric', -1.0) or -1.0),
            'commit_id': str(payload.get('commit_id', ''))[:7]}
    return ({'params': params, 'batch_stats': stats}, meta,
            sorted(set(cv.sd) - cv.used))


def write(path, tree, meta):
    """A JAX-package checkpoint: header length, JSON meta, msgpack body."""
    header = json.dumps(meta).encode()
    with open(path, 'wb') as f:
        f.write(len(header).to_bytes(8, 'little'))
        f.write(header)
        f.write(flax_msgpack.serialize(tree))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--src', required=True, help='reference .pth file')
    ap.add_argument('--dst', required=True, help='output checkpoint path')
    ap.add_argument('--cfg_file', required=True)
    ap.add_argument('--flip_kernel', action='store_true')
    args = ap.parse_args(argv)

    cfg = cfg_from_yaml_file(args.cfg_file, CfgNode())
    # a reference checkpoint pickles more than tensors (numpy metrics),
    # so it loads as the JAX package's converter loads it
    payload = torch.load(args.src, map_location='cpu', weights_only=False)
    tree, meta, unused = convert(payload, cfg.MODEL.BACKBONE.block_reps,
                                 args.flip_kernel)
    if unused:
        print('unconverted reference keys:', unused[:10])
    write(args.dst, tree, meta)
    print(f'wrote {args.dst} ({os.path.getsize(args.dst)} bytes); load '
          'with doda_tpu_torch.tools.{train,st,test} --weight/--ckpt '
          + args.dst)
    return args.dst


if __name__ == '__main__':
    main()
