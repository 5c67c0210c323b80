"""Checkpoint I/O of the port, with the reference's lifecycle semantics.

Port of ``doda_tpu/utils/checkpoint.py`` in the port's own format: the
JAX package's 8-byte little-endian header length and JSON meta
(``epoch``, ``metric``, ``commit_id``), followed by a ``torch.save`` body
of the model ``state_dict``, the optimizer ``state_dict`` and the step
count. Writes are atomic (``.tmp`` + ``os.replace``). Mirrors
util/model_utils.py: save {epoch, state, commit_id, metric} (ref :87-94),
auto-resume from the newest ``train_epoch_*`` checkpoint (ref
tool/train.py:350-353), strict/non-strict pretrain loading (ref :73-84)
and rolling deletion keeping ~2 checkpoints (ref tool/train.py:253-257).

The loaders also read the JAX package's files: the same header and meta,
followed by a flax msgpack body (``utils/flax_msgpack.py``), either a
whole ``TrainState`` (``doda_tpu/utils/checkpoint.py::save_params``) or a
``{'params', 'batch_stats'}`` tree (a converted reference checkpoint,
``tools/convert_torch_ckpt.py``). The body's first bytes tell the two
formats apart: ``torch.save`` writes a zip archive, which starts with
``PK``, and flax a msgpack map. The flax trees reach the module's names
through ``utils/convert.py::params_from_jax``.
"""

from __future__ import annotations

import glob
import io
import json
import os
import subprocess
from pathlib import Path

import numpy as np
import torch

from . import flax_msgpack
from .convert import params_from_jax

ROOT = Path(__file__).resolve().parents[2]


def get_git_commit_id():
    """(ref: util/common_utils.py:146-151)"""
    try:
        out = subprocess.run(['git', 'rev-parse', 'HEAD'], cwd=ROOT,
                             stdout=subprocess.PIPE,
                             stderr=subprocess.DEVNULL)
        return out.stdout.decode()[:7] or '0000000'
    except Exception:
        return '0000000'


def save_params(path, model, optimizer, epoch, metric=None, step=0):
    """Save the model, the optimizer and the step with their metadata."""
    path = str(path)
    body = io.BytesIO()
    torch.save({'model': model.state_dict(),
                'optimizer': optimizer.state_dict()
                if optimizer is not None else None,
                'step': int(step)}, body)
    meta = {'epoch': int(epoch),
            'metric': float(-1.0 if metric is None else metric),
            'commit_id': get_git_commit_id()}
    header = json.dumps(meta).encode()
    with open(path + '.tmp', 'wb') as f:
        f.write(len(header).to_bytes(8, 'little'))
        f.write(header)
        f.write(body.getbuffer())
    os.replace(path + '.tmp', path)


def _read(path):
    """(meta, body, whether the body is the JAX package's flax tree)."""
    with open(str(path), 'rb') as f:
        n = int.from_bytes(f.read(8), 'little')
        meta = json.loads(f.read(n).decode())
        blob = f.read()
    if blob[:2] == b'PK':
        return meta, torch.load(io.BytesIO(blob), map_location='cpu',
                                weights_only=True), False
    return meta, flax_msgpack.restore(blob), True


def _jax_weights(body):
    """A flax body's ``params`` and ``batch_stats`` as a state_dict."""
    return params_from_jax(body.get('params', {}),
                           body.get('batch_stats', {}))


def _optax_nodes(tree):
    """The optax state's momentum ``trace`` and Adam ``mu``/``nu``/``count``
    nodes, wherever ``inject_hyperparams(chain(...))`` nests them."""
    found = {}

    def visit(node):
        if not isinstance(node, dict):
            return
        if 'trace' in node:
            found.setdefault('trace', node['trace'])
        if 'mu' in node and 'nu' in node:
            found.setdefault('adam', node)
        for key, val in node.items():
            if key not in ('trace', 'mu', 'nu'):
                visit(val)
    visit(tree)
    return found


def _per_parameter(model, tree, what):
    """A flax tree shaped like ``params`` -> {parameter: tensor}, matched
    by name (the ``Dense`` kernel transposed, as for the weights)."""
    named = params_from_jax(tree, {})
    out = {}
    for name, p in model.named_parameters():
        if name not in named:
            raise KeyError(f"the JAX optimizer state's {what} has no entry "
                           f'for {name}')
        t = named[name]
        if tuple(t.shape) != tuple(p.shape):
            raise ValueError(f"the JAX optimizer state's {what} at {name} "
                             f'is {tuple(t.shape)}, not {tuple(p.shape)}')
        out[p] = t.to(device=p.device, dtype=p.dtype)
    return out


def load_optax_state(optimizer, model, opt_state):
    """Map the JAX package's optax state onto ``optimizer``, where the two
    update rules agree (``utils/optim.py::build_optimizer``): SGD's
    momentum ``trace`` is torch's ``momentum_buffer``; Adam's and AdamW's
    ``mu``/``nu``/``count`` are ``exp_avg``/``exp_avg_sq``/``step``. Any
    other pairing raises instead of dropping the state."""
    nodes = _optax_nodes(opt_state)
    in_opt = {id(p) for g in optimizer.param_groups for p in g['params']}
    if not all(id(p) in in_opt for p in model.parameters()):
        raise ValueError('the optimizer does not hold every parameter of '
                         'the model')
    if isinstance(optimizer, torch.optim.SGD) \
            and optimizer.defaults['momentum'] > 0 and 'trace' in nodes \
            and 'adam' not in nodes:
        for p, t in _per_parameter(model, nodes['trace'], 'trace').items():
            optimizer.state[p] = {'momentum_buffer': t}
        return
    if isinstance(optimizer, torch.optim.Adam) and 'adam' in nodes \
            and 'trace' not in nodes:      # AdamW is an Adam subclass
        adam = nodes['adam']
        mu = _per_parameter(model, adam['mu'], 'mu')
        nu = _per_parameter(model, adam['nu'], 'nu')
        count = float(np.asarray(adam['count']))
        for p in mu:
            optimizer.state[p] = {'step': torch.tensor(count),
                                  'exp_avg': mu[p], 'exp_avg_sq': nu[p]}
        return
    raise ValueError(
        'cannot resume the JAX optimizer state (holding {}) into {}: only '
        'SGD with momentum <- trace and Adam/AdamW <- mu, nu, count map '
        'onto each other'.format(sorted(nodes) or 'no moments',
                                 type(optimizer).__name__))


def load_params_from_ckpt(path, model, optimizer=None, logger=None):
    """Full resume: weights, running statistics, optimizer state and step
    (ref: util/model_utils.py:42-54), from the port's file or from the JAX
    package's ``TrainState``. Returns (next epoch, step)."""
    meta, body, jax_body = _read(path)
    if jax_body:
        model.load_state_dict(_jax_weights(body), strict=True)
        if optimizer is not None:
            load_optax_state(optimizer, model, body['opt_state'])
        step = int(np.asarray(body['step']))
    else:
        model.load_state_dict(body['model'], strict=True)
        if optimizer is not None and body['optimizer'] is not None:
            optimizer.load_state_dict(body['optimizer'])
        step = int(body['step'])
    if logger:
        logger.info('resumed from {} (epoch {})'.format(path,
                                                        meta['epoch']))
    return int(meta['epoch']), step


def _is_stat(name):
    return name.rsplit('.', 1)[-1] in ('mean', 'var')


def _adapt_stat(cur, new):
    """DSNorm <-> plain-BN running statistics: (1, C) broadcasts to (2, C);
    (2, C) gives its domain-0 row to (1, C) (the reference's
    suffix-stripping loader, model/dsnorm.py:104-176)."""
    if cur.dim() == 2 and new.dim() == 2 and cur.shape[1] == new.shape[1]:
        if cur.shape[0] == 2 and new.shape[0] == 1:
            return new.expand_as(cur).clone()
        if cur.shape[0] == 1 and new.shape[0] == 2:
            return new[:1].clone()
    return new


def load_params_from_pretrain(path, model, strict=True, logger=None):
    """Weights-only load (ref: util/model_utils.py:73-84), from the port's
    file, a JAX ``TrainState`` or a converted reference file. ``strict``
    binds the parameters: a missing one raises ``KeyError``, one of
    another shape ``ValueError``. The running statistics load tolerantly,
    through ``_adapt_stat``; whatever is missing or mismatched keeps its
    value, as the JAX package's loader does. Extra keys are ignored."""
    meta, body, jax_body = _read(path)
    loaded = _jax_weights(body) if jax_body else body['model']
    merged = {}
    for name, cur in model.state_dict().items():
        stat = _is_stat(name)
        if name not in loaded:
            if strict and not stat:
                raise KeyError(f'missing key in pretrain: {name}')
            if logger:
                logger.info(f'pretrain missing {name}; kept init')
            continue
        new = _adapt_stat(cur, loaded[name]) if stat else loaded[name]
        if tuple(new.shape) != tuple(cur.shape):
            if strict and not stat:
                raise ValueError(f'shape mismatch at {name}: '
                                 f'{tuple(new.shape)} vs {tuple(cur.shape)}')
            if logger:
                logger.info(f'pretrain shape mismatch at {name}; kept init')
            continue
        merged[name] = new
    model.load_state_dict(merged, strict=False)
    if logger:
        logger.info('loaded pretrain {} (epoch {}, metric {:.4f})'.format(
            path, meta['epoch'], meta['metric']))
    return model


def load_metric_from_ckpt(path):
    """(ref: util/model_utils.py:57-70)"""
    with open(str(path), 'rb') as f:
        n = int.from_bytes(f.read(8), 'little')
        meta = json.loads(f.read(n).decode())
    return float(meta.get('metric', 0.0)), int(meta.get('epoch', 0))


def auto_resume_path(ckpt_dir):
    """Highest-epoch train_epoch_* checkpoint (ref: tool/train.py:350-353
    parses epoch numbers from filenames; mtime would silently resume a
    copied/touched file at the wrong epoch)."""
    def epoch_of(path):
        tail = os.path.basename(path).rsplit('train_epoch_', 1)[-1]
        digits = ''.join(ch for ch in tail if ch.isdigit())
        return int(digits) if digits else -1

    cands = [c for c in glob.glob(str(Path(ckpt_dir) / 'train_epoch_*'))
             if os.path.isfile(c) and epoch_of(c) >= 0]
    if not cands:
        return None
    cands.sort(key=epoch_of)
    return cands[-1]


def rolling_delete(ckpt_dir, epoch, save_freq, keep=2):
    """(ref: tool/train.py:253-257)"""
    victim = Path(ckpt_dir) / f'train_epoch_{epoch - save_freq * keep}'
    if victim.exists() and victim.is_file():
        victim.unlink()
