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
Reading the JAX package's msgpack checkpoints is not ported;
``utils/convert.py::params_from_jax`` carries JAX weights over.
"""

from __future__ import annotations

import glob
import io
import json
import os
import subprocess
from pathlib import Path

import torch

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
    with open(str(path), 'rb') as f:
        n = int.from_bytes(f.read(8), 'little')
        meta = json.loads(f.read(n).decode())
        body = torch.load(io.BytesIO(f.read()), map_location='cpu',
                          weights_only=True)
    return meta, body


def load_params_from_ckpt(path, model, optimizer=None, logger=None):
    """Full resume: weights, running statistics, optimizer state and step
    (ref: util/model_utils.py:42-54). Returns (next epoch, step)."""
    meta, body = _read(path)
    model.load_state_dict(body['model'], strict=True)
    if optimizer is not None and body['optimizer'] is not None:
        optimizer.load_state_dict(body['optimizer'])
    if logger:
        logger.info('resumed from {} (epoch {})'.format(path,
                                                        meta['epoch']))
    return int(meta['epoch']), int(body['step'])


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
    """Weights-only load (ref: util/model_utils.py:73-84). ``strict``
    binds the parameters: a missing one raises ``KeyError``, one of
    another shape ``ValueError``. The running statistics load tolerantly,
    through ``_adapt_stat``; whatever is missing or mismatched keeps its
    value, as the JAX package's loader does. Extra keys are ignored."""
    meta, body = _read(path)
    loaded = body['model']
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
