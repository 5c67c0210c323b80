"""Everything the benchmark takes from the program, doda_tpu_torch: the
cfg, the model, its eval / train / self-training step as the CLIs call
them, its state, and its launch counters. Nothing else of the harness
imports the program.
"""

from __future__ import annotations

import numpy as np
import torch

from doda_tpu_torch.config import CfgNode, cfg_from_yaml_file
from doda_tpu_torch.models import model_fn
from doda_tpu_torch.models.unet import default_brick_caps
from doda_tpu_torch.ops import banded_conv, banded_conv_sm, cell_mean
from doda_tpu_torch.utils import optim

# what the eval call copies to the host, as tools/test.py's loop does,
# with the logits (its --save_logit)
EVAL_KEYS = ('loss', 'preds', 'intersection', 'union', 'target', 'count',
             'output')
TRAIN_KEYS = ('loss', 'intersection', 'union', 'target', 'count')
ST_KEYS = tuple(f'{k}_{s}' for s in 'xu' for k in TRAIN_KEYS)


def _cfg_sizes(cfg) -> dict:
    bk, opt = cfg.MODEL.BACKBONE, cfg.OPTIMIZATION
    sizes = {
        'in_channel': bk.in_channel + (3 if bk.get('use_xyz', False) else 0),
        'mid_channel': bk.mid_channel,
        'num_levels': bk.get('num_levels', 7),
        'block_reps': bk.block_reps,
        'block_residual': bk.block_residual,
        'n_classes': model_fn._n_classes(cfg),
        'dsnorm': bool(cfg.MODEL.get('dsnorm', False)),
        'brick_cap': cfg.DATA_CONFIG.DATA_PROCESSOR.brick_cap,
        'ignore_label': cfg.DATA_CONFIG.DATA_CLASS.ignore_label,
        'base_lr': opt.base_lr,
        'momentum': opt.get('momentum', 0.9),
        'weight_decay': opt.get('weight_decay', 0.0),
        'optim': opt.get('optim', 'sgd'),
        'batch_size': opt.BATCH_SIZE_PER_GPU,
        'loss': opt.get('loss', 'cross_entropy'),
    }
    if cfg.get('SELF_TRAIN', None):
        sizes['loss_weight_source'] = cfg.SELF_TRAIN.SRC.get('loss_weight',
                                                              1.0)
        sizes['loss_weight_target'] = cfg.SELF_TRAIN.TAR.get('loss_weight',
                                                              1.0)
        sizes['soft_label'] = bool(cfg.get('SOFT_LABEL', None)
                                   and cfg.SOFT_LABEL.get('enabled', False))
    if cfg.DATA_CONFIG.get('DATA_AUG', None):
        sizes['device_aug'] = bool(cfg.DATA_CONFIG.DATA_AUG.get('device',
                                                                False))
    return sizes


def _apply_set(cfg, sets: dict) -> None:
    """Dotted cfg keys to values, as the CLIs' ``--set`` gives them (a
    missing key is made)."""
    for key, value in sets.items():
        *path, leaf = key.split('.')
        node = cfg
        for part in path:
            node = node.setdefault(part, CfgNode())
        node[leaf] = value


def load_cfg(conf: dict):
    """The program's cfg of the configuration file ``conf`` (its
    ``cfg_file``, then its ``cfg_set``); raises where the cfg and the file
    disagree on a size the benchmark runs at."""
    cfg = cfg_from_yaml_file(conf['cfg_file'], CfgNode())
    _apply_set(cfg, conf.get('cfg_set', {}))
    got = _cfg_sizes(cfg)
    wrong = {k: (got[k], conf[k]) for k in got
             if k in conf and got[k] != conf[k]}
    missing = sorted(k for k in got if k not in conf)
    if wrong or missing:
        raise ValueError(f"{conf['cfg_file']} and {conf['name']}'s file "
                         f'disagree (cfg, file): {wrong}; the file lacks '
                         f'{missing}')
    return cfg


def brick_caps(conf: dict) -> tuple:
    """The cfg's caps, as the CLIs take them."""
    return default_brick_caps(conf['brick_cap'], conf['num_levels'])


def build(conf: dict, cfg, device, train: bool):
    """The model at the configuration's settings, in train mode for a
    training cell."""
    return model_fn.build_model(
        cfg, device=device, dtype=getattr(torch, conf['dtype']),
        sm_max_cin=conf['sm_max_cin'], train=train,
        fuse_norm=conf['fuse_norm'], remat=conf['remat'],
        brick=conf['brick'])


def state_shapes(model) -> dict:
    return {k: tuple(v.shape) for k, v in model.state_dict().items()}


def load_weights(model, weights: dict) -> None:
    model.load_state_dict(weights, strict=True)


def point_batch(batch: dict) -> model_fn.PointBatch:
    """A host batch as the loader hands it to the step: CPU tensors."""
    return model_fn.PointBatch(*(torch.from_numpy(batch[k]) for k in
                                 ('coords', 'feats', 'labels', 'valid')))


def _host(out: dict, keys) -> dict:
    return {k: out[k].detach().cpu().numpy() for k in keys}


class Program:
    """The model, its optimizer in a training cell, and ``call``: one
    call of the timed path on a pool item (stream -> PointBatch), until
    its outputs are on the host."""

    def __init__(self, conf: dict, cfg, kind: str, caps, device):
        self.kind = kind
        self.model = build(conf, cfg, device, train=kind != 'eval')
        self.optimizer = None
        if kind == 'eval':
            step = model_fn.make_eval_step(cfg, self.model, caps, device)
            self.call = lambda item: _host(step(item['batch'], 0),
                                           EVAL_KEYS)
            return
        self.optimizer = optim.build_optimizer(cfg.OPTIMIZATION,
                                               self.model.parameters())
        lr = conf['base_lr']
        if kind == 'train':
            step = model_fn.make_train_step(cfg, self.model, self.optimizer,
                                            caps, device)
            self.call = lambda item: _host(step(item['batch'], lr),
                                           TRAIN_KEYS)
            return
        st = model_fn.make_st_step(cfg, self.model, self.optimizer, caps,
                                   device)
        w_src, w_tar = conf['loss_weight_source'], conf['loss_weight_target']
        self.call = lambda item: _host(st(item['source'], item['target'],
                                          lr, w_src, w_tar), ST_KEYS)

    def losses(self, out: dict) -> list:
        """The losses one call returned, a term each."""
        if self.kind == 'st':
            return [float(out['loss_x']), float(out['loss_u'])]
        return [float(out['loss'])]

    def snapshot(self, weight_decay: float, start: dict | None = None):
        """The state by name on the host: parameters, momentum traces and
        statistics; with ``start`` (the weights the run began from), the
        gradient the optimizer got at its one step so far (the trace less
        the weight decay of ``start``)."""
        params = {k: p.detach().cpu().clone()
                  for k, p in self.model.named_parameters()}
        # a parameter the optimizer never moved has no trace: zero
        momenta = {k: self.optimizer.state[p].get(
            'momentum_buffer', torch.zeros_like(p)).detach().cpu().clone()
            for k, p in self.model.named_parameters()}
        stats = {k: b.detach().cpu().clone()
                 for k, b in self.model.named_buffers()}
        out = {'params': params, 'momenta': momenta, 'stats': stats}
        if start is not None:
            out['grad1'] = {k: momenta[k] - weight_decay * start[k].cpu()
                            for k in momenta}
        return out


def launch_counters() -> dict:
    """The program's own counts of its kernel launches."""
    bc, sm = banded_conv, banded_conv_sm
    return {'banded_conv_fused': bc.banded_conv_fused.launches,
            'banded_conv_fused.pro': bc.banded_conv_fused.pro_launches,
            'banded_conv_narrow': bc.banded_conv_narrow.launches,
            'banded_conv_f32': bc.banded_conv_f32.launches,
            'banded_conv_padded': bc.banded_conv_padded.launches,
            'banded_conv_sm_taps': sm.banded_conv_sm_taps.launches,
            'banded_conv_sm_taps.f32': sm.banded_conv_sm_taps.f32_launches,
            'cell_reduce_sorted': cell_mean.cell_reduce_sorted.launches}


def prebuild() -> None:
    """Build (or find built, in the checkout's build/) every CUDA source
    of the program at once, so that the first run's nvcc builds overlap."""
    from concurrent.futures import ThreadPoolExecutor
    from doda_tpu_torch.ops import _build
    names = sorted(p.stem for p in _build.CSRC.glob('*.cu'))
    with ThreadPoolExecutor(len(names)) as ex:
        list(ex.map(_build.build, names))


def finite(values) -> bool:
    return bool(np.all(np.isfinite(np.asarray(values, dtype=float))))
