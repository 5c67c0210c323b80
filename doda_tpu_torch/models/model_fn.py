"""Model factory and the eval step: the serving path of the port.

Port of ``PointBatch``, ``build_model``, ``model_input``,
``make_criterion`` (cross-entropy) and ``eval_step`` of
``doda_tpu/models/model_fn.py``. ``make_eval_step`` returns a function of a
padded ``PointBatch`` that builds the level plan, runs the U-Net and
returns the same dict as the JAX ``eval_step``: loss, predictions, IoU
histograms and confidence-thresholded pseudo labels
(ref test_model_fn, model/unet.py:115-152).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.device import resolve_device
from ..utils.metrics import intersection_and_union
from .losses import cross_entropy
from .unet import SparseConvNet, build_level_plan


class PointBatch(NamedTuple):
    """Fixed-capacity padded batch; tensors shaped (B, N_cap, ...).

    coords: int32 voxel coords (xyz * voxel_scale, min-shifted to 0)
    feats:  f32 point features
    labels: int32, ``ignore_label`` at padding
    valid:  bool padding mask
    """

    coords: torch.Tensor
    feats: torch.Tensor
    labels: torch.Tensor
    valid: torch.Tensor

    def to(self, device) -> 'PointBatch':
        return PointBatch(*(torch.as_tensor(t, device=device) for t in self))


def _n_classes(cfg) -> int:
    return cfg.COMMON_CLASSES.get('n_classes',
                                  cfg.DATA_CONFIG.DATA_CLASS.n_classes)


def build_model(cfg, device="cuda", dtype=torch.bfloat16) -> SparseConvNet:
    """Model factory from the cfg schema (cfg keys MODEL.BACKBONE.*,
    cfgs/scannet/spconv.yaml), in eval mode on ``device``."""
    dev = resolve_device(device)
    bk = cfg.MODEL.BACKBONE
    in_ch = bk.in_channel + (3 if bk.get('use_xyz', False) else 0)
    model = SparseConvNet(
        in_channel=in_ch,
        mid_channel=bk.mid_channel,
        n_classes=_n_classes(cfg),
        block_reps=bk.block_reps,
        block_residual=bk.block_residual,
        num_levels=bk.get('num_levels', 7),
        dsnorm=cfg.MODEL.get('dsnorm', False),
        dtype=dtype,
    )
    return model.to(dev).eval()


def model_input(cfg, batch: PointBatch) -> torch.Tensor:
    feats = batch.feats
    if cfg.MODEL.BACKBONE.get('use_xyz', False):
        # feats carry xyz_middle as the first 3 channels; use_xyz
        # duplicates them like the reference (model/unet.py:89-90)
        feats = torch.cat([feats, feats[..., :3]], dim=-1)
    return torch.where(batch.valid[..., None], feats, 0.0)


def make_criterion(cfg):
    kind = cfg.OPTIMIZATION.get('loss', 'cross_entropy')
    if kind != 'cross_entropy':
        raise NotImplementedError(f'loss {kind!r} is not ported yet')
    ignore = cfg.DATA_CONFIG.DATA_CLASS.ignore_label
    n_classes = _n_classes(cfg)

    def criterion(logits, labels, weight=None):
        w = weight.reshape(-1) if weight is not None else None
        return cross_entropy(logits.reshape(-1, n_classes),
                             labels.reshape(-1), ignore, w)[0]

    return criterion


def eval_outputs(cfg, logits: torch.Tensor, batch: PointBatch,
                 thres=None) -> dict:
    """Everything ``eval_step`` derives from the logits."""
    ignore = cfg.DATA_CONFIG.DATA_CLASS.ignore_label
    n_classes = _n_classes(cfg)
    labels = torch.where(batch.valid, batch.labels, ignore)
    loss = make_criterion(cfg)(logits, labels)
    preds = torch.argmax(logits, dim=-1).to(torch.int32)
    inter, union, target = intersection_and_union(preds, labels, n_classes,
                                                  ignore)
    out = {'loss': loss, 'preds': preds, 'labels': labels,
           'output': logits, 'intersection': inter, 'union': union,
           'target': target, 'count': (labels != ignore).sum()}
    # confidence-thresholded pseudo labels (ref model/unet.py:126-133)
    confidence = torch.softmax(logits, dim=-1).amax(dim=-1)
    thres_arr = torch.zeros(n_classes, device=logits.device)
    if thres is not None:
        thres_arr = thres_arr + torch.as_tensor(thres, dtype=torch.float32,
                                                device=logits.device)
    conf_ok = (confidence > thres_arr[preds.long()]) & batch.valid
    out['pseudo_labels'] = torch.where(conf_ok, preds, ignore)
    out['weight'] = torch.where(conf_ok, confidence, 0.0)
    out['confidence'] = confidence
    return out


def make_eval_step(cfg, model: SparseConvNet, b_caps, device="cuda"):
    """eval_step(batch, domain=0, thres=None) -> the dict of the JAX
    ``eval_step``; the batch is moved to ``device`` first."""
    dev = resolve_device(device)
    b_caps = tuple(b_caps)

    @torch.no_grad()
    def eval_step(batch: PointBatch, domain: int = 0, thres=None) -> dict:
        batch = batch.to(dev)
        plan = build_level_plan(batch.coords, batch.valid, b_caps, dev)
        logits = model(model_input(cfg, batch), plan, domain)
        return eval_outputs(cfg, logits, batch, thres)

    return eval_step
