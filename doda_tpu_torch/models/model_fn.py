"""Model factory, eval step and train step of the port.

Port of ``PointBatch``, ``build_model``, ``model_input``,
``make_criterion``, ``eval_step`` and ``train_step`` of
``doda_tpu/models/model_fn.py``. ``make_eval_step`` returns a function of a
padded ``PointBatch`` that builds the level plan, runs the U-Net and
returns the same dict as the JAX ``eval_step``: loss, predictions, IoU
histograms and confidence-thresholded pseudo labels
(ref test_model_fn, model/unet.py:115-152). ``make_train_step`` returns the
step that also takes the loss's gradient and updates the model through a
``torch.optim`` optimizer (ref model_fn_decorator, model/unet.py:102-203);
where the JAX step is a pure function of a ``TrainState``, here the model
and the optimizer hold the state and the step mutates them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.device import resolve_device
from ..utils.metrics import intersection_and_union
from .losses import cross_entropy, lovasz_softmax
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


def build_model(cfg, device="cuda", dtype=torch.bfloat16,
                sm_max_cin: int = 0, train: bool = False) -> SparseConvNet:
    """Model factory from the cfg schema (cfg keys MODEL.BACKBONE.*,
    cfgs/scannet/spconv.yaml) on ``device``, in eval mode unless ``train``.
    ``sm_max_cin`` picks the subm-conv kernel per conv (see ``unet.py``)."""
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
        sm_max_cin=sm_max_cin,
    )
    return model.to(dev).train(train)


def model_input(cfg, batch: PointBatch) -> torch.Tensor:
    feats = batch.feats
    if cfg.MODEL.BACKBONE.get('use_xyz', False):
        # feats carry xyz_middle as the first 3 channels; use_xyz
        # duplicates them like the reference (model/unet.py:89-90)
        feats = torch.cat([feats, feats[..., :3]], dim=-1)
    return torch.where(batch.valid[..., None], feats, 0.0)


def make_criterion(cfg):
    kind = cfg.OPTIMIZATION.get('loss', 'cross_entropy')
    if kind not in ('cross_entropy', 'lovasz'):
        raise NotImplementedError(f'loss {kind!r}')
    ignore = cfg.DATA_CONFIG.DATA_CLASS.ignore_label
    n_classes = _n_classes(cfg)

    def criterion(logits, labels, weight=None):
        flat_logits = logits.reshape(-1, n_classes)
        flat_labels = labels.reshape(-1)
        if kind == 'lovasz':
            return lovasz_softmax(flat_logits, flat_labels, ignore)
        w = weight.reshape(-1) if weight is not None else None
        return cross_entropy(flat_logits, flat_labels, ignore, w)[0]

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


def _device_aug_on(data_cfg) -> bool:
    """Whether the JAX package's ``aug_fn_for`` would return a device-side
    augmentation closure for this data config."""
    ac = data_cfg.get('DATA_AUG', None) if data_cfg else None
    if not ac or not ac.get('enabled', True) or not ac.get('device', False):
        return False
    def enabled(c):
        if c is None or c is False:
            return False
        return c.get('enabled', True) if hasattr(c, 'get') else True

    stages = ac.get('aug_list', [])
    return any(s in stages and enabled(ac.get(s))
               for s in ('scene_aug', 'elastic'))


def make_train_step(cfg, model: SparseConvNet,
                    optimizer: torch.optim.Optimizer, b_caps, device="cuda"):
    """train_step(batch, lr, domain=0, loss_weight=None) -> the metrics dict
    of the JAX ``train_step`` (loss, intersection, union, target, count).

    One step moves the batch to ``device``, builds the level plan, runs the
    model in train mode, takes the gradient of the loss, sets ``lr`` on the
    optimizer and applies its update; the norms' running statistics move in
    the forward. ``model`` must be in train mode (``build_model(...,
    train=True)``)."""
    dev = resolve_device(device)
    b_caps = tuple(b_caps)
    if _device_aug_on(cfg.get('DATA_CONFIG', None)):
        raise NotImplementedError(
            'DATA_AUG.device: the on-device augmentation belongs to the '
            'data-path slice of the port and is not ported yet')
    criterion = make_criterion(cfg)
    ignore = cfg.DATA_CONFIG.DATA_CLASS.ignore_label
    n_classes = _n_classes(cfg)

    def train_step(batch: PointBatch, lr: float, domain: int = 0,
                   loss_weight=None) -> dict:
        if not model.training:
            raise RuntimeError('train_step needs the model in train mode')
        batch = batch.to(dev)
        with torch.no_grad():
            plan = build_level_plan(batch.coords, batch.valid, b_caps, dev)
            labels = torch.where(batch.valid, batch.labels, ignore)
        logits = model(model_input(cfg, batch), plan, domain)
        loss = criterion(logits, labels, loss_weight)
        for group in optimizer.param_groups:
            group['lr'] = float(lr)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        with torch.no_grad():
            preds = torch.argmax(logits, dim=-1).to(torch.int32)
            inter, union, target = intersection_and_union(
                preds, labels, n_classes, ignore)
        return {'loss': loss.detach(), 'intersection': inter,
                'union': union, 'target': target,
                'count': (labels != ignore).sum()}

    return train_step
