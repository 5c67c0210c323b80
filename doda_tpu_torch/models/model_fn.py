"""Model factory, eval step, train step and self-training step of the port.

Port of ``PointBatch``, ``build_model``, ``model_input``,
``make_criterion``, ``eval_step``, ``train_step``, ``soft_label_loss`` and
``st_step`` of ``doda_tpu/models/model_fn.py``. ``make_eval_step`` returns
a function of a padded ``PointBatch`` that builds the level plan, runs the
U-Net in eval mode and returns the same dict as the JAX ``eval_step``:
loss, predictions, IoU histograms and confidence-thresholded pseudo labels
(ref test_model_fn, model/unet.py:115-152). ``make_train_step`` returns the
step that also takes the loss's gradient and updates the model through a
``torch.optim`` optimizer (ref model_fn_decorator, model/unet.py:102-203);
where the JAX step is a pure function of a ``TrainState``, here the model
and the optimizer hold the state and the step mutates them.
``make_st_step`` returns the self-training step in the reference's own
form (tool/st.py:136-198): the source term's forward and backward, then
the target term's, then one optimizer update.

Under ``DATA_AUG.device`` the train and st steps augment their batches on
the device (``data/device_aug.py``) with draws seeded from ``AUG_SEED``
and the step count, as the JAX steps fold ``state.step`` into their key.
In a process group (``parallel/collectives.py``) each rank's batch is its
shard of the whole batch: the loss is the whole batch's masked mean (each
rank's share divided by the summed denominator), the gradients are summed
over the ranks before the update, the norms take the whole batch's
statistics, and the returned loss, histograms and count are the whole
batch's, so every rank logs what one process would.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..parallel import collectives
from ..utils.device import resolve_device
from ..utils.metrics import intersection_and_union
from .losses import (cross_entropy, lovasz_softmax, soft_cross_entropy,
                     soft_to_hard_labels)
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


def _rank_sum(t):
    """The losses' ``reduce``: a denominator summed over the ranks."""
    return collectives.sum_tensors(t)[0]


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
            if collectives.world_size() > 1:
                raise NotImplementedError(
                    'the Lovasz loss of a batch split over ranks does not '
                    'split into per-rank terms; train it in one process')
            return lovasz_softmax(flat_logits, flat_labels, ignore)
        w = weight.reshape(-1) if weight is not None else None
        return cross_entropy(flat_logits, flat_labels, ignore, w,
                             reduce=_rank_sum)[0]

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
    ``eval_step``; the batch is moved to ``device`` first. The model runs
    in eval mode (running statistics, which stay as they are) and is put
    back in its own mode after, so a model that trains can be validated
    between steps."""
    dev = resolve_device(device)
    b_caps = tuple(b_caps)

    @torch.no_grad()
    def eval_step(batch: PointBatch, domain: int = 0, thres=None) -> dict:
        batch = batch.to(dev)
        plan = build_level_plan(batch.coords, batch.valid, b_caps, dev)
        training = model.training
        model.eval()
        try:
            logits = model(model_input(cfg, batch), plan, domain)
        finally:
            model.train(training)
        return eval_outputs(cfg, logits, batch, thres)

    return eval_step


def _device_aug(data_cfg, aug_list=None):
    """The device augmentation of ``data_cfg`` (``device_aug.aug_fn_for``),
    or None; imported on use, since the data package imports this
    module."""
    from ..data.device_aug import aug_fn_for
    return aug_fn_for(data_cfg, aug_list) if data_cfg else None


def _augment(aug, batch: PointBatch, seed: int, key: int) -> PointBatch:
    """``batch`` through ``aug`` with the draws of a generator on its
    device, seeded from ``AUG_SEED`` (``seed``), ``key`` (the step count,
    or 2·step and 2·step + 1 in st) and, in a process group, the rank, so
    that a resumed run draws what an uninterrupted run draws and the ranks
    draw apart."""
    augment, draw = aug
    gen = torch.Generator(device=batch.coords.device)
    gen.manual_seed(collectives.rank_seed(seed * 1_000_003 + key))
    with torch.no_grad():
        return augment(batch, draw(batch.valid.shape[0], gen))


def _aug_seed(cfg) -> int:
    return int(cfg.get('AUG_SEED', 0))


def _need_step(step):
    if step is None:
        raise ValueError('DATA_AUG.device draws from the step count: pass '
                         'step=<global step> to the step function')
    return int(step)


def _finish(model, optimizer, *metrics):
    """Sum the gradients over the ranks, update, and return the whole
    batch's metrics."""
    collectives.all_reduce_grads(model)
    optimizer.step()
    return collectives.sum_tensors(*metrics)


def make_train_step(cfg, model: SparseConvNet,
                    optimizer: torch.optim.Optimizer, b_caps, device="cuda"):
    """train_step(batch, lr, domain=0, loss_weight=None, step=None) -> the
    metrics dict of the JAX ``train_step`` (loss, intersection, union,
    target, count).

    One step moves the batch to ``device``, augments it there under
    ``DATA_AUG.device`` (draws from ``step``, the global step count, which
    is then required), builds the level plan, runs the model in train
    mode, takes the gradient of the loss, sets ``lr`` on the optimizer and
    applies its update; the norms' running statistics move in the
    forward. ``model`` must be in train mode (``build_model(...,
    train=True)``)."""
    dev = resolve_device(device)
    b_caps = tuple(b_caps)
    aug = _device_aug(cfg.get('DATA_CONFIG', None))
    criterion = make_criterion(cfg)
    ignore = cfg.DATA_CONFIG.DATA_CLASS.ignore_label
    n_classes = _n_classes(cfg)

    def train_step(batch: PointBatch, lr: float, domain: int = 0,
                   loss_weight=None, step=None) -> dict:
        if not model.training:
            raise RuntimeError('train_step needs the model in train mode')
        batch = batch.to(dev)
        if aug is not None:
            batch = _augment(aug, batch, _aug_seed(cfg), _need_step(step))
        with torch.no_grad():
            plan = build_level_plan(batch.coords, batch.valid, b_caps, dev)
            labels = torch.where(batch.valid, batch.labels, ignore)
        logits = model(model_input(cfg, batch), plan, domain)
        loss = criterion(logits, labels, loss_weight)
        for group in optimizer.param_groups:
            group['lr'] = float(lr)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        with torch.no_grad():
            preds = torch.argmax(logits, dim=-1).to(torch.int32)
            inter, union, target = intersection_and_union(
                preds, labels, n_classes, ignore)
        metrics = _finish(model, optimizer, loss.detach(), inter, union,
                          target, (labels != ignore).sum())
        return dict(zip(('loss', 'intersection', 'union', 'target',
                         'count'), metrics))

    return train_step


def soft_label_loss(cfg, logits: torch.Tensor, soft_labels: torch.Tensor,
                    valid: torch.Tensor, generator=None):
    """Hard/soft split target loss of the SOFT_LABEL mode (the branch the
    reference declares at model/unet.py:174-194 but never wires; the JAX
    package's ``soft_label_loss`` closure in ``make_steps``).

    Rows of ``soft_labels`` (B, N, C) whose top-1 confidence is 1 are hard
    one-hot labels; the rest carry a distribution. Three branches, by
    ``cfg.SOFT_LABEL``: ``convert_to_hard`` samples a hard label per row
    (one uniform draw each, from ``generator``) and takes CE of the hard
    and of the soft rows; ``thres.enabled`` takes CE on the hard rows'
    top-1 and soft CE on the rest; otherwise soft CE on every labelled
    row. In a process group each loss divides by its denominator summed
    over the ranks. Returns (total, hard, soft)."""
    sl = cfg.get('SOFT_LABEL', None)
    ignore = cfg.DATA_CONFIG.DATA_CLASS.ignore_label
    n_classes = _n_classes(cfg)
    flat_logits = logits.reshape(-1, n_classes)
    soft = soft_labels.reshape(-1, n_classes).float()
    has_label = (soft.sum(-1) > 0) & valid.reshape(-1)
    top1_conf, top1 = soft.max(-1)
    hard_mask = has_label & (top1_conf >= 1.0 - 1e-6)
    if sl.get('convert_to_hard', False):
        sampled = soft_to_hard_labels(soft, generator=generator,
                                      ignore_label=ignore)
        hard_loss = cross_entropy(
            flat_logits, torch.where(hard_mask, sampled, ignore), ignore,
            reduce=_rank_sum)[0]
        soft_loss = cross_entropy(
            flat_logits, torch.where(has_label & ~hard_mask, sampled, ignore),
            ignore, reduce=_rank_sum)[0]
    elif sl.get('thres', {}).get('enabled', False):
        hard_loss = cross_entropy(
            flat_logits, torch.where(hard_mask, top1, ignore), ignore,
            reduce=_rank_sum)[0]
        soft_loss = soft_cross_entropy(flat_logits, soft,
                                       has_label & ~hard_mask,
                                       _rank_sum)
    else:
        hard_loss = flat_logits.new_zeros((), dtype=torch.float32)
        soft_loss = soft_cross_entropy(flat_logits, soft, has_label,
                                       _rank_sum)
    return hard_loss + soft_loss, hard_loss, soft_loss


def make_st_step(cfg, model: SparseConvNet,
                 optimizer: torch.optim.Optimizer, b_caps, device="cuda"):
    """st_step(src_batch, tar_batch, lr, w_src, w_tar, tar_soft=None,
    generator=None, step=None) -> the metrics dict of the JAX ``st_step``
    (``loss_x``/``loss_u`` weighted, then ``intersection``, ``union``,
    ``target`` and ``count``, each ``_x`` for the source and ``_u`` for
    the target).

    One optimizer update from ``w_src * L_src + w_tar * L_tar``, in the
    reference's form (tool/st.py:136-198): the source batch's forward on
    norm domain 0 and its backward, then the target batch's on domain 1,
    then one ``optimizer.step()``. The gradients equal the JAX single-graph
    form's, because train-mode norms normalize with batch statistics; the
    running statistics move in the same order (the source's rows, then
    the target's); and the peak memory is one batch's graph. With
    SOFT_LABEL on and ``tar_soft`` (B, N, C) given, the target term is
    ``soft_label_loss``, whose ``convert_to_hard`` draws come from
    ``generator``. Under ``DATA_AUG.device`` the source batch is augmented
    with the draws of key 2·``step`` and the target batch (post-mix
    stages only: elastic, crop, shuffle; none for soft-label batches)
    with those of 2·``step`` + 1."""
    dev = resolve_device(device)
    b_caps = tuple(b_caps)
    src_aug = _device_aug(cfg.get('DATA_CONFIG', None))
    # the st target stream runs the mix dataset's post pipeline
    # (mix_dataset.py:27-29); soft-label batches skip augmentation
    tar_aug = _device_aug(cfg.get('DATA_CONFIG_TAR', None),
                          ['elastic', 'crop', 'shuffle'])
    criterion = make_criterion(cfg)
    ignore = cfg.DATA_CONFIG.DATA_CLASS.ignore_label
    n_classes = _n_classes(cfg)
    soft_enabled = bool(cfg.get('SOFT_LABEL', None)
                        and cfg.SOFT_LABEL.get('enabled', False))

    def term(batch, domain, weight, soft=None, generator=None, aug=None,
             key=0):
        """One domain's forward and backward; its loss and histograms."""
        batch = batch.to(dev)
        if aug is not None:
            batch = _augment(aug, batch, _aug_seed(cfg), key)
        with torch.no_grad():
            plan = build_level_plan(batch.coords, batch.valid, b_caps, dev)
            labels = torch.where(batch.valid, batch.labels, ignore)
        logits = model(model_input(cfg, batch), plan, domain)
        if soft is not None:
            loss = soft_label_loss(cfg, logits, soft.to(dev), batch.valid,
                                   generator)[0]
        else:
            loss = criterion(logits, labels)
        (weight * loss).backward()
        with torch.no_grad():
            preds = torch.argmax(logits, dim=-1).to(torch.int32)
            inter, union, target = intersection_and_union(
                preds, labels, n_classes, ignore)
        return (loss.detach() * weight, inter, union, target,
                (labels != ignore).sum())

    def st_step(src_batch: PointBatch, tar_batch: PointBatch, lr: float,
                w_src: float, w_tar: float, tar_soft=None,
                generator=None, step=None) -> dict:
        if not model.training:
            raise RuntimeError('st_step needs the model in train mode')
        soft = torch.as_tensor(tar_soft) \
            if soft_enabled and tar_soft is not None else None
        t_aug = tar_aug if soft is None else None
        if src_aug is not None or t_aug is not None:
            step = _need_step(step)
        for group in optimizer.param_groups:
            group['lr'] = float(lr)
        optimizer.zero_grad(set_to_none=True)
        src = term(src_batch, 0, w_src, aug=src_aug, key=2 * (step or 0))
        tar = term(tar_batch, 1, w_tar, soft, generator, aug=t_aug,
                   key=2 * (step or 0) + 1)
        metrics = _finish(model, optimizer, *src, *tar)
        keys = ('loss', 'intersection', 'union', 'target', 'count')
        return {**{f'{k}_x': v for k, v in zip(keys, metrics[:5])},
                **{f'{k}_u': v for k, v in zip(keys, metrics[5:])}}

    return st_step
