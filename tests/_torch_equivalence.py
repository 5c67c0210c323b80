"""Hold the port's steps run over ranks to the same steps in one process.

``compare`` runs, in this process and on a whole batch, one eval step, one
train step and one self-training step (SOFT_LABEL with thresholds: a hard
and a soft target term, each divided by its denominator summed over the
ranks), each from the same weights. It then spawns ``world`` ranks (gloo,
on ``device``: all of them may share one card) that each take a
contiguous shard of the same batches, and returns how far the ranks'
results are from the single process's: the losses, the IoU histograms,
every gradient, the updated weights and running statistics (SyncBN), the
eval predictions and histograms, and an ``all_gather_objects`` of a small
queue. ``loops``, when given, runs in the process and then in every rank
after the steps; its results come back beside them.

The CPU test (tests/_torch_parallel_child.py) and ``chip_smoke.py`` phase
``ddp`` call it, at their sizes. It imports nothing of JAX.
"""

from __future__ import annotations

import os
import socket
import tempfile
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from doda_tpu_torch.config import CfgNode
from doda_tpu_torch.models import model_fn
from doda_tpu_torch.parallel import collectives
from doda_tpu_torch.utils.device import deterministic
from doda_tpu_torch.utils.optim import build_optimizer

TRAIN = ('loss', 'intersection', 'union', 'target', 'count')
ST = tuple(f'{k}_{d}' for d in 'xu' for k in TRAIN)
EVAL = ('preds', 'intersection', 'union', 'target', 'count')
HISTS = ('intersection', 'union', 'target', 'count')
W_SRC, W_TAR = 0.5, 1.0
# the st target term: CE on the one-hot rows, soft CE on the rest
SOFT = {'enabled': True, 'thres': {'enabled': True}}


def _free_port():
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


def shard(t, rank, world):
    """Rank ``rank``'s contiguous share of a batch's scenes: a
    ``PointBatch`` or a tensor with the scenes first."""
    if isinstance(t, model_fn.PointBatch):
        return model_fn.PointBatch(*(shard(x, rank, world) for x in t))
    n = t.shape[0] // world
    return t[rank * n:(rank + 1) * n]


def soft_targets(valid, n_classes, seed=0):
    """Seeded SOFT_LABEL targets (B, N, C) for a batch's ``valid`` mask:
    of the valid rows ~40% one-hot (hard), ~50% distributions and ~10%
    unlabelled (all zero)."""
    g = torch.Generator().manual_seed(seed)
    shape = tuple(valid.shape)
    soft = torch.softmax(2.0 * torch.randn(shape + (n_classes,),
                                           generator=g), -1)
    kind = torch.rand(shape, generator=g)
    hard = torch.nn.functional.one_hot(soft.argmax(-1), n_classes).float()
    soft = torch.where((kind < 0.4)[..., None], hard, soft)
    return torch.where(((kind < 0.9) & valid)[..., None], soft, 0.0)


def _update(model):
    return {'grads': {n: p.grad.detach().cpu()
                      for n, p in model.named_parameters()},
            'state': {k: v.detach().cpu()
                      for k, v in model.state_dict().items()}}


def _steps(cfg, state_dict, src, tar, tar_soft, b_caps, device, dtype, lr,
           remat='off'):
    """One eval step, one train step (both on ``src``, the eval first, so
    that both sides evaluate the same weights) and one st step from
    ``state_dict`` (a fresh model under the memory policy ``remat``), with
    deterministic algorithms (a scene's sums then do not depend on the
    run); the outputs, gradients and state on the host."""
    dev = torch.device(device)
    if dev.type == 'cuda':
        torch.cuda.reset_peak_memory_stats(dev)
    st_cfg = CfgNode(dict(cfg, SOFT_LABEL=SOFT))

    def fresh():
        model = model_fn.build_model(cfg, device=dev, dtype=dtype,
                                     train=True, remat=remat)
        model.load_state_dict(state_dict, strict=True)
        return model, build_optimizer(cfg.OPTIMIZATION, model.parameters())

    res = {'points': int(src.valid.sum()), 'tar_points': int(tar.valid.sum())}
    with deterministic():
        model, opt = fresh()
        ev = model_fn.make_eval_step(cfg, model, b_caps, dev)(src)
        out = model_fn.make_train_step(cfg, model, opt, b_caps, dev)(src, lr)
        res['eval'] = {k: ev[k].cpu() for k in EVAL}
        res['train'] = {'out': {k: out[k].detach().cpu() for k in TRAIN},
                        **_update(model)}
        del model, opt, ev, out
        model, opt = fresh()
        out = model_fn.make_st_step(st_cfg, model, opt, b_caps, dev)(
            src, tar, lr, W_SRC, W_TAR, tar_soft=tar_soft)
        res['st'] = {'out': {k: out[k].detach().cpu() for k in ST},
                     **_update(model)}
    res['peak_memory_gib'] = torch.cuda.max_memory_allocated(dev) / 2 ** 30 \
        if dev.type == 'cuda' else None
    return res


def _rank_main(rank, world, port, out_dir, cfg, state_dict, src, tar,
               tar_soft, b_caps, device, dtype, lr, loops, loops_dir, remat):
    """One rank: join the group through the launcher's environment, take
    the steps on its shards, gather a queue, run ``loops``, and save what
    it saw."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      MASTER_ADDR='localhost', LOCAL_RANK='0')
    collectives.init_from_launcher('pytorch', port, backend='gloo')
    try:
        res = _steps(cfg, state_dict, shard(src, rank, world),
                     shard(tar, rank, world), shard(tar_soft, rank, world),
                     b_caps, device, dtype, lr, remat)
        res['gathered'] = collectives.all_gather_objects(
            {'rank': rank, 'queue': [rank] * (rank + 1)})
        if loops is not None:
            res['loops'] = loops(loops_dir)
        torch.save(res, Path(out_dir) / f'rank{rank}.pt')
    finally:
        dist.destroy_process_group()


def _err(got, want, rel=False):
    e = (got.double() - want.double()).abs().max().item() \
        if got.numel() else 0.0
    return e / max(1.0, want.abs().max().item()) if rel else e


def _update_diff(one, ranks, losses):
    """The worst differences of one update step: the losses (relative),
    gradients and weights (max abs over max(1, max|ref|)), running
    statistics (max abs), whether the histograms are equal and their
    largest difference in points, and whether the ranks' weights are
    equal to each other."""
    stat = {k for k in one['state']
            if k.rsplit('.', 1)[-1] in ('mean', 'var')}
    hists = [k for k in one['out'] if k not in losses]
    return {
        'loss_rel': max(abs(float(r['out'][k]) - float(one['out'][k]))
                        / max(abs(float(one['out'][k])), 1e-30)
                        for r in ranks for k in losses),
        'hist_equal': all(torch.equal(r['out'][k], one['out'][k])
                          for r in ranks for k in hists),
        'hist_max_diff': max(int((r['out'][k].long() - one['out'][k].long())
                                 .abs().max()) for r in ranks for k in hists),
        'grad': max(_err(r['grads'][n], g, True) for r in ranks
                    for n, g in one['grads'].items()),
        'weights': max(_err(r['state'][k], v, True) for r in ranks
                       for k, v in one['state'].items() if k not in stat),
        'stats': max(_err(r['state'][k], one['state'][k]) for r in ranks
                     for k in stat),
        'ranks_equal': all(torch.equal(r['state'][k], ranks[0]['state'][k])
                           for r in ranks for k in one['state'])}


def compare(cfg, state_dict, src, tar, b_caps, device='cpu',
            dtype=torch.float32, lr=0.05, world=2, loops=None,
            loops_dir=None, remat='off') -> dict:
    """One process on the batches ``src`` (eval, train and the st source)
    and ``tar`` (the st target, with ``soft_targets``) against ``world``
    gloo ranks on their shards. Returns, for the train and the st step
    (keys ``train_*`` and ``st_*``), ``_update_diff``'s differences;
    whether the eval predictions and histograms and the gathered queue
    are equal; each rank's point counts and peak memory. ``loops``, a
    picklable callable of a directory, runs in this process on
    ``loops_dir``/one and in every rank on ``loops_dir``/ranks; its
    results are ``loops_one`` and ``loops_ranks``. Every model, in the
    process and in the ranks, trains under the memory policy ``remat``:
    under a replaying one the ranks run the norms' all-reduce again
    inside the backward, in the order of the blocks' replays."""
    tar_soft = soft_targets(tar.valid, cfg.COMMON_CLASSES.n_classes)
    one = _steps(cfg, state_dict, src, tar, tar_soft, b_caps, device, dtype,
                 lr, remat)
    if loops is not None:
        one['loops'] = loops(Path(loops_dir) / 'one')
    if torch.device(device).type == 'cuda':
        torch.cuda.empty_cache()        # the ranks may share this card
    with tempfile.TemporaryDirectory(prefix='doda_ddp_') as tmp:
        mp.spawn(_rank_main, nprocs=world, join=True, args=(
            world, _free_port(), tmp, cfg, state_dict, src, tar, tar_soft,
            b_caps, device, dtype, lr, loops,
            loops_dir and Path(loops_dir) / 'ranks', remat))
        ranks = [torch.load(Path(tmp) / f'rank{r}.pt', weights_only=False)
                 for r in range(world)]
    want_gather = [{'rank': r, 'queue': [r] * (r + 1)} for r in range(world)]
    out = {}
    for kind, losses in (('train', ('loss',)), ('st', ('loss_x', 'loss_u'))):
        out.update({f'{kind}_{k}': v for k, v in _update_diff(
            one[kind], [r[kind] for r in ranks], losses).items()})
    out.update({
        'eval_preds_equal': torch.equal(
            torch.cat([r['eval']['preds'] for r in ranks]),
            one['eval']['preds']),
        'eval_hist_equal': all(torch.equal(
            sum(r['eval'][k] for r in ranks), one['eval'][k])
            for k in HISTS),
        'gathered_equal': all(r['gathered'] == want_gather for r in ranks),
        'points_per_rank': [r['points'] for r in ranks],
        'tar_points_per_rank': [r['tar_points'] for r in ranks],
        'peak_memory_gib_per_rank': [r['peak_memory_gib'] for r in ranks],
        'peak_memory_gib_one_process': one['peak_memory_gib']})
    if loops is not None:
        out['loops_one'] = one['loops']
        out['loops_ranks'] = [r['loops'] for r in ranks]
    return out
