"""Process group and collectives of the port: its single distributed seam.

Port of ``doda_tpu/parallel/collectives.py`` over ``torch.distributed``.
The port runs one process per card (the reference's DDP layout, ref
util/common_utils.py:86-126) where the JAX package runs one process per
host whose jitted steps are GSPMD programs over a device mesh. So the
JAX module's ``make_mesh``, ``shard_batch`` and ``replicate`` have no
counterpart here: each rank loads its own shard of the data
(``data/loader.py::ShardedSampler``), ``broadcast_module`` makes the
ranks' weights equal once, and the steps reduce what GSPMD reduces
inside jit: the masked batch-norm sums (SyncBN, ``models/norm.py``), the
loss's denominator, the gradients and the metrics
(``models/model_fn.py``).

``init_from_launcher`` reads the launcher's environment and joins the
group; everything else here is a no-op in a single process.
"""

from __future__ import annotations

import logging
import os
import re

import torch
import torch.distributed as dist


def _warn(msg, logger=None):
    (logger or logging.getLogger('doda_tpu_torch')).warning(msg)


def init_from_launcher(launcher: str, tcp_port: int = 18867, logger=None,
                       backend=None):
    """CLI ``--launcher`` seam: read the launcher's rendezvous environment
    and join the process group (ref util/common_utils.py:86-126,
    init_dist_pytorch / init_dist_slurm).

    ``pytorch``: the torchrun environment, RANK, WORLD_SIZE, LOCAL_RANK and
    MASTER_ADDR; the group meets at tcp://MASTER_ADDR:tcp_port, like the
    reference's tcp:// init_method. ``slurm``: SLURM_PROCID, SLURM_NTASKS,
    SLURM_LOCALID, and the first host of SLURM_STEP_NODELIST (the
    "h1,h2" and "prefix[a-b,...]" forms, parsed as the JAX package does).
    ``none``: one process, no group. A world of one runs single-process,
    with the JAX package's warning.

    ``backend``: NCCL when each rank has its own card (the default on a
    CUDA machine), gloo when asked or without a card. The log names the
    backend. Returns (rank, world size, local rank)."""
    if launcher == 'none' or not launcher:
        return 0, 1, 0
    if launcher == 'pytorch':
        world = int(os.environ.get('WORLD_SIZE', '1'))
        if world <= 1:
            _warn('--launcher pytorch with WORLD_SIZE<=1; running '
                  'single-process', logger)
            return 0, 1, 0
        rank = int(os.environ['RANK'])
        local = int(os.environ.get('LOCAL_RANK', '0'))
        addr = os.environ['MASTER_ADDR']
    elif launcher == 'slurm':
        world = int(os.environ.get('SLURM_NTASKS', '1'))
        if world <= 1:
            _warn('--launcher slurm with SLURM_NTASKS<=1; running '
                  'single-process', logger)
            return 0, 1, 0
        rank = int(os.environ['SLURM_PROCID'])
        local = int(os.environ.get('SLURM_LOCALID', '0'))
        nodelist = os.environ.get('SLURM_STEP_NODELIST',
                                  os.environ.get('SLURM_NODELIST', ''))
        # "h1,h2" or "prefix[001-004,007]" -> first hostname
        m = re.match(r'([^\[,]+)(?:\[([^\]\-,]+))?', nodelist)
        addr = m.group(1) + (m.group(2) or '') if m else nodelist
    else:
        raise ValueError(f'unknown launcher {launcher!r}')
    if backend is None:
        backend = 'nccl' if torch.cuda.is_available() else 'gloo'
    if backend == 'nccl':
        torch.cuda.set_device(local)
    dist.init_process_group(backend, init_method=f'tcp://{addr}:{tcp_port}',
                            world_size=world, rank=rank)
    (logger or logging.getLogger('doda_tpu_torch')).info(
        'process group: rank %d of %d, local rank %d, backend %s at %s:%d',
        rank, world, local, backend, addr, tcp_port)
    return rank, world, local


def world_size() -> int:
    """The group's size; 1 without a group."""
    return dist.get_world_size() if dist.is_available() \
        and dist.is_initialized() else 1


def rank() -> int:
    """This process's rank; 0 without a group."""
    return dist.get_rank() if dist.is_available() \
        and dist.is_initialized() else 0


def is_main() -> bool:
    """Whether this process writes the run's files (rank 0)."""
    return rank() == 0


def rank_seed(seed: int) -> int:
    """``seed`` in one process; in a group, ``seed`` with the rank folded
    in, so that the ranks draw apart."""
    return seed if world_size() == 1 else (seed << 12) + rank()


def barrier():
    if world_size() > 1:
        dist.barrier()


class _SumOverRanks(torch.autograd.Function):
    """y = the sum of x over the ranks. Every rank's loss depends on y,
    and the ranks' gradients are summed before the update, so the
    gradient of x is the sum of the ranks' gradients of y."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, dy):
        dx = dy.clone()
        dist.all_reduce(dx)
        return dx


def sum_with_grad(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the ranks, inside autograd (SyncBN's sums)."""
    return t if world_size() == 1 else _SumOverRanks.apply(t)


def sum_tensors(*tensors):
    """The sums of ``tensors`` over the ranks, outside autograd; the
    tensors themselves are left as they are."""
    if world_size() == 1:
        return tensors
    out = []
    for t in tensors:
        t = t.detach().clone()
        dist.all_reduce(t)
        out.append(t)
    return tuple(out)


def all_reduce_grads(module: torch.nn.Module):
    """Sum every parameter's gradient over the ranks, in one collective.
    Every parameter must have one: a parameter the step did not reach
    would leave the ranks' weights apart."""
    if world_size() == 1:
        return
    params = list(module.parameters())
    missing = [n for n, p in module.named_parameters() if p.grad is None]
    if missing:
        raise RuntimeError(f'no gradient to reduce for {missing[:5]}')
    flat = torch.cat([p.grad.reshape(-1) for p in params])
    dist.all_reduce(flat)
    offset = 0
    for p in params:
        n = p.grad.numel()
        p.grad.copy_(flat[offset:offset + n].view_as(p.grad))
        offset += n


def broadcast_module(module: torch.nn.Module, src: int = 0):
    """Rank ``src``'s parameters and buffers on every rank."""
    if world_size() == 1:
        return
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src)


def all_gather_objects(obj):
    """Gather a picklable object from every rank (host-level; the queue
    sync path, ref util/common_utils.py:390-446). Single-process returns
    [obj]."""
    if world_size() == 1:
        return [obj]
    out = [None] * world_size()
    dist.all_gather_object(out, obj)
    return out


def host_sum(values):
    """Element-wise sums over the ranks of a list of host values (numpy
    arrays, numbers), e.g. a loop's metric sums."""
    if world_size() == 1:
        return values
    gathered = all_gather_objects(values)
    return [sum(g[i] for g in gathered) for i in range(len(values))]
