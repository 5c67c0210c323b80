"""Bench-shaped synthetic batches and seeded random weights.

The scene is the JAX package's ``bench.py::make_scene``: a surface-heavy
room (floor slab, two walls, clutter) of ~150k points at voxel_scale 50,
which occupies ~40.3k 4^3 bricks. Weights are drawn with numpy from a seed
so that two runs, or two packages, can hold the same net.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.model_fn import PointBatch
from ..ops.bricks import BRICK

BATCH = 4               # scenes per eval forward
TRAIN_BATCH = 2         # scenes per train step (the JAX bench's TRAIN_BATCH)
N_CAP = 163840          # the quarter-step point bucket of a 150k scene
N_REAL = 150_000
BRICK_CAP = 40960       # level-0 brick cap that clears every bench scene
# the caps of every level in bricks of side 2: a side-2 level l holds the
# bricks of side 4's level l - 1 (side 4's caps from level 0 on, after a
# level-0 cap of twice side 4's), which clears every bench scene
# (``capacity_audit(make_batch(seed=0), BRICK_CAPS_SIDE2, brick=2)``)
BRICK_CAPS_SIDE2 = (81920, 40960, 16384, 3328, 768, 256, 128)


def make_scene(rng, n: int = N_REAL) -> np.ndarray:
    """Surface-heavy synthetic room: (n, 3) int32 voxel coords."""
    fl = rng.uniform(0, 7, (n // 2, 3))
    fl[:, 2] = np.abs(rng.normal(0, 0.02, n // 2))
    w1 = rng.uniform(0, 7, (n // 4, 3))
    w1[:, 0] = np.abs(rng.normal(0, 0.02, n // 4))
    w1[:, 2] *= 0.4
    cl = rng.uniform(0, 7, (n - n // 2 - n // 4, 3))
    cl[:, 2] = rng.uniform(0, 1.2, len(cl))
    pts = np.concatenate([fl, w1, cl])
    c = np.floor(pts * 50).astype(np.int32)
    c -= c.min(0)
    return np.clip(c, 0, 2047)


def make_batch(seed: int = 0, batch: int = BATCH, n_cap: int = N_CAP,
               n_real: int = N_REAL, n_classes: int = 20) -> PointBatch:
    """Padded CPU batch of ``batch`` scenes with random features/labels."""
    rng = np.random.default_rng(seed)
    coords = np.zeros((batch, n_cap, 3), np.int32)
    valid = np.zeros((batch, n_cap), bool)
    for b in range(batch):
        c = make_scene(rng, n_real)
        coords[b, :len(c)] = c
        valid[b, :len(c)] = True
    feats = rng.normal(size=(batch, n_cap, 3)).astype(np.float32)
    labels = rng.integers(0, n_classes, (batch, n_cap)).astype(np.int32)
    labels[~valid] = 255
    return PointBatch(*(torch.from_numpy(a)
                        for a in (coords, feats, labels, valid)))


def bench_batch(batch: int, n_real: int, b_caps, seed: int = 0,
                brick: int = BRICK) -> PointBatch:
    """``make_batch`` of ``batch`` scenes of ``n_real`` points (padded to
    N_CAP for the bench's 150k, else not at all), audited against the
    brick caps ``b_caps`` in bricks of side ``brick``: the probes'
    batch."""
    out = make_batch(seed=seed, batch=batch, n_real=n_real,
                     n_cap=N_CAP if n_real == N_REAL else n_real)
    capacity_audit(out, b_caps, brick)
    return out


def capacity_audit(batch: PointBatch, b_caps, brick: int = BRICK) -> None:
    """Raise if any level of any scene holds more bricks of side ``brick``
    than its cap (the plan would drop them silently)."""
    for b in range(batch.coords.shape[0]):
        bc = batch.coords[b][batch.valid[b]].cpu().numpy() // brick
        for lvl, cap in enumerate(b_caps):
            occ = len(np.unique(bc >> lvl, axis=0))
            if occ > cap:
                raise ValueError(f'scene {b} level {lvl}: {occ} occupied '
                                 f'bricks > cap {cap}')


def seeded_state_dict(model: torch.nn.Module, seed: int) -> dict:
    """Random weights from numpy for every parameter and buffer: convs
    Kaiming-uniform over fan_in, norm statistics and affines away from
    identity so that eval norm does work."""
    rng = np.random.default_rng(seed)
    sd = {}
    for name, t in model.state_dict().items():
        leaf = name.rsplit('.', 1)[-1]
        shape = tuple(t.shape)
        if leaf == 'mean':
            v = rng.normal(0, 0.2, shape)
        elif leaf == 'var':
            v = rng.uniform(0.5, 1.5, shape)
        elif leaf == 'scale':
            v = 1 + rng.normal(0, 0.2, shape)
        elif leaf == 'bias':
            v = rng.normal(0, 0.2, shape)
        else:
            fan_in = shape[-1] if name == 'linear.weight' else (
                shape[0] * shape[1] if len(shape) == 3 else shape[0])
            v = rng.uniform(-1, 1, shape) * (1.0 / fan_in) ** 0.5
        sd[name] = torch.from_numpy(v.astype(np.float32))
    return sd


def synth_rulebook(rows: int, grid: int, seed: int,
                   device='cuda') -> torch.Tensor:
    """A (rows, 27) int32 rulebook of ``rows`` random bricks of a grid^3
    lattice in lexicographic order, null id == rows: ragged row counts,
    absent faces beside present diagonals, as no real plan guarantees."""
    rng = np.random.default_rng(seed)
    slots = np.sort(rng.choice(grid ** 3, size=rows, replace=False))
    ids = np.full((grid + 2,) * 3, rows, np.int32)
    x, y, z = slots // (grid * grid), slots // grid % grid, slots % grid
    ids[x + 1, y + 1, z + 1] = np.arange(rows, dtype=np.int32)
    cols = [ids[x + 1 + dx, y + 1 + dy, z + 1 + dz]
            for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)]
    return torch.from_numpy(np.stack(cols, 1).astype(np.int32)).to(device)
