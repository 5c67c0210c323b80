"""Seeded inputs: rooms of points, their batches, and the weights.

A frozen copy of ``doda_tpu_torch/utils/synth.py``'s generator, so that
a later change to the program cannot move the yardstick. A room is the
JAX bench's surface-heavy scene (a floor slab, one wall, clutter up to
1.2 m) at voxel_scale 50; a room of side 7 m holds 150,000 points, about
40,300 occupied level-0 bricks of 4^3 voxels. A room of another side
keeps that density over its floor. Points, features and labels come from
numpy's ``default_rng`` of the seed, on the host, as a loader hands a
batch over; the weights come from a generator on the device.
"""

from __future__ import annotations

import numpy as np
import torch

VOXEL_SCALE = 50            # voxels a metre (DATA_PROCESSOR.voxel_scale)
ROOM_SIDE = 7.0             # metres, the bench room
ROOM_POINTS = 150_000       # points of the bench room
MAX_COORD = 2047            # voxel coords are clipped into [0, 2047]
IGNORE = 255                # DATA_CLASS.ignore_label


def room_points(side: float) -> int:
    """Points of a room of ``side`` metres at the bench room's density."""
    return int(round(ROOM_POINTS * (side / ROOM_SIDE) ** 2))


def make_scene(rng: np.random.Generator, side: float = ROOM_SIDE,
               n: int | None = None) -> np.ndarray:
    """A surface-heavy room: (n, 3) int32 voxel coords, min-shifted to 0.
    At ``side`` 7 this is ``synth.make_scene`` draw for draw."""
    n = room_points(side) if n is None else n
    fl = rng.uniform(0, side, (n // 2, 3))
    fl[:, 2] = np.abs(rng.normal(0, 0.02, n // 2))
    w1 = rng.uniform(0, side, (n // 4, 3))
    w1[:, 0] = np.abs(rng.normal(0, 0.02, n // 4))
    w1[:, 2] = w1[:, 2] * (0.4 * ROOM_SIDE / side)    # walls 2.8 m high
    cl = rng.uniform(0, side, (n - n // 2 - n // 4, 3))
    cl[:, 2] = rng.uniform(0, 1.2, len(cl))
    pts = np.concatenate([fl, w1, cl])
    c = np.floor(pts * VOXEL_SCALE).astype(np.int32)
    c -= c.min(0)
    return np.clip(c, 0, MAX_COORD)


def room_sides(lo: float, hi: float, count: int,
               rng: np.random.Generator) -> np.ndarray:
    """``count`` room sides spread evenly over [lo, hi] (the midpoints of
    ``count`` equal steps), in an order drawn from ``rng``: every seed
    serves the same set of sizes, in another order."""
    sides = lo + (hi - lo) * (np.arange(count) + 0.5) / count
    return sides[rng.permutation(count)]


def make_batch(rng: np.random.Generator, sides, n_cap: int, n_classes: int,
               ignore_share: float = 0.0, channels: int = 3) -> dict:
    """A padded host batch of one room a side: coords (B, n_cap, 3) int32,
    feats (B, n_cap, channels) float32, labels (B, n_cap) int32 with
    ``IGNORE`` at padding and, where ``ignore_share`` > 0, at that share
    of the points (pseudo-labels below their threshold), valid (B, n_cap)
    bool."""
    b = len(sides)
    coords = np.zeros((b, n_cap, 3), np.int32)
    valid = np.zeros((b, n_cap), bool)
    for i, side in enumerate(sides):
        c = make_scene(rng, float(side))
        if len(c) > n_cap:
            raise ValueError(f'a room of {len(c)} points > n_cap {n_cap}')
        coords[i, :len(c)] = c
        valid[i, :len(c)] = True
    feats = rng.normal(size=(b, n_cap, channels)).astype(np.float32)
    labels = rng.integers(0, n_classes, (b, n_cap)).astype(np.int32)
    if ignore_share > 0:
        labels[rng.random((b, n_cap)) < ignore_share] = IGNORE
    labels[~valid] = IGNORE
    return {'coords': coords, 'feats': feats, 'labels': labels,
            'valid': valid}


def audit(coords: torch.Tensor, valid: torch.Tensor, caps,
          brick: int = 4) -> None:
    """Raise where a scene holds more occupied bricks of side ``brick`` at
    a level than that level's cap: the program would drop them, and the
    reference, which has no caps, would not."""
    for s in range(coords.shape[0]):
        bc = coords[s][valid[s]].long() // brick
        for lvl, cap in enumerate(caps):
            v = bc >> lvl
            key = (v[:, 0] << 40) | (v[:, 1] << 20) | v[:, 2]
            occ = int(torch.unique(key).numel())
            if occ > cap:
                raise ValueError(f'scene {s} level {lvl}: {occ} occupied '
                                 f'bricks > cap {cap}')


def seeded_weights(shapes: dict, seed: int, device) -> dict:
    """Weights for every named tensor of ``shapes`` (name -> shape), drawn
    on ``device`` by one generator in two calls: running means N(0, 0.2),
    variances U(0.5, 1.5), norm scales 1 + N(0, 0.2), biases N(0, 0.2),
    and every other tensor (the convs' kernels, the head's weight)
    U(-b, b) with b = fan_in^-1/2, as ``synth.seeded_state_dict`` draws
    them (fan_in: K * cin of a (K, cin, cout) kernel, cin of a (cin, cout)
    one, the inputs of the head's (classes, inputs) weight). Norm
    statistics and affines sit away from identity, so that every norm
    does work. Float32, the type the parameters are held in."""
    names = sorted(shapes)
    sizes = [int(np.prod(shapes[k])) for k in names]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    uni = torch.rand(sum(sizes), generator=gen, device=device)
    nrm = torch.randn(sum(sizes), generator=gen, device=device)
    out, at = {}, 0
    for name, size in zip(names, sizes):
        shape = tuple(shapes[name])
        u = uni[at:at + size].view(shape)
        z = nrm[at:at + size].view(shape)
        at += size
        leaf = name.rsplit('.', 1)[-1]
        if leaf == 'mean':
            v = 0.2 * z
        elif leaf == 'var':
            v = 0.5 + u
        elif leaf == 'scale':
            v = 1 + 0.2 * z
        elif leaf == 'bias':
            v = 0.2 * z
        else:
            fan_in = shape[-1] if len(shape) == 2 and name.endswith(
                'linear.weight') else (shape[0] * shape[1]
                                       if len(shape) == 3 else shape[0])
            v = (2 * u - 1) * fan_in ** -0.5
        out[name] = v.contiguous()
    return out
