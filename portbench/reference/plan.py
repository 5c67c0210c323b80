"""The level plan of a batch at voxel level, by sort and search.

Level 0 holds each distinct voxel of a scene's valid points; level l + 1
holds each distinct ``v >> 1`` of level l. A subm conv at level l reads,
for each active voxel, its 27 neighbours ``v + d`` (d in {-1, 0, 1}^3,
raster order dx, dy, dz) that are active; a stride-2 conv links each
voxel of level l to its parent at level l + 1 through its parity
``(x & 1) * 4 + (y & 1) * 2 + (z & 1)``. Voxels are keyed by scene and
coordinates in one int64, sorted once a level, and found by
``searchsorted``. No caps: every voxel is kept.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

_BITS = 12                  # per axis: coords in [-1, 4094] after the shift
_MASK = (1 << _BITS) - 1
OFFSETS = tuple((dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
                for dz in (-1, 0, 1))


class Level(NamedTuple):
    keys: torch.Tensor      # (n,) int64 sorted voxel keys
    nbr: torch.Tensor       # (n, 27) int64 neighbour rows, n where absent


class Plan(NamedTuple):
    points: torch.Tensor    # (p,) int64 flat positions of the valid points
    #                         in the (B * N) point rows
    point_voxel: torch.Tensor   # (p,) int64 level-0 voxel of each
    levels: tuple           # Level per level
    parents: tuple          # (n_l,) int64 parent row at level l + 1
    parity: tuple           # (n_l,) int64 octant of each voxel of level l


def _key(scene, xyz):
    s = xyz + 1
    return (scene << (3 * _BITS)) | (s[:, 0] << (2 * _BITS)) \
        | (s[:, 1] << _BITS) | s[:, 2]


def _unkey(keys):
    xyz = torch.stack([(keys >> (2 * _BITS)) & _MASK,
                       (keys >> _BITS) & _MASK, keys & _MASK], 1) - 1
    return keys >> (3 * _BITS), xyz


def _find(keys, query):
    """Rows of ``query`` in the sorted ``keys``; len(keys) where absent."""
    pos = torch.searchsorted(keys, query).clamp(max=max(len(keys) - 1, 0))
    hit = keys[pos] == query if len(keys) else torch.zeros_like(query,
                                                                dtype=bool)
    return torch.where(hit, pos, len(keys))


def _level(keys):
    scene, xyz = _unkey(keys)
    off = torch.tensor(OFFSETS, dtype=torch.int64, device=keys.device)
    nbr = torch.stack([_find(keys, _key(scene, xyz + d)) for d in off], 1)
    return Level(keys=keys, nbr=nbr)


def build_plan(coords: torch.Tensor, valid: torch.Tensor,
               num_levels: int) -> Plan:
    """The plan of a batch: coords (B, N, 3) voxel coords >= 0, valid
    (B, N) bool."""
    b, n = valid.shape
    flat_valid = valid.reshape(-1)
    points = torch.nonzero(flat_valid).reshape(-1)
    scene = points // n
    xyz = coords.reshape(-1, 3)[points].long()
    pkeys = _key(scene, xyz)
    keys = torch.unique(pkeys)                 # sorted
    point_voxel = torch.searchsorted(keys, pkeys)
    levels, parents, parity = [_level(keys)], [], []
    for _ in range(1, num_levels):
        sc, v = _unkey(levels[-1].keys)
        pkeys = _key(sc, v >> 1)
        up = torch.unique(pkeys)
        parents.append(torch.searchsorted(up, pkeys))
        parity.append((v[:, 0] & 1) * 4 + (v[:, 1] & 1) * 2 + (v[:, 2] & 1))
        levels.append(_level(up))
    return Plan(points=points, point_voxel=point_voxel, levels=tuple(levels),
                parents=tuple(parents), parity=tuple(parity))


def level_sizes(plan: Plan):
    """(active voxels, (voxel, present neighbour) pairs) of each level."""
    return [(len(lv.keys), int((lv.nbr < len(lv.keys)).sum()))
            for lv in plan.levels]
