"""The conv's own work, counted from the benchmark's plain plan and the
configuration's widths, whatever implements it.

Each conv does 2 * cin * cout operations a (output voxel, present input
voxel) pair: a subm conv over the 27 neighbours that are active (the
plan's pairs), a stride-2 conv and its inverse once a voxel of the finer
level, a 1x1 conv and the head once a row. Bricks, caps and padding do
not count. A subm conv moves at least each active input voxel once, each
output voxel once and its weights once, in bf16.

A training step does each conv's forward and both gradients (three
products), but the input conv's input gradient, which nothing needs.
Recomputation is not counted.
"""

from __future__ import annotations

from typing import NamedTuple

from .peaks import least_seconds

BF16 = 2


class Conv(NamedTuple):
    kind: str       # 'subm', 'down', 'up', '1x1', 'head'
    level: int
    cin: int
    cout: int
    pairs: int
    n_in: int
    n_out: int


def convs(sizes: dict, levels, points: int) -> list:
    """The convs of one forward. ``levels``: (active voxels, pairs) of
    each level, as ``reference.plan.level_sizes`` gives them; ``points``:
    the valid points the head runs on."""
    m, reps = int(sizes['mid_channel']), int(sizes['block_reps'])
    n_lv = int(sizes['num_levels'])
    out = [Conv('subm', 0, int(sizes['in_channel']), m, levels[0][1],
                levels[0][0], levels[0][0])]
    for lvl in range(n_lv):
        n, pairs = levels[lvl]
        p = m * (lvl + 1)
        out += [Conv('subm', lvl, p, p, pairs, n, n)] * (2 * reps)
        if lvl == n_lv - 1:
            continue
        n2 = levels[lvl + 1][0]
        out += [Conv('down', lvl, p, p + m, n, n, n2),
                Conv('up', lvl, p + m, p, n, n2, n),
                Conv('1x1', lvl, 2 * p, p, n, n, n),
                Conv('subm', lvl, 2 * p, p, pairs, n, n)]
        out += [Conv('subm', lvl, p, p, pairs, n, n)] * (2 * reps - 1)
    out.append(Conv('head', 0, m, int(sizes['n_classes']), points, points,
                    points))
    return out


def flops(conv_list, train: bool = False) -> float:
    total = 0.0
    for i, c in enumerate(conv_list):
        products = 1 if not train else (2 if i == 0 else 3)
        total += 2.0 * c.cin * c.cout * c.pairs * products
    return total


def subm_least_seconds(conv_list) -> float:
    """The least time of a forward's subm convs, each alone on the card."""
    total = 0.0
    for c in conv_list:
        if c.kind == 'subm':
            moved = BF16 * (c.n_in * c.cin + c.n_out * c.cout
                            + 27 * c.cin * c.cout)
            total += least_seconds(moved, 2.0 * c.cin * c.cout * c.pairs)
    return total
