"""Submanifold rulebook: the 27 neighbour ids of every table row.

Port of ``kernel_offsets`` and ``build_subm_rulebook(packed=True)`` from
``doda_tpu/ops/sparse.py``. The JAX package searches half the stencil and
mirrors the rest; here all 27 columns are looked up directly with a binary
search, which gives the same table.
"""

from __future__ import annotations

import numpy as np
import torch

from .coords import CoordTable, lookup_packed


def kernel_offsets(kernel_size: int = 3) -> np.ndarray:
    """Raster-order (dx, dy, dz) offsets, centered for odd kernels.

    Offset index o = ((dx+r)*k + (dy+r))*k + (dz+r) with r = (k-1)//2.
    This fixes the weight layout: weights are (k**3, Cin, Cout) indexed by o.
    """
    r = (kernel_size - 1) // 2
    rng = np.arange(kernel_size) - r
    grid = np.stack(np.meshgrid(rng, rng, rng, indexing='ij'), axis=-1)
    return grid.reshape(-1, 3).astype(np.int32)


def build_subm_rulebook(table: CoordTable,
                        kernel_size: int = 3) -> torch.Tensor:
    """(cap, k^3) int32 neighbour ids; absent neighbours and invalid rows
    map to the null id ``cap``."""
    offs = torch.as_tensor(kernel_offsets(kernel_size),
                           device=table.coords.device)
    queries = table.coords[:, None, :] + offs[None]
    qvalid = table.valid[:, None].expand(queries.shape[:2])
    return lookup_packed(table, queries, qvalid)
