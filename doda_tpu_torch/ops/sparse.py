"""Voxel-level sparse conv engine: rulebooks and gather-GEMM convs.

Port of ``doda_tpu/ops/sparse.py``: ``kernel_offsets``,
``build_subm_rulebook`` (both key forms), the submanifold conv and its 1x1
case, and the stride-2 down/up convs with their ``DownsampleMap``. A conv
gathers each voxel's neighbours through the rulebook (the null id ``cap``
reads a zero row) and multiplies once: (V, K*Cin) @ (K*Cin, Cout). The
products are exact in float32 and summed in float32, as the JAX package's
``preferred_element_type`` asks. The JAX package searches half the stencil
and mirrors the rest; here all columns are looked up directly with a
binary search, which gives the same table. Autograd differentiates the
gathers, as JAX does (no custom VJP here).

The U-Net runs on bricks (``bricks2d``); this engine uses no bricks at all
and serves as an independent reference for the brick convs.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .coords import (CoordTable, lookup, lookup_packed, pad_rows,
                     unique_coords)


def kernel_offsets(kernel_size: int = 3) -> np.ndarray:
    """Raster-order (dx, dy, dz) offsets, centered for odd kernels.

    Offset index o = ((dx+r)*k + (dy+r))*k + (dz+r) with r = (k-1)//2.
    This fixes the weight layout: weights are (k**3, Cin, Cout) indexed by o.
    """
    r = (kernel_size - 1) // 2
    rng = np.arange(kernel_size) - r
    grid = np.stack(np.meshgrid(rng, rng, rng, indexing='ij'), axis=-1)
    return grid.reshape(-1, 3).astype(np.int32)


def build_subm_rulebook(table: CoordTable, kernel_size: int = 3,
                        packed: bool = False) -> torch.Tensor:
    """(cap, k^3) int32 neighbour ids; absent neighbours and invalid rows
    map to the null id ``cap``. ``packed`` selects the single-key lookup
    for tables of ``unique_coords_packed`` (brick tables); otherwise the
    table comes from ``unique_coords``."""
    offs = torch.as_tensor(kernel_offsets(kernel_size),
                           device=table.coords.device)
    queries = table.coords[:, None, :] + offs[None]
    qvalid = table.valid[:, None].expand(queries.shape[:2])
    return (lookup_packed if packed else lookup)(table, queries, qvalid)


def _dot(a: torch.Tensor, b: torch.Tensor, compute_dtype) -> torch.Tensor:
    """a @ b on compute_dtype-rounded operands, float32 products and sums."""
    return a.to(compute_dtype).float() @ b.to(compute_dtype).float()


def subm_conv(feats: torch.Tensor, rulebook: torch.Tensor,
              weights: torch.Tensor,
              compute_dtype=torch.float32) -> torch.Tensor:
    """Submanifold conv: im2col gather + one GEMM.

    feats (V, Cin), rulebook (V, K) ids into feats (null = V -> zeros),
    weights (K, Cin, Cout) -> (V, Cout) float32."""
    k, cin, cout = weights.shape
    gathered = pad_rows(feats)[rulebook.long()].reshape(feats.shape[0],
                                                        k * cin)
    return _dot(gathered, weights.reshape(k * cin, cout), compute_dtype)


def linear_conv(feats: torch.Tensor, weights: torch.Tensor,
                compute_dtype=torch.float32) -> torch.Tensor:
    """1x1x1 submanifold conv: a per-voxel linear map (ref: the residual
    block's identity branch, model/unet_block.py:20)."""
    return _dot(feats, weights, compute_dtype)


class DownsampleMap(NamedTuple):
    """Index structure tying a level to its stride-2 downsampled level.

    parent          : CoordTable of output voxels (capacity P_cap); its
                      p2v is child_parent
    child_parent    : (V_cap,) int32 child voxel -> parent (null = P_cap)
    child_offset    : (V_cap,) int32 in [0, 8): (x&1)*4 + (y&1)*2 + (z&1)
    parent_children : (P_cap, 8) int32 inverse map (null = V_cap)
    """

    parent: CoordTable
    child_parent: torch.Tensor
    child_offset: torch.Tensor
    parent_children: torch.Tensor


def build_downsample(table: CoordTable, out_cap: int) -> DownsampleMap:
    """Stride-2, kernel-2 output coords = unique(floor(in / 2)), spconv's
    SparseConv3d(kernel=2, stride=2) rule for non-negative coords."""
    dev = table.coords.device
    v_cap = table.cap
    valid = table.valid
    parent = unique_coords(torch.div(table.coords, 2, rounding_mode='floor'),
                           valid, out_cap)
    child_parent = parent.p2v
    bits = table.coords & 1
    child_offset = bits[:, 0] * 4 + bits[:, 1] * 2 + bits[:, 2]
    child_offset = torch.where(valid, child_offset, 0).to(torch.int32)
    pc = torch.full((out_cap + 1, 8), v_cap, dtype=torch.int32, device=dev)
    pc[child_parent.long(), child_offset.long()] = torch.where(
        valid, torch.arange(v_cap, dtype=torch.int32, device=dev), v_cap)
    return DownsampleMap(parent=parent, child_parent=child_parent,
                         child_offset=child_offset,
                         parent_children=pc[:out_cap])


def downsample_conv(feats: torch.Tensor, ds: DownsampleMap,
                    weights: torch.Tensor,
                    compute_dtype=torch.float32) -> torch.Tensor:
    """SparseConv3d(k=2, s=2): each parent reduces its <= 8 children.
    feats (V_cap, Cin), weights (8, Cin, Cout) -> (P_cap, Cout) float32."""
    _, cin, cout = weights.shape
    gathered = pad_rows(feats)[ds.parent_children.long()]
    return _dot(gathered.reshape(gathered.shape[0], 8 * cin),
                weights.reshape(8 * cin, cout), compute_dtype)


def inverse_conv(parent_feats: torch.Tensor, ds: DownsampleMap,
                 weights: torch.Tensor,
                 compute_dtype=torch.float32) -> torch.Tensor:
    """SparseInverseConv3d(k=2), the inverse of ``downsample_conv``: each
    child reads its parent through the weight slice of its own offset, on
    exactly the pre-downsample voxel set (spconv's ``indice_key`` reuse).
    One GEMM gives all 8 offset variants per parent, one gather picks."""
    _, cin, cout = weights.shape
    p_cap = parent_feats.shape[0]
    w = weights.permute(1, 0, 2).reshape(cin, 8 * cout)
    all_out = _dot(parent_feats, w, compute_dtype).reshape(p_cap * 8, cout)
    flat = (ds.child_parent.long() * 8 + ds.child_offset).clamp(
        max=p_cap * 8)                  # a null parent reads the zero row
    return pad_rows(all_out)[flat]
