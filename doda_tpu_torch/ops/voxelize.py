"""Voxelization on the device: point -> voxel maps and feature reduction.

Port of ``doda_tpu/ops/voxelize.py``, the counterpart of the reference's
host hash pass ``voxelize_idx`` (lib/pointgroup_ops/src/voxelize/
voxelize.cpp:10-31,61-155) and its scatter kernels ``voxelize_fp/bp``
(voxelize.cu:10-53): ``unique_coords`` gives the voxel table and the
point -> voxel map, a segment reduction by that map the voxel features,
and a gather by it the way back (``point_recover_fp/bp``,
voxelize.cpp:183-205). Plain PyTorch on the device of the inputs: the JAX
package has no Pallas kernel here. Shapes are static, as there: points
padded to N_cap, voxels to V_cap, misses in the null slot ``V_cap``.

Modes follow ref voxelize.cpp:54: 1 = last, 2 = first, 3 = sum, 4 = mean
(the cfgs use 4).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .coords import CoordTable, pad_rows, unique_coords


class VoxelGrid(NamedTuple):
    """One scene's voxelization.

    table : CoordTable over the voxel coords (capacity V_cap); its ``p2v``
            (N_cap,) int32 maps each point to its voxel, padding to V_cap.
    """

    table: CoordTable

    @property
    def coords(self):
        return self.table.coords

    @property
    def p2v(self):
        return self.table.p2v

    @property
    def num_voxels(self):
        return self.table.n

    @property
    def valid(self):
        return self.table.valid


def voxelize_coords(coords: torch.Tensor, valid: torch.Tensor,
                    v_cap: int) -> VoxelGrid:
    """The voxel grid of one scene: coords (N_cap, 3) non-negative int
    voxel coords, valid (N_cap,) bool."""
    return VoxelGrid(table=unique_coords(coords, valid, v_cap))


def voxelize_feats(feats: torch.Tensor, grid: VoxelGrid,
                   mode: int = 4) -> torch.Tensor:
    """Reduce per-point features into per-voxel ones: (N_cap, C) ->
    (V_cap, C). Padded points land in the null slot, which is cut off.
    Differentiable (autograd's backward of the sum is the gather that the
    reference writes by hand in voxelize_bp, voxelize.cu:34-53)."""
    v_cap = grid.table.cap
    p2v = grid.p2v.long()
    if mode in (3, 4):
        total = feats.new_zeros((v_cap + 1, feats.shape[1])).index_add(
            0, p2v, feats)[:v_cap]
        if mode == 3:
            return total
        count = feats.new_zeros(v_cap + 1).index_add(
            0, p2v, feats.new_ones(feats.shape[0]))[:v_cap]
        return total / count.clamp(min=1.0)[:, None]
    if mode in (1, 2):
        n_pts = feats.shape[0]
        pt = torch.arange(n_pts, device=feats.device)
        init, reduce = (-1, 'amax') if mode == 1 else (n_pts, 'amin')
        sel = pt.new_full((v_cap + 1,), init).scatter_reduce(
            0, p2v, pt, reduce)[:v_cap]
        out = feats[sel.clamp(0, n_pts - 1)]
        return torch.where(grid.valid[:, None], out, 0)
    raise NotImplementedError(f'voxel mode {mode}')


def devoxelize_feats(voxel_feats: torch.Tensor,
                     grid: VoxelGrid) -> torch.Tensor:
    """Voxel features back to the points (the ``input_map`` gather, ref
    model/unet.py:62): (V_cap, C) -> (N_cap, C); padded points get 0."""
    return pad_rows(voxel_feats)[grid.p2v.long()]
