"""Train augmentation on the device: scene_aug and elastic inside the step.

Port of ``doda_tpu/data/device_aug.py``. With ``DATA_AUG.device: true``
the host workers keep the stages that change the point set or need
irregular state (VSS, TACM, crop, shuffle) and emit un-rotated,
un-distorted padded batches (``augmentor.init_queue``); the train and st
steps apply ``device_augment`` to the padded (B, N_cap) batch on the
card: a per-scene rotation / flip / jitter matrix (ref aug math:
aug_ops.scene_aug), then the elastic distortion with blurred normal noise
grids of a static extent (aug_ops.elastic), then the re-voxelization
(masked min-shift + floor). The two deviations from the host path that
the JAX package documents (crop windows chosen on pre-aug coords, a
static grid extent) hold here too.

The JAX functions draw from PRNG keys. Here ``make_draws`` takes every
random number of a batch from one ``torch.Generator`` on the step's
device, and ``device_augment`` is deterministic given those draws, so the
two packages can be held to each other on equal draws. A CUDA generator
and a CPU generator with the same seed draw different numbers: CPU runs
reproduce CPU runs and card runs card runs, never each other.
"""

from __future__ import annotations

import functools
import math

import torch

# voxel-unit extent bound for the static elastic grids: reference crops
# bound scenes to full_scale (<= 512 voxels), and xyz here is
# mean-centered, so |xyz| stays well under this.
GRID_BOUND = 768


def _enabled(c):
    if c is None or c is False:
        return False
    if hasattr(c, 'get'):
        return c.get('enabled', True)
    return True


def _prob(c):
    return float(c.get('p', 1.0)) if hasattr(c, 'get') else 1.0


def _stages(aug_cfg, aug_list):
    """(scene_aug on?, elastic on?) for this config and stage list."""
    if aug_list is None:
        aug_list = aug_cfg.get('aug_list', [])
    return ('scene_aug' in aug_list and _enabled(aug_cfg.get('scene_aug')),
            'elastic' in aug_list and _enabled(aug_cfg.get('elastic')))


def elastic_pairs(aug_cfg, voxel_scale):
    """[(gran, mag, grid side d)] of each elastic value pair
    (ref aug_ops.elastic, augmentor.elastic)."""
    out = []
    for gran_fac, mag_fac in aug_cfg.elastic['value']:
        gran = max(int(gran_fac * voxel_scale // 50), 1)
        out.append((gran, mag_fac * voxel_scale / 50.0,
                    int(GRID_BOUND // gran + 3)))
    return out


def make_draws(aug_cfg, voxel_scale, batch_size, generator,
               aug_list=None) -> dict:
    """Every random number ``device_augment`` needs for ``batch_size``
    scenes, from ``generator`` on its own device: per scene the jitter
    normals (3, 3), the flip and rotation gates, the rotation uniforms
    (3,), one noise grid (3, d, d, d) per elastic pair and the elastic
    gate. Only the enabled stages draw."""
    dev = generator.device
    b = batch_size
    do_scene, do_elast = _stages(aug_cfg, aug_list)

    def normal(*shape):
        return torch.randn(shape, generator=generator, device=dev)

    def uniform(*shape):
        return torch.rand(shape, generator=generator, device=dev)

    draws = {}
    if do_scene:
        draws.update(jitter=normal(b, 3, 3), flip=uniform(b),
                     rot_gate=uniform(b), rot=uniform(b, 3))
    if do_elast:
        draws['noise'] = [normal(b, 3, d, d, d) for _, _, d
                          in elastic_pairs(aug_cfg, voxel_scale)]
        draws['elastic_gate'] = uniform(b)
    return draws


def _rotation_matrix(cfg_sa, jitter, flip, rot_gate, rot):
    """(B, 3, 3) jitter / flip / rotation matrices (ref aug_ops.scene_aug,
    augmentor_utils.py:85-104) from the draws of ``make_draws``."""
    b, dev = jitter.shape[0], jitter.device
    m = torch.eye(3, device=dev).expand(b, 3, 3)
    if _enabled(cfg_sa.get('jitter')):
        m = m + jitter * 0.1
    flip_cfg = cfg_sa.get('flip')
    if _enabled(flip_cfg):
        sign = torch.where(flip < _prob(flip_cfg), -1.0, 1.0)
        m = m.clone()
        m[:, 0, 0] = m[:, 0, 0] * sign
    rot_cfg = cfg_sa.get('rotation')
    if _enabled(rot_cfg):
        vals = torch.as_tensor(list(rot_cfg['value']), dtype=torch.float32,
                               device=dev)
        ang = torch.where((rot_gate < _prob(rot_cfg))[:, None],
                          (rot * 2 - 1) * math.pi * vals, 0.0)
        c, s = torch.cos(ang), torch.sin(ang)
        one, zero = torch.ones_like(c[:, 0]), torch.zeros_like(c[:, 0])

        def mat(*rows):
            return torch.stack([torch.stack(r, -1) for r in rows], -2)

        mx = mat((one, zero, zero), (zero, c[:, 0], -s[:, 0]),
                 (zero, s[:, 0], c[:, 0]))
        my = mat((c[:, 1], zero, s[:, 1]), (zero, one, zero),
                 (-s[:, 1], zero, c[:, 1]))
        mz = mat((c[:, 2], s[:, 2], zero), (-s[:, 2], c[:, 2], zero),
                 (zero, zero, one))
        m = m @ (mx @ my @ mz)
    return m


def _blur3(n):
    """Two rounds of 3-tap box filters along each of the last three axes,
    zeros outside (== scipy.ndimage.uniform_filter1d(size=3,
    mode='constant')); n is (..., D, D, D)."""
    def box(x, axis):
        z = torch.zeros_like(x.narrow(axis, 0, 1))
        size = x.shape[axis]
        lo = torch.cat([z, x.narrow(axis, 0, size - 1)], dim=axis)
        hi = torch.cat([x.narrow(axis, 1, size - 1), z], dim=axis)
        return (lo + x + hi) / 3.0
    for _ in range(2):
        for axis in (-3, -2, -1):
            n = box(n, axis)
    return n


def elastic_offsets(noise, gran, xyz):
    """Trilinear lookup of 3 blurred noise fields at scaled coords (the
    grid convention of aug_ops._trilinear_regular: axes span
    +-(D-1)*gran with D points). noise (B, 3, d, d, d), xyz (B, N, 3) ->
    (B, N, 3); points outside the grid get 0."""
    d = noise.shape[-1]
    u = (xyz + (d - 1) * gran) / (2.0 * gran)
    oob = ((u < 0) | (u > d - 1)).any(dim=-1)
    i0 = torch.floor(u).to(torch.int32).clamp(0, d - 2)
    frac = u - i0
    flat = noise.reshape(noise.shape[0], 3, -1)
    base = (i0[..., 0] * d + i0[..., 1]) * d + i0[..., 2]
    w1 = frac
    w0 = 1.0 - w1
    acc = torch.zeros(xyz.shape[0], 3, xyz.shape[1], device=xyz.device)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                w = ((w1[..., 0] if dx else w0[..., 0])
                     * (w1[..., 1] if dy else w0[..., 1])
                     * (w1[..., 2] if dz else w0[..., 2]))
                idx = (base + (dx * d + dy) * d + dz).long()
                vals = flat.gather(2, idx[:, None, :].expand(-1, 3, -1))
                acc = acc + w[:, None, :] * vals
    return torch.where(oob[:, None, :], 0.0, acc).transpose(1, 2)


def _elastic(pairs, noises, x):
    """(ref aug_ops.elastic + augmentor.elastic loop over value pairs)"""
    for (gran, mag, _), noise in zip(pairs, noises):
        x = x + elastic_offsets(_blur3(noise), gran, x) * mag
    return x


def aug_fn_for(data_cfg, aug_list=None):
    """A ``f(batch, draws) -> batch`` closure for one data config and the
    ``draws`` maker for it, as ``(augment, draw)``; or None when
    ``DATA_AUG.device`` is off or no device stage (scene_aug, elastic) is
    in the effective aug_list. ``aug_list`` overrides the config's: the
    st target stream runs only the post-mix stages (elastic, crop,
    shuffle; mix_dataset.py:27-29)."""
    ac = data_cfg.get('DATA_AUG', None) if data_cfg else None
    if not ac or not ac.get('enabled', True) or not ac.get('device', False):
        return None
    lst = list(aug_list if aug_list is not None else ac.get('aug_list', []))
    if not any(_stages(ac, lst)):
        return None
    scale = data_cfg.DATA_PROCESSOR.voxel_scale
    return (functools.partial(device_augment, ac, scale, aug_list=lst),
            functools.partial(make_draws, ac, scale, aug_list=lst))


def augmented_positions(aug_cfg, voxel_scale, batch, draws: dict,
                        aug_list=None):
    """The scene_aug + elastic transform of ``device_augment`` before its
    floor: (voxel positions (B, N, 3) min-shifted to 0, xyz_middle
    (B, N, 3)), zero at invalid rows; None when no device stage is on."""
    do_scene, do_elast = _stages(aug_cfg, aug_list)
    if not (do_scene or do_elast):
        return None
    valid = batch.valid[..., None]
    xyz_mid = torch.where(valid, batch.feats[..., :3].float(), 0.0)
    if do_scene:
        m = _rotation_matrix(aug_cfg.scene_aug, draws['jitter'],
                             draws['flip'], draws['rot_gate'], draws['rot'])
        xyz_mid = xyz_mid @ m
    x = xyz_mid * voxel_scale
    if do_elast:
        xe = _elastic(elastic_pairs(aug_cfg, voxel_scale), draws['noise'], x)
        gate = (draws['elastic_gate'] < _prob(aug_cfg.elastic))[:, None, None]
        x = torch.where(gate, xe, x)
        if aug_cfg.elastic.get('apply_to_feat', False):
            xyz_mid = torch.where(gate, xe / voxel_scale, xyz_mid)
    # masked min-shift (augmentor.elastic tail)
    big = 3.4e38
    mn = torch.where(valid, x, big).amin(dim=1, keepdim=True)
    mn = torch.where(torch.isfinite(mn) & (mn < big / 2), mn, 0.0)
    return (torch.where(valid, x - mn, 0.0),
            torch.where(valid, xyz_mid, 0.0))


def device_augment(aug_cfg, voxel_scale, batch, draws: dict, aug_list=None):
    """Apply scene_aug + elastic to a padded train batch with the draws of
    ``make_draws``; ``batch`` is the steps' ``PointBatch`` on the draws'
    device. Respects the aug_list membership and the per-stage enable / p
    gates. Returns a PointBatch with new coords, the floor of the
    augmented voxel positions (and new feats where the stages touch
    xyz_middle); invalid rows keep coords 0 and feats 0 in their first
    three channels."""
    out = augmented_positions(aug_cfg, voxel_scale, batch, draws, aug_list)
    if out is None:
        return batch
    positions, xyz_mid = out
    feats = batch.feats.clone()
    feats[..., :3] = xyz_mid.to(feats.dtype)
    return batch._replace(coords=torch.floor(positions).to(torch.int32),
                          feats=feats)
