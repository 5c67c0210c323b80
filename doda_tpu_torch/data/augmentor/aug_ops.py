"""Augmentation kernels (host-side NumPy, explicit RNG).

A copy of ``doda_tpu/data/augmentor/aug_ops.py``; the elastic lookup runs
in the port's own native library (``native/host_ops.py``), whose plain
twin is ``_trilinear_regular``. It re-implements the reference's
augmentor op set (ref: dataset/augmentor/augmentor_utils.py) without its
cv2/open3d/torch dependencies:

* ``elastic`` — triple-box-blurred noise grids + trilinear interpolation
  (ref :61-80) via ``scipy.ndimage.uniform_filter1d``.
* ``scene_aug`` — jitter/flip/rotation matrix (ref :85-104).
* ``crop`` — voxel-budget and max-point cropping (ref :449-472).
* VSS (virtual scan simulation, ref :108-251): camera candidates from a
  2D occupancy image eroded with ``scipy.ndimage.minimum_filter``
  (replacing cv2.erode, ref :200-201), three view-frustum modes, and a
  **spherical depth-buffer visibility test** replacing open3d's
  hidden_point_removal (ref :159-163) — points are binned by view
  direction and only the nearest shell per angular bin survives, which
  models a panoramic range scan's occlusion directly.
* TACM (tail-aware cuboid mixing, ref :255-445): randomized cuboid space
  split, per-cuboid tail-class detection, cuboid permutation, and
  target/source/queue mixing.

All randomness flows through an explicit ``np.random.Generator``.
"""

from __future__ import annotations

import math

import numpy as np
import scipy.interpolate
import scipy.ndimage


def check_key(key):
    """Aug-config enable check (ref: augmentor_utils.py:13-23)."""
    if key is None:
        return False
    if isinstance(key, bool):
        return key
    if isinstance(key, dict):
        return key.get('enabled', True)
    return True


def check_p(key, rng):
    """Probability gate (ref: augmentor_utils.py:26-27)."""
    return (not isinstance(key, dict)) or ('p' not in key) \
        or (rng.random() < key['p'])


# ==== elastic distortion ====

def elastic(xyz, gran, mag, rng):
    """Elastic distortion in voxel units (ref: augmentor_utils.py:61-80).

    Noise grids are blurred twice with 3-tap box filters along each axis
    (uniform_filter1d(size=3) == convolution with ones(3)/3). The
    trilinear lookup is hand-vectorized for the regular grid — scipy's
    RegularGridInterpolator searchsorts every query per axis and was
    ~70% of the whole host __getitem__ at 150k points."""
    dims = np.abs(xyz).max(0).astype(np.int32) // gran + 3
    noise = [rng.standard_normal(dims).astype(np.float32) for _ in range(3)]
    for _ in range(2):
        for axis in range(3):
            noise = [scipy.ndimage.uniform_filter1d(
                n, size=3, axis=axis, mode='constant', cval=0)
                for n in noise]
    # native fused lookup (~10x the NumPy 8-corner gather loop of
    # _trilinear_regular, its plain twin)
    from ...native import host_ops
    return host_ops.elastic_interp(
        np.stack([n.reshape(-1) for n in noise]), dims, float(gran),
        float(mag), xyz)


def _trilinear_regular(noise, dims, gran, xyz):
    """Trilinear interp of 3 noise fields on the reference's grid
    (axes span +-(d-1)*gran with d points -> spacing 2*gran); queries
    outside the grid get 0 (RegularGridInterpolator fill_value)."""
    dims = np.asarray(dims, np.int64)
    u = (xyz + (dims - 1) * gran) / (2.0 * gran)        # (N, 3)
    oob = ((u < 0) | (u > dims - 1)).any(axis=1)
    i0 = np.clip(np.floor(u).astype(np.int64), 0, dims - 2)
    frac = (u - i0).astype(np.float32)
    n3 = np.stack(noise).reshape(3, -1)                 # (3, cells)
    sy, sz = int(dims[1] * dims[2]), int(dims[2])
    base = i0[:, 0] * sy + i0[:, 1] * sz + i0[:, 2]
    w1 = frac.T                                          # (3, N) per-axis
    w0 = 1.0 - w1
    acc = np.zeros((3, xyz.shape[0]), np.float32)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                w = ((w1[0] if dx else w0[0])
                     * (w1[1] if dy else w0[1])
                     * (w1[2] if dz else w0[2]))
                idx = base + dx * sy + dy * sz + dz
                acc += w[None, :] * n3[:, idx]
    acc[:, oob] = 0.0
    return acc.T


# ==== scene-level rigid/affine aug ====

def scene_aug(cfg, xyz, rng):
    """Jitter + flip + rotation composite (ref: augmentor_utils.py:85-104)."""
    m = np.eye(3)
    if check_key(cfg.get('jitter')):
        m = m + rng.standard_normal((3, 3)) * 0.1
    if check_key(cfg.get('flip')) and check_p(cfg.get('flip'), rng):
        m[0][0] *= -1
    rot = cfg.get('rotation')
    if check_key(rot) and check_p(rot, rng):
        angles = [(rng.random() * 2 * math.pi - math.pi) * v
                  for v in rot['value']]
        rx, ry, rz = angles
        mx = np.array([[1, 0, 0],
                       [0, math.cos(rx), -math.sin(rx)],
                       [0, math.sin(rx), math.cos(rx)]])
        my = np.array([[math.cos(ry), 0, math.sin(ry)],
                       [0, 1, 0],
                       [-math.sin(ry), 0, math.cos(ry)]])
        mz = np.array([[math.cos(rz), math.sin(rz), 0],
                       [-math.sin(rz), math.cos(rz), 0],
                       [0, 0, 1]])
        m = m @ (mx @ my @ mz)
    return xyz @ m


# ==== crop to budgets ====

def crop(xyz, full_scale, point_range, max_npoint, rng):
    """Crop to voxel-extent and point-count budgets
    (ref: augmentor_utils.py:449-472). xyz is in voxel units, min at 0."""
    xyz_offset = xyz.copy()
    valid = xyz_offset.min(1) >= 0
    scale = np.array([full_scale[1]] * 3, dtype=np.float64)
    room_range = xyz.max(0) - xyz.min(0)
    volume = float(room_range[0] * room_range[1] * room_range[2])
    if volume > point_range:
        shrink = math.sqrt(point_range / volume)
        scale = np.minimum(scale, np.array(
            [shrink * room_range[0], shrink * room_range[1], room_range[2]]))
        valid = (xyz_offset < scale).sum(1) == 3
    while valid.sum() > max_npoint:
        offset = np.clip(scale - room_range + 0.001, None, 0) * rng.random(3)
        xyz_offset = xyz + offset
        valid = valid & (xyz_offset.min(1) >= 0) \
            & ((xyz_offset < scale).sum(1) == 3)
        scale[:2] -= 32
    return xyz_offset, valid


# ==== virtual scan simulation ====

def _camera_candidates(xyz_c, labels, class_names, rng):
    """Free-floor camera candidate positions
    (ref: augmentor_utils.py:178-208). xyz_c: centered coords of the
    label-valid points."""
    vox_scale = 10
    height = xyz_c[:, 2].max()
    v = xyz_c[:, :2] * vox_scale
    vmin = v.min(0)
    vi = np.floor(v - vmin).astype(np.int64)
    shape = vi.max(0) + 3
    img = np.zeros(shape, dtype=bool)
    img[vi[:, 0] + 1, vi[:, 1] + 1] = True
    # occupied (non-walkable) cells: anything that's not floor/ceiling
    blockers = labels != class_names.index('floor')
    if 'ceiling' in class_names:
        blockers &= labels != class_names.index('ceiling')
    bi = vi[blockers]
    img[bi[:, 0] + 1, bi[:, 1] + 1] = False
    k = (min(vox_scale, int(shape[0] / vox_scale)) or 1,
         min(vox_scale, int(shape[1] / vox_scale)) or 1)
    eroded = scipy.ndimage.minimum_filter(img, size=k, mode='constant',
                                          cval=False)
    ys, xs = np.nonzero(eroded)
    cam_xy = (np.stack([ys - 1, xs - 1], 1) + vmin) / vox_scale
    cam_h = rng.random() * height / 2.0 + height / 2.0
    return np.concatenate(
        [cam_xy, np.full((len(cam_xy), 1), cam_h)], axis=1)


def _view_mask(xyz_f, cam_f, mode, camera_view):
    """View-frustum masks, modes fixed/parallel/perspective
    (ref: augmentor_utils.py:216-251)."""
    facing = (xyz_f[:, 0] * cam_f[0] + xyz_f[:, 1] * cam_f[1]
              <= cam_f[0] ** 2 + cam_f[1] ** 2)
    if mode == 'fixed':
        if cam_f[2] > 0:
            return facing & (xyz_f[:, 2] < cam_f[2])
        return facing & (xyz_f[:, 2] > cam_f[2])
    view_angle = camera_view / 180.0 * np.pi
    pitch = np.arcsin(-cam_f[2] / (np.linalg.norm(cam_f) + 1e-9))
    cam_xy = math.sqrt(cam_f[0] ** 2 + cam_f[1] ** 2)
    if mode == 'parallel':
        run = cam_xy
    elif mode == 'perspective':
        proj = xyz_f[:, :2] @ cam_f[:2] / (cam_xy + 1e-9)
        run = cam_xy - proj
    else:
        raise NotImplementedError(mode)
    z_hi = run * np.tan(pitch + view_angle / 2.0) + cam_f[2]
    z_lo = run * np.tan(pitch - view_angle / 2.0) + cam_f[2]
    return facing & (xyz_f[:, 2] < z_hi) & (xyz_f[:, 2] > z_lo)


def depth_buffer_visibility(points, camera, n_az=None, n_el=None,
                            depth_tol=0.15):
    """Visible-point mask via a spherical z-buffer around ``camera``.

    TPU-era replacement for open3d hidden_point_removal
    (ref: augmentor_utils.py:159-163): bin view directions into an
    (azimuth x elevation) grid, keep per-bin minimum range, and accept
    points within ``depth_tol`` (relative) of their bin's minimum. This
    is a direct model of panoramic range-scan occlusion.

    Resolution defaults to ~2 points per angular bin so occlusion
    strength is density-independent. The (2 pts/bin, tol 0.15) defaults
    are calibrated against a scipy reimplementation of the reference's
    Katz spherical-flip HPR at its shipped radius 1000
    (tests/test_vss_distribution.py): per-scene kept-fraction within
    ~0.9x of HPR and per-octant survival correlation ~0.99 on synthetic
    rooms — the earlier (4 pts/bin, tol 0.03) occluded ~2.5x harder
    than the reference's augmentation.
    """
    if n_az is None:
        n_bins = max(64, points.shape[0] // 2)
        n_az = int(math.sqrt(2 * n_bins))
        n_el = max(1, n_az // 2)
    rel = points - camera
    dist = np.linalg.norm(rel, axis=1) + 1e-9
    az = np.arctan2(rel[:, 1], rel[:, 0])            # [-pi, pi)
    el = np.arcsin(np.clip(rel[:, 2] / dist, -1, 1))  # [-pi/2, pi/2]
    ai = np.clip(((az + np.pi) / (2 * np.pi) * n_az).astype(np.int64),
                 0, n_az - 1)
    ei = np.clip(((el + np.pi / 2) / np.pi * n_el).astype(np.int64),
                 0, n_el - 1)
    bins = ai * n_el + ei
    zbuf = np.full(n_az * n_el, np.inf, dtype=np.float64)
    np.minimum.at(zbuf, bins, dist)
    return dist <= zbuf[bins] * (1.0 + depth_tol)


def occlusion_simulation(param, xyz, labels, class_names, rng,
                         ignore_label=255):
    """Multi-view occlusion culling (ref: augmentor_utils.py:116-166).

    Returns a bool keep-mask over all points. Falls back to keeping all
    labeled points when no cameras can be placed."""
    n = xyz.shape[0]
    labeled = labels != ignore_label
    if labeled.sum() == 0:
        return labeled
    idx_labeled = np.nonzero(labeled)[0]
    sel = xyz[labeled]
    center = (sel.min(0) + sel.max(0)) / 2.0
    xyz_c = sel - np.array([center[0], center[1], sel[:, 2].min()])
    cameras = _camera_candidates(xyz_c, labels[labeled], class_names, rng)
    if len(cameras) == 0:
        return labeled
    keep = np.zeros(n, dtype=bool)
    walls = xyz_c[labels[labeled] == class_names.index('wall')]
    views_needed = param['value']
    taken = 0
    tries = 0
    while taken < views_needed:
        cam = cameras[rng.integers(len(cameras))]
        interest = walls[rng.integers(len(walls))] if len(walls) \
            else np.zeros(3)
        cam_f = cam - interest
        xyz_f = xyz_c - interest
        mask = _view_mask(xyz_f, cam_f, param['mode'],
                          param.get('camera_view', 180))
        if mask.sum() < 10:
            tries += 1
            if tries > max(5, views_needed):
                return labeled
            continue
        vis = depth_buffer_visibility(xyz_f[mask], cam_f)
        keep[idx_labeled[np.nonzero(mask)[0][vis]]] = True
        taken += 1
    return keep


def noise_simulation(param, xyz, rng):
    """Uniform jitter noise (ref: augmentor_utils.py:169-175)."""
    rj = param.get('random_jitter')
    if check_key(rj) and check_p(rj, rng):
        xyz = xyz + (rng.random(xyz.shape) - 0.5) * rj['value']
    return xyz


def virtual_scan_simulation(param, xyz, labels, class_names, rng,
                            ignore_label=255):
    """(ref: augmentor_utils.py:108-113)"""
    keep = occlusion_simulation(param, xyz, labels, class_names, rng,
                                ignore_label)
    xyz = noise_simulation(param, xyz, rng)
    return xyz, keep


# ==== tail-aware cuboid mixing ====

def split_space(xyz, split, rng):
    """Randomized cuboid partition of the bounding box
    (ref: augmentor_utils.py:422-441). Returns (split_max (S,3),
    split_range (S,3))."""
    xyz_min, xyz_max = xyz.min(0), xyz.max(0)
    extent = xyz_max - xyz_min + 0.001
    ratios = []
    for s in split:
        cuts = np.cumsum(np.full(s, 1.0 / s))
        cuts = np.append(cuts[:-1] + (rng.random() - 0.5) * 0.2, 1.0)
        ratios.append(cuts)
    ranges = [np.append(r[0], r[1:] - r[:-1]) for r in ratios]
    total = split[0] * split[1] * split[2]
    coord, rng_out = [], []
    for i in range(total):
        ix = i // (split[1] * split[2])
        iy = i % (split[1] * split[2]) // split[2]
        iz = i % split[2]
        coord.append([ratios[0][ix] * extent[0] + xyz_min[0],
                      ratios[1][iy] * extent[1] + xyz_min[1],
                      ratios[2][iz] * extent[2] + xyz_min[2]])
        rng_out.append([ranges[0][ix] * extent[0],
                        ranges[1][iy] * extent[1],
                        ranges[2][iz] * extent[2]])
    return np.array(coord), np.array(rng_out)


def points_in_cuboid(xyz, split_max, split_range):
    """(ref: augmentor_utils.py:444-445)"""
    return np.all(xyz < split_max, axis=-1) \
        & np.all(xyz >= split_max - split_range, axis=-1)


def assign_cuboids(param, xyz, label, split_max, split_range, n_classes,
                   collect_tail=False):
    """Per-point cuboid ids + (optionally) tail-cuboid extraction
    (ref: get_split_idx, augmentor_utils.py:368-384).

    Tail cuboids are (P, 4) arrays [xyz, label] for cuboids whose
    class-density histogram exceeds ``class_thres`` on a tail class."""
    cq = param.get('cuboid_queue', {})
    # -1 marks points outside every cuboid (boundary fallout); indexing
    # with -1 attaches them to the last cuboid, which is also what the
    # reference's int8 overflow of 255 does (augmentor_utils.py:369).
    split_idx = np.full(xyz.shape[0], -1, dtype=np.int32)
    num_tail_cls = cq.get('num_class', 0) if cq else 0
    tail_splits = [[] for _ in range(num_tail_cls)]
    split_status = []
    for s in range(len(split_max)):
        inside = points_in_cuboid(xyz, split_max[s], split_range[s])
        split_idx[inside] = s
        is_tail = False
        if collect_tail and check_key(cq) and inside.sum() > 0 \
                and label[inside].min() < 255 \
                and 'class_thres' in cq:
            dens = np.histogram(label[inside],
                                bins=np.arange(n_classes + 1),
                                density=True)[0]
            status = (dens > np.asarray(cq['class_thres']))[
                np.asarray(cq['tail_class_idx'])]
            is_tail = bool(status.any())
            for i in range(num_tail_cls):
                if status[i]:
                    tail_splits[i].append(np.concatenate(
                        [xyz[inside], label[inside].reshape(-1, 1)], axis=-1))
        split_status.append(is_tail)
    return split_idx, tail_splits, np.array(split_status)


def shift_to_center(xyz, strength=0.1):
    """(ref: transform_xyz, augmentor_utils.py:414-418)"""
    if xyz.shape[0] > 0:
        xyz = xyz - xyz.mean(0) * strength
    return xyz


def tacm(param, split_sampler, class_names, pc_target, pc_source, rng):
    """Tail-Aware Cuboid Mixing (ref: augmentor_utils.py:255-365).

    pc_target / pc_source: (xyz_middle, label) tuples. Returns mixed
    (xyz_middle, label, info) with pc1/pc2 masks, harvested tail cuboids
    per tail class, and the sampled-queue class histogram used for EMA
    ratio updates (ref :359-364).
    """
    xyz1, label1 = pc_target
    xyz2, label2 = pc_source
    xyz1 = xyz1 - (xyz1.min(0) + xyz1.max(0)) / 2.0
    xyz2 = xyz2 - (xyz2.min(0) + xyz2.max(0)) / 2.0
    n_classes = len(class_names)

    smax1, srange1 = split_space(xyz1, param['split'], rng)
    smax2, srange2 = split_space(xyz2, param['split'], rng)
    sidx1, tail_splits, status1 = assign_cuboids(
        param, xyz1, label1, smax1, srange1, n_classes, collect_tail=True)
    sidx2, _, _ = assign_cuboids(param, xyz2, label2, smax2, srange2,
                                 n_classes)
    total = len(smax1)

    # domain per cuboid: 0 = target, 1 = source (ref :272-277)
    if check_p(param, rng):
        seq = (rng.random(total) < param['mix_ratio']).astype(np.int8)
    else:
        seq = np.zeros(total, np.int8)
    n_tar = int(total - seq.sum())
    n_src = int(seq.sum())

    # cuboid permutation (ref :279-299)
    permute = check_p(param.get('permute_cuboid'), rng) \
        and check_key(param.get('permute_cuboid'))
    xyzs = [xyz1.copy(), xyz2.copy()]
    labels = [label1, label2]
    sidxs = [sidx1, sidx2]
    smaxs = [smax1, smax2]
    sranges = [srange1, srange2]
    if permute:
        permuted_max = []
        for d, n_used in ((0, n_tar), (1, n_src)):
            perm = rng.permutation(total)
            sidxs[d] = np.argsort(perm)[sidxs[d]]
            permuted_max.append(smaxs[d][perm][:n_used])
            if d == 0:
                status1 = status1[perm][:n_used]
    else:
        tar_map = np.where(seq == 0, np.cumsum(seq == 0), 0) - 1
        sidxs[0] = tar_map[sidxs[0]]
        status1 = status1[seq == 0]
        src_map = np.where(seq == 1, np.cumsum(seq == 1), 0) - 1
        sidxs[1] = src_map[sidxs[1]]

    # queue-sampled tail cuboids replace trailing target cuboids (ref :300-319)
    cq = param.get('cuboid_queue', {})
    sampled = []
    if check_key(cq) and split_sampler is not None \
            and split_sampler.initialized:
        want = cq['num_cuboid']
        want = int(want // 1) + int(rng.random() < want % 1)
        supp = min(n_tar, want) - int(status1.sum())
        if supp > 0:
            sampled = split_sampler.get_split(supp, rng)
    seq_tar = seq[seq == 0].copy()
    for i in range(len(sampled)):
        seq_tar[-i - 1] = 2
    seq[seq == 0] = seq_tar

    # mixing loop (ref :321-339)
    masks = [np.zeros(len(xyz1), bool), np.zeros(len(xyz2), bool)]
    ptrs = [0, 0, 0]
    out_queue_pts = []
    for s in range(total):
        d = int(seq[s])
        if d == 2:
            cub = sampled[ptrs[2]].copy()
            cub[:, 0:3] += smax1[s] - cub[:, 0:3].max(0)
            cub[:, 0:3] = shift_to_center(cub[:, 0:3])
            out_queue_pts.append(cub)
            ptrs[2] += 1
        else:
            inside = sidxs[d] == ptrs[d]
            if permute and len(permuted_max[d]) > ptrs[d]:
                xyzs[d][inside] += smaxs[d][s] - permuted_max[d][ptrs[d]]
            xyzs[d][inside] = shift_to_center(xyzs[d][inside])
            masks[d][inside] = True
            ptrs[d] += 1

    xyz_t, lab_t = xyzs[0][masks[0]], labels[0][masks[0]]
    xyz_s, lab_s = xyzs[1][masks[1]], labels[1][masks[1]]
    if out_queue_pts:
        qpts = np.concatenate(out_queue_pts, axis=0)
    else:
        qpts = np.zeros((0, 4), dtype=xyz_t.dtype)
    xyz = np.concatenate([xyz_t, xyz_s, qpts[:, 0:3]], axis=0)
    xyz -= xyz.mean(0)
    label = np.concatenate([lab_t, lab_s, qpts[:, 3]], axis=0)

    info = {}
    n1 = len(xyz_t)
    info['pc1_mask'] = np.arange(len(label)) < n1
    info['pc2_mask'] = ~info['pc1_mask']
    info['tar_tail_splits'] = tail_splits
    if check_key(cq) and split_sampler is not None \
            and split_sampler.initialized:
        info['tar_splits_class_ratio'] = np.histogram(
            qpts[:, 3], bins=np.arange(n_classes + 1)
        )[0][np.asarray(cq['tail_class_idx'])]
    else:
        info['tar_splits_class_ratio'] = np.zeros(3)
    return xyz, label, info
