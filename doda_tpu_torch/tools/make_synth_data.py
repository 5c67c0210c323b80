"""Generate synthetic room scans in the dataset formats the readers expect.

A copy of ``tools/make_synth_data.py``, so that the port writes its own
ScanNet-, S3DIS- and 3D-FRONT-format rooms. Used for smoke/bench runs when
the real data is unavailable: rooms have floor/wall planes plus box
"furniture" so occupancy statistics roughly match indoor scans.

    python -m doda_tpu_torch.tools.make_synth_data --root /tmp/synth \
        --dataset scannet --n_train 8 --n_val 4 --points 80000
"""

import argparse
import os

import numpy as np


def synth_room(rng, n_points, n_classes=20):
    size = rng.uniform(4.0, 8.0, size=2)
    height = rng.uniform(2.4, 3.2)
    parts = []
    labels = []

    def plane(n, axis, at, extent, label):
        p = rng.uniform(0, 1, (n, 3)) * extent
        p[:, axis] = at + rng.normal(0, 0.01, n)
        parts.append(p)
        labels.append(np.full(n, label))

    n_floor = n_points // 3
    n_wall = n_points // 4
    plane(n_floor, 2, 0.0, np.array([size[0], size[1], 1.0]), 1)  # floor
    plane(n_wall, 1, 0.0, np.array([size[0], 1.0, height]), 0)    # wall
    plane(n_wall, 0, 0.0, np.array([1.0, size[1], height]), 0)    # wall
    n_rest = n_points - n_floor - 2 * n_wall
    n_obj = max(1, n_rest // 6)
    for _ in range(6):
        c = rng.uniform(0.5, 1.0, 3) * np.array([size[0] - 1, size[1] - 1,
                                                 1.2])
        o = rng.uniform(0, 1, (n_obj, 3)) * rng.uniform(0.3, 1.2, 3) + c * \
            np.array([1, 1, 0])
        parts.append(o)
        labels.append(np.full(n_obj, int(rng.integers(2, n_classes))))
    xyz = np.concatenate(parts)[:n_points].astype(np.float64)
    label = np.concatenate(labels)[:n_points].astype(np.int64)
    xyz -= xyz.mean(0)
    return xyz, label


def make_scannet(root, n_train, n_val, n_points, rng):
    import torch
    for split, n in (('train', n_train), ('val', n_val)):
        d = os.path.join(root, 'scannetv2', split)
        os.makedirs(d, exist_ok=True)
        for i in range(n):
            xyz, label = synth_room(rng, n_points)
            rgb = rng.uniform(-1, 1, xyz.shape).astype(np.float32)
            torch.save((xyz.astype(np.float32), rgb, label),
                       os.path.join(d, f'scene{i:04d}_00.pth'))


def make_s3dis(root, n_train, n_val, n_points, rng):
    d = os.path.join(root, 's3dis', 'trainval_fullarea')
    os.makedirs(d, exist_ok=True)
    for area, n in ((1, n_train), (5, n_val)):
        for i in range(n):
            xyz, label = synth_room(rng, n_points, n_classes=13)
            rgb = rng.uniform(0, 255, xyz.shape)
            data = np.concatenate(
                [xyz, rgb, label[:, None].astype(np.float64)], axis=1)
            np.save(os.path.join(d, f'Area_{area}_room_{i}.npy'), data)


def make_front3d(root, n_train, n_val, n_points, rng):
    base = os.path.join(root, '3dfront', 'density1250')
    os.makedirs(os.path.join(base, 'rooms'), exist_ok=True)
    lists = {'train': [], 'val': []}
    for split, n in (('train', n_train), ('val', n_val)):
        for i in range(n):
            xyz, label = synth_room(rng, n_points, n_classes=71)
            # use raw 3D-FRONT label ids that map to real classes
            raw = np.array([37, 42, 4, 17, 25, 12, 0, 46, 56, 2, 24])
            label = raw[label % len(raw)]
            rgb = rng.uniform(0, 255, xyz.shape)
            data = np.concatenate(
                [xyz, rgb, label[:, None].astype(np.float64)], axis=1)
            name = f'rooms/{split}_room_{i}.npy'
            np.save(os.path.join(base, name), data)
            lists[split].append(name)
    for split, names in lists.items():
        with open(os.path.join(root, '3dfront', f'{split}_list.txt'),
                  'w') as f:
            f.write('\n'.join(names) + '\n')


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--root', required=True)
    ap.add_argument('--dataset', default='scannet',
                    choices=['scannet', 's3dis', 'front3d', 'all'])
    ap.add_argument('--n_train', type=int, default=8)
    ap.add_argument('--n_val', type=int, default=4)
    ap.add_argument('--points', type=int, default=80000)
    ap.add_argument('--seed', type=int, default=0)
    args = ap.parse_args()
    rng = np.random.default_rng(args.seed)
    makers = {'scannet': make_scannet, 's3dis': make_s3dis,
              'front3d': make_front3d}
    targets = makers if args.dataset == 'all' else \
        {args.dataset: makers[args.dataset]}
    for name, fn in targets.items():
        fn(args.root, args.n_train, args.n_val, args.points, rng)
        print(f'{name}: wrote {args.n_train} train / {args.n_val} val '
              f'scenes under {args.root}')


if __name__ == '__main__':
    main()
