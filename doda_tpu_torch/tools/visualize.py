"""Offline visualization CLI of the port (ref:
util/visualize_{scannet,s3dis,3dfront}.py).

Port of ``tools/visualize.py``, with its arguments. Exports color-coded
PLY files of a scene's input (by height), ground truth and, from the txt
dumps that ``doda_tpu_torch.tools.test --save_to_file`` writes, its
predictions::

    python -m doda_tpu_torch.tools.visualize --dataset scannet \\
        --data_root data/scannetv2 --split val --scene scene0011_00 \\
        --result_dir output/scannet/spconv/default/eval/txt --out /tmp/vis
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..utils.visualize import visualize_scene


def load_scene(dataset, data_root, split, scene):
    """(xyz, labels) of one scene file of ``dataset``'s layout."""
    if dataset == 'scannet':
        import torch
        data = torch.load(os.path.join(data_root, split, scene + '.pth'),
                          weights_only=False)
        xyz = np.asarray(data[0])
        labels = np.asarray(data[2]) if len(data) > 2 else None
        return xyz, labels
    if dataset == 's3dis':
        data = np.load(os.path.join(data_root, scene + '.npy'))
        return data[:, 0:3], data[:, 6].astype(np.int64)
    if dataset == 'front3d':
        data = np.load(os.path.join(data_root, scene + '.npy'),
                       allow_pickle=True)
        return data[:, 0:3], data[:, 6].astype(np.int64)
    raise NotImplementedError(dataset)


def main(argv=None):
    """Write ``<out>/<scene>_{input,gt,pred}.ply``; returns their prefix."""
    ap = argparse.ArgumentParser()
    ap.add_argument('--dataset', required=True,
                    choices=['scannet', 's3dis', 'front3d'])
    ap.add_argument('--data_root', required=True)
    ap.add_argument('--split', default='val')
    ap.add_argument('--scene', required=True)
    ap.add_argument('--result_dir', default=None,
                    help='eval txt dump dir for predictions')
    ap.add_argument('--out', default='./vis')
    args = ap.parse_args(argv)

    xyz, labels = load_scene(args.dataset, args.data_root, args.split,
                             args.scene)
    preds = None
    if args.result_dir:
        pred_file = os.path.join(args.result_dir, args.scene + '.txt')
        preds = np.loadtxt(pred_file, dtype=np.int64)
    os.makedirs(args.out, exist_ok=True)
    prefix = os.path.join(args.out, args.scene)
    visualize_scene(prefix, xyz, labels, preds, dataset=args.dataset)
    print(f'wrote {prefix}_{{input,gt,pred}}.ply')
    return prefix


if __name__ == '__main__':
    main()
