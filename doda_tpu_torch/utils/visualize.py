"""Offline visualization: color-coded PLY export per dataset.

Port of ``doda_tpu/utils/visualize.py`` (numpy only, so a copy): the
reference's open3d viewers (ref: util/visualize_scannet.py,
visualize_s3dis.py, visualize_3dfront.py + palettes in
visualize_utils.py) replaced with dependency-free ASCII PLY writers whose
files open in MeshLab, CloudCompare or any viewer, byte for byte the JAX
package's. Same three modes: input (height-colored), ground truth,
prediction.
"""

from __future__ import annotations

import numpy as np

# per-dataset class palettes (RGB 0-255), one color per class id;
# ignore (255) renders gray
_PALETTES = {
    'scannet': [
        (174, 199, 232), (152, 223, 138), (31, 119, 180), (255, 187, 120),
        (188, 189, 34), (140, 86, 75), (255, 152, 150), (214, 39, 40),
        (197, 176, 213), (148, 103, 189), (196, 156, 148), (23, 190, 207),
        (247, 182, 210), (219, 219, 141), (255, 127, 14), (158, 218, 229),
        (44, 160, 44), (112, 128, 144), (227, 119, 194), (82, 84, 163),
    ],
    's3dis': [
        (174, 199, 232), (152, 223, 138), (31, 119, 180), (255, 187, 120),
        (188, 189, 34), (140, 86, 75), (255, 152, 150), (214, 39, 40),
        (197, 176, 213), (148, 103, 189), (196, 156, 148), (23, 190, 207),
        (112, 128, 144),
    ],
}
_IGNORE_COLOR = (128, 128, 128)


def class_palette(dataset_or_n):
    """Palette for a dataset name or an arbitrary class count."""
    if isinstance(dataset_or_n, str) and dataset_or_n in _PALETTES:
        return np.array(_PALETTES[dataset_or_n], np.uint8)
    n = dataset_or_n if isinstance(dataset_or_n, int) else 20
    rng = np.random.default_rng(7)
    return rng.integers(40, 255, (n, 3)).astype(np.uint8)


def write_ply(path, xyz, colors):
    """Write an ASCII PLY point cloud (xyz f32, colors uint8 (N, 3))."""
    xyz = np.asarray(xyz, np.float32)
    colors = np.asarray(colors, np.uint8)
    with open(path, 'w') as f:
        f.write('ply\nformat ascii 1.0\n'
                f'element vertex {len(xyz)}\n'
                'property float x\nproperty float y\nproperty float z\n'
                'property uchar red\nproperty uchar green\n'
                'property uchar blue\nend_header\n')
        for (x, y, z), (r, g, b) in zip(xyz, colors):
            f.write(f'{x:.4f} {y:.4f} {z:.4f} {r} {g} {b}\n')


def colorize_labels(labels, palette, ignore_label=255):
    labels = np.asarray(labels).astype(np.int64)
    colors = np.full((len(labels), 3), _IGNORE_COLOR, np.uint8)
    ok = (labels >= 0) & (labels < len(palette))
    colors[ok] = palette[labels[ok]]
    return colors


def colorize_height(xyz):
    """Input mode: color by normalized height (the reference's raw-scene
    view without rgb)."""
    z = np.asarray(xyz)[:, 2].astype(np.float64)
    t = (z - z.min()) / (np.ptp(z) + 1e-9)
    colors = np.stack([255 * t, 80 + 100 * t, 255 * (1 - t)], 1)
    return colors.astype(np.uint8)


def visualize_scene(out_prefix, xyz, labels=None, preds=None,
                    dataset='scannet', ignore_label=255):
    """Dump input/gt/pred PLYs like the reference viewers
    (ref: util/visualize_scannet.py:20-73 --mode input|gt|pred)."""
    palette = class_palette(dataset)
    write_ply(f'{out_prefix}_input.ply', xyz, colorize_height(xyz))
    if labels is not None:
        write_ply(f'{out_prefix}_gt.ply', xyz,
                  colorize_labels(labels, palette, ignore_label))
    if preds is not None:
        write_ply(f'{out_prefix}_pred.ply', xyz,
                  colorize_labels(preds, palette, ignore_label))
