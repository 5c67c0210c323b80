"""Cross-domain class vocabulary mappers.

A copy of ``doda_tpu/data/class_mapper.py``. It re-encodes the
label-mapping *data* of the reference's six JSON mapper
files (ref: dataset/class_mapper/*.json, loaded by
dataset/dataset.py:52-64) as Python tables: each DA pair shares one common
class vocabulary plus a raw-label -> common-name dict per dataset.
``get_mapper`` accepts both the short pair name ("3dfront_2_scannet") and
the reference-style file path ("dataset/class_mapper/3dfront_2_scannet.json")
so configs keep working verbatim, and returns the same 256-entry int64
remap table the reference builds (unmapped labels -> 255).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

# common vocabulary for the 3D-FRONT <-> ScanNet pair
VOCAB_FRONT_SCANNET = ['wall', 'floor', 'cabinet', 'bed', 'chair', 'sofa',
                       'table', 'door', 'window', 'bookshelf', 'desk']
# common vocabulary for the 3D-FRONT <-> S3DIS pair
VOCAB_FRONT_S3DIS = ['wall', 'floor', 'chair', 'sofa', 'table', 'door',
                     'window', 'bookshelf', 'ceiling', 'beam', 'column']
# common vocabulary for the S3DIS <-> ScanNet pair
VOCAB_S3DIS_SCANNET = ['wall', 'floor', 'chair', 'sofa', 'table', 'door',
                       'window', 'bookshelf']


def _expand(groups: dict) -> dict:
    """{name: [raw ids]} -> {raw id: name}."""
    out = {}
    for name, ids in groups.items():
        for i in ids:
            out[i] = name
    return out


# raw 3D-FRONT labels (71-class scheme, cfgs/dataset_cfgs/front3d) grouped
# by the ScanNet-pair common name
FRONT3D_TO_SCANNET_VOCAB = _expand({
    'cabinet': [0, 3, 6, 7, 8, 9],
    'bookshelf': [2],
    'table': [4, 11, 22, 23],
    'desk': [24],
    'chair': [17, 18, 19, 20, 21],
    'bed': [12, 13, 14, 15, 16],
    'sofa': [25, 26, 27, 28, 29, 30],
    'wall': [37, 50, 60, 62, 63, 65, 68, 70],
    'floor': [42],
    'window': [46, 54],
    'door': [56, 64],
})

# same raw labels grouped by the S3DIS-pair common name (note: 'Desk' (24)
# merges into table here; ceilings/columns/beams appear)
FRONT3D_TO_S3DIS_VOCAB = _expand({
    'bookshelf': [2],
    'table': [4, 11, 22, 23, 24],
    'chair': [17, 18, 19, 20, 21],
    'sofa': [25, 26, 27, 28, 29, 30],
    'wall': [37, 50, 60, 62, 63, 65, 68, 70],
    'ceiling': [38, 41, 67, 69],
    'floor': [42],
    'window': [46, 54],
    'column': [48],
    'beam': [58],
    'door': [56, 64],
})

# raw ScanNet 20-class ids -> common names
SCANNET_TO_FRONT_VOCAB = _expand({
    'wall': [0], 'floor': [1], 'cabinet': [2], 'bed': [3], 'chair': [4],
    'sofa': [5], 'table': [6], 'door': [7], 'window': [8],
    'bookshelf': [9], 'desk': [12],
})
SCANNET_TO_S3DIS_VOCAB = _expand({
    'wall': [0], 'floor': [1], 'chair': [4], 'sofa': [5], 'table': [6],
    'door': [7], 'window': [8], 'bookshelf': [9],
})

# raw S3DIS 13-class ids -> common names
S3DIS_TO_FRONT_VOCAB = _expand({
    'ceiling': [0], 'floor': [1], 'wall': [2], 'beam': [3], 'column': [4],
    'window': [5], 'door': [6], 'table': [7], 'chair': [8], 'sofa': [9],
    'bookshelf': [10],
})
S3DIS_TO_SCANNET_VOCAB = _expand({
    'floor': [1], 'wall': [2], 'window': [5], 'door': [6], 'table': [7],
    'chair': [8], 'sofa': [9], 'bookshelf': [10],
})

# pair name -> (common class names, src raw-label -> name)
MAPPERS = {
    '3dfront_2_scannet': (VOCAB_FRONT_SCANNET, FRONT3D_TO_SCANNET_VOCAB),
    'scannet_2_3dfront': (VOCAB_FRONT_SCANNET, SCANNET_TO_FRONT_VOCAB),
    '3dfront_2_s3dis': (VOCAB_FRONT_S3DIS, FRONT3D_TO_S3DIS_VOCAB),
    's3dis_2_3dfront': (VOCAB_FRONT_S3DIS, S3DIS_TO_FRONT_VOCAB),
    's3dis_2_scannet': (VOCAB_S3DIS_SCANNET, S3DIS_TO_SCANNET_VOCAB),
    'scannet_2_s3dis': (VOCAB_S3DIS_SCANNET, SCANNET_TO_S3DIS_VOCAB),
}


def get_mapper(name_or_path):
    """Return (remapper[256] int64, common_class_names) like ref
    ``Dataset.load_mapper_file`` (dataset/dataset.py:52-64), or
    (None, None) when no mapper is configured."""
    if name_or_path is None:
        return None, None
    name = Path(str(name_or_path)).stem
    if name not in MAPPERS:
        raise KeyError(f'unknown class mapper: {name_or_path}')
    class_names, src = MAPPERS[name]
    remapper = np.full(256, 255, dtype=np.int64)
    for raw, cname in src.items():
        remapper[int(raw)] = class_names.index(cname)
    return remapper, list(class_names)
