"""ctypes bindings for the native host-ops library of the data path.

Port of ``doda_tpu/native/host_ops.py``. The C++ source is the port's own
copy (``src/host_ops.cc``); it is compiled with g++ at first use into
``build/`` at the repo root (``ops/_build.build_host``: hash-keyed,
file-locked, the flags of the JAX package's Makefile), so no binary is
committed. A failed build raises.

Every entry point takes the native path. The NumPy/scipy versions stay
where the JAX module has them, as the plain twins: ``native=False`` runs
them (tests hold the library to them).

Reference counterparts: the CPU voxel hash (lib/pointgroup_ops/src/
voxelize/voxelize.cpp:61-155), knnquery-based label broadcast
(model/unet.py:135-145) and the BFS clustering host path
(lib/pointgroup_ops/src/bfs_cluster/bfs_cluster.cpp:28-75). The port's
own voxelization runs on the device (``ops/voxelize.py``); the voxel hash
here is the host path the JAX package also keeps.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / 'src' / 'host_ops.cc'


@functools.lru_cache(maxsize=None)
def _load():
    """The built library with its C signatures; builds it if needed."""
    from ..ops._build import build_host
    lib = ctypes.CDLL(str(build_host(SRC, 'doda_host')))
    i32p = ctypes.POINTER(ctypes.c_int32)
    f32p = ctypes.POINTER(ctypes.c_float)
    f64p = ctypes.POINTER(ctypes.c_double)
    lib.voxelize_unique.restype = ctypes.c_int32
    lib.voxelize_unique.argtypes = [i32p, ctypes.c_int64, i32p, i32p]
    lib.voxelize_mean.restype = None
    lib.voxelize_mean.argtypes = [f32p, i32p, ctypes.c_int64,
                                  ctypes.c_int64, ctypes.c_int64, f32p]
    lib.nn1_grid.restype = None
    lib.nn1_grid.argtypes = [f32p, ctypes.c_int64, f32p, ctypes.c_int64,
                             ctypes.c_float, i32p]
    lib.connected_components.restype = None
    lib.connected_components.argtypes = [f32p, i32p, ctypes.c_int64,
                                         ctypes.c_float, i32p]
    lib.elastic_offsets.restype = None
    lib.elastic_offsets.argtypes = [f32p, i32p, ctypes.c_double,
                                    ctypes.c_double, f64p, ctypes.c_int64,
                                    f64p]
    return lib


def native_available() -> bool:
    """Whether the host library builds and loads here (g++ present)."""
    try:
        _load()
    except (RuntimeError, OSError):
        return False
    return True


def _ptr(a, typ):
    return a.ctypes.data_as(typ)


def voxelize_unique(coords: np.ndarray, native: bool = True):
    """coords (n, 3) int -> (p2v (n,), voxel_coords (m, 3)), voxel ids in
    order of first appearance (the reference's insert order)."""
    coords = np.ascontiguousarray(coords, np.int32)
    n = len(coords)
    if not native:
        uniq, p2v = np.unique(coords, axis=0, return_inverse=True)
        p2v = p2v.reshape(-1)
        # np.unique sorts; renumber by first appearance
        first = np.full(len(uniq), n, np.int64)
        np.minimum.at(first, p2v, np.arange(n))
        order = np.argsort(first, kind='stable')
        rank = np.empty_like(order)
        rank[order] = np.arange(len(uniq))
        return rank[p2v].astype(np.int32), uniq[order].astype(np.int32)
    lib = _load()
    p2v = np.empty(n, np.int32)
    vox = np.empty((max(n, 1), 3), np.int32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    m = lib.voxelize_unique(_ptr(coords, i32p), n, _ptr(p2v, i32p),
                            _ptr(vox, i32p))
    return p2v, vox[:m].copy()


def voxelize_mean(feats: np.ndarray, p2v: np.ndarray, n_voxels: int,
                  native: bool = True):
    """Scatter-mean (n, c) point features into (n_voxels, c)."""
    feats = np.ascontiguousarray(feats, np.float32)
    p2v = np.ascontiguousarray(p2v, np.int32)
    if not native:
        out = np.zeros((n_voxels, feats.shape[1]), np.float32)
        np.add.at(out, p2v, feats)
        cnt = np.bincount(p2v, minlength=n_voxels)[:, None]
        return out / np.maximum(cnt, 1)
    lib = _load()
    out = np.empty((n_voxels, feats.shape[1]), np.float32)
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.voxelize_mean(_ptr(feats, f32p), _ptr(p2v, i32p), len(feats),
                      feats.shape[1], n_voxels, _ptr(out, f32p))
    return out


def nn1(src: np.ndarray, queries: np.ndarray, cell: float = 0.1,
        native: bool = True):
    """1-NN index of each query into src (grid-hash accelerated)."""
    src = np.ascontiguousarray(src, np.float32)
    queries = np.ascontiguousarray(queries, np.float32)
    if not native:
        from scipy.spatial import cKDTree
        return cKDTree(src).query(queries, k=1)[1].astype(np.int32)
    lib = _load()
    out = np.empty(len(queries), np.int32)
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.nn1_grid(_ptr(src, f32p), len(src), _ptr(queries, f32p),
                 len(queries), ctypes.c_float(cell), _ptr(out, i32p))
    return out


def elastic_interp(noise3: np.ndarray, dims, gran: float, mag: float,
                   xyz: np.ndarray):
    """xyz + trilinear(noise3, xyz) * mag — the elastic-distortion
    lookup. Its plain twin is ``aug_ops._trilinear_regular``."""
    lib = _load()
    noise3 = np.ascontiguousarray(noise3, np.float32)
    dims_a = np.ascontiguousarray(dims, np.int32)
    xyz64 = np.ascontiguousarray(xyz, np.float64)
    out = np.empty_like(xyz64)
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    f64p = ctypes.POINTER(ctypes.c_double)
    lib.elastic_offsets(_ptr(noise3, f32p), _ptr(dims_a, i32p),
                        ctypes.c_double(gran), ctypes.c_double(mag),
                        _ptr(xyz64, f64p), len(xyz64), _ptr(out, f64p))
    return out


def connected_components(xyz: np.ndarray, key: np.ndarray, radius: float,
                         native: bool = True):
    """Union-find components over the radius graph restricted to equal
    ``key``, numbered by first appearance."""
    xyz = np.ascontiguousarray(xyz, np.float32)
    key = np.ascontiguousarray(key, np.int32)
    if not native:
        from scipy.spatial import cKDTree
        import scipy.sparse as sp
        tree = cKDTree(xyz)
        pairs = tree.query_pairs(radius, output_type='ndarray')
        pairs = pairs[key[pairs[:, 0]] == key[pairs[:, 1]]]
        n = len(xyz)
        g = sp.coo_matrix((np.ones(len(pairs)),
                           (pairs[:, 0], pairs[:, 1])), shape=(n, n))
        n_c, labels = sp.csgraph.connected_components(g, directed=False)
        # densify by first appearance
        first = {}
        out = np.empty(n, np.int32)
        for i, l in enumerate(labels):
            out[i] = first.setdefault(l, len(first))
        return out
    lib = _load()
    out = np.empty(len(xyz), np.int32)
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.connected_components(_ptr(xyz, f32p), _ptr(key, i32p), len(xyz),
                             ctypes.c_float(radius), _ptr(out, i32p))
    return out
