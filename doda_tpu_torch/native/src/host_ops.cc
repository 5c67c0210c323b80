// Native host ops for the data pipeline (C++17, no external deps).
//
// TPU-native counterpart of the reference's CPU extension layer
// (ref: lib/pointgroup_ops/src/voxelize/voxelize.cpp:61-155 — the
// dense_hash_map voxel dedup run inside the collate path, and
// lib/pointops2's knnquery used for full-resolution label broadcast).
// The device pipeline voxelizes on-TPU; these host versions serve the
// input pipeline (deterministic oracle checks, pseudo-label broadcast,
// dataset tooling) without torch or CUDA.
//
// Exposed via a plain C ABI for ctypes (no pybind11 in this image).

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <functional>
#include <initializer_list>
#include <cmath>
#include <unordered_map>
#include <vector>

namespace {

struct Key {
  int32_t x, y, z;
  bool operator==(const Key& o) const {
    return x == o.x && y == o.y && z == o.z;
  }
};

struct KeyHash {
  size_t operator()(const Key& k) const {
    // 3D variant of the Fowler splitmix finalizer; good avalanche for
    // lattice coords.
    uint64_t h = (uint64_t)(uint32_t)k.x * 0x9E3779B185EBCA87ull;
    h ^= (uint64_t)(uint32_t)k.y * 0xC2B2AE3D27D4EB4Full;
    h ^= (uint64_t)(uint32_t)k.z * 0x165667B19E3779F9ull;
    h ^= h >> 31;
    return (size_t)h;
  }
};

}  // namespace

extern "C" {

// Hash-dedup voxelization: first-appearance voxel ids (matching the
// reference's insert-order semantics, voxelize.cpp:88-108).
//
// coords:  (n, 3) int32 (non-negative voxel coords)
// out_p2v: (n,) int32 point -> voxel id
// out_voxels: (n, 3) int32 buffer; first n_voxels rows filled
// returns n_voxels
int32_t voxelize_unique(const int32_t* coords, int64_t n,
                        int32_t* out_p2v, int32_t* out_voxels) {
  std::unordered_map<Key, int32_t, KeyHash> map;
  map.reserve((size_t)n * 2);
  int32_t next = 0;
  for (int64_t i = 0; i < n; ++i) {
    Key k{coords[3 * i], coords[3 * i + 1], coords[3 * i + 2]};
    auto it = map.find(k);
    if (it == map.end()) {
      it = map.emplace(k, next).first;
      out_voxels[3 * next] = k.x;
      out_voxels[3 * next + 1] = k.y;
      out_voxels[3 * next + 2] = k.z;
      ++next;
    }
    out_p2v[i] = it->second;
  }
  return next;
}

// Scatter-mean of point features into voxels (ref voxelize.cu:10-31,
// mode 4). feats (n, c) f32, p2v (n,) int32 -> out (n_voxels, c).
void voxelize_mean(const float* feats, const int32_t* p2v, int64_t n,
                   int64_t c, int64_t n_voxels, float* out) {
  std::vector<int32_t> cnt((size_t)n_voxels, 0);
  std::memset(out, 0, sizeof(float) * (size_t)n_voxels * (size_t)c);
  for (int64_t i = 0; i < n; ++i) {
    int32_t v = p2v[i];
    ++cnt[(size_t)v];
    float* dst = out + (int64_t)v * c;
    const float* src = feats + i * c;
    for (int64_t j = 0; j < c; ++j) dst[j] += src[j];
  }
  for (int64_t v = 0; v < n_voxels; ++v) {
    float inv = cnt[(size_t)v] ? 1.0f / cnt[(size_t)v] : 0.0f;
    float* dst = out + v * c;
    for (int64_t j = 0; j < c; ++j) dst[j] *= inv;
  }
}

// 1-NN index from each query to the source set via a uniform hash grid
// (the crop/downsample -> full-resolution label broadcast,
// ref model/unet.py:135-145 + lib/pointops2 knnquery).
//
// src (n_src, 3) f32, queries (n_q, 3) f32, cell: grid cell size.
// out_idx (n_q,) int32.
void nn1_grid(const float* src, int64_t n_src, const float* q,
              int64_t n_q, float cell, int32_t* out_idx) {
  if (n_src == 0) {
    for (int64_t i = 0; i < n_q; ++i) out_idx[i] = 0;
    return;
  }
  auto cellkey = [cell](float x, float y, float z) {
    Key k{(int32_t)std::floor(x / cell), (int32_t)std::floor(y / cell),
          (int32_t)std::floor(z / cell)};
    return k;
  };
  std::unordered_map<Key, std::vector<int32_t>, KeyHash> grid;
  grid.reserve((size_t)n_src * 2);
  for (int64_t i = 0; i < n_src; ++i) {
    grid[cellkey(src[3 * i], src[3 * i + 1], src[3 * i + 2])].push_back(
        (int32_t)i);
  }
  for (int64_t i = 0; i < n_q; ++i) {
    const float qx = q[3 * i], qy = q[3 * i + 1], qz = q[3 * i + 2];
    int32_t best = -1;
    float best_d = INFINITY;
    // expand rings until a neighbor is found and the ring bound exceeds it
    for (int32_t ring = 0; ring < 64; ++ring) {
      Key c0 = cellkey(qx, qy, qz);
      for (int32_t dx = -ring; dx <= ring; ++dx)
        for (int32_t dy = -ring; dy <= ring; ++dy)
          for (int32_t dz = -ring; dz <= ring; ++dz) {
            if (std::max(std::max(std::abs(dx), std::abs(dy)), std::abs(dz))
                != ring)
              continue;  // surface of the ring only
            auto it = grid.find(Key{c0.x + dx, c0.y + dy, c0.z + dz});
            if (it == grid.end()) continue;
            for (int32_t j : it->second) {
              float ddx = src[3 * j] - qx, ddy = src[3 * j + 1] - qy,
                    ddz = src[3 * j + 2] - qz;
              float d = ddx * ddx + ddy * ddy + ddz * ddz;
              if (d < best_d) { best_d = d; best = j; }
            }
          }
      if (best >= 0 && best_d <= (float)ring * ring * cell * cell) break;
    }
    if (best < 0) {  // extremely sparse fallback: brute force
      for (int64_t j = 0; j < n_src; ++j) {
        float ddx = src[3 * j] - qx, ddy = src[3 * j + 1] - qy,
              ddz = src[3 * j + 2] - qz;
        float d = ddx * ddx + ddy * ddy + ddz * ddz;
        if (d < best_d) { best_d = d; best = (int32_t)j; }
      }
    }
    out_idx[i] = best;
  }
}

// Connected components over a radius graph restricted to equal keys
// (the host twin of ops/pointops.bfs_cluster; ref bfs_cluster.cpp:28-75).
// Union-find instead of BFS. xyz (n,3) f32, key (n,) int32, radius.
// out (n,) int32 component ids (dense, by first appearance).
void connected_components(const float* xyz, const int32_t* key, int64_t n,
                          float radius, int32_t* out) {
  std::vector<int32_t> parent((size_t)n);
  for (int64_t i = 0; i < n; ++i) parent[(size_t)i] = (int32_t)i;
  std::function<int32_t(int32_t)> find = [&](int32_t a) {
    while (parent[(size_t)a] != a) {
      parent[(size_t)a] = parent[(size_t)parent[(size_t)a]];
      a = parent[(size_t)a];
    }
    return a;
  };
  const float r2 = radius * radius;
  std::unordered_map<Key, std::vector<int32_t>, KeyHash> grid;
  auto cellkey = [radius](const float* p) {
    return Key{(int32_t)std::floor(p[0] / radius),
               (int32_t)std::floor(p[1] / radius),
               (int32_t)std::floor(p[2] / radius)};
  };
  for (int64_t i = 0; i < n; ++i) grid[cellkey(xyz + 3 * i)].push_back(
      (int32_t)i);
  for (int64_t i = 0; i < n; ++i) {
    Key c0 = cellkey(xyz + 3 * i);
    for (int32_t dx = -1; dx <= 1; ++dx)
      for (int32_t dy = -1; dy <= 1; ++dy)
        for (int32_t dz = -1; dz <= 1; ++dz) {
          auto it = grid.find(Key{c0.x + dx, c0.y + dy, c0.z + dz});
          if (it == grid.end()) continue;
          for (int32_t j : it->second) {
            if (j <= (int32_t)i || key[j] != key[i]) continue;
            float ax = xyz[3 * i] - xyz[3 * j],
                  ay = xyz[3 * i + 1] - xyz[3 * j + 1],
                  az = xyz[3 * i + 2] - xyz[3 * j + 2];
            if (ax * ax + ay * ay + az * az <= r2) {
              int32_t ra = find((int32_t)i), rb = find(j);
              if (ra != rb) parent[(size_t)std::max(ra, rb)] =
                  std::min(ra, rb);
            }
          }
        }
  }
  std::unordered_map<int32_t, int32_t> remap;
  int32_t next = 0;
  for (int64_t i = 0; i < n; ++i) {
    int32_t r = find((int32_t)i);
    auto it = remap.find(r);
    if (it == remap.end()) it = remap.emplace(r, next++).first;
    out[i] = it->second;
  }
}

// Trilinear interpolation of 3 noise fields for elastic distortion
// (the host twin of data/augmentor/aug_ops._trilinear_regular; ref
// augmentor_utils.py:61-80). The NumPy form materializes eight (3, N)
// gathered corner arrays per call and was the input pipeline's hottest
// loop (~0.3 s per 150k-point scene); this fused walk runs ~10x faster.
//
// noise: (3, dims[0]*dims[1]*dims[2]) f32, C-order per field
// xyz:   (n, 3) f64 point coords (voxel units)
// out:   (n, 3) f64 <- xyz + offset * mag; out-of-grid points copy xyz
void elastic_offsets(const float* noise, const int32_t* dims, double gran,
                     double mag, const double* xyz, int64_t n,
                     double* out) {
  const int64_t dx_ = dims[0], dy_ = dims[1], dz_ = dims[2];
  const int64_t cells = dx_ * dy_ * dz_;
  const int64_t sy = dy_ * dz_, sz = dz_;
  const float* n0 = noise;
  const float* n1 = noise + cells;
  const float* n2 = noise + 2 * cells;
  const double inv = 1.0 / (2.0 * gran);
  for (int64_t i = 0; i < n; ++i) {
    double u[3], f[3];
    int64_t i0[3];
    bool oob = false;
    for (int a = 0; a < 3; ++a) {
      const int64_t d = dims[a];
      u[a] = (xyz[3 * i + a] + (d - 1) * gran) * inv;
      if (u[a] < 0.0 || u[a] > (double)(d - 1)) oob = true;
      int64_t lo = (int64_t)std::floor(u[a]);
      if (lo < 0) lo = 0;
      if (lo > d - 2) lo = d - 2;
      i0[a] = lo;
      f[a] = u[a] - (double)lo;
    }
    if (oob) {
      out[3 * i] = xyz[3 * i];
      out[3 * i + 1] = xyz[3 * i + 1];
      out[3 * i + 2] = xyz[3 * i + 2];
      continue;
    }
    const int64_t base = i0[0] * sy + i0[1] * sz + i0[2];
    const double w0x = 1.0 - f[0], w0y = 1.0 - f[1], w0z = 1.0 - f[2];
    double acc0 = 0.0, acc1 = 0.0, acc2 = 0.0;
    for (int cx = 0; cx < 2; ++cx)
      for (int cy = 0; cy < 2; ++cy)
        for (int cz = 0; cz < 2; ++cz) {
          const double w = (cx ? f[0] : w0x) * (cy ? f[1] : w0y)
              * (cz ? f[2] : w0z);
          const int64_t idx = base + cx * sy + cy * sz + cz;
          acc0 += w * (double)n0[idx];
          acc1 += w * (double)n1[idx];
          acc2 += w * (double)n2[idx];
        }
    out[3 * i] = xyz[3 * i] + acc0 * mag;
    out[3 * i + 1] = xyz[3 * i + 1] + acc1 * mag;
    out[3 * i + 2] = xyz[3 * i + 2] + acc2 * mag;
  }
}

}  // extern "C"
