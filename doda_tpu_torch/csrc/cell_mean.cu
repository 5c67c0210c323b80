// The point -> cell reduction over brickify's (brick, cell)-sorted stream,
// and the voxel -> point gather's backward, which is the same sum.
//
// Replaces no TPU kernel: it is the port of the JAX package's default
// reduction, doda_tpu/ops/bricks.py::_brick_feats_sorted, which is plain
// XLA (a float32 cumsum over lane-expanded rows, differences at run ends).
// It was added so that neither the point -> cell mean nor the transpose of
// the voxel -> point gather needs float atomics on the card: index_add_
// (ops/bricks.py::cell_feats_2d, and index_select's autograd backward)
// sums a cell's points in an order that changes from call to call, and a
// float cumsum on CUDA is no more reproducible (nor precise: its prefix
// grows with the stream).
//
// For feats (N, C) float32 and the stream sort_cell (N,) int32 (flat cell
// id in [0, n_cells), n_cells = rows * cells, any larger id for none) and
// sort_pos (N,) int32 (the feats row of each slot), cut into `scenes`
// equal segments, it writes the dense out (rows, cells * C), float32 or
// bf16:
//
//     out[id, :] = sum of feats[sort_pos[j], :] over the run of id
//                  (mode 3), divided by the run's length (mode 4),
//     out[id, :] = 0 where no slot holds id.
//
// The stream's contract: segment s holds the ids of rows [s * rows /
// scenes, (s + 1) * rows / scenes) in ascending order, then its null ids.
// brickify leaves one scene's stream so; models/unet.py::batch_stream
// concatenates the scenes' (one segment a scene). A cell's slots are
// adjacent, in point order.
//
// What bounds it on an H100: bytes. The dense output dominates: at brick
// side 4, batch 4, 40,960 bricks a scene and C = 3 it is 4 x 40,960 x 64 x
// 3 x 4 bytes = 126 MB (0.038 ms at 3.35 TB/s), against 7.9 MB of
// features and 5.2 MB of stream for 655,360 points. As the gather's
// backward (C = 16, the float32 cotangent in, the bf16 cell table out) it
// writes 336 MB. It does one FADD a point and channel.
//
// What the design does about it.
//  * One launch writes every output element once. A block owns a range of
//    whole rows (bricks) of one segment: it builds a tile of those rows in
//    the output's type in shared memory (kTileBytes, so fewer rows a block
//    as C or the type grows, six blocks an SM; and no more rows than hold
//    about one slot a thread), zeros included, and stores it in coalesced
//    16-byte stores. Rows that no slot reaches cost only their stores;
//    there is no zero pass.
//  * Finding the slots: the block's first and last slots are two lower
//    bounds in its segment (the first slot whose id reaches the range's
//    first id, and the first past its last), each found by one warp that
//    probes 32 slots a step (four dependent loads for a segment of 10^5
//    slots in place of seventeen), while the other warps zero the tile.
//  * Summing: one thread a run. A slot starts a run where its id differs
//    from the slot before (an integer compare); that thread walks the run,
//    reads each point's row through sort_pos (16-byte loads where C is a
//    multiple of 4; up to 16 channels a walk, held in registers, so one
//    dependent load chain a point) and sums it in stream order in float32,
//    then writes the run's sum or mean into the tile, rounded once to the
//    output's type. No atomics, no float scan: the same bits on every call,
//    and the same arithmetic as the first version (a zero fill, then one
//    thread a slot), so the same bits as it.
//  * Runs are short (a voxel holds one or two points of a ScanNet room at
//    2 cm), so the walk costs about as much as the read it makes. What is
//    left is latency: a block's search, walk and stores follow one another,
//    and the tiles resident on an SM bound the bytes in flight.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kSearchWarps = 2;       // one lower bound a warp
constexpr int kTileBytes = 36864;     // a block's tile of output rows
constexpr int kMaxTileBytes = 48128;  // one float32 row, without opt-in

// The first slot in [lo, hi) whose id is >= key, hi if none, over a
// segment whose ids ascend (null ids, past every key, at its end). Called
// by a whole warp; every lane returns the answer. Each step probes 32
// slots a stride apart and keeps the stride that brackets the answer.
__device__ long long warp_lower_bound(const int* __restrict__ sort_cell,
                                      long long lo, long long hi,
                                      long long key) {
  const int lane = threadIdx.x & 31;
  while (lo < hi) {                    // the answer lies in [lo, hi]
    const long long step = (hi - lo + 31) / 32;
    const long long p = lo + lane * step;
    const bool ge = p >= hi || __ldg(sort_cell + p) >= key;
    const unsigned mask = __ballot_sync(0xffffffffu, ge);
    const int f = mask ? __ffs(mask) - 1 : 32;   // first probe >= key
    if (f == 0) return lo;
    hi = f < 32 ? min(lo + f * step, hi) : hi;
    lo += (f - 1) * step + 1;
  }
  return lo;
}

__device__ __forceinline__ void put(float* dst, float v) { *dst = v; }
__device__ __forceinline__ void put(__nv_bfloat16* dst, float v) {
  *dst = __float2bfloat16_rn(v);
}

// grid (blocks a segment, scenes); block (kThreads); dynamic shared
// memory block_rows * cells * c elements of OutT. kChunk channels of a
// run are summed in registers a walk (4, or 16 for a wider C).
template <typename OutT, int kChunk>
__global__ void __launch_bounds__(kThreads)
cell_rows(const float* __restrict__ feats,
          const int* __restrict__ sort_cell,
          const int* __restrict__ sort_pos, OutT* __restrict__ out,
          long long seg_slots, int c, int cells, long long seg_rows,
          int block_rows, int mode, bool vec) {
  extern __shared__ uint4 tile16[];
  OutT* tile = reinterpret_cast<OutT*>(tile16);
  __shared__ long long bounds[kSearchWarps];
  const long long scene = blockIdx.y;
  const long long r0 = scene * seg_rows +
                       static_cast<long long>(blockIdx.x) * block_rows;
  const long long r1 = min(r0 + block_rows, (scene + 1) * seg_rows);
  const int row_elems = cells * c;
  const int n_el = static_cast<int>(r1 - r0) * row_elems;
  const int n_words = (n_el * static_cast<int>(sizeof(OutT)) + 3) / 4;
  const int warp = threadIdx.x >> 5;
  if (warp < kSearchWarps) {           // the block's first and last slots
    const long long lo = scene * seg_slots;
    const long long j = warp_lower_bound(sort_cell, lo, lo + seg_slots,
                                         (warp == 0 ? r0 : r1) * cells);
    if ((threadIdx.x & 31) == 0) bounds[warp] = j;
  } else {                             // meanwhile the others zero the tile
    unsigned* words = reinterpret_cast<unsigned*>(tile16);
    for (int e = threadIdx.x - 32 * kSearchWarps; e < n_words;
         e += kThreads - 32 * kSearchWarps)
      words[e] = 0u;
  }
  __syncthreads();
  const long long j0 = bounds[0], j1 = bounds[1];
  const long long id0 = r0 * cells;
  for (long long j = j0 + threadIdx.x; j < j1; j += kThreads) {
    const int id = __ldg(sort_cell + j);
    if (j > j0 && __ldg(sort_cell + j - 1) == id) continue;  // not a start
    long long end = j + 1;
    while (end < j1 && __ldg(sort_cell + end) == id) ++end;
    const float len = static_cast<float>(end - j);
    OutT* dst = tile + (id - id0) * c;
    for (int c0 = 0; c0 < c; c0 += kChunk) {
      float acc[kChunk];
#pragma unroll
      for (int q = 0; q < kChunk; ++q) acc[q] = 0.f;
      for (long long k = j; k < end; ++k) {
        const float* src =
            feats + static_cast<long long>(__ldg(sort_pos + k)) * c + c0;
        if (vec) {                     // c % 4 == 0: whole float4s
#pragma unroll
          for (int q = 0; q < kChunk; q += 4) {
            if (c0 + q < c) {
              const float4 v =
                  __ldg(reinterpret_cast<const float4*>(src + q));
              acc[q] += v.x;
              acc[q + 1] += v.y;
              acc[q + 2] += v.z;
              acc[q + 3] += v.w;
            }
          }
        } else {
#pragma unroll
          for (int q = 0; q < kChunk; ++q)
            if (c0 + q < c) acc[q] += __ldg(src + q);
        }
      }
#pragma unroll
      for (int q = 0; q < kChunk; ++q)
        if (c0 + q < c) put(dst + c0 + q, mode == 4 ? acc[q] / len : acc[q]);
    }
  }
  __syncthreads();
  if ((row_elems * sizeof(OutT)) % 16 == 0) {   // aligned whole vectors
    uint4* dst = reinterpret_cast<uint4*>(out + r0 * row_elems);
    for (int e = threadIdx.x; e < n_words / 4; e += kThreads)
      dst[e] = tile16[e];
  } else {
    OutT* dst = out + r0 * row_elems;
    for (int e = threadIdx.x; e < n_el; e += kThreads) dst[e] = tile[e];
  }
}

template <typename OutT>
int launch(const void* feats, const void* sort_cell, const void* sort_pos,
           void* out, long long n_pts, int c, long long rows, int cells,
           int scenes, int mode, cudaStream_t stream) {
  const long long seg_rows = rows / scenes;
  const int row_bytes = cells * c * static_cast<int>(sizeof(OutT));
  // as many rows as the tile holds, but about one slot a thread: more
  // rows would walk runs one after another in a thread
  const long long slots_a_row = std::max(1LL, n_pts / rows);
  const long long block_rows = std::min<long long>(
      std::min<long long>(std::max(1, kTileBytes / row_bytes),
                          std::max(1LL, kThreads / slots_a_row)),
      seg_rows);
  const dim3 grid(static_cast<unsigned>((seg_rows + block_rows - 1) /
                                        block_rows), scenes);
  const size_t smem = (block_rows * row_bytes + 15) / 16 * 16;
  const bool vec = c % 4 == 0 &&
                   reinterpret_cast<std::uintptr_t>(feats) % 16 == 0;
  const auto* f = static_cast<const float*>(feats);
  const auto* sc = static_cast<const int*>(sort_cell);
  const auto* sp = static_cast<const int*>(sort_pos);
  auto* o = static_cast<OutT*>(out);
  if (c <= 4)
    cell_rows<OutT, 4><<<grid, kThreads, smem, stream>>>(
        f, sc, sp, o, n_pts / scenes, c, cells, seg_rows,
        static_cast<int>(block_rows), mode, vec);
  else
    cell_rows<OutT, 16><<<grid, kThreads, smem, stream>>>(
        f, sc, sp, o, n_pts / scenes, c, cells, seg_rows,
        static_cast<int>(block_rows), mode, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The largest C whose row of `cells` float32 cells fits one block's tile.
extern "C" int doda_cell_reduce_max_c(int cells) {
  return kMaxTileBytes / (cells * static_cast<int>(sizeof(float)));
}

// feats (n_pts, c) float32, sort_cell and sort_pos (n_pts,) int32 in
// `scenes` equal segments, out (rows, cells * c) float32 (out_bf16 = 0) or
// bf16 (1), written whole; mode 3 = sum, 4 = mean. Returns
// cudaGetLastError() after the launch.
extern "C" int doda_cell_reduce_sorted(const void* feats,
                                       const void* sort_cell,
                                       const void* sort_pos, void* out,
                                       long long n_pts, int c,
                                       long long rows, int cells,
                                       int scenes, int mode, int out_bf16,
                                       void* stream) {
  if (n_pts < 0 || n_pts > 0x7fffffffLL || c <= 0 || cells <= 0 ||
      rows <= 0 || scenes <= 0 || scenes > 65535 || n_pts % scenes ||
      rows % scenes || rows * cells > 0x7fffffffLL ||
      c > doda_cell_reduce_max_c(cells) || (mode != 3 && mode != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  return out_bf16
      ? launch<__nv_bfloat16>(feats, sort_cell, sort_pos, out, n_pts, c,
                              rows, cells, scenes, mode, s)
      : launch<float>(feats, sort_cell, sort_pos, out, n_pts, c, rows, cells,
                      scenes, mode, s);
}
