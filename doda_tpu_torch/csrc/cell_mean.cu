// The point -> cell reduction over brickify's (brick, cell)-sorted stream.
//
// Replaces no TPU kernel: it is the port of the JAX package's default
// reduction, doda_tpu/ops/bricks.py::_brick_feats_sorted, which is plain
// XLA (a float32 cumsum over lane-expanded rows, differences at run ends).
// It was added so that the point -> cell mean needs no float atomics on the
// card: index_add_ (ops/bricks.py::cell_feats_2d) sums a cell's points in
// an order that changes from call to call, and a float cumsum on CUDA is
// no more reproducible (nor precise: its prefix grows with the stream).
//
// For feats (N, C) float32 and the stream sort_cell (N,) int32 (flat cell
// id in [0, n_cells), any other id for none; the slots of one cell
// adjacent, as brickify's sort leaves them) and sort_pos (N,) int32 (the
// feats row of each slot) it writes the dense out (n_cells, C) float32:
//
//     out[id, :] = sum of feats[sort_pos[j], :] over the run of id
//                  (mode 3), divided by the run's length (mode 4),
//     out[id, :] = 0 where no slot holds id.
//
// What bounds it on an H100: bytes. The dense output dominates: at brick
// side 4, batch 4, 40,960 bricks a scene and C = 3 it is 4 x 40,960 x 64 x
// 3 x 4 bytes = 126 MB (0.038 ms at 3.35 TB/s), against 7.9 MB of
// features and 5.2 MB of stream for 655,360 points. It does one FADD a
// point and channel.
//
// What the design does about it.
//  * The caller zero-fills the output (torch.zeros, the pass that the
//    bound counts); cell_runs then writes the cells that points reach,
//    each once.
//  * cell_runs: one thread a slot. A slot starts a run where its id
//    differs from the slot before (an integer compare); that thread walks
//    the run, reads each point's features through sort_pos and sums them
//    in stream order in float32, four channels a pass (any C: a wider C
//    walks the run again for each group of four), and writes the run's sum
//    or mean. Threads of other slots return. No atomics, no float scan:
//    the same bits on every call.
//  * Runs are short (a voxel holds one or two points of a ScanNet room at
//    2 cm), so the walk costs about as much as the read it makes.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 4;       // channels summed a pass over a run

__global__ void __launch_bounds__(kThreads)
cell_runs(const float* __restrict__ feats, const int* __restrict__ sort_cell,
          const int* __restrict__ sort_pos, float* __restrict__ out,
          long long n_pts, int c, long long n_cells, int mode) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (i >= n_pts) return;
  const int id = __ldg(sort_cell + i);
  if (id < 0 || id >= n_cells) return;              // no cell
  if (i > 0 && __ldg(sort_cell + i - 1) == id) return;  // not a run start
  long long end = i + 1;
  while (end < n_pts && __ldg(sort_cell + end) == id) ++end;
  const float len = static_cast<float>(end - i);
  float* dst = out + static_cast<long long>(id) * c;
  for (int c0 = 0; c0 < c; c0 += kGroup) {
    float acc[kGroup] = {0.f, 0.f, 0.f, 0.f};
    for (long long j = i; j < end; ++j) {
      const float* src =
          feats + static_cast<long long>(__ldg(sort_pos + j)) * c + c0;
#pragma unroll
      for (int k = 0; k < kGroup; ++k)
        if (c0 + k < c) acc[k] += __ldg(src + k);
    }
#pragma unroll
    for (int k = 0; k < kGroup; ++k)
      if (c0 + k < c) dst[c0 + k] = mode == 4 ? acc[k] / len : acc[k];
  }
}

}  // namespace

// feats (n_pts, c) float32, sort_cell and sort_pos (n_pts,) int32, out
// (n_cells, c) float32 and zero; mode 3 = sum, 4 = mean. Returns
// cudaGetLastError() after the launch.
extern "C" int doda_cell_reduce_sorted(const void* feats,
                                       const void* sort_cell,
                                       const void* sort_pos, void* out,
                                       long long n_pts, int c,
                                       long long n_cells, int mode,
                                       void* stream) {
  if (n_pts < 0 || n_pts > 0x7fffffffLL || c <= 0 || n_cells <= 0 ||
      (mode != 3 && mode != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_pts == 0) return 0;
  cell_runs<<<static_cast<unsigned>((n_pts + kThreads - 1) / kThreads),
              kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(feats), static_cast<const int*>(sort_cell),
      static_cast<const int*>(sort_pos), static_cast<float*>(out), n_pts, c,
      n_cells, mode);
  return static_cast<int>(cudaGetLastError());
}
