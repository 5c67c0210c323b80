// Kernel K2: the source-major banded submanifold conv.
//
// Replaces the TPU kernel doda_tpu/ops/pallas_sm.py::banded_conv_sm. The
// operands are a brick's own activation x (B, 64*cin) and only the halo
// around it: gyz (B, 96*cin), per x-slice the in-plane halo padded to 24
// cells, and the x-halo planes gxm / gxp (B, 40*cin). With wc (3, 16cin, N),
// wh (3, 24cin, N), wx (2, 40cin, N), N = 16*cout, output x-slice xr is
//
//     out[b, xr*N + n] = sum over taps i < 3, cx = xr + i - 1 of
//         gxm[b, :] . wx[0][:, n]                          if cx == -1
//         gxp[b, :] . wx[1][:, n]                          if cx == 4
//         x[b, cx*16cin : +16cin] . wc[i][:, n]
//           + gyz[b, cx*24cin : +24cin] . wh[i][:, n]      otherwise
//
// unmasked, with float32 accumulation. cin % 16 == 0 and cout % 8 == 0.
//
// Design. Each output slice is one GEMM (B, 120*cin) @ (120*cin, N) whose K
// axis is pieced together from five or six segments, each with its own A
// base, A row stride and weight block. The host lays those out as a small
// table per slice; a block owns one (row tile, slice, N tile) and walks the
// table with the tile loop of kernel K1 (banded_conv.cu). Every segment
// length is a multiple of 16*cin >= 256, so a K tile never straddles two
// segments and 16-byte loads always apply. The Pallas kernel kept the
// weights resident in VMEM; they are 1.6 MB in bf16 at cin = cout = 16 and
// 6.6 MB at 32/32, against 227 KB of shared memory, so this kernel tiles
// rows, N and K. Blocks walk N fastest, then the slice, so the blocks that
// share a row tile run together and re-read it from L2. B need not divide
// the row tile: the row edge is masked.
//
// What bounds it on an H100: at the level-0 training shape the function
// must move 240*cin + 64*cout elements per brick (0.48 ms at B = 163840,
// cin = cout = 16, bf16, 3.35 TB/s) against 0.15 ms of non-zero taps at
// 989 TFLOP/s, so the least time is set by bytes. This first kernel multiplies
// the full 120*cin band of every slice, zero padding included (27 of every
// 120 products are non-zero taps), and is bound by its
// WMMA 16x16x16 tile loop rather than by memory. bf16 operands run on
// tensor cores with the next K tile prefetched into registers; float32
// operands take an exact CUDA-core path (the float32 checks of the model
// need full float32, not TF32). Skipping zero K blocks, wgmma, TMA and
// fusing the gather in are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ bf16 from_float<bf16>(float v) {
  return __float2bfloat16(v);
}

// One K segment of a slice: A rows at a + row*lda, weights at w (k x N).
struct Seg {
  const void* a;
  const void* w;
  long long lda;
  int k;
  int pad;
};
constexpr int MAX_SEGS = 6;
struct Plan {
  Seg seg[4][MAX_SEGS];
  int nseg[4];
};

// ---------------------------------------------------------------- bf16 ----
constexpr int TC_BM = 128, TC_BN = 128, TC_BK = 32, TC_THREADS = 256;
constexpr int A_LD = TC_BK + 8;   // smem row pitch (elements), 80 B
constexpr int B_LD = TC_BN + 8;   // 272 B
constexpr int C_LD = 20;          // per-warp float staging pitch
// Two resident blocks per SM are asked of ptxas: left alone it takes 166
// registers, which fits one block; held to 128 (8 bytes spilled) the second
// block hides the first one's loads and the kernel runs a quarter faster.
constexpr int TC_MIN_BLOCKS = 2;

struct TcSmem {                   // bf16 tiles held as raw 16-bit words
  unsigned short a[TC_BM * A_LD];
  unsigned short b[TC_BK * B_LD];
  float c[TC_THREADS / 32][16 * C_LD];
  Seg seg[MAX_SEGS];
};

template <typename OutT>
__global__ void __launch_bounds__(TC_THREADS, TC_MIN_BLOCKS)
sm_tc(const __grid_constant__ Plan plan, OutT* __restrict__ out, int64_t M,
      int N) {
  using namespace nvcuda;
  __shared__ __align__(128) TcSmem sm;
  const int n_tiles = (N + TC_BN - 1) / TC_BN;
  const int n0 = (int)(blockIdx.x % n_tiles) * TC_BN;
  const int xr = (int)((blockIdx.x / n_tiles) & 3);
  const int64_t m0 = (int64_t)(blockIdx.x / (4 * n_tiles)) * TC_BM;
  const int tid = threadIdx.x;
  const int nseg = plan.nseg[xr];
  if (tid < nseg) sm.seg[tid] = plan.seg[xr][tid];
  __syncthreads();

  // each thread stages two 8-element chunks of A and two of B per K tile
  bool a_ok[2];
  int64_t a_rowi[2];
  int a_row[2], a_k[2], b_k[2], b_n[2];
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    int chunk = tid + c * TC_THREADS;
    a_row[c] = chunk >> 2;
    a_k[c] = (chunk & 3) * 8;
    int64_t r = m0 + a_row[c];
    a_ok[c] = r < M;
    a_rowi[c] = a_ok[c] ? r : 0;
    b_k[c] = chunk >> 4;
    b_n[c] = (chunk & 15) * 8;
  }
  uint4 ra[2], rb[2];

  // (s, k0): the K tile at offset k0 of segment s
  auto load = [&](int s, int k0) {
    const Seg sg = sm.seg[s];
    const bf16* a = static_cast<const bf16*>(sg.a);
    const bf16* w = static_cast<const bf16*>(sg.w);
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      ra[c] = a_ok[c] ? *reinterpret_cast<const uint4*>(
                            a + a_rowi[c] * sg.lda + k0 + a_k[c])
                      : make_uint4(0, 0, 0, 0);
      int nb = n0 + b_n[c];
      rb[c] = nb < N ? *reinterpret_cast<const uint4*>(
                           w + (int64_t)(k0 + b_k[c]) * N + nb)
                     : make_uint4(0, 0, 0, 0);
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      *reinterpret_cast<uint4*>(&sm.a[a_row[c] * A_LD + a_k[c]]) = ra[c];
      *reinterpret_cast<uint4*>(&sm.b[b_k[c] * B_LD + b_n[c]]) = rb[c];
    }
  };

  const int warp = tid >> 5, lane = tid & 31;
  const int wm = (warp >> 2) * 64;   // 2 x 4 warps, 64 x 32 each
  const int wn = (warp & 3) * 32;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  int s = 0, k0 = 0;                 // cursor of the tile being prefetched
  load(s, k0);
  store();
  __syncthreads();
  while (true) {
    k0 += TC_BK;
    if (k0 >= sm.seg[s].k) { ++s; k0 = 0; }
    const bool more = s < nseg;
    if (more) load(s, k0);
#pragma unroll
    for (int ks = 0; ks < TC_BK; ks += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(
            fa[i], reinterpret_cast<const bf16*>(&sm.a[(wm + i * 16) * A_LD + ks]),
            A_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(
            fb[j], reinterpret_cast<const bf16*>(&sm.b[ks * B_LD + wn + j * 16]),
            B_LD);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
    if (!more) break;
    store();
    __syncthreads();
  }

  // epilogue: each warp stages one 16x16 fragment at a time in smem and
  // writes it into the slice's columns with the ragged row edge masked
  float* stage = sm.c[warp];
  const int64_t ldo = 4 * (int64_t)N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(stage, acc[i][j], C_LD, wmma::mem_row_major);
      __syncwarp();
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        int idx = lane * 8 + e;
        int rr = idx >> 4, cc = idx & 15;
        int64_t gr = m0 + wm + i * 16 + rr;
        int gc = n0 + wn + j * 16 + cc;
        if (gr < M && gc < N)
          out[gr * ldo + (int64_t)xr * N + gc] =
              from_float<OutT>(stage[rr * C_LD + cc]);
      }
      __syncwarp();
    }
  }
}

// ------------------------------------------------------------- float32 ----
constexpr int S_BM = 64, S_BN = 64, S_BK = 16, S_THREADS = 256;

template <typename OutT>
__global__ void __launch_bounds__(S_THREADS)
sm_f32(const __grid_constant__ Plan plan, OutT* __restrict__ out, int64_t M,
       int N) {
  __shared__ float as[S_BK][S_BM + 4];
  __shared__ float bs[S_BK][S_BN + 4];
  const int n_tiles = (N + S_BN - 1) / S_BN;
  const int n0 = (int)(blockIdx.x % n_tiles) * S_BN;
  const int xr = (int)((blockIdx.x / n_tiles) & 3);
  const int64_t m0 = (int64_t)(blockIdx.x / (4 * n_tiles)) * S_BM;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;   // 4x4 outputs per thread

  int64_t a_rowi[4];
  bool a_ok[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    int64_t r = m0 + ((tid + c * S_THREADS) >> 4);
    a_ok[c] = r < M;
    a_rowi[c] = a_ok[c] ? r : 0;
  }
  float acc[4][4] = {};
  const int nseg = plan.nseg[xr];
  for (int s = 0; s < nseg; ++s) {
    const Seg sg = plan.seg[xr][s];
    const float* a = static_cast<const float*>(sg.a);
    const float* w = static_cast<const float*>(sg.w);
    for (int k0 = 0; k0 < sg.k; k0 += S_BK) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        int e = tid + c * S_THREADS;
        int row = e >> 4, kk = e & 15;
        as[kk][row] = a_ok[c] ? a[a_rowi[c] * sg.lda + k0 + kk] : 0.0f;
        int kr = e >> 6, col = e & 63;
        bs[kr][col] = (n0 + col < N) ? w[(int64_t)(k0 + kr) * N + n0 + col]
                                     : 0.0f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < S_BK; ++kk) {
        float av[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = as[kk][ty * 4 + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = bs[kk][tx * 4 + j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
  }
  const int64_t ldo = 4 * (int64_t)N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int64_t gr = m0 + ty * 4 + i;
    if (gr >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int gc = n0 + tx * 4 + j;
      if (gc < N)
        out[gr * ldo + (int64_t)xr * N + gc] = from_float<OutT>(acc[i][j]);
    }
  }
}

template <int BM, int BN>
int64_t grid_size(int64_t M, int N) {
  return ((M + BM - 1) / BM) * 4 * ((N + BN - 1) / BN);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16; ld* are row strides in elements.
// Returns cudaGetLastError().
extern "C" int doda_banded_conv_sm(
    const void* x, long long ldx, const void* gyz, long long ldg,
    const void* gxm, long long ldm, const void* gxp, long long ldp,
    const void* wc, const void* wh, const void* wx, void* out, long long B,
    int cin, int N, int in_dtype, int out_dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || cin <= 0 || cin % 16 || N <= 0 || N % 128
      || (in_dtype != 0 && in_dtype != 1) || (out_dtype != 0 && out_dtype != 1))
    return (int)cudaErrorInvalidValue;
  const size_t es = in_dtype == 1 ? 2 : 4;
  const int k16 = 16 * cin, k24 = 24 * cin, k40 = 40 * cin;
  auto at = [es](const void* p, long long elems) -> const void* {
    return static_cast<const char*>(p) + (size_t)elems * es;
  };
  Plan plan;
  for (int xr = 0; xr < 4; ++xr) {
    int n = 0;
    for (int i = 0; i < 3; ++i) {
      const int cx = xr + i - 1;
      if (cx == -1) {
        plan.seg[xr][n++] = Seg{gxm, wx, ldm, k40, 0};
      } else if (cx == 4) {
        plan.seg[xr][n++] = Seg{gxp, at(wx, (long long)k40 * N), ldp, k40, 0};
      } else {
        plan.seg[xr][n++] = Seg{at(x, (long long)cx * k16),
                                at(wc, (long long)i * k16 * N), ldx, k16, 0};
        plan.seg[xr][n++] = Seg{at(gyz, (long long)cx * k24),
                                at(wh, (long long)i * k24 * N), ldg, k24, 0};
      }
    }
    plan.nseg[xr] = n;
    for (; n < MAX_SEGS; ++n) plan.seg[xr][n] = Seg{nullptr, nullptr, 0, 0, 0};
  }
  if (in_dtype == 1) {
    const int64_t grid = grid_size<TC_BM, TC_BN>(B, N);
    if (grid > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
    if (out_dtype == 1)
      sm_tc<bf16><<<(unsigned)grid, TC_THREADS, 0, st>>>(
          plan, static_cast<bf16*>(out), B, N);
    else
      sm_tc<float><<<(unsigned)grid, TC_THREADS, 0, st>>>(
          plan, static_cast<float*>(out), B, N);
  } else {
    const int64_t grid = grid_size<S_BM, S_BN>(B, N);
    if (grid > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
    if (out_dtype == 1)
      sm_f32<bf16><<<(unsigned)grid, S_THREADS, 0, st>>>(
          plan, static_cast<bf16*>(out), B, N);
    else
      sm_f32<float><<<(unsigned)grid, S_THREADS, 0, st>>>(
          plan, static_cast<float*>(out), B, N);
  }
  return (int)cudaGetLastError();
}
