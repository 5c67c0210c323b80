// Kernel K1: the banded 3-tap submanifold conv over six halo planes.
//
// Replaces the TPU kernel doda_tpu/ops/pallas_banded.py::banded_conv.
// For rows (B, 6, K) with K = 36*cin -- the halo planes x = -1, 0..3, +4 of
// each brick -- and banded weights wb (3, K, N) with N = 16*cout it writes
//
//     out[b, x*N + n] = sum_{j<3} sum_{k<K} rows[b, x+j, k] * wb[j, k, n]
//
// for x = 0..3, unmasked, with float32 accumulation.
//
// Design. The three planes x..x+2 of a brick are contiguous in memory, so
// output row r = 4b + x of the (4B, N) result reads one contiguous run of
// 3K operands at rows + (6b + x)*K: the conv is one GEMM (4B, 3K) @ (3K, N)
// whose A rows overlap. The Pallas kernel kept wb resident in VMEM; wb does
// not fit in shared memory at any flagship width (0.9 MB at cin = cout = 16,
// 64 MB at cin 192 / cout 96), so this kernel tiles rows, N and K. Tiles
// walk N fastest, so the blocks that share a row tile run together and read
// it from L2 rather than from device memory.
//
// What bounds it on an H100: at the level-0 bench shape (B = 163840,
// cin = cout = 16, bf16) the function must move ~1.47 GB (0.44 ms at
// 3.35 TB/s) while the full band takes 5.8e11 FLOPs (0.59 ms at 989 TF/s,
// of which only a quarter are non-zero taps), so the least time is set by
// bytes and this kernel, which computes the full band, is bound by tensor-core
// throughput first. bf16 operands go through WMMA 16x16x16 tensor-core tiles
// with the next K tile prefetched into registers while the current one is
// multiplied; float32 operands take an exact CUDA-core path (the tests and
// the float32 checks of the model need full float32).
//
// This is K1's first version. It stays for the cin = 3 input conv, float32
// operands and the contract test against the Pallas kernel. Every other
// conv runs the second version, banded_conv_fused.cu, which assembles the
// halo inside the kernel from the activation and the rulebook and
// multiplies the taps only, so neither the planes nor the placed zeros of
// wb exist there.

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

// offset of output row r = 4b + x's operand run
__device__ __forceinline__ int64_t row_base(int64_t r, int K) {
  return ((r >> 2) * 6 + (r & 3)) * (int64_t)K;
}

// ---------------------------------------------------------------- bf16 ----
constexpr int TC_BM = 128, TC_BN = 128, TC_BK = 32, TC_THREADS = 256;
constexpr int A_LD = TC_BK + 8;   // smem row pitch (elements), 80 B
constexpr int B_LD = TC_BN + 8;   // 272 B
constexpr int C_LD = 20;          // per-warp float staging pitch

struct TcSmem {                   // bf16 tiles held as raw 16-bit words
  unsigned short a[TC_BM * A_LD];
  unsigned short b[TC_BK * B_LD];
  float c[TC_THREADS / 32][16 * C_LD];
};

template <typename OutT>
__global__ void __launch_bounds__(TC_THREADS)
banded_tc(const bf16* __restrict__ rows, const bf16* __restrict__ wb,
          OutT* __restrict__ out, int64_t M, int K, int N, int vec_a) {
  using namespace nvcuda;
  __shared__ __align__(128) TcSmem sm;
  const int KT = 3 * K;
  const int n_tiles = (N + TC_BN - 1) / TC_BN;
  const int n0 = (int)(blockIdx.x % n_tiles) * TC_BN;
  const int64_t m0 = (int64_t)(blockIdx.x / n_tiles) * TC_BM;
  const int tid = threadIdx.x;
  const unsigned short* rows_u = reinterpret_cast<const unsigned short*>(rows);

  // each thread stages two 8-element chunks of A and two of B per K tile
  int64_t a_base[2];
  bool a_ok[2];
  int a_row[2], a_k[2], b_k[2], b_n[2];
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    int chunk = tid + c * TC_THREADS;
    a_row[c] = chunk >> 2;
    a_k[c] = (chunk & 3) * 8;
    int64_t r = m0 + a_row[c];
    a_ok[c] = r < M;
    a_base[c] = a_ok[c] ? row_base(r, K) : 0;
    b_k[c] = chunk >> 4;
    b_n[c] = (chunk & 15) * 8;
  }
  uint4 ra[2], rb[2];

  auto load = [&](int k0) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      int kk = k0 + a_k[c];
      if (vec_a) {
        ra[c] = (a_ok[c] && kk < KT)
                    ? *reinterpret_cast<const uint4*>(rows + a_base[c] + kk)
                    : make_uint4(0, 0, 0, 0);
      } else {
        union { uint4 v; unsigned short s[8]; } u;
#pragma unroll
        for (int e = 0; e < 8; ++e)
          u.s[e] = (a_ok[c] && kk + e < KT) ? rows_u[a_base[c] + kk + e] : 0;
        ra[c] = u.v;
      }
      int kb = k0 + b_k[c], nb = n0 + b_n[c];
      rb[c] = (kb < KT && nb < N)
                  ? *reinterpret_cast<const uint4*>(wb + (int64_t)kb * N + nb)
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

  load(0);
  store();
  __syncthreads();
  for (int k0 = 0; k0 < KT; k0 += TC_BK) {
    const bool more = k0 + TC_BK < KT;
    if (more) load(k0 + TC_BK);
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
    if (more) {
      store();
      __syncthreads();
    }
  }

  // epilogue: each warp stages one 16x16 fragment at a time in smem and
  // writes it out with the ragged row and column edges masked
  float* stage = sm.c[warp];
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
          out[gr * N + gc] = from_float<OutT>(stage[rr * C_LD + cc]);
      }
      __syncwarp();
    }
  }
}

// ------------------------------------------------------------- float32 ----
constexpr int S_BM = 64, S_BN = 64, S_BK = 16, S_THREADS = 256;

template <typename OutT>
__global__ void __launch_bounds__(S_THREADS)
banded_f32(const float* __restrict__ rows, const float* __restrict__ wb,
           OutT* __restrict__ out, int64_t M, int K, int N) {
  __shared__ float as[S_BK][S_BM + 4];
  __shared__ float bs[S_BK][S_BN + 4];
  const int KT = 3 * K;
  const int n_tiles = (N + S_BN - 1) / S_BN;
  const int n0 = (int)(blockIdx.x % n_tiles) * S_BN;
  const int64_t m0 = (int64_t)(blockIdx.x / n_tiles) * S_BM;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;   // 4x4 outputs per thread

  int64_t a_base[4];
  bool a_ok[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    int64_t r = m0 + ((tid + c * S_THREADS) >> 4);
    a_ok[c] = r < M;
    a_base[c] = a_ok[c] ? row_base(r, K) : 0;
  }
  float acc[4][4] = {};
  for (int k0 = 0; k0 < KT; k0 += S_BK) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      int e = tid + c * S_THREADS;
      int row = e >> 4, kk = e & 15;
      as[kk][row] = (a_ok[c] && k0 + kk < KT) ? rows[a_base[c] + k0 + kk]
                                               : 0.0f;
      int kr = e >> 6, col = e & 63;
      bs[kr][col] = (k0 + kr < KT && n0 + col < N)
                        ? wb[(int64_t)(k0 + kr) * N + n0 + col]
                        : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < S_BK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = as[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int64_t gr = m0 + ty * 4 + i;
    if (gr >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int gc = n0 + tx * 4 + j;
      if (gc < N) out[gr * N + gc] = from_float<OutT>(acc[i][j]);
    }
  }
}

template <int BM, int BN>
int64_t grid_size(int64_t M, int N) {
  return ((M + BM - 1) / BM) * ((N + BN - 1) / BN);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. Returns cudaGetLastError().
extern "C" int doda_banded_conv(const void* rows, const void* wb, void* out,
                                long long B, int K, int N, int in_dtype,
                                int out_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t M = 4 * (int64_t)B;
  if (B <= 0 || K <= 0 || N <= 0 || N % 8 || (in_dtype != 0 && in_dtype != 1)
      || (out_dtype != 0 && out_dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (in_dtype == 1) {
    const int64_t grid = grid_size<TC_BM, TC_BN>(M, N);
    if (grid > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
    const int vec_a = (K % 8 == 0) && (reinterpret_cast<uintptr_t>(rows) % 16 == 0);
    const bf16* r = static_cast<const bf16*>(rows);
    const bf16* w = static_cast<const bf16*>(wb);
    if (out_dtype == 1)
      banded_tc<bf16><<<(unsigned)grid, TC_THREADS, 0, s>>>(
          r, w, static_cast<bf16*>(out), M, K, N, vec_a);
    else
      banded_tc<float><<<(unsigned)grid, TC_THREADS, 0, s>>>(
          r, w, static_cast<float*>(out), M, K, N, vec_a);
  } else {
    const int64_t grid = grid_size<S_BM, S_BN>(M, N);
    if (grid > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
    const float* r = static_cast<const float*>(rows);
    const float* w = static_cast<const float*>(wb);
    if (out_dtype == 1)
      banded_f32<bf16><<<(unsigned)grid, S_THREADS, 0, s>>>(
          r, w, static_cast<bf16*>(out), M, K, N);
    else
      banded_f32<float><<<(unsigned)grid, S_THREADS, 0, s>>>(
          r, w, static_cast<float*>(out), M, K, N);
  }
  return (int)cudaGetLastError();
}
