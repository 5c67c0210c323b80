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
// multiplied. It takes bf16 operands only: its float32 CUDA-core path was
// deleted once float32 convs took subm_conv_f32.cu, from the activation and
// the rulebook.
//
// This is K1's first version. It stays for bf16 convs of widths that the
// fused and narrow versions refuse (cin or cout not a multiple of 8 with
// cin > 7) and the contract test against the Pallas kernel. Every other
// bf16 conv runs the second version, banded_conv_fused.cu, or the narrow
// one, subm_conv_narrow.cu, which assemble the halo inside the kernel from
// the activation and the rulebook and multiply the taps only, so neither
// the planes nor the placed zeros of wb exist there.
//
// The brick side S (the JAX package's DODA_BRICK) is a template parameter
// of the row map, instantiated for 4 (above) and 2: rows (B, S+2, K) with
// K = (S+2)^2*cin, wb (3, K, N) with N = S^2*cout, output rows r = S*b + x
// for x = 0..S-1 reading the run rows + ((S+2)b + x)*K. K and N come from
// the shapes, so the tiles are the same at every side.

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

// offset of output row r = S*b + x's operand run (S a power of two: a
// signed division would cost the side-4 kernel registers, and occupancy)
template <int S>
__device__ __forceinline__ int64_t row_base(int64_t r, int K) {
  constexpr int SHIFT = S == 4 ? 2 : 1;
  static_assert(S == 1 << SHIFT, "sides 2 and 4");
  return ((r >> SHIFT) * (S + 2) + (r & (S - 1))) * (int64_t)K;
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

template <typename OutT, int S>
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
    a_base[c] = a_ok[c] ? row_base<S>(r, K) : 0;
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

template <int BM, int BN>
int64_t grid_size(int64_t M, int N) {
  return ((M + BM - 1) / BM) * ((N + BN - 1) / BN);
}

template <int S>
int launch(const void* rows, const void* wb, void* out, long long B, int K,
           int N, int out_dtype, cudaStream_t s) {
  const int64_t M = S * (int64_t)B;
  const int64_t grid = grid_size<TC_BM, TC_BN>(M, N);
  if (grid > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  const int vec_a = (K % 8 == 0) && (reinterpret_cast<uintptr_t>(rows) % 16 == 0);
  const bf16* r = static_cast<const bf16*>(rows);
  const bf16* w = static_cast<const bf16*>(wb);
  if (out_dtype == 1)
    banded_tc<bf16, S><<<(unsigned)grid, TC_THREADS, 0, s>>>(
        r, w, static_cast<bf16*>(out), M, K, N, vec_a);
  else
    banded_tc<float, S><<<(unsigned)grid, TC_THREADS, 0, s>>>(
        r, w, static_cast<float*>(out), M, K, N, vec_a);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16; in_dtype must be 1 (float32
// operands take subm_conv_f32.cu); side: the brick side, 2 or 4. Returns
// cudaGetLastError().
extern "C" int doda_banded_conv(const void* rows, const void* wb, void* out,
                                long long B, int K, int N, int side,
                                int in_dtype, int out_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || K <= 0 || N <= 0 || N % 8 || (side != 2 && side != 4) ||
      in_dtype != 1 || (out_dtype != 0 && out_dtype != 1))
    return (int)cudaErrorInvalidValue;
  return side == 4 ? launch<4>(rows, wb, out, B, K, N, out_dtype, s)
                   : launch<2>(rows, wb, out, B, K, N, out_dtype, s);
}
