// Kernel K2, first version: the source-major banded submanifold conv on
// float32 operands.
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
// Those are brick side 4's widths. The side S is a template parameter,
// instantiated for 4 and 2: S slices of S^2 cells, gyz runs of RUN = 4S+8
// cells, x-planes of XPAD = (S+2)^2+4 cells, N = S^2*cout (side 2: x 8,
// gyz 32, gxm / gxp 20 cells a row). bf16 operands take the second
// version, banded_conv_sm_taps.cu; this kernel runs the float32 'sm' convs,
// whose checks need full float32, not TF32.
//
// Design. Each output slice is one GEMM (B, 3*XPAD*cin) @ (3*XPAD*cin, N)
// whose K axis is pieced together from five or six segments, each with its
// own A base, A row stride and weight block. The host lays those out as a
// small table per slice; a block owns one (row tile, slice, N tile) and
// walks the table with an exact CUDA-core tile loop. Every segment length
// is a multiple of S^2*cin >= 64, so a K tile never straddles two
// segments. Blocks walk N fastest, then the slice, so the blocks that share
// a row tile run together and re-read it from L2. B need not divide the
// row tile: the row edge is masked.
//
// What bounds it on an H100: float32 operations on the CUDA cores. Every
// tap of every row is 2*B*S^3*27*cin*cout operations (at side 4, B =
// 163840, cin = cout = 16: 1.45e11, 2.2 ms at 67 TFLOP/s), and the kernel
// multiplies the whole band, zero padding included (27 of every 120
// products at side 4 are taps). It serves the float32 checks only.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
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
  Seg seg[4][MAX_SEGS];   // slices 0..S-1 used
  int nseg[4];
};

constexpr int S_BM = 64, S_BN = 64, S_BK = 16, S_THREADS = 256;

template <typename OutT, int S>
__global__ void __launch_bounds__(S_THREADS)
sm_f32(const __grid_constant__ Plan plan, OutT* __restrict__ out, int64_t M,
       int N) {
  static_assert(S == 2 || S == 4, "sides 2 and 4");
  __shared__ float as[S_BK][S_BM + 4];
  __shared__ float bs[S_BK][S_BN + 4];
  const int n_tiles = (N + S_BN - 1) / S_BN;
  const int n0 = (int)(blockIdx.x % n_tiles) * S_BN;
  const int xr = (int)((blockIdx.x / n_tiles) & (S - 1));
  const int64_t m0 = (int64_t)(blockIdx.x / (S * n_tiles)) * S_BM;
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
  const int64_t ldo = S * (int64_t)N;
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

// The row maps of side S: slice xr reads, for i < 3 and cx = xr + i - 1,
// gxm (cx == -1), gxp (cx == S) or x's slice cx and its gyz run.
template <int S>
Plan make_plan(const float* x, long long ldx, const float* gyz,
               long long ldg, const float* gxm, long long ldm,
               const float* gxp, long long ldp, const float* wc,
               const float* wh, const float* wx, int cin, int N) {
  constexpr int SL = S * S, RUN = 4 * S + 8, XPAD = (S + 2) * (S + 2) + 4;
  const int kx = SL * cin, kr = RUN * cin, kp = XPAD * cin;
  Plan plan;
  for (int xr = 0; xr < 4; ++xr) {
    int n = 0;
    for (int i = 0; xr < S && i < 3; ++i) {
      const int cx = xr + i - 1;
      if (cx == -1) {
        plan.seg[xr][n++] = Seg{gxm, wx, ldm, kp, 0};
      } else if (cx == S) {
        plan.seg[xr][n++] = Seg{gxp, wx + (long long)kp * N, ldp, kp, 0};
      } else {
        plan.seg[xr][n++] = Seg{x + (long long)cx * kx,
                                wc + (long long)i * kx * N, ldx, kx, 0};
        plan.seg[xr][n++] = Seg{gyz + (long long)cx * kr,
                                wh + (long long)i * kr * N, ldg, kr, 0};
      }
    }
    plan.nseg[xr] = n;
    for (; n < MAX_SEGS; ++n) plan.seg[xr][n] = Seg{nullptr, nullptr, 0, 0, 0};
  }
  return plan;
}

template <int S>
int launch(const Plan& plan, void* out, long long B, int N, int out_dtype,
           cudaStream_t st) {
  const int64_t grid = ((B + S_BM - 1) / S_BM) * S * ((N + S_BN - 1) / S_BN);
  if (grid > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  if (out_dtype == 1)
    sm_f32<bf16, S><<<(unsigned)grid, S_THREADS, 0, st>>>(
        plan, static_cast<bf16*>(out), B, N);
  else
    sm_f32<float, S><<<(unsigned)grid, S_THREADS, 0, st>>>(
        plan, static_cast<float*>(out), B, N);
  return (int)cudaGetLastError();
}

}  // namespace

// 1 if the kernel is built for bricks of `side`, else 0.
extern "C" int doda_banded_conv_sm_has_side(int side) {
  return side == 2 || side == 4;
}

// float32 operands on bricks of `side` (2 or 4), N = side^2 * cout; ld* are
// row strides in elements; out_dtype: 0 = float32, 1 = bfloat16. Returns
// cudaGetLastError().
extern "C" int doda_banded_conv_sm(
    const void* x, long long ldx, const void* gyz, long long ldg,
    const void* gxm, long long ldm, const void* gxp, long long ldp,
    const void* wc, const void* wh, const void* wx, void* out, long long B,
    int cin, int N, int side, int out_dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || cin <= 0 || cin % 16 || (side != 2 && side != 4) ||
      N <= 0 || N % (8 * side * side) || (out_dtype != 0 && out_dtype != 1))
    return (int)cudaErrorInvalidValue;
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  if (side == 4)
    return launch<4>(make_plan<4>(f(x), ldx, f(gyz), ldg, f(gxm), ldm,
                                  f(gxp), ldp, f(wc), f(wh), f(wx), cin, N),
                     out, B, N, out_dtype, st);
  return launch<2>(make_plan<2>(f(x), ldx, f(gyz), ldg, f(gxm), ldm, f(gxp),
                                ldp, f(wc), f(wh), f(wx), cin, N),
                   out, B, N, out_dtype, st);
}
