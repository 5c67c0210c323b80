// Kernel K1, float32: the submanifold 3^3 conv straight from the activation
// and the rulebook, on the CUDA cores.
//
// Replaces the TPU kernel doda_tpu/ops/pallas_banded.py::banded_conv on
// float32 operands, together with the plane assembly in front of it,
// doda_tpu/ops/bricks2d.py::_assemble_p6. For x2 (rows, S^3*cin) float32,
// the rulebook nbr (rows, 27) int32 (null id == rows) and raster weights
// w (27, cin, cout) float32 it writes, unmasked,
//
//     out[b, cell, :] = sum_{tap} halo_b[cell + tap] @ w[tap]
//
// where halo_b is the (S+2)^3 cell neighbourhood of brick b: the function
// of banded_conv(_assemble_p6(x2, halo_index(nbr)), banded_weights(w)), for
// any cin >= 1 and cout >= 1. Every product and sum is a float32 FMA (no
// TF32: the float32 checks of the model need full float32), and each
// output is one thread's register, summed in a fixed order (channel chunk,
// dx, dy, dz, channel): no atomics, the same bits on every call.
//
// What bounds it on an H100: float32 operations. At the level-0 bench shape
// (rows = 163840 bricks of side 4, 16 -> 16) the taps of the present halo
// cells are at most 1.45e11 FLOPs, 2.2 ms at 67 TFLOP/s, against 1.36 GB of
// x2, out and nbr (0.41 ms at 3.35 TB/s). To reach the FFMA rate an SM must
// issue an FFMA every cycle on each of its four schedulers, so every other
// instruction, shared loads included, is time taken from it. The first
// version (banded_f32 of banded_conv.cu, deleted) read six assembled halo
// planes (3.4x the activation, written by a gather first), multiplied the
// whole band (4x the taps) and fed a 4x4 register tile from scalar shared
// loads (8 operands for 16 FMAs).
//
// What the design does about it.
//  * No planes: the staging of the fused K1 (banded_conv_fused.cu). A block
//    owns tiles of TB bricks. For each brick it reads the 27 rulebook
//    entries, derives the source (neighbour, cell) of each halo cell in
//    closed form (bricks2d._halo_map; a table of the (S+2)^3 cells in
//    shared memory) and copies the cells from x2 into shared memory with
//    cp.async; an absent neighbour is zero-filled (source size 0). Two
//    stages: the copies of the next (tile, chunk) step are in flight while
//    the current one is multiplied; the rulebook rows ride a tile ahead.
//  * A chunk is 4 channels, 16 bytes a cell, so a side-4 brick's halo is
//    3.5 KB a stage (the bf16 kernel's 16-channel chunks would be 32 bytes,
//    6.9 KB in float32 at 8 channels): 16 bricks a stage and 8 warps a
//    block fit beside the resident weights. At side 2 a brick reads 64 halo
//    cells for 8 outputs; a tile is 64 bricks (2 x 65 KB of stages).
//  * Taps only, from the raster weights: each output cell sums 27 shifted
//    halo cells times w[tap], into float32 registers; no banded weights, no
//    placed zeros, no MMA. The weights of a block's cout chunk (at most 32
//    couts, blockIdx.y; more blocks where cout is wider, which also fills
//    the card at the deep levels' 512-3,072 rows) stay in shared memory for
//    all of cin where they fit (64 KB), else they ride in the stages.
//  * A register tile of 8 cells x 8 couts a thread (64 accumulators): at
//    S = 4 two y-rows of one x-slice of a brick, at S = 2 the whole brick.
//    For each (dx, dy) a thread loads its cells' halo rows once as float4s
//    (the chunk's 4 channels of a cell; 12 at S = 4: 2 rows x 6 z), each
//    read by up to three dz taps; each (tap, channel)'s 8 weights are two
//    float4 loads at one address for the whole warp (its couts are the
//    warp's), which feed 64 FMAs. 36 shared loads feed 768 FMAs at S = 4.
//  * Bank conflicts: the 8 lanes of a quarter warp are 8 bricks of the tile
//    at the same cell offsets, and a brick's halo takes (S+2)^3 + 1 16-byte
//    slots, an odd number, so their float4 loads fall on 8 distinct 16-byte
//    bank groups. (The bf16 kernel's half swap on odd y-rows serves
//    ldmatrix's 8 rows of one brick; nothing here reads that pattern.)
//  * Every width. cin % 4 == 0 copies whole 16-byte cells; any other cin
//    (the 3 -> 16 input conv) copies 4-byte channels, the lanes past cin
//    zero-filled in the halo and the weights, so no plane is ever needed.
//    cout comes in cout groups of 8 per warp; a ragged last group is masked
//    at the store. The brick side S is a template parameter, 2 or 4; the
//    row maps use shifts and masks, no signed division.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int TAPS = 27;
constexpr int CQ = 4;                     // channels a chunk: a float4 a cell
constexpr int NG = 8;                     // couts a thread
constexpr int MAX_G = 4;                  // cout groups a block: <= 32 couts
constexpr int THREADS_MAX = 256;
constexpr int W_RESIDENT_B = 64 * 1024;   // keep all of cin's weights below

// What the brick side S fixes.
template <int S> struct Geo {
  static constexpr int HS = S + 2;                 // halo side
  static constexpr int PLANE = HS * HS;            // cells a halo x-plane
  static constexpr int HCELLS = HS * PLANE;        // 216 at S = 4, 64 at 2
  static constexpr int SLICE = S * S;              // cells an x-slice
  static constexpr int CELLS = S * SLICE;          // cells a brick
  static constexpr int BP = HCELLS + 1;            // 16-byte slots a brick
  static constexpr int XT = S == 4 ? 1 : 2;        // a thread's x-slices
  static constexpr int YT = 2;                     // its y-rows
  static constexpr int UNITS = CELLS / 8;          // threads a brick, group
  static_assert(S == 2 || S == 4, "K1 float32 is built for sides 2 and 4");
  static_assert(XT * YT * S == 8 && (BP & 1), "8 cells a thread, odd pitch");
};

// A block owns tiles of TB bricks; P = TB * UNITS threads take one cout
// group of 8, and a block runs one group of P threads per cout group.
template <int S, int TB> struct Tile {
  using G = Geo<S>;
  static constexpr int P = TB * G::UNITS;
  static constexpr int STAGE_B = TB * G::BP * 16;
  static constexpr int NBR_INTS = (TB * TAPS + 31) / 32 * 32;
  static constexpr int TAB_B = (G::HCELLS + 3) / 4 * 16;
  static_assert(TB % 8 == 0 && P % 32 == 0 && P * 2 <= THREADS_MAX,
                "whole warps, quarter warps of 8 bricks");
};

struct Params {
  const float* x;      // (rows, S^3*cin)
  const int* nbr;      // (rows, 27)
  const float* w;      // (27, cin, cout)
  void* out;           // (rows, S^3*cout)
  long long rows;
  long long ntiles;
  int cin, cout;
  int nc;              // couts a block (a multiple of 8, <= 32)
  int ng;              // cout groups a block: nc / 8
  int nk;              // channel chunks of 4
  int w_resident;      // all chunks' weights loaded once
  int vec_x;           // cin % 4 == 0 and x 16-byte aligned
  int vec_w;           // cout % 4 == 0 and w 16-byte aligned
  int vec_out;         // cout % 8 == 0: whole cout groups
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// halo coordinate h = 0..S+1 (brick coordinate h - 1): the neighbour
// offset + 1 it comes from, and the coordinate inside that neighbour
template <int S> __device__ __forceinline__ int halo_dir(int h) {
  return h == 0 ? 0 : (h == S + 1 ? 2 : 1);
}
template <int S> __device__ __forceinline__ int halo_pos(int h) {
  return (h + S - 1) & (S - 1);
}

__device__ __forceinline__ void store8(float* o, const float (&v)[NG]) {
  *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(o + 4) = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(bf16* o, const float (&v)[NG]) {
  uint4 u;
  uint32_t* q = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
    q[j] = *reinterpret_cast<const uint32_t*>(&h);
  }
  *reinterpret_cast<uint4*>(o) = u;
}
__device__ __forceinline__ void store1(float* o, float v) { *o = v; }
__device__ __forceinline__ void store1(bf16* o, float v) {
  *o = __float2bfloat16(v);
}

template <typename OutT, int S, int TB>
__global__ void __launch_bounds__(THREADS_MAX) subm_f32(const Params p) {
  using G = Geo<S>;
  using T = Tile<S, TB>;
  constexpr int XT = G::XT, YT = G::YT;
  extern __shared__ __align__(16) unsigned char smem[];
  int* nbr_s = reinterpret_cast<int*>(smem);             // [2][NBR_INTS]
  int* tab_s = nbr_s + 2 * T::NBR_INTS;                  // [HCELLS]
  float* w_s = reinterpret_cast<float*>(smem + 2 * T::NBR_INTS * 4 +
                                        T::TAB_B);       // weights
  const int wchunk = TAPS * CQ * p.nc;                   // floats a chunk
  float4* h_s = reinterpret_cast<float4*>(
      w_s + (p.w_resident ? p.nk : 2) * wchunk);         // [2] stages

  const int tid = threadIdx.x, nthreads = blockDim.x;
  // this thread: cout group gi, brick b of the tile, cells from (x0, y0, 0)
  const int gi = tid / T::P, pi = tid - gi * T::P;
  const int b = pi & (TB - 1), unit = pi / TB;
  const int x0 = S == 4 ? unit >> 1 : 0, y0 = S == 4 ? (unit & 1) * 2 : 0;
  const int n0 = blockIdx.y * p.nc;
  const int n = n0 + gi * NG;                            // its first cout
  const long long nti =
      (p.ntiles - blockIdx.x + gridDim.x - 1) / gridDim.x;  // my tiles
  auto tile_of = [&](long long i) {
    return (long long)blockIdx.x + i * (long long)gridDim.x;
  };

  // halo cell hc -> rulebook column | source cell << 5
  for (int hc = tid; hc < G::HCELLS; hc += nthreads) {
    const int hx = hc / G::PLANE, r2 = hc - hx * G::PLANE, hy = r2 / G::HS,
              hz = r2 - hy * G::HS;
    const int col =
        halo_dir<S>(hx) * 9 + halo_dir<S>(hy) * 3 + halo_dir<S>(hz);
    const int cell = halo_pos<S>(hx) * G::SLICE + halo_pos<S>(hy) * S +
                     halo_pos<S>(hz);
    tab_s[hc] = col | cell << 5;
  }

  // rulebook rows of a tile -> shared memory; -1 past the end
  auto load_nbr = [&](long long i, int buf) {
    const long long tile = tile_of(i);
    for (int e = tid; e < TB * TAPS; e += nthreads) {
      const long long brick = tile * TB + e / TAPS;
      int* dst = nbr_s + buf * T::NBR_INTS + e;
      if (i < nti && brick < p.rows)
        cp_async4(dst, p.nbr + brick * TAPS + e % TAPS, 4);
      else
        *dst = -1;
    }
  };
  // the halo cells of each brick of a tile, channels [4kc, 4kc+4)
  auto issue_halo = [&](int kc, int stage, int nbuf) {
    const int* nb = nbr_s + nbuf * T::NBR_INTS;
    float4* st = h_s + stage * (TB * G::BP);
    const int ch = kc * CQ;
    for (int e = tid; e < TB * G::HCELLS; e += nthreads) {
      const int bb = e / G::HCELLS, hc = e - bb * G::HCELLS;
      const int t = tab_s[hc];
      const int src = nb[bb * TAPS + (t & 31)];
      const bool ok = src >= 0 && src < p.rows;
      const float* g =
          p.x + ((long long)(ok ? src : 0) * G::CELLS + (t >> 5)) * p.cin + ch;
      float4* dst = st + bb * G::BP + hc;
      if (p.vec_x) {
        cp_async16(dst, ok ? g : p.x, ok ? 16 : 0);
      } else {
#pragma unroll
        for (int j = 0; j < CQ; ++j) {
          const bool okj = ok && ch + j < p.cin;
          cp_async4(reinterpret_cast<float*>(dst) + j, okj ? g + j : p.x,
                    okj ? 4 : 0);
        }
      }
    }
  };
  // weights w[:, 4kc:4kc+4, n0:n0+nc] -> rows (tap, channel) of nc floats
  auto issue_w = [&](int kc, int wbuf) {
    const int units = p.nc >> 2;
    float* wd = w_s + wbuf * wchunk;
    for (int e = tid; e < TAPS * CQ * units; e += nthreads) {
      const int row = e / units, u4 = e - row * units;
      const int tap = row >> 2, ch = kc * CQ + (row & 3), c0 = n0 + u4 * 4;
      const float* g = p.w + ((long long)tap * p.cin + ch) * p.cout + c0;
      float* dst = wd + row * p.nc + u4 * 4;
      if (p.vec_w) {
        const bool ok = ch < p.cin && c0 < p.cout;
        cp_async16(dst, ok ? g : p.w, ok ? 16 : 0);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bool ok = ch < p.cin && c0 + j < p.cout;
          cp_async4(dst + j, ok ? g + j : p.w, ok ? 4 : 0);
        }
      }
    }
  };

  float acc[8][NG];

  load_nbr(0, 0);
  load_nbr(1, 1);
  if (p.w_resident)
    for (int kc = 0; kc < p.nk; ++kc) issue_w(kc, kc);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  issue_halo(0, 0, 0);
  if (!p.w_resident) issue_w(0, 0);
  cp_async_commit();

  const long long steps = nti * p.nk;
  long long i = 0;
  int kc = 0;
  for (long long s = 0; s < steps; ++s) {
    cp_async_wait_all();
    __syncthreads();
    const int stage = (int)(s & 1);
    const bool last = kc == p.nk - 1;
    const int kc1 = last ? 0 : kc + 1;
    const long long i1 = last ? i + 1 : i;
    if (s + 1 < steps) {
      issue_halo(kc1, stage ^ 1, (int)(i1 & 1));
      if (!p.w_resident) issue_w(kc1, stage ^ 1);
    }
    if (last) load_nbr(i + 2, (int)(i & 1));
    cp_async_commit();

    if (kc == 0) {
#pragma unroll
      for (int c = 0; c < 8; ++c)
#pragma unroll
        for (int j = 0; j < NG; ++j) acc[c][j] = 0.0f;
    }

    // For each (dx, dy) the thread's XT x YT halo rows of S+2 cells, each
    // cell's float4 read by the dz taps of up to three of its cells.
    const float4* hb = h_s + stage * (TB * G::BP) + b * G::BP +
                       x0 * G::PLANE + y0 * G::HS;
    const float* wk = w_s + (p.w_resident ? kc : stage) * wchunk + gi * NG;
#pragma unroll 1
    for (int dx = 0; dx < 3; ++dx) {
#pragma unroll 1
      for (int dy = 0; dy < 3; ++dy) {
        const float4* hr = hb + dx * G::PLANE + dy * G::HS;
        float4 a[XT][YT][S + 2];
#pragma unroll
        for (int xi = 0; xi < XT; ++xi)
#pragma unroll
          for (int yi = 0; yi < YT; ++yi)
#pragma unroll
            for (int hz = 0; hz < S + 2; ++hz)
              a[xi][yi][hz] = hr[xi * G::PLANE + yi * G::HS + hz];
        const float* wt = wk + (dx * 3 + dy) * 3 * CQ * p.nc;
#pragma unroll
        for (int dz = 0; dz < 3; ++dz) {
#pragma unroll
          for (int c = 0; c < CQ; ++c) {
            const float* wr = wt + (dz * CQ + c) * p.nc;
            const float4 w0 = *reinterpret_cast<const float4*>(wr);
            const float4 w1 = *reinterpret_cast<const float4*>(wr + 4);
            const float wv[NG] = {w0.x, w0.y, w0.z, w0.w,
                                  w1.x, w1.y, w1.z, w1.w};
#pragma unroll
            for (int xi = 0; xi < XT; ++xi)
#pragma unroll
              for (int yi = 0; yi < YT; ++yi)
#pragma unroll
                for (int z = 0; z < S; ++z) {
                  const float4& av4 = a[xi][yi][z + dz];
                  const float av = c == 0   ? av4.x
                                   : c == 1 ? av4.y
                                   : c == 2 ? av4.z
                                            : av4.w;
                  float* o = acc[(xi * YT + yi) * S + z];
#pragma unroll
                  for (int j = 0; j < NG; ++j) o[j] = fmaf(av, wv[j], o[j]);
                }
          }
        }
      }
    }

    if (last) {
      const long long brick = tile_of(i) * TB + b;
      if (brick < p.rows && n < p.cout) {
#pragma unroll
        for (int xi = 0; xi < XT; ++xi)
#pragma unroll
          for (int yi = 0; yi < YT; ++yi)
#pragma unroll
            for (int z = 0; z < S; ++z) {
              const int c = (xi * YT + yi) * S + z;
              const int cell = (x0 + xi) * G::SLICE + (y0 + yi) * S + z;
              OutT* o = static_cast<OutT*>(p.out) +
                        (brick * G::CELLS + cell) * p.cout + n;
              if (p.vec_out) {
                store8(o, acc[c]);
              } else {
#pragma unroll
                for (int j = 0; j < NG; ++j)
                  if (n + j < p.cout) store1(o + j, acc[c][j]);
              }
            }
      }
    }
    kc = kc1;
    i = i1;
  }
}

template <int S, int TB>
constexpr int fixed_smem() {
  using T = Tile<S, TB>;
  return 2 * T::NBR_INTS * 4 + T::TAB_B + 2 * T::STAGE_B;
}

// couts a block, chunks, weight residency and the tile of a shape; returns
// TB and sets the dynamic shared memory. Side 4 takes 16 bricks a tile up
// to 16 couts a block (two cout groups of 128 threads), else 8; side 2
// takes 64.
template <int S>
int plan(int cin, int cout, Params* p, int* smem_bytes) {
  const int nchunks = (cout + NG * MAX_G - 1) / (NG * MAX_G);
  p->nc = ((cout + nchunks - 1) / nchunks + NG - 1) / NG * NG;
  p->ng = p->nc / NG;
  p->nk = (cin + CQ - 1) / CQ;
  const int wchunk_b = TAPS * CQ * p->nc * 4;
  p->w_resident = (long long)p->nk * wchunk_b <= W_RESIDENT_B;
  const int w_b = (p->w_resident ? p->nk : 2) * wchunk_b;
  int tb, fixed;
  if constexpr (S == 2) {
    tb = 64;
    fixed = fixed_smem<2, 64>();
  } else {
    tb = p->ng <= 2 ? 16 : 8;
    fixed = tb == 16 ? fixed_smem<4, 16>() : fixed_smem<4, 8>();
  }
  *smem_bytes = fixed + w_b;
  return tb;
}

template <typename OutT, int S, int TB>
int launch(Params p, int smem_bytes, cudaStream_t s) {
  using T = Tile<S, TB>;
  p.ntiles = (p.rows + TB - 1) / TB;
  const int threads = T::P * p.ng;
  auto kern = subm_f32<OutT, S, TB>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return (int)e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kern, threads, smem_bytes)) != cudaSuccess)
    return (int)e;
  if (per_sm < 1) return (int)cudaErrorLaunchOutOfResources;
  const int ny = (p.cout + p.nc - 1) / p.nc;
  long long gx = (long long)per_sm * sms / ny;   // one resident wave
  if (gx < 1) gx = 1;
  if (gx > p.ntiles) gx = p.ntiles;
  kern<<<dim3((unsigned)gx, (unsigned)ny), threads, smem_bytes, s>>>(p);
  return (int)cudaGetLastError();
}

template <typename OutT>
int run(Params p, int side, cudaStream_t s) {
  int smem_bytes = 0;
  if (side == 2) {
    plan<2>(p.cin, p.cout, &p, &smem_bytes);
    return launch<OutT, 2, 64>(p, smem_bytes, s);
  }
  const int tb = plan<4>(p.cin, p.cout, &p, &smem_bytes);
  return tb == 16 ? launch<OutT, 4, 16>(p, smem_bytes, s)
                  : launch<OutT, 4, 8>(p, smem_bytes, s);
}

}  // namespace

// 1 if the kernel is built for bricks of `side`, else 0.
extern "C" int doda_subm_conv_f32_has_side(int side) {
  return side == 2 || side == 4;
}

// Dynamic shared memory of a launch at (cin, cout) on bricks of `side`,
// bytes; -1 if refused.
extern "C" int doda_subm_conv_f32_smem(int cin, int cout, int side) {
  if (cin <= 0 || cout <= 0) return -1;
  Params p;
  int smem_bytes = 0;
  if (side == 4)
    plan<4>(cin, cout, &p, &smem_bytes);
  else if (side == 2)
    plan<2>(cin, cout, &p, &smem_bytes);
  else
    return -1;
  return smem_bytes;
}

// Operands float32; out_dtype: 0 = float32, 1 = bfloat16; side: the brick
// side, 2 or 4. Returns cudaGetLastError().
extern "C" int doda_subm_conv_f32(const void* x2, const void* nbr,
                                  const void* w, void* out, long long rows,
                                  int cin, int cout, int out_dtype, int side,
                                  void* stream) {
  if (rows <= 0 || rows > 0x7fffffffLL || cin <= 0 || cout <= 0 ||
      (out_dtype != 0 && out_dtype != 1) || (side != 2 && side != 4))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.x = static_cast<const float*>(x2);
  p.nbr = static_cast<const int*>(nbr);
  p.w = static_cast<const float*>(w);
  p.out = out;
  p.rows = rows;
  p.ntiles = 0;
  p.cin = cin;
  p.cout = cout;
  p.vec_x = cin % 4 == 0 && reinterpret_cast<uintptr_t>(x2) % 16 == 0;
  p.vec_w = cout % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  p.vec_out = cout % 8 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return out_dtype == 1 ? run<bf16>(p, side, s) : run<float>(p, side, s);
}
