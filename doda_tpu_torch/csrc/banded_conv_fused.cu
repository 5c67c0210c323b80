// Kernel K1, second version: the submanifold 3^3 conv straight from the
// activation and the rulebook, with the halo assembled in shared memory.
//
// Replaces the TPU kernel doda_tpu/ops/pallas_banded.py::banded_conv
// together with the plane assembly in front of it,
// doda_tpu/ops/bricks2d.py::_assemble_p6. For x2 (rows, 64*cin) bf16, the
// rulebook nbr (rows, 27) int32 (null id == rows) and raster weights
// w (27, cin, cout) bf16 it writes, unmasked and accumulated in float32,
//
//     out[b, cell, :] = sum_{tap} halo_b[cell + tap] @ w[tap]
//
// where halo_b is the 6x6x6 cell neighbourhood of brick b: exactly
// banded_conv(_assemble_p6(x2, halo_index(nbr)), banded_weights(w)).
//
// What bounds it on an H100. The function moves x2 once, out once and nbr
// (0.69 GB, 0.206 ms at 3.35 TB/s at rows = 163840, cin = cout = 16) and
// needs 1.45e11 FLOPs of taps (0.147 ms at 989 TFLOP/s): bytes at 16 -> 16,
// operations from 32 -> 32 on. The first version read six assembled planes
// (3.4x the activation, written by a gather and read back) and multiplied
// a band that is 75% placed zeros.
//
// What the design does about it.
//  * No planes in device memory. A block owns tiles of TB bricks, one warp
//    per brick (TB = 4 where two blocks then fit an SM's shared memory, the
//    shallow levels; else 8). For each brick it reads the 27 rulebook entries, derives
//    the source (neighbour, cell) of each of the 216 halo cells in closed
//    form (the map of bricks2d._halo_map) and copies the cells from x2 into
//    shared memory with 16-byte cp.async; an absent neighbour is zero-filled
//    (source size 0), so no zero row is appended to x2. Channels are walked
//    in chunks of 16 (32 bytes a cell, 6.9 KB a brick), so every width fits.
//    Two stages: the copies of the next (tile, chunk) step are in flight
//    while the current one is multiplied; the rulebook rows run one tile
//    further ahead. Which (brick, halo cell) a thread copies never changes,
//    so its destinations and rulebook slots are packed into registers once
//    and a step's copy costs a shared-memory load and an address, not the
//    geometry.
//  * No placed zeros. With the halo in shared memory the conv is an
//    implicit GEMM, M = 64 cells of a brick, K = 27*cin, N = cout, straight
//    from the raster weights: 2 * rows * 64 * 27 * cin * cout FLOPs, the
//    non-zero taps and nothing else. No banded weights are built. The
//    weights of a block's cout chunk (at most 32 wide, blockIdx.y) stay in
//    shared memory for all of cin where they fit (72 KB), else they ride
//    in the stages.
//  * Tensor cores fed from shared memory: mma.sync m16n8k16 (bf16, float32
//    accumulators) with ldmatrix. An A tile is the 16 cells of one x-slice
//    shifted by the tap: ldmatrix takes one row address a thread, so the
//    overlapping, non-uniform rows cost nothing. Output slice m under
//    tap dx reads halo plane m + dx, so for each (dy, dz) a warp loads the
//    six planes' A tiles once and uses each for up to three dx (54 A loads
//    a chunk instead of 108), with the three taps' B tiles loaded once for
//    all four slices. 32-byte cells
//    would put the two y-rows of a tile on the same banks: the two 16-byte
//    halves of a cell are swapped on odd halo y-rows (and the weight rows
//    have an odd pitch in 16-byte units), so ldmatrix is conflict-free.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int TAPS = 27;
constexpr int HCELLS = 216;              // 6*6*6 halo cells of a brick
constexpr int CK = 16;                   // channels per chunk (one mma K)
constexpr int CELL_B = CK * 2;           // bytes of a cell chunk
constexpr int HALO_B = HCELLS * CELL_B;  // 6912
constexpr int NT_MAX = 4;                // n8 tiles per block: cout chunk <= 32
constexpr int W_RESIDENT_B = 72 * 1024;  // keep all of cin's weights below this
constexpr int TWO_BLOCKS_B = 113 * 1024; // two blocks fit an SM below this

// One block owns tiles of TB bricks, one warp per brick. TB = 4 where two
// blocks fit an SM's shared memory (the shallow levels), else TB = 8.
template <int TB> struct Tile {
  static constexpr int THREADS = TB * 32;
  static constexpr int STAGE_B = TB * HALO_B;
  static constexpr int NBR_INTS = (TB * TAPS + 31) / 32 * 32;
  static constexpr int COPIES = (TB * HCELLS * 2 + THREADS - 1) / THREADS;
  static constexpr int MAX_SMEM = 2 * NBR_INTS * 4 + W_RESIDENT_B + 2 * STAGE_B;
};

struct Params {
  const bf16* x;       // (rows, 64*cin)
  const int* nbr;      // (rows, 27)
  const bf16* w;       // (27, cin, cout)
  void* out;           // (rows, 64*cout)
  long long rows;
  long long ntiles;
  int cin, cout;
  int nc;              // couts per block (multiple of 8, <= 32)
  int wpitch;          // bytes of a weight row in shared memory
  int nk;              // cin chunks
  int w_resident;      // all chunks' weights loaded once
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
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// halo coordinate h' = 0..5 (brick coordinate h' - 1): the neighbour offset
// + 1 it comes from, and the coordinate inside that neighbour
__device__ __forceinline__ int halo_dir(int h) { return h == 0 ? 0 : (h == 5 ? 2 : 1); }
__device__ __forceinline__ int halo_pos(int h) { return (h + 3) & 3; }

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <typename OutT, int TB>
__global__ void __launch_bounds__(Tile<TB>::THREADS) fused_tc(const Params p) {
  using T = Tile<TB>;
  extern __shared__ __align__(128) unsigned char smem[];
  int* nbr_s = reinterpret_cast<int*>(smem);            // [2][NBR_INTS]
  unsigned char* w_s = smem + 2 * T::NBR_INTS * 4;      // weight chunks
  const int wbuf_b = TAPS * CK * p.wpitch;              // one chunk
  unsigned char* h_s = w_s + (p.w_resident ? p.nk : 2) * wbuf_b;  // [2] stages

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n0 = blockIdx.y * p.nc;
  const int nt = min(p.nc, p.cout - n0) >> 3;           // valid n8 tiles
  const long long nti =
      (p.ntiles - blockIdx.x + gridDim.x - 1) / gridDim.x;  // my tiles
  auto tile_of = [&](long long i) {
    return (long long)blockIdx.x + i * (long long)gridDim.x;
  };

  // This thread's 16-byte copies of a step are the same (brick, halo cell,
  // half) every step; only the rulebook entry changes. Each is packed once:
  // destination / 16 (12 bits) | rulebook slot b*27 + col (8) | source cell
  // (6) | half (1) | valid (1).
  uint32_t copy[T::COPIES];
#pragma unroll
  for (int k = 0; k < T::COPIES; ++k) {
    const int e = tid + k * T::THREADS;
    const int b = e / (HCELLS * 2);
    const int rem = e - b * (HCELLS * 2);
    const int hc = rem >> 1, half = rem & 1;
    const int hx = hc / 36, r2 = hc - hx * 36, hy = r2 / 6, hz = r2 - hy * 6;
    const int col = halo_dir(hx) * 9 + halo_dir(hy) * 3 + halo_dir(hz);
    const int cell = halo_pos(hx) * 16 + halo_pos(hy) * 4 + halo_pos(hz);
    const int dst = b * HALO_B + hc * CELL_B + ((half ^ (hy & 1)) << 4);
    copy[k] = e < TB * HCELLS * 2
                  ? (uint32_t)(dst >> 4) | (uint32_t)(b * TAPS + col) << 12 |
                        (uint32_t)cell << 20 | (uint32_t)half << 26 | 1u << 27
                  : 0u;
  }

  // rulebook rows of a tile -> shared memory; -1 past the end
  auto load_nbr = [&](long long i, int buf) {
    const long long tile = tile_of(i);
    for (int e = tid; e < TB * TAPS; e += T::THREADS) {
      const long long brick = tile * TB + e / TAPS;
      int* dst = nbr_s + buf * T::NBR_INTS + e;
      if (i < nti && brick < p.rows)
        cp_async4(dst, p.nbr + brick * TAPS + e % TAPS);
      else
        *dst = -1;
    }
  };
  // the 216 halo cells of each brick of a tile, channels [16kc, 16kc+16)
  auto issue_halo = [&](int kc, int stage, int nbuf) {
    const int* nb = nbr_s + nbuf * T::NBR_INTS;
    unsigned char* st = h_s + stage * T::STAGE_B;
#pragma unroll
    for (int k = 0; k < T::COPIES; ++k) {
      const uint32_t d = copy[k];
      if (d >> 27) {
        const int src = nb[(d >> 12) & 0xff];
        const int ch = kc * CK + (int)((d >> 26) & 1) * 8;
        const bool ok = src >= 0 && src < p.rows && ch < p.cin;
        const bf16* g = ok ? p.x + ((long long)src * 64 + ((d >> 20) & 63)) *
                                       p.cin + ch
                           : p.x;
        cp_async16(st + ((d & 0xfff) << 4), g, ok ? 16 : 0);
      }
    }
  };
  // weights w[:, 16kc:16kc+16, n0:n0+nc] -> rows (tap, k) of wpitch bytes
  auto issue_w = [&](int kc, int wbuf) {
    const int units = p.nc >> 3;
    unsigned char* wd = w_s + wbuf * wbuf_b;
    for (int row = tid; row < TAPS * CK; row += T::THREADS) {
      const int tap = row >> 4, ch = kc * CK + (row & 15);
      const bf16* g = p.w + ((long long)tap * p.cin + ch) * p.cout + n0;
      for (int u = 0; u < units; ++u) {
        const bool ok = ch < p.cin && n0 + u * 8 < p.cout;
        cp_async16(wd + row * p.wpitch + u * 16, ok ? g + u * 8 : p.w,
                   ok ? 16 : 0);
      }
    }
  };

  // this lane's row of an A tile: cell (y, z) of an x-slice, and which
  // 8-channel half of the chunk its ldmatrix address points at
  const int r = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int ay = r >> 2, az = r & 3;
  const uint32_t a_off = (ay * 6 + az) * CELL_B;
  const int a_half = (lane >> 4) ^ (ay & 1);
  // and of a B tile pair: weight row k = lane % 16, n8 tile lane / 16
  const uint32_t b_off = (lane & 15) * p.wpitch + (lane >> 4) * 16;

  float acc[4][NT_MAX][4];

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
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int j = 0; j < NT_MAX; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.0f;
    }

    // Output slice m under tap dx reads halo plane m + dx: the six planes'
    // A tiles of one (dy, dz) are loaded once and feed all three dx.
    const uint32_t hbase =
        smem_u32(h_s + stage * T::STAGE_B + warp * HALO_B) + a_off;
    const uint32_t wbase =
        smem_u32(w_s + (p.w_resident ? kc : stage) * wbuf_b) + b_off;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
      for (int dz = 0; dz < 3; ++dz) {
        const uint32_t aaddr =
            hbase + (dy * 6 + dz) * CELL_B + ((a_half ^ (dy & 1)) << 4);
        uint32_t a[6][4];
#pragma unroll
        for (int pl = 0; pl < 6; ++pl) ldsm_x4(a[pl], aaddr + pl * 36 * CELL_B);
#pragma unroll
        for (int jp = 0; jp < NT_MAX / 2; ++jp) {
          if (2 * jp < nt) {
            uint32_t b[3][4];
#pragma unroll
            for (int dx = 0; dx < 3; ++dx)
              ldsm_x4_trans(b[dx], wbase +
                                       ((dx * 3 + dy) * 3 + dz) * CK * p.wpitch +
                                       jp * 32);
#pragma unroll
            for (int dx = 0; dx < 3; ++dx)
#pragma unroll
              for (int m = 0; m < 4; ++m)
                mma_bf16(acc[m][2 * jp], a[m + dx], b[dx][0], b[dx][1]);
            if (2 * jp + 1 < nt) {
#pragma unroll
              for (int dx = 0; dx < 3; ++dx)
#pragma unroll
                for (int m = 0; m < 4; ++m)
                  mma_bf16(acc[m][2 * jp + 1], a[m + dx], b[dx][2], b[dx][3]);
            }
          }
        }
      }
    }

    if (last) {
      const long long brick = tile_of(i) * TB + warp;
      if (brick < p.rows) {
        OutT* o = static_cast<OutT*>(p.out) +
                  (brick * 64 + (lane >> 2)) * p.cout + n0 + (lane & 3) * 2;
#pragma unroll
        for (int m = 0; m < 4; ++m)
#pragma unroll
          for (int j = 0; j < NT_MAX; ++j)
            if (j < nt) {
              OutT* q = o + (long long)(m * 16) * p.cout + j * 8;
              store2(q, acc[m][j][0], acc[m][j][1]);
              store2(q + 8LL * p.cout, acc[m][j][2], acc[m][j][3]);
            }
      }
    }
    kc = kc1;
    i = i1;
  }
}

// cout chunk per block, shared-memory layout and size for a shape; returns
// the bricks per tile
int plan(int cin, int cout, Params* p, int* smem_bytes) {
  const int nchunks = (cout + 8 * NT_MAX - 1) / (8 * NT_MAX);
  p->nc = ((cout + nchunks - 1) / nchunks + 7) / 8 * 8;
  p->wpitch = 16 * ((p->nc / 8) | 1);
  p->nk = (cin + CK - 1) / CK;
  const int wbuf_b = TAPS * CK * p->wpitch;
  p->w_resident = (long long)p->nk * wbuf_b <= W_RESIDENT_B;
  const int w_b = (p->w_resident ? p->nk : 2) * wbuf_b;
  const int smem4 = 2 * Tile<4>::NBR_INTS * 4 + w_b + 2 * Tile<4>::STAGE_B;
  if (smem4 <= TWO_BLOCKS_B) {
    *smem_bytes = smem4;
    return 4;
  }
  *smem_bytes = 2 * Tile<8>::NBR_INTS * 4 + w_b + 2 * Tile<8>::STAGE_B;
  return 8;
}

template <typename OutT, int TB>
int launch(Params p, int smem_bytes, cudaStream_t s) {
  using T = Tile<TB>;
  p.ntiles = (p.rows + TB - 1) / TB;
  cudaError_t e = cudaFuncSetAttribute(
      fused_tc<OutT, TB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      T::MAX_SMEM);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return (int)e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, fused_tc<OutT, TB>, T::THREADS, smem_bytes)) !=
      cudaSuccess)
    return (int)e;
  if (per_sm < 1) return (int)cudaErrorLaunchOutOfResources;
  const int ny = (p.cout + p.nc - 1) / p.nc;
  long long gx = (long long)per_sm * sms / ny;   // one resident wave
  if (gx < 1) gx = 1;
  if (gx > p.ntiles) gx = p.ntiles;
  fused_tc<OutT, TB><<<dim3((unsigned)gx, (unsigned)ny), T::THREADS,
                       smem_bytes, s>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of a launch at (cin, cout), bytes; -1 if refused.
extern "C" int doda_banded_conv_fused_smem(int cin, int cout) {
  if (cin <= 0 || cin % 8 || cout <= 0 || cout % 8) return -1;
  Params p;
  int smem_bytes = 0;
  plan(cin, cout, &p, &smem_bytes);
  return smem_bytes;
}

// out_dtype: 0 = float32, 1 = bfloat16; operands are bfloat16. Returns
// cudaGetLastError().
extern "C" int doda_banded_conv_fused(const void* x2, const void* nbr,
                                      const void* w, void* out,
                                      long long rows, int cin, int cout,
                                      int out_dtype, void* stream) {
  if (rows <= 0 || rows > 0x7fffffffLL || cin <= 0 || cin % 8 || cout <= 0 ||
      cout % 8 || (out_dtype != 0 && out_dtype != 1))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.x = static_cast<const bf16*>(x2);
  p.nbr = static_cast<const int*>(nbr);
  p.w = static_cast<const bf16*>(w);
  p.out = out;
  p.rows = rows;
  p.ntiles = 0;
  p.cin = cin;
  p.cout = cout;
  int smem_bytes = 0;
  const int tb = plan(cin, cout, &p, &smem_bytes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tb == 4)
    return out_dtype == 1 ? launch<bf16, 4>(p, smem_bytes, s)
                          : launch<float, 4>(p, smem_bytes, s);
  return out_dtype == 1 ? launch<bf16, 8>(p, smem_bytes, s)
                        : launch<float, 8>(p, smem_bytes, s);
}
