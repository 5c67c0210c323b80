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
// banded_conv_plain(_assemble_p6(x2, halo_index(nbr)),
// banded_weights(w)). The route 'padded' (ops/banded_conv.py::
// banded_conv_padded) runs it on operands zero-padded to multiples of 8
// channels, for the bf16 widths no kernel takes as they are.
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
//
// The prologue variant (PRO, the fused norm + ReLU engine). It replaces
// the same TPU kernel as it runs under DODA_FUSE_NORM, on planes that
// doda_tpu/ops/bricks2d.py::_assemble_p6 assembled with a prologue:
// the conv reads where(occ, relu(x*scale + bias), 0) in place of x, and
// that activation never reaches device memory. Each brick's occupancy is
// one 64-bit word (bit c = cell c active, occ_words in ops/banded_conv.py).
// Its bound is K1's plus the occupancy words (8 bytes a brick, read up to
// 27 times from L2) and 3 float32 operations an input element. What it
// must not add is a pass over shared memory between two barriers, with
// every warp idle at the second. So the prologue is applied inside the
// copy pipeline, one barrier a step:
//  * The next (tile, chunk)'s cells are copied into the other stage with
//    cp.async before the current stage's MMAs, as in the plain variant.
//  * After its MMAs each thread waits for its own copies and rewrites the
//    16-byte cells it copied in place: relu(x*scale + bias) in float32 on
//    the bf16 value and the bf16 scale and bias (multiply, then add, each
//    rounded, as the plain version does), rounded once to bf16, and zero
//    where the cell's bit is clear (a bias > 0 would otherwise light
//    inactive cells through the ReLU). No other thread reads those cells
//    before the step's one barrier, which then hands the stage to
//    ldmatrix; the other warps' MMAs overlap the pass.
//  * The occupancy words ride a tile ahead of the copies: at a tile's last
//    step the words of tile i+2's neighbours are copied beside the
//    rulebook with cp.async (an absent neighbour's zero-fill gives word
//    0), so the rulebook rows ride three tiles ahead, in three buffers.
// Staging the cells through registers (loaded before the MMAs, the
// prologue applied on the way to st.shared) was tried: at 32 couts the 14
// uint4 a thread hold beside the accumulators spill past 255 registers,
// and it ran slower there, as did spreading the prologue between the MMAs.
//
// The brick side S (the JAX package's DODA_BRICK) is a template parameter,
// instantiated for 4 (everything above) and 2. A brick has S^3 cells, an
// (S+2)^3 halo of S+2 planes of (S+2)^2 cells, and S output x-slices of S^2
// cells. An A tile is 16 rows: at S = 4 the 16 cells of one x-slice of one
// brick; at S = 2 an x-slice holds 4 cells, so a warp owns BPW = 16 / S^2
// = 4 bricks and an A tile stacks the same x-slice of all four, each row
// addressed inside its own brick's halo (ldmatrix takes a row address a
// thread, so rows from four halos cost nothing extra). The warp's S m-tiles
// are its bricks' S x-slices, so the A tiles of one (dy, dz) are still
// loaded once per plane and feed all three dx. A tile of TB bricks is then
// 4 * warps, the block's stages and rulebook rows grow with it, and a
// side-2 brick's occupancy word uses bits 0-7.
// Swizzle at S = 2: a halo y-row is 4 cells of 32 bytes, one 128-byte line,
// and a brick's halo is 2048 bytes (16 lines), so the 8 rows of an 8x8
// ldmatrix phase (2 bricks x 2 y x 2 z) would fall on 2 of the 8 16-byte
// bank groups. Each brick's cells are laid out with the two 16-byte halves
// swapped on odd halo y-rows, as at S = 4, and with the cell's z position
// XORed with 2 in odd bricks of the tile: the 8 rows then take 8 distinct
// groups (the numpy mirror in tests/test_torch_brick_side.py checks it).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int TAPS = 27;
constexpr int CK = 16;                   // channels per chunk (one mma K)
constexpr int CELL_B = CK * 2;           // bytes of a cell chunk
constexpr int NT_MAX = 4;                // n8 tiles per block: cout chunk <= 32
constexpr int W_RESIDENT_B = 72 * 1024;  // keep all of cin's weights below this
constexpr int TWO_BLOCKS_B = 113 * 1024; // two blocks fit an SM below this

// What the brick side S fixes. A packed copy (see fused_tc) holds the
// destination / 16 (12 bits), the rulebook slot b*27 + col (SLOT_BITS),
// the source cell (CELL_BITS), the half (1) and a valid bit.
template <int S> struct Geo {
  static constexpr int HS = S + 2;                 // halo side
  static constexpr int PLANE = HS * HS;            // cells a halo x-plane
  static constexpr int HCELLS = HS * PLANE;        // 216 at S = 4, 64 at 2
  static constexpr int SLICE = S * S;              // cells an x-slice
  static constexpr int CELLS = S * SLICE;          // cells a brick
  static constexpr int BPW = 16 / SLICE;           // bricks a warp
  static constexpr int HALO_B = HCELLS * CELL_B;   // 6912 at S = 4
  static constexpr int SLOT_BITS = S == 4 ? 8 : 10;
  static constexpr int CELL_BITS = S == 4 ? 6 : 3;
  static constexpr int CELL_SHIFT = 12 + SLOT_BITS;
  static constexpr int HALF_SHIFT = CELL_SHIFT + CELL_BITS;
  static constexpr int VALID_SHIFT = HALF_SHIFT + 1;
  static_assert(S == 2 || S == 4, "fused K1 is built for sides 2 and 4");
  static_assert(16 % SLICE == 0 && VALID_SHIFT < 32, "");
};

// One block owns tiles of TB bricks, BPW bricks a warp (one at S = 4).
// WB = 4 warps where two blocks fit an SM's shared memory (the shallow
// levels), else WB = 8.
template <int S, int WB> struct Tile {
  using G = Geo<S>;
  static constexpr int TB = WB * G::BPW;
  static constexpr int THREADS = WB * 32;
  static constexpr int STAGE_B = TB * G::HALO_B;
  static constexpr int NBR_INTS = (TB * TAPS + 31) / 32 * 32;
  static constexpr int COPIES = (TB * G::HCELLS * 2 + THREADS - 1) / THREADS;
  static constexpr int OCC_B = NBR_INTS * 8;   // one stage of occupancy words
  static constexpr int MAX_SMEM =
      2 * NBR_INTS * 4 + 2 * OCC_B + W_RESIDENT_B + 2 * STAGE_B;
  static_assert(STAGE_B / 16 <= 4096 && TB * TAPS <= (1 << G::SLOT_BITS),
                "a packed copy's fields overflow");
};

struct Params {
  const bf16* x;       // (rows, 64*cin)
  const int* nbr;      // (rows, 27)
  const bf16* w;       // (27, cin, cout)
  void* out;           // (rows, 64*cout)
  const bf16* scale;   // (cin,) prologue scale, or null
  const bf16* bias;    // (cin,) prologue bias, or null
  const unsigned long long* occw;  // (rows,) occupancy words, or null
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
__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
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

// halo coordinate h' = 0..S+1 (brick coordinate h' - 1): the neighbour
// offset + 1 it comes from, and the coordinate inside that neighbour
template <int S> __device__ __forceinline__ int halo_dir(int h) {
  return h == 0 ? 0 : (h == S + 1 ? 2 : 1);
}
template <int S> __device__ __forceinline__ int halo_pos(int h) {
  return (h + S - 1) & (S - 1);
}
// byte offset of 16-byte half `half` of halo cell (hy, hz) of brick b of a
// tile (hc its raster index), swizzled (see the header)
template <int S>
__device__ __forceinline__ int halo_off(int hc, int hy, int half, int b) {
  const int c = S == 4 ? hc : hc ^ ((b & 1) << 1);
  return c * CELL_B + ((half ^ (hy & 1)) << 4);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// relu(v*s + b) of 8 bf16 channels in float32, rounded once to bf16. A
// product of two bf16 values is exact in float32 (above the subnormals),
// so one fma gives the plain version's rounded multiply, then rounded add,
// bit for bit; the ReLU rides the bf16 pack (cvt.rn.relu).
__device__ __forceinline__ uint4 prologue8(uint4 v, uint4 s, uint4 b) {
  const __nv_bfloat162* v2 = reinterpret_cast<const __nv_bfloat162*>(&v);
  const __nv_bfloat162* s2 = reinterpret_cast<const __nv_bfloat162*>(&s);
  const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&b);
  uint4 out;
  uint32_t* o = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 fv = __bfloat1622float2(v2[j]);
    const float2 fs = __bfloat1622float2(s2[j]);
    const float2 fb = __bfloat1622float2(b2[j]);
    asm("cvt.rn.relu.bf16x2.f32 %0, %1, %2;\n"
        : "=r"(o[j])
        : "f"(__fmaf_rn(fv.y, fs.y, fb.y)), "f"(__fmaf_rn(fv.x, fs.x, fb.x)));
  }
  return out;
}

// NTA: n8 tiles of the accumulators; the prologue variant sizes them by
// the block's cout chunk (2 at 16 couts, which ran faster at level 0)
template <typename OutT, int S, int WB, bool PRO, int NTA = NT_MAX>
__global__ void __launch_bounds__(Tile<S, WB>::THREADS)
    fused_tc(const Params p) {
  using T = Tile<S, WB>;
  using G = Geo<S>;
  constexpr int TB = T::TB;
  constexpr int HS = G::HS;
  constexpr int HALO_B = G::HALO_B;
  constexpr int NBUF = PRO ? 3 : 2;                     // rulebook buffers
  extern __shared__ __align__(128) unsigned char smem[];
  int* nbr_s = reinterpret_cast<int*>(smem);            // [NBUF][NBR_INTS]
  // [2][NBR_INTS] occupancy words of the rulebook's bricks (PRO only)
  unsigned long long* occ_s =
      reinterpret_cast<unsigned long long*>(smem + NBUF * T::NBR_INTS * 4);
  unsigned char* w_s =
      smem + NBUF * T::NBR_INTS * 4 + (PRO ? 2 * T::OCC_B : 0);  // weights
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
  // destination / 16 (12 bits) | rulebook slot b*27 + col (SLOT_BITS) |
  // source cell (CELL_BITS) | half (1) | valid (1).
  uint32_t copy[T::COPIES];
#pragma unroll
  for (int k = 0; k < T::COPIES; ++k) {
    const int e = tid + k * T::THREADS;
    const int b = e / (G::HCELLS * 2);
    const int rem = e - b * (G::HCELLS * 2);
    const int hc = rem >> 1, half = rem & 1;
    const int hx = hc / G::PLANE, r2 = hc - hx * G::PLANE, hy = r2 / HS,
              hz = r2 - hy * HS;
    const int col =
        halo_dir<S>(hx) * 9 + halo_dir<S>(hy) * 3 + halo_dir<S>(hz);
    const int cell = halo_pos<S>(hx) * G::SLICE + halo_pos<S>(hy) * S +
                     halo_pos<S>(hz);
    const int dst = b * HALO_B + halo_off<S>(hc, hy, half, b);
    copy[k] = e < TB * G::HCELLS * 2
                  ? (uint32_t)(dst >> 4) | (uint32_t)(b * TAPS + col) << 12 |
                        (uint32_t)cell << G::CELL_SHIFT |
                        (uint32_t)half << G::HALF_SHIFT | 1u << G::VALID_SHIFT
                  : 0u;
  }
  constexpr uint32_t SLOT_MASK = (1u << G::SLOT_BITS) - 1;
  constexpr uint32_t CELL_MASK = (1u << G::CELL_BITS) - 1;

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
  // the halo cells of each brick of a tile, channels [16kc, 16kc+16)
  auto issue_halo = [&](int kc, int stage, int nbuf) {
    const int* nb = nbr_s + nbuf * T::NBR_INTS;
    unsigned char* st = h_s + stage * T::STAGE_B;
#pragma unroll
    for (int k = 0; k < T::COPIES; ++k) {
      const uint32_t d = copy[k];
      if (d >> G::VALID_SHIFT) {
        const int src = nb[(d >> 12) & SLOT_MASK];
        const int ch = kc * CK + (int)((d >> G::HALF_SHIFT) & 1) * 8;
        const bool ok = src >= 0 && src < p.rows && ch < p.cin;
        const bf16* g =
            ok ? p.x + ((long long)src * G::CELLS +
                        ((d >> G::CELL_SHIFT) & CELL_MASK)) * p.cin + ch
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

  // PRO: the occupancy words of tile i's neighbours -> occ_s[i % 2]
  auto issue_occ = [&](long long i) {
    const int* nb = nbr_s + (int)(i % 3) * T::NBR_INTS;
    unsigned long long* ow = occ_s + (int)(i & 1) * T::NBR_INTS;
    for (int e = tid; e < TB * TAPS; e += T::THREADS) {
      const int src = nb[e];
      const bool ok = src >= 0 && src < p.rows;
      cp_async8(ow + e, ok ? p.occw + src : p.occw, ok ? 8 : 0);
    }
  };
  // PRO: this thread's own cells of (tile i, chunk kc), landed in a stage
  // by its cp.async, -> relu(x*scale + bias) in place, zero where the cell
  // is inactive. No other thread touches them before the next barrier.
  auto prologue_cells = [&](int kc, long long i, int stage) {
    cp_async_wait_all();
    const unsigned long long* ow = occ_s + (int)(i & 1) * T::NBR_INTS;
    unsigned char* st = h_s + stage * T::STAGE_B;
    // the chunk's scale and bias, per 8-channel half (cin % 8 == 0, so
    // a half lies wholly inside cin or wholly past it)
    const int c0 = kc * CK, c1 = c0 + 8;
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    const uint4 s0 = __ldg(reinterpret_cast<const uint4*>(p.scale + c0));
    const uint4 b0 = __ldg(reinterpret_cast<const uint4*>(p.bias + c0));
    const uint4 s1 = c1 < p.cin
        ? __ldg(reinterpret_cast<const uint4*>(p.scale + c1)) : zero;
    const uint4 b1 = c1 < p.cin
        ? __ldg(reinterpret_cast<const uint4*>(p.bias + c1)) : zero;
#pragma unroll
    for (int k = 0; k < T::COPIES; ++k) {
      const uint32_t d = copy[k];
      if (d >> G::VALID_SHIFT) {
        const bool hi = (d >> G::HALF_SHIFT) & 1;
        const bool on = (!hi || c1 < p.cin) &&
                        ((ow[(d >> 12) & SLOT_MASK] >>
                          ((d >> G::CELL_SHIFT) & CELL_MASK)) & 1);
        uint4* cell = reinterpret_cast<uint4*>(st + ((d & 0xfff) << 4));
        if (on)   // a branch, not a select: inactive cells skip the math
          *cell = prologue8(*cell, hi ? s1 : s0, hi ? b1 : b0);
        else
          *cell = zero;
      }
    }
  };

  // this lane's row of an A tile: cell (y, z) of an x-slice of the warp's
  // brick rb, and which 8-channel half of the chunk its ldmatrix address
  // points at
  const int r = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int rb = r / G::SLICE, aq = r % G::SLICE;
  const int ay = aq / S, az = aq % S;
  const uint32_t a_off = rb * HALO_B + (ay * HS + az) * CELL_B;
  const int a_half = (lane >> 4) ^ (ay & 1);
  // and of a B tile pair: weight row k = lane % 16, n8 tile lane / 16
  const uint32_t b_off = (lane & 15) * p.wpitch + (lane >> 4) * 16;

  float acc[S][NTA][4];

  load_nbr(0, 0);
  load_nbr(1, 1);
  if constexpr (PRO) load_nbr(2, 2);
  if (p.w_resident)
    for (int kc = 0; kc < p.nk; ++kc) issue_w(kc, kc);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  if constexpr (PRO) {   // tiles 0 and 1's occupancy words
    issue_occ(0);
    issue_occ(1);
  }
  issue_halo(0, 0, 0);
  if (!p.w_resident) issue_w(0, 0);
  cp_async_commit();
  if constexpr (PRO) {   // the first stage's prologue, before the loop
    cp_async_wait_all();
    __syncthreads();     // tile 0's occupancy words, copied by all threads
    prologue_cells(0, 0, 0);
  }

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
      if constexpr (PRO)   // the rulebook rows of tile i in buffer i % 3
        issue_halo(kc1, stage ^ 1, (int)(i1 % 3));
      else
        issue_halo(kc1, stage ^ 1, (int)(i1 & 1));
      if (!p.w_resident) issue_w(kc1, stage ^ 1);
    }
    if (last) {
      if constexpr (PRO) {
        issue_occ(i + 2);
        load_nbr(i + 3, (int)(i % 3));
      } else {
        load_nbr(i + 2, (int)(i & 1));
      }
    }
    cp_async_commit();

    if (kc == 0) {
#pragma unroll
      for (int m = 0; m < S; ++m)
#pragma unroll
        for (int j = 0; j < NTA; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.0f;
    }

    // Output slice m under tap dx reads halo plane m + dx: the S+2 planes'
    // A tiles of one (dy, dz) are loaded once and feed all three dx.
    const uint32_t hbase =
        smem_u32(h_s + stage * T::STAGE_B + warp * G::BPW * HALO_B) + a_off;
    const uint32_t wbase =
        smem_u32(w_s + (p.w_resident ? kc : stage) * wbuf_b) + b_off;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
      for (int dz = 0; dz < 3; ++dz) {
        uint32_t aaddr;
        if constexpr (S == 4) {
          aaddr = hbase + (dy * 6 + dz) * CELL_B + ((a_half ^ (dy & 1)) << 4);
        } else {   // the z swizzle of odd bricks acts on the shifted z
          const int hz = az + dz;
          aaddr = hbase + (dy * HS + (hz ^ ((rb & 1) << 1)) - az) * CELL_B +
                  ((a_half ^ (dy & 1)) << 4);
        }
        uint32_t a[HS][4];
#pragma unroll
        for (int pl = 0; pl < HS; ++pl)
          ldsm_x4(a[pl], aaddr + pl * G::PLANE * CELL_B);
#pragma unroll
        for (int jp = 0; jp < NTA / 2; ++jp) {
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
              for (int m = 0; m < S; ++m)
                mma_bf16(acc[m][2 * jp], a[m + dx], b[dx][0], b[dx][1]);
            if (2 * jp + 1 < nt) {
#pragma unroll
              for (int dx = 0; dx < 3; ++dx)
#pragma unroll
                for (int m = 0; m < S; ++m)
                  mma_bf16(acc[m][2 * jp + 1], a[m + dx], b[dx][2], b[dx][3]);
            }
          }
        }
      }
    }

    // PRO: the next stage's prologue, on this thread's own landed cells
    if constexpr (PRO)
      if (s + 1 < steps) prologue_cells(kc1, i1, stage ^ 1);

    if (last) {
      if constexpr (S == 4) {
        const long long brick = tile_of(i) * TB + warp;
        if (brick < p.rows) {
          OutT* o = static_cast<OutT*>(p.out) +
                    (brick * 64 + (lane >> 2)) * p.cout + n0 + (lane & 3) * 2;
#pragma unroll
          for (int m = 0; m < 4; ++m)
#pragma unroll
            for (int j = 0; j < NTA; ++j)
              if (j < nt) {
                OutT* q = o + (long long)(m * 16) * p.cout + j * 8;
                store2(q, acc[m][j][0], acc[m][j][1]);
                store2(q + 8LL * p.cout, acc[m][j][2], acc[m][j][3]);
              }
        }
      } else {   // accumulator rows g and g + 8: brick g / S^2 and 2 later
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = (lane >> 2) + 8 * h;
          const long long brick =
              tile_of(i) * TB + warp * G::BPW + row / G::SLICE;
          if (brick < p.rows) {
            OutT* o = static_cast<OutT*>(p.out) +
                      (brick * G::CELLS + row % G::SLICE) * p.cout + n0 +
                      (lane & 3) * 2;
#pragma unroll
            for (int m = 0; m < S; ++m)
#pragma unroll
              for (int j = 0; j < NTA; ++j)
                if (j < nt)
                  store2(o + (long long)(m * G::SLICE) * p.cout + j * 8,
                         acc[m][j][2 * h], acc[m][j][2 * h + 1]);
          }
        }
      }
    }
    kc = kc1;
    i = i1;
  }
}

// cout chunk per block, shared-memory layout and size for a shape; returns
// the warps per block
template <int S>
int plan(int cin, int cout, bool pro, Params* p, int* smem_bytes) {
  const int nchunks = (cout + 8 * NT_MAX - 1) / (8 * NT_MAX);
  p->nc = ((cout + nchunks - 1) / nchunks + 7) / 8 * 8;
  p->wpitch = 16 * ((p->nc / 8) | 1);
  p->nk = (cin + CK - 1) / CK;
  const int wbuf_b = TAPS * CK * p->wpitch;
  p->w_resident = (long long)p->nk * wbuf_b <= W_RESIDENT_B;
  const int w_b = (p->w_resident ? p->nk : 2) * wbuf_b;
  // the prologue variant keeps a third tile of rulebook rows and two of
  // occupancy words
  using T4 = Tile<S, 4>;
  using T8 = Tile<S, 8>;
  const int smem4 = (pro ? 3 : 2) * T4::NBR_INTS * 4 +
                    (pro ? 2 * T4::OCC_B : 0) + w_b + 2 * T4::STAGE_B;
  if (smem4 <= TWO_BLOCKS_B) {
    *smem_bytes = smem4;
    return 4;
  }
  *smem_bytes = (pro ? 3 : 2) * T8::NBR_INTS * 4 +
                (pro ? 2 * T8::OCC_B : 0) + w_b + 2 * T8::STAGE_B;
  return 8;
}

template <typename OutT, int S, int WB, bool PRO, int NTA = NT_MAX>
int launch(Params p, int smem_bytes, cudaStream_t s) {
  using T = Tile<S, WB>;
  p.ntiles = (p.rows + T::TB - 1) / T::TB;
  cudaError_t e = cudaFuncSetAttribute(
      fused_tc<OutT, S, WB, PRO, NTA>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      T::MAX_SMEM + (PRO ? T::NBR_INTS * 4 : 0));
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return (int)e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, fused_tc<OutT, S, WB, PRO, NTA>, T::THREADS,
           smem_bytes)) != cudaSuccess)
    return (int)e;
  if (per_sm < 1) return (int)cudaErrorLaunchOutOfResources;
  const int ny = (p.cout + p.nc - 1) / p.nc;
  long long gx = (long long)per_sm * sms / ny;   // one resident wave
  if (gx < 1) gx = 1;
  if (gx > p.ntiles) gx = p.ntiles;
  fused_tc<OutT, S, WB, PRO, NTA><<<dim3((unsigned)gx, (unsigned)ny),
                                    T::THREADS, smem_bytes, s>>>(p);
  return (int)cudaGetLastError();
}

template <int S, bool PRO, int NTA = NT_MAX>
int dispatch(const Params& p, int wb, int smem_bytes, int out_dtype,
             cudaStream_t s) {
  if (wb == 4)
    return out_dtype == 1 ? launch<bf16, S, 4, PRO, NTA>(p, smem_bytes, s)
                          : launch<float, S, 4, PRO, NTA>(p, smem_bytes, s);
  return out_dtype == 1 ? launch<bf16, S, 8, PRO, NTA>(p, smem_bytes, s)
                        : launch<float, S, 8, PRO, NTA>(p, smem_bytes, s);
}

template <int S>
int run(Params p, bool pro, int out_dtype, cudaStream_t s) {
  int smem_bytes = 0;
  const int wb = plan<S>(p.cin, p.cout, pro, &p, &smem_bytes);
  if (!pro) return dispatch<S, false>(p, wb, smem_bytes, out_dtype, s);
  return p.nc <= 16 ? dispatch<S, true, 2>(p, wb, smem_bytes, out_dtype, s)
                    : dispatch<S, true>(p, wb, smem_bytes, out_dtype, s);
}

}  // namespace

// 1 if the kernel is built for bricks of `side`, else 0.
extern "C" int doda_banded_conv_fused_has_side(int side) {
  return side == 2 || side == 4;
}

// Dynamic shared memory of a launch at (cin, cout), with or without the
// prologue, on bricks of `side`, bytes; -1 if refused.
extern "C" int doda_banded_conv_fused_smem(int cin, int cout, int pro,
                                           int side) {
  if (cin <= 0 || cin % 8 || cout <= 0 || cout % 8) return -1;
  Params p;
  int smem_bytes = 0;
  if (side == 4)
    plan<4>(cin, cout, pro != 0, &p, &smem_bytes);
  else if (side == 2)
    plan<2>(cin, cout, pro != 0, &p, &smem_bytes);
  else
    return -1;
  return smem_bytes;
}

// out_dtype: 0 = float32, 1 = bfloat16; operands are bfloat16; side: the
// brick side, 2 or 4. scale, bias (cin,) bf16 and occw (rows,) uint64 are
// all given (the prologue variant) or all null. Returns cudaGetLastError().
extern "C" int doda_banded_conv_fused(const void* x2, const void* nbr,
                                      const void* w, void* out,
                                      long long rows, int cin, int cout,
                                      int out_dtype, int side,
                                      const void* scale, const void* bias,
                                      const void* occw, void* stream) {
  const bool pro = scale != nullptr;
  if (rows <= 0 || rows > 0x7fffffffLL || cin <= 0 || cin % 8 || cout <= 0 ||
      cout % 8 || (out_dtype != 0 && out_dtype != 1) ||
      (side != 2 && side != 4) || (bias != nullptr) != pro ||
      (occw != nullptr) != pro)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.x = static_cast<const bf16*>(x2);
  p.nbr = static_cast<const int*>(nbr);
  p.w = static_cast<const bf16*>(w);
  p.out = out;
  p.scale = static_cast<const bf16*>(scale);
  p.bias = static_cast<const bf16*>(bias);
  p.occw = static_cast<const unsigned long long*>(occw);
  p.rows = rows;
  p.ntiles = 0;
  p.cin = cin;
  p.cout = cout;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return side == 4 ? run<4>(p, pro, out_dtype, s)
                   : run<2>(p, pro, out_dtype, s);
}
