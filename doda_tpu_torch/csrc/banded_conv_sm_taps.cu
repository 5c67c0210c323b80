// Kernel K2, second version: the source-major submanifold conv on the
// non-zero taps only, from raster weights, on brick tiles streamed by TMA.
//
// Replaces the TPU kernel doda_tpu/ops/pallas_sm.py::banded_conv_sm. The
// operands are those of the first version (banded_conv_sm.cu, deleted): a
// brick's own activation x (B, 64*cin) and its halo, gyz (B, 96*cin: per
// x-slice the 20 in-plane halo cells in bricks2d._H_LIST order, padded to
// 24) and the x-halo planes gxm / gxp (B, 40*cin: 6x6 rasters padded to
// 40). With raster weights w (27, cin, cout) bf16 it writes, unmasked,
// float32-accumulated,
//
//     out[b, o, :] = sum over taps t of src_b[tap_source(o, t)] @ w[t]
//
// which is banded_conv_sm(x, gyz, gxm, gxp, *bricks2d.sm_weights(w)): the
// same products, without the placed zeros. cin % 16 == 0, cout % 8 == 0.
//
// What bounds it on an H100. A brick's 216 halo cells are read once and its
// 64 output cells written once: 1.47 GB at B = 163840, cin = cout = 16 in
// bf16, 0.438 ms at 3.35 TB/s, against 1.45e11 FLOPs of taps (0.147 ms at
// 989 TFLOP/s). Bytes bound it at every width the engine rule sends here.
// The first version multiplied the whole 120*cin band of each slice (27 of
// every 120 products are taps) and re-read a 1920 x 128 weight panel from
// L2 in every one of its blocks.
//
// What the design does about it.
//  * M = bricks. A block walks tiles of TB = 16 bricks. One source cell of
//    a tile is a dense (16 bricks, 16 channels) A tile, one tap's weights a
//    (16 channels, 16 couts) B tile: each (output cell, tap, n8 tile) is one
//    mma.sync m16n8k16 into that output cell's accumulator. 2*B*64*27*cin*cout FLOPs are
//    executed, the taps and nothing else.
//  * The stream. A tile is six source planes (x' = -1..4; plane x' in 1..4
//    is x-slice x'-1's 16 cells of x plus its 20-cell run of gyz, planes 0
//    and 5 are the 36 cells of gxm and gxp) times cin/16 channel chunks.
//    One unit, (plane, chunk), is 36 cells x 16 bricks x 32 bytes = 18 KB.
//    A producer warp streams units into a ring of stages with TMA
//    (cp.async.bulk.tensor, one tensor map per operand, mbarrier completion):
//    each operand is viewed as (cells, B, cin) so a box of (cells, 16
//    bricks, 16 channels) lands cell-major, and TMA zero-fills the bricks of
//    a ragged last tile. The padding cells of gyz, gxm and gxp are outside
//    every box and never read.
//  * A block owns 16 couts (blockIdx.y; cout = 32 reads the operands once
//    per 16, the second time mostly from L2) and is persistent over tiles.
//    Eight consumer warps, two per output x-slice, each with the
//    accumulators of two y-rows (8 cells x 16 couts, 64 registers) for the
//    whole tile. Unit (plane x', chunk) feeds slices x'-2..x' (those that
//    exist), so every operand byte of a cout block crosses device memory
//    once. Within a unit a warp holds the plane's nine taps' B fragments
//    (36 registers) and loads each of the 24 source cells its rows read
//    once with ldmatrix, for every output cell it feeds (117 bytes of
//    ldmatrix an mma at cout = 16). One warp a slice needs 128 accumulator
//    registers and spilled; tools/probe_sm.py times that variant.
//  * The weights of a block's 16 couts stay in shared memory for the whole
//    launch (13.8 KB at cin = 16, 27.6 KB at 32; cin <= 112 fits beside
//    two stages). A wider cin is cut into weight groups of equal numbers of
//    channel chunks that fit: the consumers reload the block's weights
//    group by group, between two consumer barriers, at the first unit of
//    each group of every tile (the units of a tile run chunk-major). No
//    configuration of the repo sends such a conv, so these reloads, from
//    L2 and stalling the block, are left slow. The grouped loop is its own
//    instantiation (GROUPED): in the loop of one group it cost 5-22% of
//    the time (tools/probe_sm.py, PERF.md).
//  * Bank conflicts: a source cell's 16 bricks are 16 rows of 32 bytes.
//    The 32-byte TMA swizzle (16-byte half index ^= bit 7 of the offset)
//    puts the 8 rows of each 8x8 ldmatrix on 8 distinct bank groups; weight
//    rows have an odd pitch in 16-byte units, as in banded_conv_fused.cu.
//  * The epilogue stages a warp's outputs in shared memory under the same
//    swizzle and writes whole 32-byte sectors, 16 bytes a lane; storing the
//    mma fragments directly (4-byte pieces) cost 0.35 of 0.92 ms at
//    163840 x 16 -> 16 (tools/probe_sm.py, PERF.md).
//
// The brick side S (the JAX package's DODA_BRICK) is a template parameter,
// instantiated for 4 (the numbers above) and 2. At side S a brick has S^3
// cells in S x-slices of S^2, gyz runs of 4S+4 cells padded to RUN = 4S+8,
// x-planes of (S+2)^2 cells padded to XPAD = (S+2)^2+4, and a tile streams
// S+2 planes of (S+2)^2 cells. A side-2 slice has 4 output cells, so one
// warp owns a whole slice (Layout<2>): two consumer warps a block, with
// four blocks resident an SM. At side 2 a brick reads 64 halo cells and writes 8: 0.755 GB at B =
// 327680, cin = cout = 16, 0.225 ms at 3.35 TB/s against 3.6e10 FLOPs
// (0.037 ms); bytes bound it there too.
//
// The float32 kernel, sm_taps_f32 (doda_banded_conv_sm_taps_f32), replaces
// the same TPU kernel on float32 operands and raster weights w (27, cin,
// cout) float32, for the float32 'sm' convs; it replaced the first version
// (banded_conv_sm.cu, deleted), which multiplied the whole band with a
// 64x64 SGEMM tile. Every product and sum is a float32 FMA on the CUDA
// cores (TF32 would fail the float32 checks), in a fixed order. What bounds
// it on an H100: float32 operations, 1.45e11 FLOPs at B = 163840, cin =
// cout = 16 (2.2 ms at 67 TFLOP/s) against 2.9 GB of float32 halo and
// output (0.88 ms at 3.35 TB/s). Its design keeps the tiles of 16 bricks,
// the ring of units, the producer warp and its TMA boxes, the tap table and
// Layout<S>: a float32 unit of 8 channels is the 32 bytes of a bf16 unit of
// 16, so a unit is the same 18 KB and a box (cells, 16 bricks, 8 channels).
// The consumers multiply on the CUDA cores instead: a lane owns one brick
// (lane % 16) and one group of 8 couts (lane / 16), CW cells x 8 couts of
// float32 accumulators (64 at side 4, 32 at side 2). For each channel quad
// and dy it loads its rows' source cells once as float4s and feeds the dz
// taps of every output cell that reads them; each (tap, channel)'s 8 couts
// are two float4 loads at one address a half warp. The 32-byte TMA swizzle
// is kept: a brick's row of a source cell is 32 bytes, so without it the 8
// bricks of a quarter warp's float4 loads would meet on 4 bank groups; with
// it they take 8. The weights of a block's 16 couts are float32 rows of 64
// bytes (27.6 KB at cin = 16, 55 KB at 32) in weight groups by the same
// rule; the outputs go straight from the registers, 32 bytes of a cell a
// lane (no staging).
//
// Tensor maps come from cuTensorMapEncodeTiled, reached through
// cudaGetDriverEntryPoint, so the library links the CUDA runtime only.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int CK = 16;                    // channels per chunk (mma K)
constexpr int MAX_STAGES = 6;
constexpr int HEAD_B = 1024;              // mbarriers; stages start 1024-aligned
constexpr int MAX_SMEM_B = 227 * 1024;    // dynamic shared memory of a block
constexpr int SM_SMEM_B = 228 * 1024;     // of an SM, 1 KB of it kept a block
constexpr int NC = 16;                    // couts a block (blockIdx.y)
constexpr int WPITCH = 48;                // bytes a weight row: odd in 16 B

// A block's layout at side S: YSPLIT consumer warps an output slice, and
// the resident blocks an SM the ring of stages is sized for.
// tools/probe_sm.py times the alternatives.
template <int S> struct Layout;
template <> struct Layout<4> {
  static constexpr int YSPLIT = 2, BLOCKS = 1;
};
template <> struct Layout<2> {
  static constexpr int YSPLIT = 1, BLOCKS = 4;
};

// The geometry of side S; the comments give side 4's numbers.
template <int S_>
struct Geo {
  static constexpr int S = S_;
  static constexpr int SHIFT = S == 4 ? 2 : 1;       // log2 S
  static constexpr int SL = S * S;                   // cells of a slice: 16
  static constexpr int CELLS = S * SL;               // cells of a brick: 64
  static constexpr int PLANE = (S + 2) * (S + 2);    // cells of a plane: 36
  static constexpr int RUN = 4 * S + 8;              // padded gyz run: 24
  static constexpr int XPAD = PLANE + 4;             // padded x-plane: 40
  // the operand cell space [x CELLS | gyz S*RUN | gxm XPAD | gxp XPAD]
  static constexpr int GYZ0 = CELLS;                 // 64
  static constexpr int GXM0 = CELLS + S * RUN;       // 160
  static constexpr int GXP0 = GXM0 + XPAD;           // 200
  static constexpr int YSPLIT = Layout<S>::YSPLIT;
  static constexpr int BLOCKS = Layout<S>::BLOCKS;
  static constexpr int TB = 16;                      // bricks a tile
  static constexpr int SLOT_B = TB * CK * 2;         // a source cell: 512 B
  static constexpr int UNIT_B = PLANE * SLOT_B;      // 18432
  static constexpr int RY = S / YSPLIT;              // y-rows of a slice a warp
  static constexpr int CW = S * RY;                  // output cells a warp
  static constexpr int CWARPS = S * YSPLIT;          // consumer warps a block
  static constexpr int THREADS = (CWARPS + 1) * 32;
  static constexpr int STAGED_B = CW * TB * 32;      // a warp's staged outputs
  static_assert(S == 1 << SHIFT, "sides 2 and 4");
  static_assert(YSPLIT == 1 || YSPLIT == 2, "one or two warps a slice");
};

// ---------------------------------------------------------------- geometry
// An in-plane halo cell (hy, hz), each in -1..S, of a brick's x-slice:
// its place in a gyz run (bricks2d._H_LIST: the edge runs z-1, z+1, y-1,
// y+1, then the corners), or, inside the brick, its cell y*S + z.
template <int S>
__host__ __device__ constexpr bool inside(int h) {
  return h >= 0 && h < S;
}
template <int S>
__host__ __device__ constexpr int run_pos(int hy, int hz) {
  return (!inside<S>(hy) && !inside<S>(hz)) ? 4 * S + (hy == S) * 2 + (hz == S)
         : hz == -1                         ? hy
         : hz == S                          ? S + hy
         : hy == -1                         ? 2 * S + hz
                                            : 3 * S + hz;
}

// The kernel's tap table: the source of tap t (raster (dx, dy, dz)) of
// output cell o (x*S^2 + y*S + z) in the operand cell space (240 cells at
// side 4, 80 at side 2). Padding cells (gyz run places 4S+4..RUN-1, plane
// places PLANE..XPAD-1) are never named.
template <int S>
__host__ __device__ constexpr int tap_source(int o, int t) {
  using G = Geo<S>;
  const int sx = (o >> (2 * G::SHIFT)) + t / 9 - 1;
  const int hy = ((o >> G::SHIFT) & (S - 1)) + (t / 3) % 3 - 1;
  const int hz = (o & (S - 1)) + t % 3 - 1;
  return sx == -1  ? G::GXM0 + (hy + 1) * (S + 2) + (hz + 1)
         : sx == S ? G::GXP0 + (hy + 1) * (S + 2) + (hz + 1)
         : (inside<S>(hy) && inside<S>(hz)) ? sx * G::SL + hy * S + hz
                                            : G::GYZ0 + sx * G::RUN +
                                                  run_pos<S>(hy, hz);
}

// Where a source cell lies in its staged unit: a centre plane holds the
// slice's S^2 x cells at slots 0..S^2-1 and its gyz run after them, an
// x-plane its (S+2)^2 raster cells.
template <int S>
__host__ __device__ constexpr int staged_slot(int src) {
  using G = Geo<S>;
  return src < G::GYZ0   ? src % G::SL
         : src < G::GXM0 ? G::SL + (src - G::GYZ0) % G::RUN
                         : (src - G::GXM0) % G::XPAD;
}

template <int S>
constexpr bool tables_hold() {
  using G = Geo<S>;
  return tap_source<S>(0, 0) == G::GXM0  // corner of the x-minus plane
         && tap_source<S>(G::CELLS - 1, 26) == G::GXP0 + G::PLANE - 1
         && tap_source<S>(G::SL, 13) == G::SL  // centre tap: the cell itself
         && tap_source<S>(G::SL, 9) == G::GYZ0 + G::RUN + 4 * S  // run 1's
         && staged_slot<S>(G::GYZ0 + G::RUN + 4 * S + 3) == G::PLANE - 1;
}
static_assert(tables_hold<4>() && tables_hold<2>(), "tap tables");
static_assert(tap_source<4>(16, 9) == 104 && Geo<4>::UNIT_B == 18432 &&
                  Geo<4>::CWARPS == 8 && Geo<4>::THREADS == 288,
              "side 4 as in the comments");

// -------------------------------------------------------------- primitives
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ uint64_t globaltimer_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}
// A healthy wait lasts as long as one unit's copies or one unit's products,
// microseconds. One that has not completed after WAIT_LIMIT_NS of the
// card's global timer (a fault in the pipeline) traps, so the launch fails
// instead of hanging the card; the limit leaves room for time slicing and
// preemption. The timer is read only once the first try_wait has failed.
constexpr uint64_t WAIT_LIMIT_NS = 10ull * 1000 * 1000 * 1000;
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint64_t t0 = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    const uint64_t now = globaltimer_ns();
    if (t0 == 0)
      t0 = now;
    else if (now - t0 > WAIT_LIMIT_NS)
      __trap();
  }
}
// Barrier 1 of the consumer warps only (the producer never waits on it)
template <int S>
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(Geo<S>::CWARPS * 32) : "memory");
}
__device__ __forceinline__ void tma_load3(uint32_t dst, const CUtensorMap* map,
                                          uint32_t bar, int c0, int c1,
                                          int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
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

struct Params {
  CUtensorMap map[4];  // x, gyz, gxm, gxp viewed as (cells, B, cin)
  const bf16* w;       // (27, cin, cout)
  void* out;           // (B, S^3*cout)
  long long rows;
  long long ntiles;
  int cin, cout;
  int nk;              // channel chunks
  int gk;              // channel chunks a weight group (nk: one group)
  int stages;          // units in the ring
};

// The block's couts of weight group k0 / gk (channel chunks k0 .. k0+gk-1,
// fewer in a last group) of all 27 taps into w_s: rows (tap, channel of
// the group) of WPITCH bytes, by the threads t0, t0 + nthreads, ...
__device__ __forceinline__ void load_weights(const Params& p,
                                             unsigned char* w_s, int n0,
                                             int k0, int t0, int nthreads) {
  const int wc = p.gk * CK;
  for (int row = t0; row < 27 * wc; row += nthreads) {
    const int t = row / wc, ch = k0 * CK + row % wc;
    if (ch >= p.cin) continue;
    const bf16* g = p.w + ((long long)t * p.cin + ch) * p.cout + n0;
#pragma unroll
    for (int u = 0; u < NC / 8; ++u) {
      uint4 v = make_uint4(0, 0, 0, 0);
      if (n0 + u * 8 < p.cout) v = *reinterpret_cast<const uint4*>(g + u * 8);
      *reinterpret_cast<uint4*>(w_s + row * WPITCH + u * 16) = v;
    }
  }
}

// One unit's products for the y-rows Y0 .. Y0+RY-1 of one output slice,
// NT n8 tiles of couts: tap dx is fixed by the plane, b holds its nine
// (dy, dz) taps' B fragments. Each source cell those rows read is loaded
// once and fed to every output cell that reads it. The slot of a source
// cell comes from the tap table: output cells of slice 1 stand for any
// centre plane (dx = 0), of slice 0 at dx = -1 for an x-plane. NT is a
// template argument so that the unrolled products are one basic block.
template <int S, bool XPLANE, int Y0, int NT>
__device__ __forceinline__ void plane_mma(float (&acc)[Geo<S>::CW][2][4],
                                          const uint32_t (&b)[9][4],
                                          uint32_t abase) {
  using G = Geo<S>;
#pragma unroll
  for (int hy = Y0 - 1; hy <= Y0 + G::RY; ++hy) {
#pragma unroll
    for (int hz = -1; hz <= S; ++hz) {
      // the output cell (y, z) = (hy, hz) clamped into the rows, read
      // through tap (dy, dz) = (hy - y, hz - z): any reader names one slot
      const int ry = hy < Y0 ? Y0 : (hy >= Y0 + G::RY ? Y0 + G::RY - 1 : hy);
      const int rz = hz < 0 ? 0 : (hz > S - 1 ? S - 1 : hz);
      const int o = (XPLANE ? 0 : G::SL) + ry * S + rz;
      const int t = (XPLANE ? 0 : 9) + (hy - ry + 1) * 3 + (hz - rz + 1);
      const uint32_t slot =
          abase + staged_slot<S>(tap_source<S>(o, t)) * G::SLOT_B;
      uint32_t a[4];
      ldsm_x4(a, slot);
#pragma unroll
      for (int dy = -1; dy <= 1; ++dy) {
#pragma unroll
        for (int dz = -1; dz <= 1; ++dz) {
          const int y = hy - dy, z = hz - dz;
          if (y >= Y0 && y < Y0 + G::RY && inside<S>(z)) {
            const int k = (dy + 1) * 3 + (dz + 1), c = (y - Y0) * S + z;
#pragma unroll
            for (int j = 0; j < NT; ++j)
              mma_bf16(acc[c][j], a, b[k][2 * j], b[k][2 * j + 1]);
          }
        }
      }
    }
  }
}

template <int S, bool XPLANE, int NT>
__device__ __forceinline__ void rows_mma(float (&acc)[Geo<S>::CW][2][4],
                                         const uint32_t (&b)[9][4],
                                         uint32_t abase, int yh) {
  if constexpr (Geo<S>::YSPLIT == 1) {
    plane_mma<S, XPLANE, 0, NT>(acc, b, abase);
  } else {
    if (yh == 0)
      plane_mma<S, XPLANE, 0, NT>(acc, b, abase);
    else
      plane_mma<S, XPLANE, Geo<S>::RY, NT>(acc, b, abase);
  }
}

template <int S, int NT>
__device__ __forceinline__ void unit_mma(float (&acc)[Geo<S>::CW][2][4],
                                         const uint32_t (&b)[9][4],
                                         uint32_t abase, bool xplane,
                                         int yh) {
  if (xplane)
    rows_mma<S, true, NT>(acc, b, abase, yh);
  else
    rows_mma<S, false, NT>(acc, b, abase, yh);
}

// The epilogue of one warp: its CW cells x TB bricks x 16 couts go to the
// warp's shared buffer as one 32-byte row a (cell, brick) under the 32-byte
// swizzle (bf16: all 16 couts; float32: one n8 tile a pass), then every
// row leaves with two 16-byte stores, 16 bricks of one cell a warp store:
// whole sectors, where fragment stores would write 4-byte pieces.
template <int S>
__device__ __forceinline__ uint32_t staged_off(int c, int r, int half) {
  return c * Geo<S>::TB * 32 + r * 32 + ((half ^ ((r >> 2) & 1)) << 4);
}
template <int S, typename OutT>
__device__ __forceinline__ void store_tile(
    const float (&acc)[Geo<S>::CW][2][4], unsigned char* stg,
    const Params& p, long long brick0, int cell0, int n, int nt, int lane) {
  using G = Geo<S>;
  const int g = lane >> 2, q = lane & 3;
  constexpr bool F32 = sizeof(OutT) == 4;
#pragma unroll
  for (int pass = 0; pass < (F32 ? 2 : 1); ++pass) {
    if (pass >= nt) break;
#pragma unroll
    for (int c = 0; c < G::CW; ++c)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = g + 8 * h;
        if constexpr (F32) {
          *reinterpret_cast<float2*>(stg + staged_off<S>(c, r, q >> 1) +
                                     (q & 1) * 8) =
              make_float2(acc[c][pass][2 * h], acc[c][pass][2 * h + 1]);
        } else {
#pragma unroll
          for (int j = 0; j < 2; ++j)
            *reinterpret_cast<__nv_bfloat162*>(stg + staged_off<S>(c, r, j) +
                                               q * 4) =
                __floats2bfloat162_rn(acc[c][j][2 * h], acc[c][j][2 * h + 1]);
        }
      }
    __syncwarp();
    // lane -> (brick r, 16-byte half) of cell c: 512 contiguous bytes read
#pragma unroll
    for (int c = 0; c < G::CW; ++c) {
      const int r = lane >> 1, half = lane & 1;
      const long long brick = brick0 + r;
      const int col = F32 ? n + pass * 8 + half * 4 : n + half * 8;
      const bool ok = brick < p.rows && (F32 ? n + pass * 8 : col) < p.cout;
      if (ok)
        *reinterpret_cast<uint4*>(
            static_cast<OutT*>(p.out) +
            (brick * G::CELLS + cell0 + c) * p.cout + col) =
            *reinterpret_cast<const uint4*>(stg + staged_off<S>(c, r, half));
    }
    __syncwarp();
  }
}

// TMA loads of unit (channel chunk kc, plane pl) of the tile at brick c1
template <int S>
__device__ __forceinline__ void issue_unit(const Params& p, uint32_t dst,
                                           uint32_t bar, int kc, int pl,
                                           int c1) {
  using G = Geo<S>;
  if (pl == 0 || pl == S + 1) {
    tma_load3(dst, &p.map[pl == 0 ? 2 : 3], bar, kc * CK, c1, 0);
  } else {
    tma_load3(dst, &p.map[0], bar, kc * CK, c1, (pl - 1) * G::SL);
    tma_load3(dst + G::SL * G::SLOT_B, &p.map[1], bar, kc * CK, c1,
              (pl - 1) * G::RUN);
  }
}

// A block: 16 couts (blockIdx.y), CWARPS consumer warps (YSPLIT an output
// slice) and one producer warp, persistent over tiles blockIdx.x + i *
// gridDim.x. GROUPED: more than one weight group (gk < nk).
template <int S, typename OutT, bool GROUPED>
__global__ void __launch_bounds__(Geo<S>::THREADS, 1)
    sm_taps_tc(const __grid_constant__ Params p) {
  using G = Geo<S>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t full0 = smem_u32(smem);              // [MAX_STAGES] x 8 B
  const uint32_t empty0 = full0 + 8 * MAX_STAGES;
  unsigned char* stage0 = smem + HEAD_B;
  unsigned char* staged = stage0 + p.stages * G::UNIT_B;  // [CWARPS] outputs
  unsigned char* w_s = staged + G::CWARPS * G::STAGED_B;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n0 = blockIdx.y * NC;

  if (!GROUPED) load_weights(p, w_s, n0, 0, tid, G::THREADS);
  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, G::CWARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const long long my_tiles =
      (p.ntiles - blockIdx.x + gridDim.x - 1) / gridDim.x;
  const int per_tile = (S + 2) * p.nk;
  const long long nunits = my_tiles * per_tile;

  if (warp == G::CWARPS) {  // the producer
    if (lane == 0) {
      for (long long u = 0; u < nunits; ++u) {
        const int s = (int)(u % p.stages);
        const uint32_t ph = (uint32_t)((u / p.stages) & 1);
        mbar_wait(empty0 + 8 * s, ph ^ 1);
        const long long i = u / per_tile;
        const int rem = (int)(u - i * per_tile);
        const int kc = rem / (S + 2), pl = rem - kc * (S + 2);
        const int c1 = (int)((blockIdx.x + i * gridDim.x) * G::TB);
        const uint32_t bar = full0 + 8 * s;
        mbar_expect_tx(bar, G::UNIT_B);
        issue_unit<S>(p, smem_u32(stage0 + s * G::UNIT_B), bar, kc, pl, c1);
      }
    }
    return;
  }

  // a consumer: y-rows yh*RY .. of output slice xr
  const int xr = warp & (S - 1), yh = warp >> G::SHIFT;
  const int nvalid = min(NC, p.cout - n0);
  const int nt = nvalid >= 16 ? 2 : 1;
  // this lane's ldmatrix row of an A tile (brick r, channel half) under
  // the 32-byte swizzle, and of a B tile pair (channel row, n8 tile)
  const int r = (lane & 7) + ((lane >> 3) & 1) * 8;
  const uint32_t a_off = r * 32 + (((lane >> 4) ^ ((r >> 2) & 1)) << 4);
  const uint32_t w_lane =
      smem_u32(w_s) + (lane & 15) * WPITCH + (lane >> 4) * 16;
  const int wc = p.gk * CK;  // channels of the resident weight rows a tap

  float acc[G::CW][2][4];
#pragma unroll
  for (int c = 0; c < G::CW; ++c)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c][j][e] = 0.0f;

  for (long long u = 0; u < nunits; ++u) {
    const int s = (int)(u % p.stages);
    const long long i = u / per_tile;
    const int rem = (int)(u - i * per_tile);
    const int kc = rem / (S + 2), pl = rem - kc * (S + 2);
    const int dx = pl - 1 - xr;
    const int kg = GROUPED ? kc % p.gk : kc;  // chunk within its group
    if (GROUPED && kg == 0 && pl == 0) {
      // a new weight group: every consumer is done with the last one
      consumers_sync<S>();
      load_weights(p, w_s, n0, kc, tid, G::CWARPS * 32);
      consumers_sync<S>();
    }
    mbar_wait(full0 + 8 * s, (uint32_t)((u / p.stages) & 1));
    if (dx >= -1 && dx <= 1) {
      uint32_t b[9][4];
      const uint32_t wb = w_lane + ((dx + 1) * 9 * wc + kg * CK) * WPITCH;
#pragma unroll
      for (int k = 0; k < 9; ++k) ldsm_x4_trans(b[k], wb + k * wc * WPITCH);
      const uint32_t abase = smem_u32(stage0 + s * G::UNIT_B) + a_off;
      const bool xplane = pl == 0 || pl == S + 1;
      if (nt == 2)
        unit_mma<S, 2>(acc, b, abase, xplane, yh);
      else
        unit_mma<S, 1>(acc, b, abase, xplane, yh);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * s);

    if (kc == p.nk - 1 && pl == xr + 2) {  // the slice's last unit of a tile
      store_tile<S, OutT>(acc, staged + warp * G::STAGED_B, p,
                          (blockIdx.x + i * gridDim.x) * G::TB,
                          xr * G::SL + yh * G::CW, n0, nt, lane);
#pragma unroll
      for (int c = 0; c < G::CW; ++c)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[c][j][e] = 0.0f;
    }
  }
}

// ----------------------------------------------------------------- float32
// sm_taps_f32, the float32 kernel (see the header): the tiles, units, ring
// and tap table above, float32 FMAs on the CUDA cores in place of the MMAs.
constexpr int CKF = 8;                    // float32 channels a unit: 32 bytes
constexpr int WPITCH_F = NC * 4;          // bytes a float32 weight row: 64

struct ParamsF {
  CUtensorMap map[4];  // x, gyz, gxm, gxp viewed as (cells, B, cin), float32
  const float* w;      // (27, cin, cout)
  void* out;           // (B, S^3*cout)
  long long rows;
  long long ntiles;
  int cin, cout;
  int nk;              // channel chunks of CKF
  int gk;              // channel chunks a weight group (nk: one group)
  int stages;          // units in the ring
};

// The block's couts of float32 weight group k0 / gk into w_s: rows (tap,
// channel of the group) of WPITCH_F bytes, 16 couts, zero past cout.
__device__ __forceinline__ void load_weights_f32(const ParamsF& p,
                                                 unsigned char* w_s, int n0,
                                                 int k0, int t0,
                                                 int nthreads) {
  const int wc = p.gk * CKF;
  for (int row = t0; row < 27 * wc; row += nthreads) {
    const int t = row / wc, ch = k0 * CKF + row % wc;
    if (ch >= p.cin) continue;
    const float* g = p.w + ((long long)t * p.cin + ch) * p.cout + n0;
#pragma unroll
    for (int u = 0; u < NC / 4; ++u) {
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (n0 + u * 4 < p.cout) v = *reinterpret_cast<const float4*>(g + u * 4);
      *reinterpret_cast<float4*>(w_s + row * WPITCH_F + u * 16) = v;
    }
  }
}

// The byte offsets in a staged unit of the source cells that the y-rows
// of a consumer warp read, one table a block in shared memory: entry
// [plane kind][yh][dy][ry][hz] (plane kind 1 an x-plane, 0 a centre plane;
// dy = 0..2 for -1..1; hz = 0..S+1 for -1..S) is the slot of source cell
// (Y0 + ry + dy - 1, hz - 1), Y0 = yh * RY, from the tap table: an output
// cell of the rows that reads it through a tap, of slice 1 at dx = 0 for
// a centre plane or slice 0 at dx = -1 for an x-plane, as in plane_mma.
// A table in place of unrolled constants keeps one loop body of ~800
// instructions for every warp; four unrolled bodies, one per (plane kind,
// yh), did not fit the instruction cache beside each other.
template <int S>
__host__ __device__ constexpr int slot_entries() {
  return 2 * Geo<S>::YSPLIT * 3 * Geo<S>::RY * (S + 2);
}
template <int S>
__device__ __forceinline__ int slot_entry(int e) {
  using G = Geo<S>;
  const int hz = e % (S + 2) - 1;
  e /= S + 2;
  const int ry = e % G::RY;
  e /= G::RY;
  const int dy = e % 3 - 1;
  e /= 3;
  const int y0 = (e % G::YSPLIT) * G::RY;
  const bool xplane = e / G::YSPLIT;
  const int hy = y0 + ry + dy;
  const int cy = hy < y0 ? y0 : (hy >= y0 + G::RY ? y0 + G::RY - 1 : hy);
  const int cz = hz < 0 ? 0 : (hz > S - 1 ? S - 1 : hz);
  const int oc = (xplane ? 0 : G::SL) + cy * S + cz;
  const int t = (xplane ? 0 : 9) + (hy - cy + 1) * 3 + (hz - cz + 1);
  return staged_slot<S>(tap_source<S>(oc, t)) * G::SLOT_B;
}

// One unit's float32 products for the RY y-rows of one output slice and
// one channel quad (a float4 of a source cell of the lane's brick): for
// each dy the rows' S+2 source cells are loaded once (their offsets from
// ``slots``, the warp's part of the table) and feed the dz taps of every
// output cell that reads them; each (tap, channel)'s 8 couts of the lane's
// cout group are two float4 loads, one address for each half warp. wbase
// points at tap (dx, -1, -1) of the quad; tap_b is the bytes between two
// taps' rows.
template <int S>
__device__ __forceinline__ void unit_fma(float (&acc)[Geo<S>::CW][8],
                                         const unsigned char* abase,
                                         const unsigned char* wbase,
                                         int tap_b, const int* slots) {
  using G = Geo<S>;
#pragma unroll 1
  for (int dy = 0; dy < 3; ++dy) {
    const int* row = slots + dy * G::RY * (S + 2);
    float4 a[G::RY][S + 2];
#pragma unroll
    for (int ry = 0; ry < G::RY; ++ry)
#pragma unroll
      for (int hz = 0; hz < S + 2; ++hz)
        a[ry][hz] = *reinterpret_cast<const float4*>(
            abase + row[ry * (S + 2) + hz]);
    const unsigned char* wd = wbase + dy * 3 * tap_b;
#pragma unroll
    for (int dz = 0; dz < 3; ++dz) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const unsigned char* wr = wd + dz * tap_b + c * WPITCH_F;
        const float4 w0 = *reinterpret_cast<const float4*>(wr);
        const float4 w1 = *reinterpret_cast<const float4*>(wr + 16);
        const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
        for (int ry = 0; ry < G::RY; ++ry)
#pragma unroll
          for (int z = 0; z < S; ++z) {
            const float4& v = a[ry][z + dz];
            const float av = c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
            float* o = acc[ry * S + z];
#pragma unroll
            for (int j = 0; j < 8; ++j) o[j] = fmaf(av, wv[j], o[j]);
          }
      }
    }
  }
}

__device__ __forceinline__ void put8(float* o, const float (&v)[8]) {
  *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(o + 4) = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void put8(bf16* o, const float (&v)[8]) {
  uint4 u;
  uint32_t* q = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
    q[j] = *reinterpret_cast<const uint32_t*>(&h);
  }
  *reinterpret_cast<uint4*>(o) = u;
}

// TMA loads of float32 unit (channel chunk kc of CKF, plane pl) of the
// tile at brick c1: the boxes of issue_unit, half the channels each
template <int S>
__device__ __forceinline__ void issue_unit_f32(const ParamsF& p, uint32_t dst,
                                               uint32_t bar, int kc, int pl,
                                               int c1) {
  using G = Geo<S>;
  const int ch = kc * CKF;
  if (pl == 0 || pl == S + 1) {
    tma_load3(dst, &p.map[pl == 0 ? 2 : 3], bar, ch, c1, 0);
  } else {
    tma_load3(dst, &p.map[0], bar, ch, c1, (pl - 1) * G::SL);
    tma_load3(dst + G::SL * G::SLOT_B, &p.map[1], bar, ch, c1,
              (pl - 1) * G::RUN);
  }
}

// A block as sm_taps_tc's: 16 couts (blockIdx.y), CWARPS consumer warps
// (YSPLIT an output slice) and one producer warp, persistent over tiles.
// A consumer lane owns one brick of the tile (lane % 16) and one cout
// group of 8 (lane / 16): CW cells x 8 couts of accumulators.
template <int S, typename OutT, bool GROUPED>
__global__ void __launch_bounds__(Geo<S>::THREADS, 1)
    sm_taps_f32(const __grid_constant__ ParamsF p) {
  using G = Geo<S>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t full0 = smem_u32(smem);              // [MAX_STAGES] x 8 B
  const uint32_t empty0 = full0 + 8 * MAX_STAGES;
  unsigned char* stage0 = smem + HEAD_B;
  unsigned char* w_s = stage0 + p.stages * G::UNIT_B;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n0 = blockIdx.y * NC;

  // the slot table, after the mbarriers in the head
  int* slot_s = reinterpret_cast<int*>(smem + 16 * MAX_STAGES);
  static_assert(16 * MAX_STAGES + 4 * slot_entries<S>() <= HEAD_B, "");

  if (!GROUPED) load_weights_f32(p, w_s, n0, 0, tid, G::THREADS);
  for (int e = tid; e < slot_entries<S>(); e += G::THREADS)
    slot_s[e] = slot_entry<S>(e);
  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, G::CWARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const long long my_tiles =
      (p.ntiles - blockIdx.x + gridDim.x - 1) / gridDim.x;
  const int per_tile = (S + 2) * p.nk;
  const long long nunits = my_tiles * per_tile;

  if (warp == G::CWARPS) {  // the producer
    if (lane == 0) {
      for (long long u = 0; u < nunits; ++u) {
        const int s = (int)(u % p.stages);
        mbar_wait(empty0 + 8 * s, (uint32_t)(((u / p.stages) & 1) ^ 1));
        const long long i = u / per_tile;
        const int rem = (int)(u - i * per_tile);
        const int kc = rem / (S + 2), pl = rem - kc * (S + 2);
        const uint32_t bar = full0 + 8 * s;
        mbar_expect_tx(bar, G::UNIT_B);
        issue_unit_f32<S>(p, smem_u32(stage0 + s * G::UNIT_B), bar, kc, pl,
                          (int)((blockIdx.x + i * gridDim.x) * G::TB));
      }
    }
    return;
  }

  // a consumer: y-rows yh*RY .. of output slice xr; the lane's brick r and
  // cout group gq. Brick r's 32-byte row of a source cell holds its two
  // channel quads, swapped where the TMA's 32-byte swizzle sets bit 7 of
  // the offset (bricks 4-7, 12-15): the 8 lanes of a quarter warp then
  // read 8 distinct 16-byte bank groups.
  const int xr = warp & (S - 1), yh = warp >> G::SHIFT;
  const int r = lane & 15, gq = lane >> 4;
  const int sw = (r >> 2) & 1;
  const int a_q0 = r * 32 + (sw << 4), a_q1 = r * 32 + ((sw ^ 1) << 4);
  const int wc = p.gk * CKF;      // channels of the resident weight rows
  const int tap_b = wc * WPITCH_F;

  float acc[G::CW][8];
#pragma unroll
  for (int c = 0; c < G::CW; ++c)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[c][j] = 0.0f;

  for (long long u = 0; u < nunits; ++u) {
    const int s = (int)(u % p.stages);
    const long long i = u / per_tile;
    const int rem = (int)(u - i * per_tile);
    const int kc = rem / (S + 2), pl = rem - kc * (S + 2);
    const int dx = pl - 1 - xr;
    const int kg = GROUPED ? kc % p.gk : kc;  // chunk within its group
    if (GROUPED && kg == 0 && pl == 0) {
      // a new weight group: every consumer is done with the last one
      consumers_sync<S>();
      load_weights_f32(p, w_s, n0, kc, tid, G::CWARPS * 32);
      consumers_sync<S>();
    }
    mbar_wait(full0 + 8 * s, (uint32_t)((u / p.stages) & 1));
    if (-1 <= dx && dx <= 1) {
      const unsigned char* stg = stage0 + s * G::UNIT_B;
      const unsigned char* wb =
          w_s + ((dx + 1) * 9 * wc + kg * CKF) * WPITCH_F + gq * 32;
      const int xplane = pl == 0 || pl == S + 1;
      const int* slots =
          slot_s + (xplane * G::YSPLIT + yh) * 3 * G::RY * (S + 2);
#pragma unroll 1
      for (int q = 0; q < 2; ++q)
        unit_fma<S>(acc, stg + (q ? a_q1 : a_q0), wb + q * 4 * WPITCH_F,
                    tap_b, slots);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * s);

    if (kc == p.nk - 1 && pl == xr + 2) {  // the slice's last unit of a tile
      const long long brick = (blockIdx.x + i * gridDim.x) * G::TB + r;
      const int n = n0 + gq * 8;
      if (brick < p.rows && n < p.cout) {
        const int cell0 = xr * G::SL + yh * G::CW;
#pragma unroll
        for (int c = 0; c < G::CW; ++c)
          put8(static_cast<OutT*>(p.out) +
                   (brick * G::CELLS + cell0 + c) * p.cout + n,
               acc[c]);
      }
#pragma unroll
      for (int c = 0; c < G::CW; ++c)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[c][j] = 0.0f;
    }
  }
}

// ------------------------------------------------------------------- host
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                            cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// (cells, B, cin) view of an operand with row stride ld elements; a box is
// (box_cells, tb bricks, 32 bytes of channels: 16 bf16 or, with f32, 8
// float32), 32-byte swizzled
CUresult make_map(EncodeTiled enc, CUtensorMap* map, const void* base,
                  long long ld, long long rows, int cin, int cells,
                  int box_cells, int tb, bool f32 = false) {
  const cuuint64_t esize = f32 ? 4 : 2;
  const cuuint64_t dims[3] = {(cuuint64_t)cin, (cuuint64_t)rows,
                              (cuuint64_t)cells};
  const cuuint64_t strides[2] = {(cuuint64_t)ld * esize,
                                 (cuuint64_t)cin * esize};
  const cuuint32_t box[3] = {(cuuint32_t)(f32 ? CKF : CK), (cuuint32_t)tb,
                             (cuuint32_t)box_cells};
  const cuuint32_t one[3] = {1, 1, 1};
  return enc(map,
             f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
             3, const_cast<void*>(base), dims, strides, box, one,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_32B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// Weight groups, ring depth and shared-memory size for cin: as few groups
// of equal numbers of chunks as leave room for two stages (one group up to
// cin = 112), then as many stages as fit, at most MAX_STAGES, beside
// Layout<S>::BLOCKS resident blocks an SM (fewer where two stages would
// not fit).
template <int S>
bool plan(int cin, Params* p, int* smem_bytes) {
  using G = Geo<S>;
  p->nk = cin / CK;
  const int fixed_b = 2 * HEAD_B + G::CWARPS * G::STAGED_B;
  const int chunk_w_b = 27 * CK * WPITCH;  // one chunk's weights
  const int gmax = (MAX_SMEM_B - fixed_b - 2 * G::UNIT_B) / chunk_w_b;
  const int groups = (p->nk + gmax - 1) / gmax;
  p->gk = (p->nk + groups - 1) / groups;
  const int w_b = p->gk * chunk_w_b;
  int free_b = 0;
  for (int blocks = G::BLOCKS; blocks >= 1; --blocks) {
    const int room = SM_SMEM_B / blocks - 1024;
    free_b = (room < MAX_SMEM_B ? room : MAX_SMEM_B) - fixed_b - w_b;
    if (free_b >= 2 * G::UNIT_B) break;
  }
  p->stages = free_b / G::UNIT_B < MAX_STAGES ? free_b / G::UNIT_B
                                              : MAX_STAGES;
  *smem_bytes = fixed_b + p->stages * G::UNIT_B + w_b;
  return p->stages >= 2;
}

template <int S, typename OutT>
int launch(const Params& p, int smem_bytes, cudaStream_t s) {
  using G = Geo<S>;
  auto kern = p.gk < p.nk ? sm_taps_tc<S, OutT, true>
                          : sm_taps_tc<S, OutT, false>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM_B);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return (int)e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kern, G::THREADS, smem_bytes)) != cudaSuccess)
    return (int)e;
  if (per_sm < 1) return (int)cudaErrorLaunchOutOfResources;
  const int ny = (p.cout + NC - 1) / NC;
  long long gx = (long long)per_sm * sms / ny;  // one resident wave
  if (gx < 1) gx = 1;
  if (gx > p.ntiles) gx = p.ntiles;
  kern<<<dim3((unsigned)gx, (unsigned)ny), G::THREADS, smem_bytes, s>>>(p);
  return (int)cudaGetLastError();
}

// The tensor maps, tiles and launch of one call at side S.
template <int S>
int run(const void* const (&base)[4], const long long (&ld)[4],
        const void* w, void* out, long long rows, int cin, int cout,
        int out_dtype, cudaStream_t s) {
  using G = Geo<S>;
  if (rows > 0x7fffffffLL - G::TB) return (int)cudaErrorInvalidValue;
  Params p;
  int smem_bytes = 0;
  if (!plan<S>(cin, &p, &smem_bytes)) return (int)cudaErrorInvalidValue;
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  // cells a row and cells a box: x (a slice), gyz (a run's halo cells),
  // gxm, gxp (a plane)
  const int cells[4] = {G::CELLS, S * G::RUN, G::XPAD, G::XPAD};
  const int boxes[4] = {G::SL, G::PLANE - G::SL, G::PLANE, G::PLANE};
  for (int k = 0; k < 4; ++k) {
    CUresult r = make_map(enc, &p.map[k], base[k], ld[k], rows, cin,
                          cells[k], boxes[k], G::TB);
    if (r != CUDA_SUCCESS) return 1000 + (int)r;
  }
  p.w = static_cast<const bf16*>(w);
  p.out = out;
  p.rows = rows;
  p.ntiles = (rows + G::TB - 1) / G::TB;
  p.cin = cin;
  p.cout = cout;
  return out_dtype == 1 ? launch<S, bf16>(p, smem_bytes, s)
                        : launch<S, float>(p, smem_bytes, s);
}

// The float32 kernel's weight groups, ring and shared memory: plan's
// rule with float32 weight chunks (8 channels, 13.8 KB) and no output
// staging.
template <int S>
bool plan_f32(int cin, ParamsF* p, int* smem_bytes) {
  using G = Geo<S>;
  p->nk = cin / CKF;
  const int fixed_b = 2 * HEAD_B;
  const int chunk_w_b = 27 * CKF * WPITCH_F;
  const int gmax = (MAX_SMEM_B - fixed_b - 2 * G::UNIT_B) / chunk_w_b;
  const int groups = (p->nk + gmax - 1) / gmax;
  p->gk = (p->nk + groups - 1) / groups;
  const int w_b = p->gk * chunk_w_b;
  int free_b = 0;
  for (int blocks = G::BLOCKS; blocks >= 1; --blocks) {
    const int room = SM_SMEM_B / blocks - 1024;
    free_b = (room < MAX_SMEM_B ? room : MAX_SMEM_B) - fixed_b - w_b;
    if (free_b >= 2 * G::UNIT_B) break;
  }
  p->stages = free_b / G::UNIT_B < MAX_STAGES ? free_b / G::UNIT_B
                                              : MAX_STAGES;
  *smem_bytes = fixed_b + p->stages * G::UNIT_B + w_b;
  return p->stages >= 2;
}

template <int S, typename OutT>
int launch_f32(const ParamsF& p, int smem_bytes, cudaStream_t s) {
  using G = Geo<S>;
  auto kern = p.gk < p.nk ? sm_taps_f32<S, OutT, true>
                          : sm_taps_f32<S, OutT, false>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM_B);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return (int)e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kern, G::THREADS, smem_bytes)) != cudaSuccess)
    return (int)e;
  if (per_sm < 1) return (int)cudaErrorLaunchOutOfResources;
  const int ny = (p.cout + NC - 1) / NC;
  long long gx = (long long)per_sm * sms / ny;  // one resident wave
  if (gx < 1) gx = 1;
  if (gx > p.ntiles) gx = p.ntiles;
  kern<<<dim3((unsigned)gx, (unsigned)ny), G::THREADS, smem_bytes, s>>>(p);
  return (int)cudaGetLastError();
}

// The float32 tensor maps, tiles and launch of one call at side S.
template <int S>
int run_f32(const void* const (&base)[4], const long long (&ld)[4],
            const void* w, void* out, long long rows, int cin, int cout,
            int out_dtype, cudaStream_t s) {
  using G = Geo<S>;
  if (rows > 0x7fffffffLL - G::TB) return (int)cudaErrorInvalidValue;
  ParamsF p;
  int smem_bytes = 0;
  if (!plan_f32<S>(cin, &p, &smem_bytes)) return (int)cudaErrorInvalidValue;
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  const int cells[4] = {G::CELLS, S * G::RUN, G::XPAD, G::XPAD};
  const int boxes[4] = {G::SL, G::PLANE - G::SL, G::PLANE, G::PLANE};
  for (int k = 0; k < 4; ++k) {
    CUresult r = make_map(enc, &p.map[k], base[k], ld[k], rows, cin,
                          cells[k], boxes[k], G::TB, true);
    if (r != CUDA_SUCCESS) return 1000 + (int)r;
  }
  p.w = static_cast<const float*>(w);
  p.out = out;
  p.rows = rows;
  p.ntiles = (rows + G::TB - 1) / G::TB;
  p.cin = cin;
  p.cout = cout;
  return out_dtype == 1 ? launch_f32<S, bf16>(p, smem_bytes, s)
                        : launch_f32<S, float>(p, smem_bytes, s);
}

}  // namespace

// 1 if the kernel is built for bricks of `side`, else 0.
extern "C" int doda_banded_conv_sm_taps_has_side(int side) {
  return side == 2 || side == 4;
}

// Dynamic shared memory of a launch at cin on bricks of `side`, bytes; -1
// if refused.
extern "C" int doda_banded_conv_sm_taps_smem(int cin, int side) {
  if (cin <= 0 || cin % 16 || (side != 2 && side != 4)) return -1;
  Params p;
  int smem_bytes = 0;
  const bool ok = side == 4 ? plan<4>(cin, &p, &smem_bytes)
                            : plan<2>(cin, &p, &smem_bytes);
  return ok ? smem_bytes : -1;
}

// Operands bf16 with row strides ld* in elements, on bricks of `side` (2
// or 4); out_dtype: 0 = float32, 1 = bfloat16. Returns a CUDA runtime
// error, or 1000 + the CUresult of cuTensorMapEncodeTiled where a tensor
// map could not be made.
extern "C" int doda_banded_conv_sm_taps(
    const void* x, long long ldx, const void* gyz, long long ldg,
    const void* gxm, long long ldm, const void* gxp, long long ldp,
    const void* w, void* out, long long rows, int cin, int cout, int side,
    int out_dtype, void* stream) {
  if (rows <= 0 || cin <= 0 || cin % 16 || cout <= 0 || cout % 8 ||
      (side != 2 && side != 4) || (out_dtype != 0 && out_dtype != 1))
    return (int)cudaErrorInvalidValue;
  const void* const base[4] = {x, gyz, gxm, gxp};
  const long long ld[4] = {ldx, ldg, ldm, ldp};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return side == 4 ? run<4>(base, ld, w, out, rows, cin, cout, out_dtype, s)
                   : run<2>(base, ld, w, out, rows, cin, cout, out_dtype, s);
}

// Dynamic shared memory of a float32 launch at cin on bricks of `side`,
// bytes; -1 if refused.
extern "C" int doda_banded_conv_sm_taps_f32_smem(int cin, int side) {
  if (cin <= 0 || cin % 16 || (side != 2 && side != 4)) return -1;
  ParamsF p;
  int smem_bytes = 0;
  const bool ok = side == 4 ? plan_f32<4>(cin, &p, &smem_bytes)
                            : plan_f32<2>(cin, &p, &smem_bytes);
  return ok ? smem_bytes : -1;
}

// The float32 kernel: operands and weights float32 with row strides ld* in
// elements, otherwise as doda_banded_conv_sm_taps.
extern "C" int doda_banded_conv_sm_taps_f32(
    const void* x, long long ldx, const void* gyz, long long ldg,
    const void* gxm, long long ldm, const void* gxp, long long ldp,
    const void* w, void* out, long long rows, int cin, int cout, int side,
    int out_dtype, void* stream) {
  if (rows <= 0 || cin <= 0 || cin % 16 || cout <= 0 || cout % 8 ||
      (side != 2 && side != 4) || (out_dtype != 0 && out_dtype != 1))
    return (int)cudaErrorInvalidValue;
  const void* const base[4] = {x, gyz, gxm, gxp};
  const long long ld[4] = {ldx, ldg, ldm, ldp};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return side == 4
             ? run_f32<4>(base, ld, w, out, rows, cin, cout, out_dtype, s)
             : run_f32<2>(base, ld, w, out, rows, cin, cout, out_dtype, s);
}
