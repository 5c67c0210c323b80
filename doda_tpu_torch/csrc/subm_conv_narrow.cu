// Kernel K1, narrow-input version: the submanifold 3^3 conv of an input
// with fewer than 8 channels (the cin = 3 input conv of the U-Net), straight
// from the activation and the rulebook.
//
// Replaces the TPU kernel doda_tpu/ops/pallas_banded.py::banded_conv
// together with the plane assembly in front of it,
// doda_tpu/ops/bricks2d.py::_assemble_p6, where the JAX package's
// subm_conv3_2d runs them on the input conv. For x2 (rows, 64*cin) bf16
// with 1 <= cin <= 7, the rulebook nbr (rows, 27) int32 (null id == rows)
// and raster weights w (27, cin, cout) bf16, cout % 8 == 0, it writes,
// unmasked and accumulated in float32,
//
//     out[b, cell, :] = sum_{tap} halo_b[cell + tap] @ w[tap]
//
// exactly banded_conv(_assemble_p6(x2, halo_index(nbr)), banded_weights(w)).
//
// What bounds it on an H100. The function moves x2 once, out once and the
// rulebook: at the bench input conv (rows = 163840, cin = 3, cout = 16,
// bf16 out) 416 MB, 0.124 ms at 3.35 TB/s; the output is 80% of it. Its
// 2.7e10 FLOPs of taps are 0.03 ms on the tensor cores. So bytes bound it.
// The first version (banded_conv.cu) read six assembled planes, 3.4x the
// activation, written by a gather and read back, and multiplied a band
// that is 75% placed zeros, 81 taps a cell padded into WMMA tiles.
//
// What the design does about it.
//  * No planes. One warp owns a brick at a time (a persistent grid of one
//    resident wave; warps walk the bricks with a stride of the grid's warp
//    count and never meet at a barrier). For each brick it reads the 27
//    rulebook entries (lane e < 27 holds entry e), and each lane derives the
//    source (neighbour, cell) of its halo cells hc = lane + 32i in closed
//    form (the map of bricks2d._halo_map, as in banded_conv_fused.cu) and
//    loads their cin channels. A 3-channel bf16 cell is 6 bytes, not a
//    16-byte unit, so cp.async's cell copies do not apply: the lane loads
//    the channels as 2-byte read-only loads into registers, and an absent
//    neighbour gives zeros without a load. The x2 reads of a brick's halo
//    hit the same few sectors of its 27 neighbours, which L1 and L2 serve.
//  * Loads in flight during the products. A brick's halo values are
//    loaded one brick ahead (and its rulebook entries two ahead) into
//    registers; the warp stores them to its own shared-memory halo, then
//    issues the next brick's loads before it multiplies the current one,
//    so the loads' latency hides behind the MMAs and the output stores.
//    Latency, not bandwidth, is what the warps wait on, so the kernel is
//    held to 128 registers at CP <= 4 for 16 resident warps an SM (with 8,
//    at the 180 registers it would take, it ran well slower).
//  * The im2col tile is implicit. Each halo cell holds CP = cin rounded up
//    to even channels (the pad channel zero), so a k column pair
//    (2t, 2t+1) of K = 27*CP (padded to a multiple of 16) is one 32-bit
//    word of one halo cell, and the word of A[cell][k] is
//    base(cell) + koff(k): the cell's halo origin plus the tap's offset.
//    A lane's four A words of an m16n8k16 tile are four shared-memory
//    loads from two bases and two offsets fixed per lane; the halo spans
//    at most 216*CP/2 words, so the 32 lanes' words fall on distinct banks
//    or share a word (at CP = 8 some pairs meet on a bank twice). Padded k
//    columns read the cell's own centre word against zero weights.
//  * Tensor cores on the taps only: mma.sync m16n8k16 bf16 with float32
//    accumulators, 4 m-tiles x ceil(27*CP/16) k-steps x 2 n8 tiles a brick
//    (16 couts a block, blockIdx.y for more). The B fragments, the raster
//    weights laid out as (tap, channel) rows, are built once a block in
//    shared memory, one word a lane, so their loads are conflict-free. No
//    banded weights, no placed zeros.
//  * The output, 80% of the bytes, leaves from the accumulators as 4-byte
//    (bf16) or 8-byte (float32) stores that fill whole 32-byte sectors per
//    pair of n8 tiles.
//
// The brick side S (the JAX package's DODA_BRICK) is a template parameter,
// instantiated for 4 (everything above) and 2. At S = 2 a brick has 8 cells
// and a 4x4x4 halo of 64, so a warp owns NB = 2 bricks at a time and its
// one m16 tile stacks them: rows g = 0..7 are brick 0's cells, rows g + 8
// brick 1's, each row's A words read from its own brick's halo (the second
// base is one halo further on, not two y-rows). The two halos are staged
// side by side, 128 cells, 4 a lane; the rulebook entries of both bricks
// ride in two registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int TAPS = 27;
constexpr int WARPS = 4;                          // warps a block
constexpr int NT = 2;                             // n8 tiles a block
constexpr int MAX_CIN = 7;

// bricks of side S: a warp owns NB bricks at a time, whose MT m16 tiles
// it multiplies; a brick's halo: HCELLS cells of CP bf16 channels; K =
// 27*CP in k16 steps
template <int S, int CP> struct Shape {
  static constexpr int HS = S + 2;                // halo side
  static constexpr int PLANE = HS * HS;
  static constexpr int HCELLS = HS * PLANE;       // 216 at S = 4, 64 at 2
  static constexpr int CELLS = S * S * S;
  static constexpr int NB = CELLS >= 16 ? 1 : 16 / CELLS;
  static constexpr int MT = NB * CELLS / 16;
  static constexpr int HSLOTS = (NB * HCELLS + 31) / 32;  // cells a lane
  static constexpr int WORDS = CP / 2;            // 32-bit words a cell
  static constexpr int HALO_W = HCELLS * WORDS;
  static constexpr int KS = (TAPS * CP + 15) / 16;
  static_assert(S == 2 || S == 4, "narrow K1 is built for sides 2 and 4");
  static_assert(NB == 1 || HCELLS % 32 == 0, "a lane slot spans bricks");
};

struct Params {
  const unsigned short* x;   // (rows, 64*cin) bf16 bits
  const int* nbr;            // (rows, 27)
  const unsigned short* w;   // (27, cin, cout) bf16 bits
  void* out;                 // (rows, 64*cout)
  long long rows;
  int cin, cout;
};

template <int S> __device__ __forceinline__ int halo_dir(int h) {
  return h == 0 ? 0 : (h == S + 1 ? 2 : 1);
}
template <int S> __device__ __forceinline__ int halo_pos(int h) {
  return (h + S - 1) & (S - 1);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// the word offset of column k of the (tap, channel) K axis inside a
// cell's halo neighbourhood; padded columns read the centre cell's first
// word (their weights are zero)
template <int SD, int CP> __device__ __forceinline__ int koff(int k) {
  using S = Shape<SD, CP>;
  int tap = k / CP, c = k - tap * CP;
  if (tap >= TAPS) tap = 13, c = 0;
  const int dx = tap / 9, dy = tap / 3 % 3, dz = tap % 3;
  return (dx * S::PLANE + dy * S::HS + dz) * (CP / 2) + c / 2;
}

// four blocks (16 warps) an SM where CP <= 4; wider cells need the room
template <typename OutT, int SD, int CP>
__global__ void __launch_bounds__(WARPS * 32, CP <= 4 ? 4 : 2)
    narrow_tc(const Params p) {
  using S = Shape<SD, CP>;
  constexpr int HSLOTS = S::HSLOTS;
  __shared__ __align__(16) uint32_t halo_s[WARPS][S::NB * S::HALO_W];
  // B fragments, one word per (k step, n8 tile, register, lane)
  __shared__ uint32_t b_s[S::KS][NT][2][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t* hs = halo_s[warp];
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.y * 8 * NT;
  const int nt = min(NT, (p.cout - n0) >> 3);

  // rows k = (tap, channel) of the raster weights, columns n0 + 8j + g;
  // zero past cin, past the 27 taps and past cout
  for (int e = threadIdx.x; e < S::KS * NT * 2 * 32; e += WARPS * 32) {
    const int el = e & 31, eh = (e >> 5) & 1, ej = (e >> 6) % NT;
    const int ks = e / (64 * NT), et = el & 3, n = n0 + 8 * ej + (el >> 2);
    uint32_t word = 0;
    for (int h = 0; h < 2; ++h) {
      const int k = ks * 16 + 2 * et + 8 * eh + h;
      const int tap = k / CP, c = k - tap * CP;
      if (tap < TAPS && c < p.cin && n < p.cout)
        word |= (uint32_t)__ldg(p.w + ((long long)tap * p.cin + c) *
                                          p.cout + n) << (16 * h);
    }
    b_s[ks][ej][eh][el] = word;
  }
  __syncthreads();

  // this lane's halo cells (the warp's NB halos side by side; the brick
  // of slot i is 32i / HCELLS): rulebook column (5 bits) | source cell (6)
  // | valid (1)
  uint32_t hmap[HSLOTS];
#pragma unroll
  for (int i = 0; i < HSLOTS; ++i) {
    const int hc = lane + 32 * i - (32 * i / S::HCELLS) * S::HCELLS;
    const int hx = hc / S::PLANE, r2 = hc - hx * S::PLANE, hy = r2 / S::HS,
              hz = r2 - hy * S::HS;
    const int col =
        halo_dir<SD>(hx) * 9 + halo_dir<SD>(hy) * 3 + halo_dir<SD>(hz);
    const int cell = halo_pos<SD>(hx) * SD * SD + halo_pos<SD>(hy) * SD +
                     halo_pos<SD>(hz);
    hmap[i] = hc < S::HCELLS
                  ? (uint32_t)col | (uint32_t)cell << 5 | 1u << 11
                  : 0u;
  }

  // the channels of this lane's halo cells of the bricks whose rulebook
  // entries nb holds (lane e < 27: entry e of brick j in nb[j]; -1 past
  // the last brick)
  unsigned short v[HSLOTS][CP];
  auto load_halo = [&](const int (&nb)[S::NB]) {
#pragma unroll
    for (int i = 0; i < HSLOTS; ++i) {
      const uint32_t d = hmap[i];
      const int src = __shfl_sync(0xffffffffu, nb[32 * i / S::HCELLS],
                                  d & 31);
      const bool ok = (d >> 11) && src >= 0 && src < p.rows;
      const unsigned short* q =
          p.x + ((long long)src * S::CELLS + ((d >> 5) & 63)) * p.cin;
#pragma unroll
      for (int c = 0; c < CP; ++c)
        v[i][c] = ok && c < p.cin ? __ldg(q + c) : (unsigned short)0;
    }
  };
  auto load_nbr = [&](long long brick, int (&nb)[S::NB]) {
#pragma unroll
    for (int j = 0; j < S::NB; ++j)
      nb[j] = lane < TAPS && brick + j < p.rows
                  ? __ldg(p.nbr + (brick + j) * TAPS + lane)
                  : -1;
  };

  // A words: cell row g (and g + 8) of m-tile mi. At S = 4 row g starts
  // at halo cell mi*36 + (g/4)*6 + g%4 and row g + 8 12 halo cells
  // further; at S = 2 row g is cell g of brick 0 and row g + 8 the same
  // cell of brick 1, one halo further
  int abase;
  if constexpr (SD == 4)
    abase = ((g >> 2) * 6 + (g & 3)) * S::WORDS;
  else
    abase = ((g >> 2) * S::PLANE + ((g >> 1) & 1) * S::HS + (g & 1)) *
            S::WORDS;
  constexpr int ROW8 = SD == 4 ? 12 * S::WORDS : S::HALO_W;
  constexpr int MSTEP = S::PLANE * S::WORDS;      // the next x-slice

  const long long stride = (long long)gridDim.x * WARPS * S::NB;
  long long brick = ((long long)blockIdx.x * WARPS + warp) * S::NB;
  int nb_next[S::NB];
  load_nbr(brick, nb_next);
  load_halo(nb_next);
  load_nbr(brick + stride, nb_next);

  for (; brick < p.rows; brick += stride) {
    __syncwarp();
#pragma unroll
    for (int i = 0; i < HSLOTS; ++i) {
      const int hc = lane + 32 * i;
      if (hc < S::NB * S::HCELLS) {
        uint32_t wd[S::WORDS];
#pragma unroll
        for (int j = 0; j < S::WORDS; ++j)
          wd[j] = (uint32_t)v[i][2 * j] | (uint32_t)v[i][2 * j + 1] << 16;
        uint32_t* dst = hs + hc * S::WORDS;
        if constexpr (S::WORDS == 2) {
          *reinterpret_cast<uint2*>(dst) = make_uint2(wd[0], wd[1]);
        } else if constexpr (S::WORDS == 4) {
          *reinterpret_cast<uint4*>(dst) =
              make_uint4(wd[0], wd[1], wd[2], wd[3]);
        } else {
#pragma unroll
          for (int j = 0; j < S::WORDS; ++j) dst[j] = wd[j];
        }
      }
    }
    __syncwarp();

    // the next bricks' halos in flight while these are multiplied
    int nb_after[S::NB];
    load_nbr(brick + 2 * stride, nb_after);
    load_halo(nb_next);
#pragma unroll
    for (int j = 0; j < S::NB; ++j) nb_next[j] = nb_after[j];

    float acc[S::MT][NT][4];
#pragma unroll
    for (int m = 0; m < S::MT; ++m)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < S::KS; ++ks) {
      const int ka = koff<SD, CP>(ks * 16 + 2 * t);
      const int kb = koff<SD, CP>(ks * 16 + 2 * t + 8);
      uint32_t b[NT][2];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) b[j][h] = b_s[ks][j][h][lane];
#pragma unroll
      for (int m = 0; m < S::MT; ++m) {
        const uint32_t* r = hs + m * MSTEP + abase;
        const uint32_t a[4] = {r[ka], r[ROW8 + ka], r[kb], r[ROW8 + kb]};
#pragma unroll
        for (int j = 0; j < NT; ++j)
          if (j < nt) mma_bf16(acc[m][j], a, b[j][0], b[j][1]);
      }
    }

    if constexpr (SD == 4) {
      OutT* o = static_cast<OutT*>(p.out) + (brick * 64 + g) * p.cout + n0 +
                2 * t;
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int j = 0; j < NT; ++j)
          if (j < nt) {
            OutT* q = o + (long long)(m * 16) * p.cout + j * 8;
            store2(q, acc[m][j][0], acc[m][j][1]);
            store2(q + 8LL * p.cout, acc[m][j][2], acc[m][j][3]);
          }
    } else {   // row g: cell g of brick 0; row g + 8: of brick 1
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (brick + h < p.rows) {
          OutT* o = static_cast<OutT*>(p.out) +
                    ((brick + h) * S::CELLS + g) * p.cout + n0 + 2 * t;
#pragma unroll
          for (int j = 0; j < NT; ++j)
            if (j < nt) store2(o + j * 8, acc[0][j][2 * h],
                               acc[0][j][2 * h + 1]);
        }
    }
  }
}

template <typename OutT, int SD, int CP>
int launch(const Params& p, cudaStream_t s) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return (int)e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, narrow_tc<OutT, SD, CP>, WARPS * 32, 0)) != cudaSuccess)
    return (int)e;
  if (per_sm < 1) return (int)cudaErrorLaunchOutOfResources;
  const int ny = (p.cout + 8 * NT - 1) / (8 * NT);
  long long gx = (long long)per_sm * sms / ny;   // one resident wave
  if (gx < 1) gx = 1;
  constexpr int per_block = WARPS * Shape<SD, CP>::NB;
  const long long blocks = (p.rows + per_block - 1) / per_block;
  if (gx > blocks) gx = blocks;
  narrow_tc<OutT, SD, CP><<<dim3((unsigned)gx, (unsigned)ny), WARPS * 32, 0,
                            s>>>(p);
  return (int)cudaGetLastError();
}

template <int SD, int CP>
int dispatch(const Params& p, int out_dtype, cudaStream_t s) {
  return out_dtype == 1 ? launch<bf16, SD, CP>(p, s)
                        : launch<float, SD, CP>(p, s);
}

template <int SD>
int dispatch_cp(const Params& p, int out_dtype, cudaStream_t s) {
  switch (p.cin + (p.cin & 1)) {
    case 2: return dispatch<SD, 2>(p, out_dtype, s);
    case 4: return dispatch<SD, 4>(p, out_dtype, s);
    case 6: return dispatch<SD, 6>(p, out_dtype, s);
    default: return dispatch<SD, 8>(p, out_dtype, s);
  }
}

}  // namespace

// out_dtype: 0 = float32, 1 = bfloat16; operands are bfloat16, 1 <= cin <=
// 7, cout % 8 == 0; side: the brick side, 2 or 4. Returns
// cudaGetLastError().
extern "C" int doda_subm_conv_narrow(const void* x2, const void* nbr,
                                     const void* w, void* out,
                                     long long rows, int cin, int cout,
                                     int out_dtype, int side, void* stream) {
  if (rows <= 0 || rows > 0x7fffffffLL || cin < 1 || cin > MAX_CIN ||
      cout <= 0 || cout % 8 || (out_dtype != 0 && out_dtype != 1) ||
      (side != 2 && side != 4))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.x = static_cast<const unsigned short*>(x2);
  p.nbr = static_cast<const int*>(nbr);
  p.w = static_cast<const unsigned short*>(w);
  p.out = out;
  p.rows = rows;
  p.cin = cin;
  p.cout = cout;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return side == 4 ? dispatch_cp<4>(p, out_dtype, s)
                   : dispatch_cp<2>(p, out_dtype, s);
}
