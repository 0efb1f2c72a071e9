// Int8 3x3 convolution with the requantisation epilogue and an optional
// fused 2x2 max-pool, for Hopper (sm_90a).
//
// What it replaces.  The JAX package has no Pallas kernel for this: its
// int8 appearance trunk (mmmot_tpu/models/quantize.py,
// quantized_trunk_stages) leaves the conv (:267-271) and the 2x2 max-pool
// that follows a stage's last conv (:261) to XLA.  For an NHWC int8 map
// x [n, H, W, Cin] and int8 weights w [Cout, Kp] (K = 9 * Cin in
// (ky, kx, ci) order, zero padded to Kp, a multiple of 32), per output
// pixel p and channel c:
//
//   acc[p, c] = sum_k x_im2col[p, k] * w[c, k]          (int32, exact)
//   y         = fma(float(acc), m[c], b[c])              (f32, rounded once)
//   out[p, c] = clamp(rint(y), 0, 127)                   (int8; the clamp at
//                                                         0 is the ReLU)
//
// and with `pool`, out is then max-pooled 2x2 with stride 2, VALID (an odd
// last row or column is dropped).  The max is taken after the requant: a
// folded BatchNorm can make m[c] negative, and then the requant is not
// monotone in acc.  float(acc) rounds to nearest even (|acc| reaches
// 9 * 512 * 127^2, above 2^24), rint is round-half-to-even, and the
// multiply-add rounds once, as XLA's compiled `acc * m + b`.  Integer
// sums are exact in any order, so this kernel, the plain version
// (kernels/int8_conv.py, a float64 conv) and XLA give the same int8 maps
// bit for bit.
//
// What bounds it on an H100 (1,979 TOP/s int8 dense, 3.35 TB/s).  Per
// output pixel 2 * 9 * Cin * Cout operations against Cin bytes read and
// Cout (a quarter of it when pooled) written: VGG16's conv_0 (Cin 3) and
// conv_1 (Cin 64) are bound by bytes, conv_2 to conv_12 (Cin >= 64,
// Cout >= 128) by operations.  chip_smoke.py phase 11 (a) prints each
// layer's bound.
//
// Design.  An implicit GEMM, M = output pixels, N = Cout, K = Kp, with no
// im2col in device memory.  A tile is up to 128 output pixels (64 in the
// stem), a rectangle of bw x bh pixels of one image (the host picks the
// rectangle with the fewest tiles, e.g. 16 x 8 at 224², 28 x 4 at 28²,
// 14 x 9 at 14²), times BN = 64 or 128 output channels.  Each consumer
// warpgroup holds 64 pixels x BN int32 accumulators in registers and
// runs wgmma.mma_async m64nBNk32 s8 x s8 -> s32 with both operands
// K-major in shared memory.
//
//  - Main instance (Cin a multiple of 32: conv_1 to conv_12).  One
//    producer warp streams K, one (tap, channel chunk) a stage of ck = 128
//    (Cin % 128 == 0), 64 or 32 bytes, through a ring of 3 shared stages
//    guarded by "full" and "empty" mbarriers; the consumers never meet at
//    a block barrier in the K loop.  A stage is TMA loads in the ck-byte swizzle (128B for
//    ck = 128; conv_1's 64 channels give 64-byte rows and the 64B
//    swizzle): the input through a
//    4-D tiled tensor map over [n, H, W, Cin], one box of ck channels x bw
//    x bh pixels shifted by (ky - 1, kx - 1), whose out-of-bounds
//    coordinates TMA fills with zeros (the SAME halo costs nothing); the
//    weights through a 2-D tiled map over [Cout, Kp].  With 64 output
//    channels or 64 channels a stage (conv_1, conv_2) the products are
//    small beside the input tile, and the 9 input loads a chunk bound the
//    layer: their HALO instance loads
//    (bh + 2) x bw pixels once for a column offset and runs the three
//    taps of that column on them, a dy * bw-row start into the tile (bw a
//    multiple of 8 keeps the swizzle atoms whole): 3 loads of 160 rows
//    for 9 of 128.  Rows of a tile
//    that no box pixel fills are computed and discarded: at 14² a 196-pixel
//    map fills 2 tiles of 128 rows (23 % padding at conv_10-12), at 28²
//    28 x 4 boxes fill 112 of 128 rows (12.5 %).  TMA's im2col mode would
//    avoid that; the tiled route keeps one box shape for every layer.
//  - Stem instance (other Cin: conv_0's 3, the narrow widths of small
//    configs).  A tile's input patch, (bh + 2) x (bw + 2) x Cin bytes,
//    comes from device memory as aligned 4-byte words of its row runs (no
//    per-byte gather) and lands in shared memory at exact pixel offsets,
//    zeros outside the map; the block builds the im2col tile from it
//    through a per-K offset table (K in 32-byte swizzled blocks, groups
//    of up to 512 bytes) and runs wgmma on it.  conv_0 is bound by its
//    output bytes (103 MB for 32 crops at 224²) and has one k32 step:
//    what it pays is latency and the epilogue's instructions, so its
//    blocks are one warpgroup on 64-pixel tiles, eight a multiprocessor,
//    and persistent: each loads the weights once and the next tile's
//    patch words into registers while it computes and stores this one.
//  - Epilogue.  Requant + ReLU in registers (m and b staged once a block
//    in shared memory; __fmaf_rn, the float-to-int rounding and, for
//    |acc| < 2^22, the int-to-float conversion as exact float adds, since
//    the conversion instructions run at a quarter of the rate), int8
//    results through a padded shared tile, then 16-byte row stores (8 when
//    Cout is not a multiple of 16) or, with `pool`, the byte-wise max of
//    the four pixels of each 2x2 window (__vmaxu4; results are in
//    [0, 127]) stored at the pooled map's coordinates: the unpooled map
//    never reaches device memory.  With `pool` the host picks rectangles
//    with even sides (or the whole map's side), so a window never straddles
//    two tiles.
//
// Registers are not rebalanced (setmaxnreg): a consumer holds at most 64
// accumulators and the block fits the 112 registers a thread that two
// blocks a multiprocessor leave, so that one block's epilogue overlaps the
// other's main loop.

#include <cuda.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kBM = 128;                  // output pixels per tile
constexpr int kConsumers = 256;           // two consumer warpgroups
constexpr int kMainThreads = kConsumers + 32;   // + one producer warp
constexpr int kStages = 3;                // main instance's ring
constexpr int kKStep = 32;                // K bytes of one wgmma (k32)
constexpr int kStemRows = 64;             // stem: output pixels per tile
constexpr int kStemThreads = 128;         // ... one warpgroup
constexpr int kStemGroup = 512;           // K bytes the stem builds at once
constexpr int kStemPatchMax = 32 * 1024;  // stem patch bytes, at most

struct Geom {
  int n, H, W, Cin, Cout, Kp;
  int bw, bh;              // tile rectangle: columns, rows of pixels
  int tiles_x, tiles_y;
  int n_co;                // Cout tiles of BN
  int ck;                  // main: K bytes a stage; stem: K bytes a group
  int pool;
  int tiles;               // output tiles: n * tiles_y * tiles_x * n_co
  int small_acc;           // |acc| < 2^22 for any int8 input (Cin <= 28)
  int halo;                // main: the HALO instance
};

struct Tile {
  int img, y0, x0, n0;
};

// Output tile `bid`: its image, first pixel row and column, and first
// output channel (output-channel tiles vary fastest).
__device__ __forceinline__ Tile tile_at(const Geom& g, int bn, int bid) {
  const int co_t = bid % g.n_co;
  int p = bid / g.n_co;
  const int per_img = g.tiles_x * g.tiles_y;
  Tile t;
  t.img = p / per_img;
  p -= t.img * per_img;
  const int ty = p / g.tiles_x, tx = p - ty * g.tiles_x;
  t.y0 = ty * g.bh;
  t.x0 = tx * g.bw;
  t.n0 = co_t * bn;
  return t;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  const uint32_t a = smem_u32(p);
  return p + ((1024u - (a & 1023u)) & 1023u);
}

// --- mbarriers and TMA -------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("{\n.reg .b64 state;\n"
               "mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// Waits until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile("{\n.reg .pred p;\n"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(a), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// --- wgmma ---------------------------------------------------------------

// Shared-memory matrix descriptor of a K-major tile of `swizzle`-byte rows
// in that swizzle (128, 64 or 32), 8-row groups `8 * swizzle` bytes apart.
// The leading byte offset is unused in these layouts.  Adding 2 advances
// the start by one k32 step (32 bytes) inside the swizzled rows.
__device__ __forceinline__ uint64_t smem_desc(const void* p, int swizzle) {
  const uint64_t layout = swizzle == 128 ? 1 : swizzle == 64 ? 2 : 3;
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>((8 * swizzle) >> 4) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous products.
template <int R>
__device__ __forceinline__ void fence_acc(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}

__device__ __forceinline__ void wgmma_n64(int (&d)[32], uint64_t a,
                                          uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_n128(int (&d)[64], uint64_t a,
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma_bn(int (&d)[BN / 2], uint64_t a,
                                         uint64_t b) {
  if constexpr (BN == 128)
    wgmma_n128(d, a, b);
  else
    wgmma_n64(d, a, b);
}

// --- epilogue ----------------------------------------------------------

// Barrier 1 over the NT threads that compute the tile.
template <int NT>
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(NT) : "memory");
}

// 1.5 * 2^23.  Floats in [2^23, 2^24) are the integers, so y + kMagic
// rounds a float y of magnitude below 2^22 to an integer, half to even as
// rint does, and its bits minus kMagicBits are that integer; an int32 i of
// magnitude below 2^22 added to kMagicBits is the float kMagic + i.
constexpr float kMagic = 12582912.0f;
constexpr int kMagicBits = 0x4B400000;

// clamp(rint(fma(float(acc), m, b)), 0, 127).  The conversions are float
// adds (full rate) rather than I2F / F2I (a quarter of it), which bound
// the output-heavy layers' epilogues: the clamp comes first, so the
// rounding add is exact in range, and with kSmall (|acc| < 2^22, Cin at
// most 28) so is the int-to-float one.  The multiply-add rounds once.
template <bool kSmall>
__device__ __forceinline__ int8_t requant(int acc, float m, float b) {
  const float a = kSmall ? __int_as_float(acc + kMagicBits) - kMagic
                         : __int2float_rn(acc);
  const float y = fminf(fmaxf(__fmaf_rn(a, m, b), 0.f), 127.f);
  return static_cast<int8_t>(__float_as_int(y + kMagic) - kMagicBits);
}

__device__ __forceinline__ uint4 vmax4(uint4 a, uint4 b) {
  return make_uint4(__vmaxu4(a.x, b.x), __vmaxu4(a.y, b.y),
                    __vmaxu4(a.z, b.z), __vmaxu4(a.w, b.w));
}

template <int VEC>
__device__ __forceinline__ uint4 load_vec(const uint8_t* p) {
  if constexpr (VEC == 16) {
    return *reinterpret_cast<const uint4*>(p);
  } else {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    return make_uint4(v.x, v.y, 0u, 0u);
  }
}

template <int VEC>
__device__ __forceinline__ void store_vec(int8_t* p, uint4 v) {
  if constexpr (VEC == 16)
    *reinterpret_cast<uint4*>(p) = v;
  else
    *reinterpret_cast<uint2*>(p) = make_uint2(v.x, v.y);
}

// The staged int8 tile [rows x BN] (row r = pixel (r / bw, r % bw) of
// the tile) to device memory, VEC bytes a store: the tile's pixels, or
// with g.pool the max of each 2x2 window at the pooled map's coordinates.
template <int BN, int VEC, int NT>
__device__ __forceinline__ void store_tile(const uint8_t* stage,
                                           const Geom& g, const Tile& t,
                                           int8_t* __restrict__ out,
                                           int tid) {
  constexpr int kSst = BN + 16;
  constexpr int kPerRow = BN / VEC;
  if (!g.pool) {
    const int rows = g.bw * g.bh;
    for (int i = tid; i < rows * kPerRow; i += NT) {
      const int r = i / kPerRow, ch = (i - r * kPerRow) * VEC;
      const int yy = r / g.bw;
      const int y = t.y0 + yy, x = t.x0 + r - yy * g.bw, co = t.n0 + ch;
      if (y >= g.H || x >= g.W || co >= g.Cout) continue;
      store_vec<VEC>(out + ((static_cast<size_t>(t.img) * g.H + y) * g.W + x)
                               * g.Cout + co,
                     load_vec<VEC>(stage + r * kSst + ch));
    }
    return;
  }
  const int Hp = g.H / 2, Wp = g.W / 2;
  const int ph = g.bh / 2, pw = g.bw / 2;
  for (int i = tid; i < ph * pw * kPerRow; i += NT) {
    const int q = i / kPerRow, ch = (i - q * kPerRow) * VEC;
    const int qi = q / pw, qj = q - qi * pw;
    const int py = t.y0 / 2 + qi, px = t.x0 / 2 + qj, co = t.n0 + ch;
    if (py >= Hp || px >= Wp || co >= g.Cout) continue;
    const uint8_t* s0 = stage + (2 * qi * g.bw + 2 * qj) * kSst + ch;
    const uint8_t* s1 = s0 + g.bw * kSst;
    const uint4 v = vmax4(vmax4(load_vec<VEC>(s0), load_vec<VEC>(s0 + kSst)),
                          vmax4(load_vec<VEC>(s1), load_vec<VEC>(s1 + kSst)));
    store_vec<VEC>(out + ((static_cast<size_t>(t.img) * Hp + py) * Wp + px)
                             * g.Cout + co, v);
  }
}

// Requant of a consumer's accumulators into the staging tile (shared
// memory that the tile's operands no longer need), then the stores.
// Accumulator layout of m64nBN: d[4j + e] is row (warp % 4) * 16 + lane / 4
// (+ 8 for e >= 2) of the warpgroup's 64, column 8j + 2 (lane % 4) + e % 2.
template <int BN, bool kSmall, int NT>
__device__ __forceinline__ void epilogue(const int (&acc)[BN / 2],
                                         uint8_t* stage, const float* m_s,
                                         const float* b_s, const Geom& g,
                                         const Tile& t,
                                         int8_t* __restrict__ out, int tid) {
  constexpr int kSst = BN + 16;
  const int warp = tid >> 5, lane = tid & 31;
  const int r0 = (warp >> 2) * 64 + (warp & 3) * 16 + (lane >> 2);
  const int cq = (lane & 3) * 2;
  consumers_sync<NT>();          // every product has read its operands
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int c = j * 8 + cq;
    const float m0 = m_s[c], m1 = m_s[c + 1], b0 = b_s[c], b1 = b_s[c + 1];
    char2 lo, hi;
    lo.x = requant<kSmall>(acc[4 * j], m0, b0);
    lo.y = requant<kSmall>(acc[4 * j + 1], m1, b1);
    hi.x = requant<kSmall>(acc[4 * j + 2], m0, b0);
    hi.y = requant<kSmall>(acc[4 * j + 3], m1, b1);
    *reinterpret_cast<char2*>(stage + r0 * kSst + c) = lo;
    *reinterpret_cast<char2*>(stage + (r0 + 8) * kSst + c) = hi;
  }
  consumers_sync<NT>();
  if (g.Cout % 16 == 0)
    store_tile<BN, 16, NT>(stage, g, t, out, tid);
  else
    store_tile<BN, 8, NT>(stage, g, t, out, tid);
}

template <int BN>
__device__ __forceinline__ void stage_scales(const float* __restrict__ m,
                                             const float* __restrict__ bias,
                                             float* m_s, float* b_s,
                                             const Geom& g, const Tile& t,
                                             int tid) {
  if (tid < BN) {
    const int co = t.n0 + tid;
    m_s[tid] = co < g.Cout ? m[co] : 0.f;
    b_s[tid] = co < g.Cout ? bias[co] : 0.f;
  }
}

// --- main instance: TMA + mbarrier ring, warp-specialised ---------------

// HALO: each stage loads the tile's rows and the two halo rows once for a
// column offset dx, (bh + 2) x bw pixels, and runs the three taps of that
// column on it, the row offset dy as a start dy * bw rows into the tile
// (bw a multiple of 8 keeps the swizzle atoms whole): 3 input loads for 9
// taps, for layers whose products are small beside their input tile.
template <int BN, int CK, bool HALO>
__global__ void __launch_bounds__(kMainThreads, 2)
int8_conv_main_kernel(const __grid_constant__ CUtensorMap xmap,
                      const __grid_constant__ CUtensorMap wmap,
                      const float* __restrict__ m,
                      const float* __restrict__ bias,
                      int8_t* __restrict__ out, const Geom g) {
  constexpr int kTaps = HALO ? 3 : 1;                 // taps a stage
  constexpr int kABytes = (HALO ? kBM + 32 : kBM) * CK;
  constexpr int kBBytes = BN * CK;
  constexpr int kStageBytes = kABytes + kTaps * kBBytes;
  constexpr int kStaged = kBM * (BN + 16);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  constexpr int kRing = kStages * kStageBytes;
  float* m_s = reinterpret_cast<float*>(smem + (kRing > kStaged ? kRing
                                                                : kStaged));
  float* b_s = m_s + BN;
  uint64_t* full = reinterpret_cast<uint64_t*>(b_s + BN);
  uint64_t* empty = full + kStages;
  const Tile t = tile_at(g, BN, blockIdx.x);
  const int tid = threadIdx.x;
  // The warpgroup index, uniform in each warp as the compiler sees it
  // (wgmma must not sit on a path it takes for divergent).
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  stage_scales<BN>(m, bias, m_s, b_s, g, t, tid);
  if (tid == kConsumers) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);          // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // Stage it: tap it / chunks (HALO: column offset dx = it / chunks),
  // channel chunk it % chunks.
  const int chunks = g.Cin / CK, nk = (HALO ? 3 : 9) * chunks;

  if (wg == 2) {
    // Producer warp: one thread issues every load.
    if (tid == kConsumers) {
      const int a_rows = HALO ? (g.bh + 2) * g.bw : g.bh * g.bw;
      const uint32_t tx = static_cast<uint32_t>(a_rows * CK + kTaps * kBBytes);
      for (int it = 0; it < nk; ++it) {
        const int s = it % kStages;
        mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], tx);
        const int u = it / chunks, c0 = (it - u * chunks) * CK;
        const int dx = HALO ? u : u % 3, dy0 = HALO ? 0 : u / 3;
        uint8_t* a = smem + s * kStageBytes;
        tma_load_4d(a, &xmap, &full[s], c0, t.x0 + dx - 1, t.y0 + dy0 - 1,
                    t.img);
#pragma unroll
        for (int j = 0; j < kTaps; ++j)
          tma_load_2d(a + kABytes + j * kBBytes, &wmap, &full[s],
                      ((dy0 + j) * 3 + dx) * g.Cin + c0, t.n0);
      }
    }
    return;
  }

  // Consumer warpgroups: warpgroup wg owns tile rows [64 wg, 64 wg + 64)
  // (rows no box pixel fills are computed and discarded).
  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
  fence_acc(acc);
  const int row0 = wg * 64;
  for (int it = 0; it < nk; ++it) {
    const int s = it % kStages;
    mbar_wait(&full[s], (it / kStages) & 1);
    const uint8_t* a = smem + s * kStageBytes;
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kTaps; ++j) {
      const uint64_t da = smem_desc(a + (row0 + j * g.bw) * CK, CK);
      const uint64_t db = smem_desc(a + kABytes + j * kBBytes, CK);
#pragma unroll
      for (int k = 0; k < CK / kKStep; ++k)
        wgmma_bn<BN>(acc, da + 2 * k, db + 2 * k);
    }
    wgmma_commit();
    wgmma_wait<1>();                    // the previous stage's products
    if (it > 0 && (tid & 127) == 0) mbar_arrive(&empty[(it - 1) % kStages]);
  }
  wgmma_wait<0>();
  fence_acc(acc);
  epilogue<BN, false, kConsumers>(acc, smem, m_s, b_s, g, t, out, tid);
}

// --- stem instance: im2col built in shared memory ------------------------

// Byte (r, c) of a [rows x 32] tile in the 32-byte swizzle.
__device__ __forceinline__ int swz32(int r, int c) {
  return r * 32 + (c ^ (((r >> 2) & 1) << 4));
}

// Bytes of a patch row in shared memory: (bw + 2) * Cin, rounded up to 16.
__host__ __device__ __forceinline__ int patch_row(const Geom& g) {
  return ((g.bw + 2) * g.Cin + 15) & ~15;
}

// 4-byte words a patch row takes from device memory: the row run of
// (bw + 2) * Cin bytes starts up to 3 bytes into its first word.
__host__ __device__ __forceinline__ int patch_words(const Geom& g) {
  return ((g.bw + 2) * g.Cin + 3 + 3) / 4;
}

// Byte offsets below are from xb, x rounded down to a 4-byte boundary:
// x's byte i is xb's byte i + shift.

// Byte offset of pixel (y, x0 - 1) of image img.
__device__ __forceinline__ long long patch_origin(const Geom& g, int shift,
                                                  int img, int y, int x0) {
  return ((static_cast<long long>(img) * g.H + y) * g.W + x0 - 1) * g.Cin +
         shift;
}

// Word w of patch row pr of tile t: the aligned 4-byte word of xb at
// (origin & ~3) + 4w, where origin is the byte of pixel (y0 - 1 + pr,
// x0 - 1); bytes outside the map row's pixels (the SAME halo, other
// rows) are 0.  No byte past the end of x is read.
__device__ __forceinline__ uint32_t patch_word(const int8_t* __restrict__ xb,
                                               int shift, const Geom& g,
                                               const Tile& t, int pr, int w) {
  const int y = t.y0 - 1 + pr;
  if (y < 0 || y >= g.H) return 0u;
  const long long row_bytes = static_cast<long long>(g.W) * g.Cin;
  const long long row0 =
      (static_cast<long long>(t.img) * g.H + y) * row_bytes + shift;
  const long long origin = patch_origin(g, shift, t.img, y, t.x0);
  const long long lo = row0 + static_cast<long long>(max(t.x0 - 1, 0)) * g.Cin;
  const long long hi =
      row0 + static_cast<long long>(min(t.x0 + g.bw + 1, g.W)) * g.Cin;
  const long long addr = (origin & ~3LL) + 4LL * w;
  if (addr + 4 <= lo || addr >= hi) return 0u;
  uint32_t v = 0u;
  if (addr + 4 <= row_bytes * g.H * g.n + shift) {
    v = __ldg(reinterpret_cast<const unsigned*>(xb + addr));
  } else {
    for (int b = 0; addr + b < hi; ++b)
      if (addr + b >= lo)
        v |= static_cast<uint32_t>(static_cast<uint8_t>(xb[addr + b]))
             << (8 * b);
  }
#pragma unroll
  for (int b = 0; b < 4; ++b)
    if (addr + b < lo || addr + b >= hi) v &= ~(0xFFu << (8 * b));
  return v;
}

// The bytes of word w of patch row pr into the shared patch, at their
// place in the row: pixel column c (x0 - 1 + c) at c * Cin.
__device__ __forceinline__ void put_patch_word(uint8_t* patch, int shift,
                                               const Geom& g, const Tile& t,
                                               int pr, int w, uint32_t v) {
  const long long origin = patch_origin(g, shift, t.img, t.y0 - 1 + pr, t.x0);
  const int idx0 = 4 * w - static_cast<int>(origin & 3);
  const int run = (g.bw + 2) * g.Cin;
#pragma unroll
  for (int b = 0; b < 4; ++b)
    if (idx0 + b >= 0 && idx0 + b < run)
      patch[pr * patch_row(g) + idx0 + b] = static_cast<uint8_t>(v >> (8 * b));
}

constexpr int kPrefetch = 2;     // patch words a thread holds ahead

// Persistent blocks: block b computes tiles b, b + gridDim.x, ... (of one
// output-channel tile: gridDim.x is a multiple of n_co).  The next tile's
// patch words are loaded into registers while this tile is computed and
// stored.
template <int BN>
__global__ void __launch_bounds__(kStemThreads, BN == 64 ? 8 : 4)
int8_conv_stem_kernel(const int8_t* __restrict__ x,
                      const int8_t* __restrict__ w,
                      const float* __restrict__ m,
                      const float* __restrict__ bias,
                      int8_t* __restrict__ out, const Geom g) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  const int kg = g.ck;
  uint8_t* a_s = smem;                  // kg / 32 blocks [kStemRows x 32]
  uint8_t* b_s = a_s + kStemRows * kg;   // kg / 32 blocks [BN x 32]
  uint8_t* stage = b_s + BN * kg;        // [kStemRows x (BN + 16)]
  float* m_s = reinterpret_cast<float*>(stage + kStemRows * (BN + 16));
  float* b_sh = m_s + BN;
  // Per K byte, its offset in the patch from the row's pixel: dy rows,
  // dx pixels and ci bytes in; 0xFFFF past K.
  uint16_t* koff = reinterpret_cast<uint16_t*>(b_sh + BN);
  uint8_t* patch = reinterpret_cast<uint8_t*>(koff + ((g.Kp + 7) & ~7));
  const int lp = patch_row(g), words = patch_words(g);
  const int n_words = (g.bh + 2) * words;
  const int shift = static_cast<int>(reinterpret_cast<uintptr_t>(x) & 3);
  const int8_t* xb = x - shift;
  const int tid = threadIdx.x;
  const int rows = g.bw * g.bh, K = 9 * g.Cin;
  const bool b_once = g.Kp <= kg;

  // The weights [BN x kg] of K bytes [k_lo, k_lo + kg) into b_s.
  auto load_b = [&](int n0, int k_lo) {
    const int nkb = min(kg, g.Kp - k_lo) / kKStep;
    for (int i = tid; i < nkb * BN * 2; i += kStemThreads) {
      const int half = i & 1, rr = (i >> 1) % BN, kb = (i >> 1) / BN;
      const int co = n0 + rr;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (co < g.Cout)
        v = *reinterpret_cast<const uint4*>(
            w + static_cast<size_t>(co) * g.Kp + k_lo + kb * kKStep +
            half * 16);
      *reinterpret_cast<uint4*>(b_s + kb * BN * kKStep +
                                swz32(rr, half * 16)) = v;
    }
  };

  for (int k = tid; k < g.Kp; k += kStemThreads) {
    const int tap = k / g.Cin, ci = k - tap * g.Cin;
    koff[k] = k < K ? static_cast<uint16_t>((tap / 3) * lp +
                                            (tap % 3) * g.Cin + ci)
                    : static_cast<uint16_t>(0xFFFF);
  }
  Tile t = tile_at(g, BN, blockIdx.x);
  stage_scales<BN>(m, bias, m_s, b_sh, g, t, tid);
  if (b_once) load_b(t.n0, 0);
  uint32_t ahead[kPrefetch];
#pragma unroll
  for (int q = 0; q < kPrefetch; ++q) {
    const int i = tid + q * kStemThreads;
    ahead[q] = i < n_words ? patch_word(xb, shift, g, t, i / words,
                                        i % words)
                           : 0u;
  }
  for (int tile = blockIdx.x; tile < g.tiles; tile += gridDim.x) {
    __syncthreads();             // the last tile's patch and tiles are read
#pragma unroll
    for (int q = 0; q < kPrefetch; ++q) {
      const int i = tid + q * kStemThreads;
      if (i < n_words)
        put_patch_word(patch, shift, g, t, i / words, i % words, ahead[q]);
    }
    for (int i = tid + kPrefetch * kStemThreads; i < n_words; i += kStemThreads)
      put_patch_word(patch, shift, g, t, i / words, i % words,
                     patch_word(xb, shift, g, t, i / words, i % words));
    const int next = tile + gridDim.x;
    const Tile tn = tile_at(g, BN, next < g.tiles ? next : tile);
    if (next < g.tiles) {
#pragma unroll
      for (int q = 0; q < kPrefetch; ++q) {
        const int i = tid + q * kStemThreads;
        if (i < n_words)
          ahead[q] = patch_word(xb, shift, g, tn, i / words, i % words);
      }
    }
    __syncthreads();             // the patch is in
    int acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    fence_acc(acc);
    for (int k_lo = 0; k_lo < g.Kp; k_lo += kg) {
      if (k_lo) __syncthreads();   // the last group's tiles are read
      const int nkb = min(kg, g.Kp - k_lo) / kKStep;
      // im2col: 16 bytes of one tile row a thread and step.
      for (int i = tid; i < nkb * kStemRows * 2; i += kStemThreads) {
        const int half = i & 1, r = (i >> 1) & (kStemRows - 1), kb = i >> 7;
        const int k0 = k_lo + kb * kKStep + half * 16;
        unsigned words4[4] = {0u, 0u, 0u, 0u};
        if (r < rows) {
          const int py = r / g.bw, px = r - py * g.bw;
          const uint8_t* base = patch + py * lp + px * g.Cin;
          const uint4 o0 = *reinterpret_cast<const uint4*>(koff + k0);
          const uint4 o1 = *reinterpret_cast<const uint4*>(koff + k0 + 8);
          const unsigned o[8] = {o0.x, o0.y, o0.z, o0.w,
                                 o1.x, o1.y, o1.z, o1.w};
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const unsigned off = (o[j >> 1] >> (16 * (j & 1))) & 0xFFFFu;
            if (off != 0xFFFFu)
              words4[j >> 2] |= static_cast<unsigned>(base[off])
                                << (8 * (j & 3));
          }
        }
        *reinterpret_cast<uint4*>(a_s + kb * kStemRows * kKStep +
                                  swz32(r, half * 16)) =
            make_uint4(words4[0], words4[1], words4[2], words4[3]);
      }
      if (!b_once) load_b(t.n0, k_lo);
      // The tiles were written by this proxy; wgmma reads them through the
      // async proxy.
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
      wgmma_fence();
      for (int kb = 0; kb < nkb; ++kb)
        wgmma_bn<BN>(acc,
                     smem_desc(a_s + kb * kStemRows * kKStep, kKStep),
                     smem_desc(b_s + kb * BN * kKStep, kKStep));
      wgmma_commit();
      wgmma_wait<0>();
    }
    fence_acc(acc);
    if (g.small_acc)
      epilogue<BN, true, kStemThreads>(acc, stage, m_s, b_sh, g, t, out,
                                       tid);
    else
      epilogue<BN, false, kStemThreads>(acc, stage, m_s, b_sh, g, t, out,
                                        tid);
    t = tn;
  }
}

// --- host side -----------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up at run time through the CUDA runtime,
// so the library links no -lcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// Error codes of the C entry points beyond cudaError_t's.
constexpr int kErrNoEncoder = 10000;     // no cuTensorMapEncodeTiled
constexpr int kErrEncode = 20000;        // + the CUresult of a failed encode
constexpr int kErrShape = 30000;         // a shape the instance refuses

CUtensorMapSwizzle swizzle_of(int bytes) {
  return bytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
         : bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                       : CU_TENSOR_MAP_SWIZZLE_32B;
}

// The tile rectangle (bw x bh pixels, bw * bh <= max_rows) with the fewest
// tiles; with `pool`, sides even unless they cover the map's whole side.
void choose_tile(Geom& g, int max_rows) {
  const int cands[] = {g.W, 16, 32, 8, 64, 128};
  long long best = LLONG_MAX;
  g.bw = 0;
  for (int bw : cands) {
    if (bw > g.W || bw > max_rows || bw > 256) continue;
    int bh = min(g.H, max_rows / bw);
    if (g.pool && bh < g.H) bh &= ~1;
    if (bh == 0) continue;
    const int tx = (g.W + bw - 1) / bw, ty = (g.H + bh - 1) / bh;
    const long long tiles = static_cast<long long>(tx) * ty;
    if (tiles < best) {
      best = tiles;
      g.bw = bw;
      g.bh = bh;
      g.tiles_x = tx;
      g.tiles_y = ty;
    }
  }
}

int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n > 0 ? n : 132;
}

// The launch plan of an instance (0 main, 1 stem) for g's shape: fills
// the tile, the K bytes a stage or group (g.ck), the output-channel tiles
// and the tile count, sets `blocks` (the main instance: a block a tile;
// the stem: persistent blocks, a few a multiprocessor) and returns the
// dynamic shared memory in bytes, or -kErrShape.
int plan(Geom& g, int instance, int bn, unsigned& blocks) {
  g.n_co = (g.Cout + bn - 1) / bn;
  const int staged = kBM * (bn + 16);
  if (instance == 0) {
    if (g.Cin % kKStep || g.Kp != 9 * g.Cin) return -kErrShape;
    g.ck = g.Cin % 128 == 0 ? 128 : g.Cin % 64 == 0 ? 64 : 32;
    choose_tile(g, kBM);
    g.tiles = g.n * g.tiles_x * g.tiles_y * g.n_co;
    blocks = static_cast<unsigned>(g.tiles);
    // HALO where the input tile weighs as much as the products (64 output
    // channels, or 64 channels a stage: conv_1, conv_2), the tile's
    // columns are whole swizzle atoms, and three stages fit 2 blocks a
    // multiprocessor.
    g.halo = (bn == 64 || g.ck <= 64) && g.bw % 8 == 0 && g.bw <= 16;
    const int ring = kStages *
                     ((g.halo ? kBM + 32 : kBM) + (g.halo ? 3 : 1) * bn) * g.ck;
    return 1024 + (ring > staged ? ring : staged) + 8 * bn + 16 * kStages;
  }
  if (g.Kp % kKStep || g.Kp < 9 * g.Cin) return -kErrShape;
  g.ck = g.Kp < kStemGroup ? g.Kp : kStemGroup;
  for (int max_rows = kStemRows;; max_rows /= 2) {
    choose_tile(g, max_rows);
    if (g.bw && static_cast<long long>(g.bh + 2) * patch_row(g) <=
                    kStemPatchMax)
      break;
    if (max_rows <= 16) return -kErrShape;
  }
  g.tiles = g.n * g.tiles_x * g.tiles_y * g.n_co;
  g.small_acc = 9LL * g.Cin * 128 * 128 < (1LL << 22);
  const int per_sm = bn == 64 ? 8 : 4;     // the kernel's launch bounds
  const int cap = sm_count() * per_sm / g.n_co * g.n_co;
  blocks = static_cast<unsigned>(g.tiles < cap ? g.tiles
                                               : (cap > 0 ? cap : g.n_co));
  return 1024 + (kStemRows + bn) * g.ck + kStemRows * (bn + 16) + 8 * bn +
         2 * ((g.Kp + 7) & ~7) + (g.bh + 2) * patch_row(g);
}

template <typename Kernel, typename... Args>
int launch(Kernel kernel, unsigned blocks, int threads, int smem,
           cudaStream_t s, Args... args) {
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<blocks, threads, smem, s>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

int launch_main(const int8_t* x, const int8_t* w, const float* m,
                const float* b, int8_t* out, const Geom& g, int bn,
                int smem, unsigned blocks, cudaStream_t s) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kErrNoEncoder;
  CUtensorMap xmap, wmap;
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  const cuuint64_t xdim[4] = {
      static_cast<cuuint64_t>(g.Cin), static_cast<cuuint64_t>(g.W),
      static_cast<cuuint64_t>(g.H), static_cast<cuuint64_t>(g.n)};
  const cuuint64_t xstride[3] = {
      static_cast<cuuint64_t>(g.Cin),
      static_cast<cuuint64_t>(g.W) * g.Cin,
      static_cast<cuuint64_t>(g.H) * g.W * g.Cin};
  const cuuint32_t xbox[4] = {static_cast<cuuint32_t>(g.ck),
                              static_cast<cuuint32_t>(g.bw),
                              static_cast<cuuint32_t>(g.bh + 2 * g.halo), 1};
  CUresult r = encode(&xmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4,
                      const_cast<int8_t*>(x), xdim, xstride, xbox, ones,
                      CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle_of(g.ck),
                      CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return kErrEncode + static_cast<int>(r);
  const cuuint64_t wdim[2] = {static_cast<cuuint64_t>(g.Kp),
                              static_cast<cuuint64_t>(g.Cout)};
  const cuuint64_t wstride[1] = {static_cast<cuuint64_t>(g.Kp)};
  const cuuint32_t wbox[2] = {static_cast<cuuint32_t>(g.ck),
                              static_cast<cuuint32_t>(bn)};
  r = encode(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<int8_t*>(w),
             wdim, wstride, wbox, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
             swizzle_of(g.ck), CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return kErrEncode + static_cast<int>(r);
  auto go = [&](auto kernel) {
    return launch(kernel, blocks, kMainThreads, smem, s, xmap, wmap, m, b,
                  out, g);
  };
  if (bn == 128 && g.halo)
    return g.ck == 64 ? go(int8_conv_main_kernel<128, 64, true>)
                      : go(int8_conv_main_kernel<128, 32, true>);
  if (bn == 128)
    return g.ck == 128   ? go(int8_conv_main_kernel<128, 128, false>)
           : g.ck == 64 ? go(int8_conv_main_kernel<128, 64, false>)
                        : go(int8_conv_main_kernel<128, 32, false>);
  if (g.halo)
    return g.ck == 128   ? go(int8_conv_main_kernel<64, 128, true>)
           : g.ck == 64 ? go(int8_conv_main_kernel<64, 64, true>)
                        : go(int8_conv_main_kernel<64, 32, true>);
  return g.ck == 128   ? go(int8_conv_main_kernel<64, 128, false>)
         : g.ck == 64 ? go(int8_conv_main_kernel<64, 64, false>)
                      : go(int8_conv_main_kernel<64, 32, false>);
}

Geom geom(int n, int H, int W, int Cin, int Cout, int Kp, int pool) {
  Geom g{};
  g.n = n;
  g.H = H;
  g.W = W;
  g.Cin = Cin;
  g.Cout = Cout;
  g.Kp = Kp;
  g.pool = pool ? 1 : 0;
  return g;
}

int tile_n(int Cout) { return Cout >= 128 ? 128 : 64; }

}  // namespace

extern "C" {

// The K granularity: the wrapper pads the weights' K to a multiple of it.
int mmmot_int8_conv_k_step() { return kKStep; }

// The plan of a launch (nothing runs): info = {tile columns, tile rows,
// tiles along W, tiles along H, output-channel tile, its count, K bytes a
// stage (main) or group (stem), dynamic shared memory bytes, blocks,
// HALO (main; 0 for the stem)}.
// Returns 0, or kErrShape for a shape the instance refuses.
int mmmot_int8_conv_plan(int n, int H, int W, int Cin, int Cout, int Kp,
                         int pool, int instance, int* info) {
  Geom g = geom(n, H, W, Cin, Cout, Kp, pool);
  const int bn = tile_n(Cout);
  unsigned blocks = 0;
  const int smem = plan(g, instance, bn, blocks);
  if (smem < 0) return -smem;
  const int v[10] = {g.bw, g.bh, g.tiles_x, g.tiles_y, bn, g.n_co, g.ck,
                     smem, static_cast<int>(blocks), g.halo};
  for (int i = 0; i < 10; ++i) info[i] = v[i];
  return 0;
}

// x [n, H, W, Cin] int8, w [Cout, Kp] int8, m / b [Cout] float32 ->
// out [n, H, W, Cout] int8, or with `pool` [n, H / 2, W / 2, Cout], on
// `stream`.  `instance` 0 is the main instance (Cin a multiple of 32,
// Kp = 9 * Cin, x on a 16-byte boundary), 1 the stem (any Cin).  Kp is
// 9 * Cin rounded up to a multiple of 32, Cout a multiple of 8, w on a
// 16-byte boundary.  Returns the launch's cudaError_t, or one of the
// kErr codes above (nothing launched).
int mmmot_int8_conv3x3(const void* x, const void* w, const void* m,
                       const void* b, void* out, int n, int H, int W,
                       int Cin, int Cout, int Kp, int pool, int instance,
                       void* stream) {
  const int Ho = pool ? H / 2 : H, Wo = pool ? W / 2 : W;
  if (static_cast<long long>(n) * Ho * Wo == 0) return 0;
  if (Cout % 8) return kErrShape;
  Geom g = geom(n, H, W, Cin, Cout, Kp, pool);
  const int bn = tile_n(Cout);
  unsigned blocks = 0;
  const int smem = plan(g, instance, bn, blocks);
  if (smem < 0) return -smem;
  const auto* xi = static_cast<const int8_t*>(x);
  const auto* wi = static_cast<const int8_t*>(w);
  const auto* mf = static_cast<const float*>(m);
  const auto* bf = static_cast<const float*>(b);
  auto* o = static_cast<int8_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (instance == 0)
    return launch_main(xi, wi, mf, bf, o, g, bn, smem, blocks, s);
  return bn == 128 ? launch(int8_conv_stem_kernel<128>, blocks, kStemThreads,
                            smem, s, xi, wi, mf, bf, o, g)
                   : launch(int8_conv_stem_kernel<64>, blocks, kStemThreads,
                            smem, s, xi, wi, mf, bf, o, g);
}

}  // extern "C"
