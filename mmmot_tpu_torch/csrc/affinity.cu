// Fused association-cost kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel mmmot_tpu/kernels/affinity_kernel.py:206
// (pallas_affinity, body _kernel): for a batch of B frame pairs and K
// branches, with prev/curr embeddings a, b [B, K, N, D] and the
// correlation ops o_1..o_m (W1 [K, m*D, H], one D-row segment an op),
//
//   pair_k    = [o_1(a_i, b_j) | ... | o_m(a_i, b_j)]  (compute dtype)
//               subabs |a - b|, mul a * b, diff a - b, cosine an * bn
//               (an = a * rsqrt(sum a^2 + 1e-8), once per detection)
//   h_k       = relu(BN_eval(pair_k @ W1_k + b1_k))   (dot in f32, cast,
//                                                      BN in f32, cast)
//   score_k   = h_k . w2_k + b2_k                     (f32)
//   link      = mask * (sum_k score_k [/ K] + bias)   (f32 sum, cast)
//   link_norm = dual (rows + columns) / single (rows) masked softmax of
//               the link, or the link itself (none)
//   new / end = v2 heads: pool link over rows / columns (max, mean, or
//               weighted by its softmax), then
//               relu([feat | pooled] @ Wn1 + bn1) @ wn2 + bn2, masked.
//
// Rounding points follow the TPU kernel: every value the TPU kernel holds
// in the compute dtype is rounded to it here (T = float or bfloat16);
// sums accumulate in f32.  Where the reference's compiled program keeps
// a product in f32 before a sum (the cosine squares, the pools' terms),
// so does this kernel.
//
// What bounds it on an H100: operations over the VALID pairs.  The work
// the masks ask for is 2 K n_p n_c (m D H + H) for the links plus
// 2 (n_p + n_c)(D hh + hh) for the heads, per frame pair; W1 (1.5 MB in
// bf16 for one op) and the embeddings are read once.  At the flagship
// shapes that is a few us on the bf16 tensor cores (chip_smoke.py:
// affinity_bound).
//
// Design.  Two launches on the caller's stream (three with cosine); the
// wrapper allocates the float32 scratch part [B, K, N, N] and
// hs [B, 2, N, hh] (and with cosine norms [2, B, K, N]).
//
// Launch 0 (norms_kernel, cosine only): a warp per row of a and b writes
// rnd(rsqrt(rnd(rnd(sum x^2) + eps))), the squares summed in f32 in the
// reference's order (windows of 32 entries in order, then the window
// sums in order).
//
// Launch 1 (products_kernel), grid (B, K*T + 2*G) with T = ceil(N*N/64)
// and G = ceil(N/64),
// 256 threads: every dense product, one 64-row tile per block.
//  - Block (pb, k*T + tile) scores branch k for 64 valid pairs of frame
//    pair pb.  It compacts the two masks with ballots into the lists of
//    valid prev and curr slots (n_p, n_c entries) and takes the pair ids
//    q = tile*64 + r < n_p*n_c, (i, j) = (prev[q / n_c], curr[q % n_c]):
//    the (i, j) of each row are computed once per tile.  A tile with no
//    valid pair exits at once, so no work is done for masked pairs, and no
//    host sync is needed to size the grid.  It builds the 64 x D tile
//    rnd(o(a_i, b_j)) of one op in shared memory, with 16-byte loads.
//    W1_k streams through a double buffer of shared-memory stages of
//    64 x NT, filled by cp.async, so the copy of the next stage overlaps
//    this stage's product.  With one op the tile is built once and reused
//    for all H columns.  With m ops the contraction over m*D runs one op
//    segment at a time: for each NT-column tile, op o's tile is built and
//    multiplied by W1 rows [o*D, (o+1)*D), the f32 accumulator kept
//    across the segments (a 64 x m*D tile would not fit: 256 KB in bf16
//    at m*D = 2048); the tile is rebuilt m times per column tile.  The
//    epilogue of each NT-column tile, after the last segment, applies
//    rnd(rnd(acc) + b1), eval BN in f32 then rnd, ReLU and the f32 dot
//    with w2, reduced over the columns with warp shuffles and shared
//    memory; part[pb, k, i, j] = score_k + b2_k.  Splitting the branches
//    over blocks triples the blocks in flight for a short window.
//  - Blocks (pb, K*T + h*G + g), h = 0 (new head, curr features) and 1
//    (end head, prev features), run the head's first Dense over valid
//    detections 64g.. 64g+63, feat[valid] @ W [n, D] x [D, hh], through
//    the same tile and ring, and store the f32 sums into hs.
//
//   bfloat16: the products run on the tensor cores, mma.sync m16n8k16
//   (bf16 in, f32 accumulate) with ldmatrix from padded, conflict-free
//   shared tiles; 8 warps as 2 x 4 over a 64 x 128 output tile, the next
//   k16 step's fragments loaded before this step's products issue.
//   wgmma (m64n64k16, both operands from shared memory) is the path to
//   the full tensor-core rate; a version with no-swizzle tiles and the
//   same cp.async double buffer was right but slower at these shapes
//   (PERF.md): it needs TMA, swizzled tiles and a warp-specialised
//   pipeline to pay off.
//   float32: the tensor cores have no full-f32 mode (TF32 keeps about
//   three digits, which would break the f32 parity mode), so the products
//   stay SIMT FMA on a 4 x 4 register tile per thread over a 64 x 64
//   output tile; they share the valid-pair list, the pair tile and the
//   cp.async ring.
//
// Launch 2 (finish_kernel), grid (B): per frame pair, link = cast(sum_k
// part [/ K] [+ bias]) at valid pairs and an exact 0 elsewhere (every element
// written once, `link` is not zeroed by the wrapper), the row and column
// softmaxes and pools over it, then the heads' epilogues from hs:
// rnd(s + pooled * wp + b1) in f32, ReLU and the f32 dot with w2 (a warp
// per detection, lanes over the hh hidden units), 0 for masked
// detections.  Up to N = 128 the lines sit in dynamic shared memory
// (2 N (N + 1) floats: 132 KB at N = 128).  Above, those would pass
// the 227 KB of a block past N of about 168, and an instance streams the
// rows and columns from the link it has just written to device memory
// (it stays in L1/L2: 128 KB a pair at N = 256 in bf16), writing the
// row softmax into `norm` and folding the column softmax into it.  Of the
// two designs that fit, this one keeps one block a frame pair and the very
// arithmetic of the N <= 128 instance, with no extra scratch; splitting
// the rows over a thread-block cluster would share column maxima and
// sums through distributed shared memory with a cluster barrier per
// pass, for a launch that is a small part of the call at these widths.
// N is at most 512 (kMaxN): the mask lists and ballot words are sized
// by a template argument of each launch's instance, 128 slots up to
// N = 128 and 512 above.
//
// What this design does about the faults of the first (SIMT) kernel:
// no tensor cores -> mma.sync in bf16; every pair computed -> a work
// list of valid pairs; the pair tile rebuilt for each hidden tile -> once
// per branch (and op segment); W1 loaded synchronously -> a cp.async
// double buffer; launch 2 one block per frame pair with a serial 512-long
// dot per lane -> the head products are tiles of launch 1 over the valid
// detections only, and launch 2 keeps only the O(N^2 + N hh) epilogues.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e9f;  // ops/masking.py NEG_INF (finite)
constexpr int kThreads = 256;
constexpr int kRows = 64;         // pairs (launch 1) or detections per tile
constexpr int kMaxN = 512;        // slots a frame (check_widths names it)
constexpr int kSmemN = 128;       // launch 2 holds its lines on chip up to here
constexpr int kWindow = 32;       // the reference's ordered-sum window
constexpr int kKT = 64;           // features per W stage
constexpr int kStages = 2;        // W stages in flight (double buffer)
constexpr int kPartLd = 17;       // row stride of the per-row partial sums
constexpr int kFill = 8;          // 16-byte chunks in flight per thread

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);  // round to nearest even
}

// Round an f32 value to the compute dtype and widen it again.
template <typename T> __device__ __forceinline__ float rnd(float x) {
  return to_f(from_f<T>(x));
}

// Correlation ops (kernels/affinity.py OP_CODES): 2 bits an op.
enum Op { kSubabs = 0, kMul = 1, kDiff = 2, kCosine = 3 };
// Pools (POOL_CODES) and softmax modes (MODE_CODES).
enum Pool { kPoolMax = 0, kPoolMean = 1, kPoolSoftmax = 2 };
enum Mode { kDual = 0, kSingle = 1, kNone = 2 };

// One pair feature of op kOp in f32 from the compute-dtype inputs x (a
// row) and y (b row); ra, rb their rows' cosine scales.  The caller
// rounds the result to T.  No product feeds an add, so nothing contracts.
template <typename T, int kOp>
__device__ __forceinline__ float pair_op(float x, float y, float ra,
                                         float rb) {
  if constexpr (kOp == kMul) {
    return __fmul_rn(x, y);
  } else if constexpr (kOp == kDiff) {
    return __fsub_rn(x, y);
  } else if constexpr (kOp == kCosine) {
    return __fmul_rn(rnd<T>(__fmul_rn(x, ra)), rnd<T>(__fmul_rn(y, rb)));
  } else {
    return fabsf(__fsub_rn(x, y));  // subabs: |rnd(x)| == rnd(|x|)
  }
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 16-byte asynchronous copy global -> shared; src_bytes 0 fills zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ldmatrix at a shared-memory address (bytes).
__device__ __forceinline__ void ldsm_x4(uint32_t* r, unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// The block-level product engines: a 64-row A tile (pairs or detections,
// D features) in shared memory times an NT-column stage of W from the
// ring, accumulated in registers.  Eng<T>::fill_op<kOp> builds the A
// tile: rnd(op(a_i, b_j)) for rows with a b row, the a row itself
// without one, zeros for rows whose index is negative and for features
// >= D (zero for every op); fill_tile picks the op's instance.  The
// epilogue takes f(col), which loads that column's parameters once and
// returns g(row, acc), the f32 contribution of one product element.

template <typename T> struct Eng;

template <> struct Eng<__nv_bfloat16> {
  using T = __nv_bfloat16;
  static constexpr int kNT = 128;       // output columns per tile
  static constexpr int kWLd = kNT + 8;  // padded W-stage row (elements)
  static constexpr int kParts = 4;      // column groups per row (warps)
  static constexpr int kStageElems = kKT * kWLd;
  struct Acc { float c[2][4][4]; };

  __host__ __device__ static int a_ld(int Dp) { return Dp + 8; }
  __host__ __device__ static size_t a_bytes(int Dp) {
    return (size_t)kRows * a_ld(Dp) * sizeof(T);
  }

  template <int kOp>
  __device__ static void fill_op(T* A, int Dp, int D, const T* abase,
                                 const int* ri, const T* bbase, const int* rj,
                                 const float* na, const float* nb) {
    const int lda = a_ld(Dp), chunks = Dp / 8, total = kRows * chunks;
    for (int c0 = threadIdx.x; c0 < total; c0 += kFill * kThreads) {
      uint4 av[kFill], bv[kFill];  // kFill chunks' loads in flight at once
#pragma unroll
      for (int u = 0; u < kFill; ++u) {
        const int c = c0 + u * kThreads, r = c / chunks, d = (c % chunks) * 8;
        av[u] = bv[u] = make_uint4(0u, 0u, 0u, 0u);
        if (c < total && ri[r] >= 0 && d < D) {
          av[u] = *reinterpret_cast<const uint4*>(abase + (long)ri[r] * D + d);
          if (bbase != nullptr)
            bv[u] = *reinterpret_cast<const uint4*>(bbase + (long)rj[r] * D + d);
        }
      }
#pragma unroll
      for (int u = 0; u < kFill; ++u) {
        const int c = c0 + u * kThreads, r = c / chunks, d = (c % chunks) * 8;
        if (c >= total) continue;
        if (bbase != nullptr) {
          __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&av[u]);
          const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&bv[u]);
          float ra = 0.f, rb = 0.f;
          if constexpr (kOp == kCosine)
            if (ri[r] >= 0) ra = na[ri[r]], rb = nb[rj[r]];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 xa = __bfloat1622float2(o[e]);
            const float2 xb = __bfloat1622float2(y[e]);
            o[e] = __floats2bfloat162_rn(pair_op<T, kOp>(xa.x, xb.x, ra, rb),
                                         pair_op<T, kOp>(xa.y, xb.y, ra, rb));
          }
        }
        *reinterpret_cast<uint4*>(A + r * lda + d) = av[u];
      }
    }
  }

  __device__ static void zero(Acc& acc) {
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc.c[m][n][e] = 0.f;
  }

  // Fragments of one k16 step: A for the warp's two m16 tiles (rows
  // wm*32.. of A, shared address a_addr of this lane's row and column),
  // B for its four n8 tiles (w_addr likewise in the W stage).
  __device__ static void frags(uint32_t (*af)[4], uint32_t (*bf)[2],
                               unsigned a_addr, int lda, unsigned w_addr) {
#pragma unroll
    for (int m = 0; m < 2; ++m) ldsm_x4(af[m], a_addr + m * 16 * lda * 2);
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      uint32_t r[4];
      ldsm_x4_t(r, w_addr + np * 16 * 2);
      bf[2 * np][0] = r[0];
      bf[2 * np][1] = r[1];
      bf[2 * np + 1][0] = r[2];
      bf[2 * np + 1][1] = r[3];
    }
  }

  // The stage's k16 steps, with the next step's fragments loaded before
  // this step's products are issued.
  __device__ static void mma(Acc& acc, const T* A, int Dp, const T* W,
                             int d0) {
    constexpr int kSteps = kKT / 16;
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    const int wm = warp / 4, wn = warp % 4, lda = a_ld(Dp);
    const unsigned a_addr = smem_addr(
        A + (wm * 32 + lane % 16) * lda + d0 + (lane / 16) * 8);
    const unsigned w_addr = smem_addr(
        W + (lane % 8 + ((lane / 8) % 2) * 8) * kWLd + wn * 32 +
        (lane / 16) * 8);
    uint32_t af[2][2][4], bf[2][4][2];
    frags(af[0], bf[0], a_addr, lda, w_addr);
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      if (s + 1 < kSteps)
        frags(af[(s + 1) % 2], bf[(s + 1) % 2], a_addr + (s + 1) * 16 * 2,
              lda, w_addr + (s + 1) * 16 * kWLd * 2);
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int n = 0; n < 4; ++n)
          mma_bf16(acc.c[m][n], af[s % 2][m], bf[s % 2][n]);
    }
  }

  // part_s[row][warp column group] = sum over this tile's columns < Nc of
  // f(col)(row, acc).
  template <class F>
  __device__ static void epilogue(const Acc& acc, int n0, int Nc,
                                  float (*part_s)[kPartLd], F f) {
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    const int wm = warp / 4, wn = warp % 4, g = lane / 4, qd = lane % 4;
    float part[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = n0 + wn * 32 + n * 8 + qd * 2 + e;
        if (col >= Nc) continue;
        const auto at = f(col);
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int half = 0; half < 2; ++half)
            part[m][half] += at(wm * 32 + m * 16 + half * 8 + g,
                                acc.c[m][n][half * 2 + e]);
      }
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float v = part[m][half];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        if (qd == 0) part_s[wm * 32 + m * 16 + half * 8 + g][wn] = v;
      }
  }
};

template <> struct Eng<float> {
  using T = float;
  static constexpr int kNT = 64;
  static constexpr int kWLd = kNT;
  static constexpr int kParts = 16;     // column groups per row (tx)
  static constexpr int kStageElems = kKT * kWLd;
  struct Acc { float c[4][4]; };

  // A is stored transposed, [Dp][64], for float4 reads along the rows.
  __host__ __device__ static size_t a_bytes(int Dp) {
    return (size_t)Dp * kRows * sizeof(T);
  }

  template <int kOp>
  __device__ static void fill_op(T* A, int Dp, int D, const T* abase,
                                 const int* ri, const T* bbase, const int* rj,
                                 const float* na, const float* nb) {
    const int total = kRows * (Dp / 4);
    for (int c0 = threadIdx.x; c0 < total; c0 += kFill * kThreads) {
      float4 av[kFill], bv[kFill];
#pragma unroll
      for (int u = 0; u < kFill; ++u) {
        const int c = c0 + u * kThreads, r = c % kRows, d = (c / kRows) * 4;
        av[u] = bv[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (c < total && ri[r] >= 0 && d < D) {
          av[u] = *reinterpret_cast<const float4*>(abase + (long)ri[r] * D + d);
          if (bbase != nullptr)
            bv[u] = *reinterpret_cast<const float4*>(bbase + (long)rj[r] * D + d);
        }
      }
#pragma unroll
      for (int u = 0; u < kFill; ++u) {
        const int c = c0 + u * kThreads, r = c % kRows, d = (c / kRows) * 4;
        if (c >= total) continue;
        float4 v = av[u];
        if (bbase != nullptr) {
          float ra = 0.f, rb = 0.f;
          if constexpr (kOp == kCosine)
            if (ri[r] >= 0) ra = na[ri[r]], rb = nb[rj[r]];
          const float4 w = bv[u];
          v = make_float4(pair_op<T, kOp>(v.x, w.x, ra, rb),
                          pair_op<T, kOp>(v.y, w.y, ra, rb),
                          pair_op<T, kOp>(v.z, w.z, ra, rb),
                          pair_op<T, kOp>(v.w, w.w, ra, rb));
        }
        A[(d + 0) * kRows + r] = v.x;
        A[(d + 1) * kRows + r] = v.y;
        A[(d + 2) * kRows + r] = v.z;
        A[(d + 3) * kRows + r] = v.w;
      }
    }
  }

  __device__ static void zero(Acc& acc) {
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc.c[r][c] = 0.f;
  }

  __device__ static void mma(Acc& acc, const T* A, int, const T* W, int d0) {
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
    for (int dd = 0; dd < kKT; ++dd) {
      const float4 av = *reinterpret_cast<const float4*>(&A[(d0 + dd) * kRows + ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&W[dd * kWLd + tx * 4]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc.c[r][c] = fmaf(ar[r], br[c], acc.c[r][c]);
    }
  }

  template <class F>
  __device__ static void epilogue(const Acc& acc, int n0, int Nc,
                                  float (*part_s)[kPartLd], F f) {
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
    float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = n0 + tx * 4 + c;
      if (col >= Nc) continue;
      const auto at = f(col);
#pragma unroll
      for (int r = 0; r < 4; ++r) part[r] += at(ty * 4 + r, acc.c[r][c]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) part_s[ty * 4 + r][tx] = part[r];
  }
};

// Eng<T>::fill_op for the op `op` chosen at run time (one instance an
// op, each with its op's arithmetic inline).
template <typename T>
__device__ void fill_tile(int op, T* A, int Dp, int D, const T* abase,
                          const int* ri, const T* bbase, const int* rj,
                          const float* na, const float* nb) {
  using E = Eng<T>;
  switch (op) {
    case kMul:
      E::template fill_op<kMul>(A, Dp, D, abase, ri, bbase, rj, na, nb);
      break;
    case kDiff:
      E::template fill_op<kDiff>(A, Dp, D, abase, ri, bbase, rj, na, nb);
      break;
    case kCosine:
      E::template fill_op<kCosine>(A, Dp, D, abase, ri, bbase, rj, na, nb);
      break;
    default:
      E::template fill_op<kSubabs>(A, Dp, D, abase, ri, bbase, rj, na, nb);
  }
}

// Stage of W [D, Nc] (row-major; D all its rows), features d0..
// d0+kKT, columns n0.. n0+NT, into `dst` by cp.async; out-of-range
// chunks are zero-filled.
// Both engines have 16 chunks of 16 bytes per stage row.
template <typename T>
__device__ void load_stage(T* dst, const T* W, int D, int Nc, int d0,
                           int n0) {
  using E = Eng<T>;
  constexpr int kPer = 16 / sizeof(T);
  constexpr int kChunksRow = E::kNT / kPer;
  for (int c = threadIdx.x; c < kKT * kChunksRow; c += kThreads) {
    const int r = c / kChunksRow, col = (c % kChunksRow) * kPer;
    const int d = d0 + r, n = n0 + col;
    const bool ok = d < D && n < Nc;
    cp_async16(dst + r * E::kWLd + col, ok ? W + (long)d * Nc + n : W,
               ok ? 16 : 0);
  }
}

template <typename T> __host__ __device__ size_t gemm_smem_bytes(int D) {
  return Eng<T>::a_bytes(round_up(D, kKT)) +
         (size_t)kStages * Eng<T>::kStageElems * sizeof(T);
}

// The block computes A [64, S*D] x W [S*D, Nc] tile by tile and reduces
// each row over the columns, A in S segments of D features:
//   fill(A, s)       builds segment s of A (all threads; no barrier
//                    inside), the first while the ring's first W stages
//                    are in flight,
//   epi(col)(row, acc)  the f32 contribution of one product element,
//   done(row, sum)   called by thread `row` (< 64) with the row's sum over
//                    all Nc columns.
// W stages stream through a ring of kStages across the column tiles and
// segments; with S > 1 each column tile runs the segments in order,
// rebuilding A for each, and keeps its accumulator across them: only the
// kSegs instance holds that code (with one segment the accumulator is
// not live across a fill, which keeps its registers).  `smem` holds one
// segment's A tile and the ring (gemm_smem_bytes).
template <typename T, bool kSegs, class Fill, class Epi, class Done>
__device__ void row_gemm(const T* w, int D, int S, int Nc,
                         unsigned char* smem, float (*part_s)[kPartLd],
                         Fill fill, Epi epi, Done done) {
  using E = Eng<T>;
  if constexpr (!kSegs) S = 1;
  const int Dp = round_up(D, kKT);
  T* A = reinterpret_cast<T*>(smem);
  T* ring = reinterpret_cast<T*>(smem + E::a_bytes(Dp));
  const int n_kt = Dp / kKT, per_tile = S * n_kt;
  const int total = (Nc + E::kNT - 1) / E::kNT * per_tile;
  const int tid = threadIdx.x;

  // Stage t: column tile t / per_tile, segment (t / n_kt) % S, features
  // kt * kKT.. of that segment (W rows seg * D + kt * kKT..; rows past
  // the segment's D meet A's zero columns).
  auto issue = [&](int t) {
    if (t < total)
      load_stage<T>(ring + (t % kStages) * E::kStageElems, w, S * D, Nc,
                    (t / n_kt) % S * D + (t % n_kt) * kKT,
                    (t / per_tile) * E::kNT);
    cp_async_commit();  // possibly empty: keeps the group count uniform
  };
  for (int t = 0; t < kStages - 1; ++t) issue(t);
  fill(A, 0);

  typename E::Acc acc;
  float rowsum = 0.f;
  for (int t = 0; t < total; ++t) {
    const int kt = t % n_kt, seg = (t / n_kt) % S;
    if constexpr (kSegs) {
      if (kt == 0 && t > 0) {
        __syncthreads();  // every warp is done with the previous segment
        fill(A, seg);
      }
    }
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage t and A visible; stage t-1 consumed
    issue(t + kStages - 1);
    if (kt == 0 && seg == 0) E::zero(acc);
    E::mma(acc, A, Dp, ring + (t % kStages) * E::kStageElems, kt * kKT);
    if (kt == n_kt - 1 && seg == S - 1) {
      E::epilogue(acc, (t / per_tile) * E::kNT, Nc, part_s, epi);
      __syncthreads();
      if (tid < kRows) {
        float s = 0.f;
#pragma unroll
        for (int q = 0; q < E::kParts; ++q) s += part_s[tid][q];
        rowsum += s;
      }
    }
  }
  cp_async_wait<0>();
  if (tid < kRows) done(tid, rowsum);
}

// Warps 0 and 1 compact mask 0 and mask 1 (N <= kCap bytes each) into
// lists of valid slots (ascending) and their counts: a ballot word per
// 32 slots, kCap / 32 words.
template <int kCap>
__device__ void compact_masks(const uint8_t* m0, const uint8_t* m1, int N,
                              int (*list_s)[kCap], int* count_s) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp > 1) return;
  const uint8_t* m = warp == 0 ? m0 : m1;
  const unsigned below = (1u << lane) - 1u;
  int before = 0;
#pragma unroll
  for (int w = 0; w < kCap / 32; ++w) {
    const int n = lane + 32 * w;
    const unsigned bits = __ballot_sync(0xffffffffu, n < N && m[n] != 0);
    if (bits >> lane & 1u) list_s[warp][before + __popc(bits & below)] = n;
    before += __popc(bits);
  }
  if (lane == 0) count_s[warp] = before;
}

// Launch 0 (cosine): norms[r] for each of the 2 * rows rows of D
// features (the `rows` rows of a, then those of b), a warp a row:
// rnd(rsqrt(rnd(rnd(sum x^2) + eps))), eps the compute dtype's 1e-8.
// The squares are f32 (exact for bfloat16), summed as the reference's
// compiled program sums: each window of kWindow entries in order, then
// the window sums in order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
norms_kernel(const T* __restrict__ a, const T* __restrict__ b,
             float* __restrict__ norms, int rows, int D) {
  __shared__ float win_s[kThreads / 32][kWindow];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * (kThreads / 32) + warp;
  if (row >= 2 * rows) return;  // warp-uniform
  const T* xr = row < rows ? a + (long)row * D : b + (long)(row - rows) * D;
  const int n_win = (D + kWindow - 1) / kWindow;
  float total = 0.f;
  for (int w0 = 0; w0 < n_win; w0 += kWindow) {
    // Lane l sums window w0 + l in order.
    const int w = w0 + lane;
    float s = 0.f;
    if (w < n_win) {
      const int d1 = min(D, (w + 1) * kWindow);
      for (int d = w * kWindow; d < d1; ++d) {
        const float v = to_f(xr[d]);
        s = __fadd_rn(s, __fmul_rn(v, v));
      }
    }
    win_s[warp][lane] = s;
    __syncwarp();
    if (lane == 0)
      for (int q = 0; q < min(kWindow, n_win - w0); ++q)
        total = __fadd_rn(total, win_s[warp][q]);
    __syncwarp();
  }
  if (lane == 0) {
    const float eps = rnd<T>(1e-8f);
    const float t = rnd<T>(__fadd_rn(rnd<T>(total), eps));
    norms[row] = rnd<T>(1.f / sqrtf(t));
  }
}

template <typename T, bool kSegs, int kCap>
__global__ void __launch_bounds__(kThreads, 2)
products_kernel(const T* __restrict__ a, const T* __restrict__ b,
                const uint8_t* __restrict__ mp, const uint8_t* __restrict__ mc,
                const T* __restrict__ w1, const T* __restrict__ b1,
                const float* __restrict__ bn_mean,
                const float* __restrict__ bn_inv,
                const float* __restrict__ bn_scale,
                const float* __restrict__ bn_bias,
                const T* __restrict__ w2, const float* __restrict__ b2,
                const T* __restrict__ wn1, const T* __restrict__ we1,
                float* __restrict__ part, float* __restrict__ hs,
                const float* __restrict__ norms, int B, int K, int N, int D,
                int H, int HH, int n_ops, int ops) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float part_s[kRows][kPartLd];
  __shared__ int list_s[2][kCap];
  __shared__ int count_s[2];
  __shared__ int ri_s[kRows], rj_s[kRows];

  const int pb = blockIdx.x, tid = threadIdx.x, NN = N * N;
  const int tiles = (NN + kRows - 1) / kRows;
  const int Dp = round_up(D, kKT);

  if ((int)blockIdx.y < K * tiles) {
    // Branch k's scores for 64 valid pairs.
    const int k = blockIdx.y / tiles, q0 = (blockIdx.y % tiles) * kRows;
    compact_masks(mp + pb * N, mc + pb * N, N, list_s, count_s);
    __syncthreads();
    const int n_c = count_s[1], n_pairs = count_s[0] * n_c;
    if (q0 >= n_pairs) return;  // block-uniform: no valid pair here
    if (tid < kRows) {
      const int q = q0 + tid;
      const bool ok = q < n_pairs;
      ri_s[tid] = ok ? list_s[0][q / n_c] : -1;
      rj_s[tid] = ok ? list_s[1][q % n_c] : -1;
    }
    __syncthreads();
    const long off = ((long)pb * K + k) * N * D;
    // Cosine scales of this branch's rows (launch 0): a, then b.
    const float* na = norms ? norms + ((long)pb * K + k) * N : nullptr;
    const float* nb = norms ? na + (long)B * K * N : nullptr;
    const T* b1k = b1 + (long)k * H;
    const T* w2k = w2 + (long)k * H;
    const float* meank = bn_mean + (long)k * H;
    const float* invk = bn_inv + (long)k * H;
    const float* scalek = bn_scale + (long)k * H;
    const float* shiftk = bn_bias + (long)k * H;
    float* out = part + ((long)pb * K + k) * NN;
    const float bias2 = b2[k];
    row_gemm<T, kSegs>(
        w1 + (long)k * n_ops * D * H, D, n_ops, H, smem, part_s,
        [&](T* A, int seg) {
          fill_tile<T>(ops >> (2 * seg) & 3, A, Dp, D, a + off, ri_s,
                       b + off, rj_s, na, nb);
        },
        [&](int h) {
          const float bias1 = to_f(b1k[h]), mean = meank[h], inv = invk[h];
          const float scale = scalek[h], shift = shiftk[h];
          const float wout = to_f(w2k[h]);
          return [=](int, float acc) {
            const float hd = rnd<T>(rnd<T>(acc) + bias1);
            const float hn = rnd<T>((hd - mean) * inv * scale + shift);
            return fmaxf(hn, 0.f) * wout;
          };
        },
        [&](int r, float s) {
          if (ri_s[r] >= 0) out[ri_s[r] * N + rj_s[r]] = s + bias2;
        });
    return;
  }

  // Head h's first Dense over 64 of the valid detections (tile ht of
  // the head's head_tiles): h = 0 new (curr features, curr mask), h = 1
  // end (prev features, prev mask).  Branch 0 (fused) feeds both.
  const int head_tiles = (N + kRows - 1) / kRows;
  const int h = (blockIdx.y - K * tiles) / head_tiles;
  const int r0 = (blockIdx.y - K * tiles) % head_tiles * kRows;
  const uint8_t* own = (h == 0 ? mc : mp) + pb * N;
  compact_masks(own, own, N, list_s, count_s);
  __syncthreads();
  const int n_own = count_s[0];
  if (r0 >= n_own) return;  // block-uniform
  if (tid < kRows) ri_s[tid] = r0 + tid < n_own ? list_s[0][r0 + tid] : -1;
  __syncthreads();
  const T* feat = (h == 0 ? b : a) + (long)pb * K * N * D;
  float* hsb = hs + ((long)pb * 2 + h) * N * HH;
  const int* ri = ri_s;
  row_gemm<T, false>(
      h == 0 ? wn1 : we1, D, 1, HH, smem, part_s,
      [&](T* A, int) {
        Eng<T>::template fill_op<kSubabs>(A, Dp, D, feat, ri_s, nullptr,
                                          nullptr, nullptr, nullptr);
      },
      [=](int col) {
        return [=](int r, float s) {
          if (ri[r] >= 0) hsb[(long)ri[r] * HH + col] = s;
          return 0.f;
        };
      },
      [](int, float) {});
}

// Launch 2: link, its row and column softmaxes and pools, the
// normalisation, and the heads' epilogues, for frame pair blockIdx.x.  A
// warp per row (then per column) of the softmax, lanes over its entries;
// a warp per valid detection of the heads, lanes over the hidden units.
// Dynamic shared memory: link_s and row_s, N x (N + 1) floats each.
//
// kBias: the instance with the optional additive link bias [B, N, N] f32
// (the learned motion term of mmmot_tpu/kernels/affinity_kernel.py's
// `link_bias`), added to the f32 branch sum before the mask select and
// the cast, so the softmax and both pools read the biased link.  The
// instance without it compiles to the bias-free instructions.
//
// avg (score_fusion="avg", the TPU kernel's `avg`): the f32 branch sum is
// divided by K (an IEEE division, as the TPU kernel's acc / K: a product
// with 1/K rounds differently at K=3) before the bias, the mask and the
// cast.  K may be 1 (one score branch: fused-only, one modality), 2 (a
// dead sensor's branch absent) or 3.
//
// pool (Pool): the heads' evidence over a row (end) or column (new) of
// the link: kPoolMax the largest valid entry (0 with none), kPoolMean
// rnd(rnd(sum of the valid entries) / max(count, 1)), kPoolSoftmax
// rnd(sum of w * link) with w the line's masked softmax; the sums in f32
// over f32 terms.  mode (Mode): link_norm = rnd(0.5 rnd(row + col)) of
// the two softmaxes (kDual), the row softmax (kSingle), or the link
// itself (kNone).
//
// kU: entries of a line per lane (a line has at most 32 kU entries).
// kU = kSmemN / 32 is the instance for N <= kSmemN: link_s and row_s in
// dynamic shared memory, two lines a warp at a time.  Above kSmemN (kU =
// kMaxN / 32, one instance for every N up to kMaxN) the two N x (N + 1)
// float planes would pass the 227 KB a block may hold (N > 168), so this instance
// keeps no plane on chip: the lines read the link back from `link`
// itself (its compute-dtype value, which is what link_s holds, widened;
// a frame pair's link is 128 KB at N = 256 in bf16 and stays in L1/L2),
// the row pass writes the row softmax straight into `norm` (a value
// already rounded to T, so the store is exact) and the column pass
// combines it there with the column softmax.  One line a warp at a time
// keeps the lane's 3 kU line registers in bounds.  The arithmetic, and
// so every rounding point, is the shared-memory instance's.
template <typename T, bool kBias, int kU>
__global__ void __launch_bounds__(kThreads)
finish_kernel(const float* __restrict__ part, const float* __restrict__ hs,
              const uint8_t* __restrict__ mp, const uint8_t* __restrict__ mc,
              const float* __restrict__ wnp, const float* __restrict__ bn1,
              const T* __restrict__ wn2, const float* __restrict__ bn2,
              const float* __restrict__ wep, const float* __restrict__ be1,
              const T* __restrict__ ew2, const float* __restrict__ eb2,
              T* __restrict__ link, T* __restrict__ norm,
              T* __restrict__ new_out, T* __restrict__ end_out,
              const float* __restrict__ bias, int K, int N, int HH,
              int avg, int pool, int mode) {
  constexpr int kCap = 32 * kU;          // slots this instance takes
  constexpr bool kSmem = kCap <= kSmemN;  // lines in shared memory
  constexpr int kQ = kSmem ? 2 : 1;       // lines a warp at a time
  extern __shared__ __align__(16) float lines_s[];
  const int ld = N + 1;              // conflict-free rows and columns
  float* link_s = lines_s;           // the link, then its column softmax
  float* row_s = lines_s + N * ld;   // its row softmax
  __shared__ float best_s[2][kCap];  // column (new) and row (end) pools
  __shared__ int list_s[2][kCap];
  __shared__ int count_s[2];

  const int pb = blockIdx.x, tid = threadIdx.x, NN = N * N;
  const int warp = tid / 32, lane = tid % 32, n_warps = kThreads / 32;
  const float neg = rnd<T>(kNegInf);
  const float tiny = rnd<T>(1e-30f);
  T* const link_b = link + (long)pb * NN;  // this pair's link and norm
  T* const norm_b = norm + (long)pb * NN;
  __shared__ bool mpb[kCap], mcb[kCap];
  compact_masks(mc + pb * N, mp + pb * N, N, list_s, count_s);  // curr, prev
  for (int n = tid; n < N; n += kThreads) {
    mpb[n] = mp[pb * N + n] != 0;
    mcb[n] = mc[pb * N + n] != 0;
  }
  __syncthreads();
  // link = cast(sum over branches, in branch order, then + bias) at
  // valid pairs, an exact 0 elsewhere, kChunk elements a thread at a
  // time.  A thread's elements are loaded together, and unconditionally
  // so that the loads do not wait on the masks (scratch that launch 1
  // left unwritten is discarded).
  constexpr int kChunk = 16;
  for (int e0 = 0; e0 < NN; e0 += kChunk * kThreads) {
    float v[kChunk];
#pragma unroll
    for (int u = 0; u < kChunk; ++u) v[u] = 0.f;
    for (int k = 0; k < K; ++k) {
      const float* pk = part + ((long)pb * K + k) * NN + e0 + tid;
#pragma unroll
      for (int u = 0; u < kChunk; ++u)
        if (e0 + tid + u * kThreads < NN) v[u] += pk[u * kThreads];
    }
    if (avg) {
      const float kf = (float)K;
#pragma unroll
      for (int u = 0; u < kChunk; ++u) v[u] = v[u] / kf;
    }
    if constexpr (kBias) {
      const float* pbias = bias + (long)pb * NN + e0 + tid;
#pragma unroll
      for (int u = 0; u < kChunk; ++u)
        if (e0 + tid + u * kThreads < NN) v[u] += pbias[u * kThreads];
    }
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      const int e = e0 + tid + u * kThreads, i = e / N, j = e % N;
      if (e >= NN) break;
      const T lv = from_f<T>(mpb[i] && mcb[j] ? v[u] : 0.f);
      link_b[e] = lv;
      if (mode == kNone) norm_b[e] = lv;
      if constexpr (kSmem) link_s[i * ld + j] = to_f(lv);
    }
  }
  __syncthreads();  // the link, in link_s or in `link`, is complete
  // Entry (i, j) of the link as the lines read it.
  auto link_at = [&](int i, int j) {
    if constexpr (kSmem) return link_s[i * ld + j];
    else return to_f(link_b[(long)i * N + j]);
  };

  // Masked softmax of lines l + 8 q, q < kQ (rows if by_row, else
  // columns; a line >= N is skipped) of the link matrix, and their pools
  // over the valid entries into best.  The softmax goes to out_s (the
  // shared-memory instance), or into `norm` (the other: rows as the row
  // softmax, columns combined with it by the mode).  Lanes take entries
  // lane + 32 u; the lines' shuffle chains interleave.
  auto lines = [&](int l, bool by_row, float* out_s, float* best) {
    float lg[kQ][kU], pm[kQ][kU], ex[kQ][kU], mx[kQ], top[kQ], den[kQ],
        sum[kQ], cnt[kQ], wsum[kQ];
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      const int lq = l + 8 * q;
      const bool own = lq < N && (by_row ? mpb[lq] : mcb[lq]);
      mx[q] = top[q] = -INFINITY;
      sum[q] = cnt[q] = 0.f;
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int x = lane + 32 * u;
        const bool in = x < N;
        const bool ok = in && own && (by_row ? mcb[x] : mpb[x]);
        pm[q][u] = ok ? 1.f : 0.f;
        lg[q][u] = ok ? (by_row ? link_at(lq, x) : link_at(x, lq)) : neg;
        if (in) mx[q] = fmaxf(mx[q], lg[q][u]);
        if (ok) {
          top[q] = fmaxf(top[q], lg[q][u]);
          sum[q] += lg[q][u];
          cnt[q] += 1.f;
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off /= 2)
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        mx[q] = fmaxf(mx[q], __shfl_xor_sync(0xffffffffu, mx[q], off));
        top[q] = fmaxf(top[q], __shfl_xor_sync(0xffffffffu, top[q], off));
      }
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      den[q] = 0.f;
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        ex[q][u] = rnd<T>(expf(rnd<T>(lg[q][u] - mx[q])));
        den[q] += ex[q][u] * pm[q][u];
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off /= 2)
#pragma unroll
      for (int q = 0; q < kQ; ++q)
        den[q] += __shfl_xor_sync(0xffffffffu, den[q], off);
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      const float dq = fmaxf(rnd<T>(den[q]), tiny);
      wsum[q] = 0.f;
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        ex[q][u] = rnd<T>(ex[q][u] * pm[q][u] / dq);  // the softmax
        if (pm[q][u] > 0.f) wsum[q] += __fmul_rn(ex[q][u], lg[q][u]);
      }
    }
    if (pool != kPoolMax) {  // block-uniform
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
#pragma unroll
        for (int q = 0; q < kQ; ++q) {
          sum[q] += __shfl_xor_sync(0xffffffffu, sum[q], off);
          cnt[q] += __shfl_xor_sync(0xffffffffu, cnt[q], off);
          wsum[q] += __shfl_xor_sync(0xffffffffu, wsum[q], off);
        }
    }
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      const int lq = l + 8 * q;
      if (lq >= N) continue;
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int x = lane + 32 * u;
        if (x >= N) continue;
        if constexpr (kSmem) {
          out_s[by_row ? lq * ld + x : x * ld + lq] = ex[q][u];
        } else if (by_row) {
          if (mode != kNone) norm_b[(long)lq * N + x] = from_f<T>(ex[q][u]);
        } else if (mode == kDual) {  // the row softmax, stored above
          T* o = norm_b + (long)x * N + lq;
          *o = from_f<T>(rnd<T>(0.5f * rnd<T>(to_f(*o) + ex[q][u])));
        }
      }
      if (lane == 0)
        best[lq] = pool == kPoolMean ? rnd<T>(rnd<T>(sum[q]) /
                                              fmaxf(cnt[q], 1.f))
                   : pool == kPoolSoftmax ? rnd<T>(wsum[q])
                   : top[q] == -INFINITY  ? 0.f
                                          : top[q];
    }
  };
  static_assert(kThreads / 32 == 8, "lines pairs l with l + 8");
  for (int i = warp; i < N; i += 8 * kQ) lines(i, true, row_s, best_s[1]);
  __syncthreads();  // rows read and stored; the columns overwrite below
  for (int j = warp; j < N; j += 8 * kQ) lines(j, false, link_s, best_s[0]);
  __syncthreads();
  if (kSmem && mode != kNone)
    for (int e = tid; e < NN; e += kThreads) {
      const int x = (e / N) * ld + e % N;
      norm[(long)pb * NN + e] = mode == kSingle
          ? from_f<T>(row_s[x])
          : from_f<T>(rnd<T>(0.5f * rnd<T>(row_s[x] + link_s[x])));
    }

  // Heads: 0 for masked detections; for each valid one a warp computes
  // relu(rnd(s + pooled * wp + b1)) . w2 + b2.
  for (int n = tid; n < N; n += kThreads) {
    if (!mcb[n]) new_out[(long)pb * N + n] = from_f<T>(0.f);
    if (!mpb[n]) end_out[(long)pb * N + n] = from_f<T>(0.f);
  }
  const int n_new = count_s[0];
  for (int w = warp; w < n_new + count_s[1]; w += n_warps) {
    const int h = w < n_new ? 0 : 1;  // 0 new (curr n), 1 end (prev n)
    const int n = list_s[h][w - h * n_new];
    const float pooled = best_s[h][n];
    const float* s = hs + (((long)pb * 2 + h) * N + n) * HH;
    const float* wp = h == 0 ? wnp : wep;
    const float* hb1 = h == 0 ? bn1 : be1;
    const T* hw2 = h == 0 ? wn2 : ew2;
    float acc = 0.f;
#pragma unroll 8
    for (int j = lane; j < HH; j += 32) {
      const float hf = s[j] + pooled * wp[j] + hb1[j];
      acc += fmaxf(rnd<T>(hf), 0.f) * to_f(hw2[j]);
    }
#pragma unroll
    for (int off = 16; off > 0; off /= 2)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0)
      (h == 0 ? new_out : end_out)[(long)pb * N + n] =
          from_f<T>(acc + (h == 0 ? bn2 : eb2)[0]);
  }
}

// Launch 2's dynamic shared memory: the two line planes up to kSmemN,
// none above.
size_t finish_smem_bytes(int N) {
  return N <= kSmemN ? (size_t)2 * N * (N + 1) * 4 : 0;
}

// Launch 2's instance for N slots and `bias`: the entries a lane holds
// of a line (kU) by N, the bias instance or not.
template <typename T, int kU>
auto finish_for(bool bias) {
  return bias ? finish_kernel<T, true, kU> : finish_kernel<T, false, kU>;
}
template <typename T>
auto finish_instance(int N, bool bias) {
  return N <= kSmemN ? finish_for<T, kSmemN / 32>(bias)
                     : finish_for<T, kMaxN / 32>(bias);
}

// Launch 1's instance: the op segments' with several ops, and mask lists
// of kCap slots (kSmemN: the instance of N <= 128 as it was before N
// could pass 128; kMaxN above).
template <typename T, int kCap>
auto products_for(int n_ops) {
  return n_ops > 1 ? products_kernel<T, true, kCap>
                   : products_kernel<T, false, kCap>;
}

template <typename T>
int launch_products(const void* a, const void* b, const void* mp,
                    const void* mc, const void* w1, const void* b1,
                    const void* bn_mean, const void* bn_inv,
                    const void* bn_scale, const void* bn_bias, const void* w2,
                    const void* b2, const void* wn1, const void* we1,
                    void* part, void* hs, void* norms, int B, int K, int N,
                    int D, int H, int HH, int n_ops, int ops,
                    cudaStream_t stream) {
  if (norms != nullptr) {  // cosine: the rows' scales first
    const int rows = B * K * N, per = kThreads / 32;
    norms_kernel<T><<<(2 * rows + per - 1) / per, kThreads, 0, stream>>>(
        (const T*)a, (const T*)b, (float*)norms, rows, D);
  }
  // Opt in to the dynamic shared memory on the current device (the
  // attribute is per device; setting it is a cheap host call).
  auto kernel = N <= kSmemN ? products_for<T, kSmemN>(n_ops)
                            : products_for<T, kMaxN>(n_ops);
  const size_t bytes = gemm_smem_bytes<T>(D);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (N * N + kRows - 1) / kRows;
  const int head_tiles = (N + kRows - 1) / kRows;
  kernel<<<dim3(B, K * tiles + 2 * head_tiles), kThreads, bytes, stream>>>(
      (const T*)a, (const T*)b, (const uint8_t*)mp, (const uint8_t*)mc,
      (const T*)w1, (const T*)b1, (const float*)bn_mean, (const float*)bn_inv,
      (const float*)bn_scale, (const float*)bn_bias, (const T*)w2,
      (const float*)b2, (const T*)wn1, (const T*)we1, (float*)part,
      (float*)hs, (const float*)norms, B, K, N, D, H, HH, n_ops, ops);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_finish(const void* part, const void* hs, const void* mp,
                  const void* mc, const void* wnp, const void* bn1,
                  const void* wn2, const void* bn2, const void* wep,
                  const void* be1, const void* ew2, const void* eb2,
                  void* link, void* norm, void* new_out, void* end_out,
                  const void* bias, int B, int K, int N, int HH, int avg,
                  int pool, int mode, cudaStream_t stream) {
  auto kernel = finish_instance<T>(N, bias != nullptr);
  const size_t bytes = finish_smem_bytes(N);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B, kThreads, bytes, stream>>>(
      (const float*)part, (const float*)hs, (const uint8_t*)mp,
      (const uint8_t*)mc, (const float*)wnp, (const float*)bn1,
      (const T*)wn2, (const float*)bn2, (const float*)wep, (const float*)be1,
      (const T*)ew2, (const float*)eb2, (T*)link, (T*)norm, (T*)new_out,
      (T*)end_out, (const float*)bias, K, N, HH, avg, pool, mode);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The most slots per frame the kernels take, and the most for which
// launch 2 holds its lines in shared memory.
int mmmot_affinity_max_n() { return kMaxN; }
int mmmot_affinity_smem_n() { return kSmemN; }

// Launch 1 (after launch 0 with cosine): the dense products.
// part [B, K, N, N] gets each branch's score + b2 at the valid pairs,
// hs [B, 2, N, HH] the new / end heads' first Dense (without bias) at the
// valid curr / prev detections; both are float32 scratch, other elements
// are left unwritten.  w1 is [K, n_ops * D, H]; op o of the pair feature
// is (ops >> 2 o) & 3 (Op).  norms, float32 scratch [2, B, K, N], is
// non-null exactly when an op is cosine.  Pointers are device pointers
// of contiguous tensors; `is_bf16` selects bfloat16 (else float32) for
// a, b, w1, b1, w2, wn1 and we1; masks are uint8 (bool) and the BN terms
// and b2 float32.  The caller has checked the widths (the wrapper's
// check_widths: N <= mmmot_affinity_max_n(), D % 16, H % 8, HH % 8) and
// made the stream's device current.  Returns the CUDA error of the
// launch (0 on success), or cudaErrorInvalidValue for N outside 1..kMaxN
// or n_ops outside 1..4; nothing synchronises.
int mmmot_affinity_products(const void* a, const void* b, const void* mp,
                            const void* mc, const void* w1, const void* b1,
                            const void* bn_mean, const void* bn_inv,
                            const void* bn_scale, const void* bn_bias,
                            const void* w2, const void* b2, const void* wn1,
                            const void* we1, void* part, void* hs,
                            void* norms, int B, int K, int N, int D, int H,
                            int HH, int n_ops, int ops, int is_bf16,
                            void* stream) {
  if (B <= 0 || K <= 0 || N <= 0 || N > kMaxN || n_ops < 1 || n_ops > 4)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return launch_products<__nv_bfloat16>(a, b, mp, mc, w1, b1, bn_mean,
                                          bn_inv, bn_scale, bn_bias, w2, b2,
                                          wn1, we1, part, hs, norms, B, K, N,
                                          D, H, HH, n_ops, ops, s);
  return launch_products<float>(a, b, mp, mc, w1, b1, bn_mean, bn_inv,
                                bn_scale, bn_bias, w2, b2, wn1, we1, part, hs,
                                norms, B, K, N, D, H, HH, n_ops, ops, s);
}

// Launch 2, after launch 1 on the same stream: link, link_norm, new and
// end (compute dtype; every element written).  wn2 and ew2 are in the
// compute dtype, wnp, bn1, bn2, wep, be1 and eb2 float32.  bias is a
// contiguous float32 [B, N, N] added to the link before the mask, or
// null for none.  avg != 0 divides the branch sum by K first
// (score_fusion="avg"); pool and mode pick the heads' pool (Pool) and the
// normalisation (Mode).
int mmmot_affinity_finish(const void* part, const void* hs, const void* mp,
                          const void* mc, const void* wnp, const void* bn1,
                          const void* wn2, const void* bn2, const void* wep,
                          const void* be1, const void* ew2, const void* eb2,
                          void* link, void* norm, void* new_out,
                          void* end_out, const void* bias, int B, int K,
                          int N, int HH, int avg, int pool, int mode,
                          int is_bf16, void* stream) {
  if (B <= 0 || K <= 0 || N <= 0 || N > kMaxN || pool < 0 || pool > 2 ||
      mode < 0 || mode > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return launch_finish<__nv_bfloat16>(part, hs, mp, mc, wnp, bn1, wn2, bn2,
                                        wep, be1, ew2, eb2, link, norm,
                                        new_out, end_out, bias, B, K, N, HH,
                                        avg, pool, mode, s);
  return launch_finish<float>(part, hs, mp, mc, wnp, bn1, wn2, bn2, wep, be1,
                              ew2, eb2, link, norm, new_out, end_out, bias, B,
                              K, N, HH, avg, pool, mode, s);
}

}  // extern "C"
