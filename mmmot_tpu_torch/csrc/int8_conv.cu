// Int8 3x3 convolution with the requantisation epilogue, for Hopper
// (sm_90a).
//
// The JAX package has no Pallas kernel for this: its int8 appearance trunk
// (mmmot_tpu/models/quantize.py:267-271, quantized_trunk_stages) leaves
// the conv to XLA.  Eager PyTorch on CUDA has no int8 convolution, so the
// port's trunk runs this kernel.  For an NHWC int8 map x [n, H, W, Cin]
// and int8 weights w [Cout, Kp] (K = 9 * Cin in (ky, kx, ci) order, zero
// padded to Kp, a multiple of 32), per output pixel p and channel c:
//
//   acc[p, c] = sum_k x_im2col[p, k] * w[c, k]          (int32, exact)
//   y         = fma(float(acc), m[c], b[c])              (f32, rounded once)
//   out[p, c] = clamp(rint(y), 0, 127)                   (int8; the clamp at
//                                                         0 is the ReLU)
//
// float(acc) rounds to nearest even (|acc| reaches 9 * 512 * 127^2, above
// 2^24), and rint is round-half-to-even, as jnp.round and torch.round are.
// The multiply-add rounds once, as XLA's CPU code contracts the
// reference's `acc * m + b`.  So this kernel, the plain version
// (kernels/int8_conv.py, a float64 conv) and XLA's int32 conv give the
// same int8 maps bit for bit.
//
// What bounds it on an H100: operations.  2 * 9 * Cin * Cout per output
// pixel on the int8 tensor cores (1,979 TOP/s dense) against reading x
// once and writing out once (3.35 TB/s): at VGG16's shapes, 128 or more
// operations per byte, above the int8 ridge only for Cin >= 128
// (chip_smoke.py phase 11 (a) names the bound of each layer).
//
// Design: an implicit GEMM, M = n * H * W output pixels, N = Cout, K = Kp,
// with no im2col in device memory.  One block of 256 threads computes a
// 128-pixel x 64-channel output tile; its 8 warps are 4 x 2, each
// 32 x 32, as 2 x 4 mma.sync.m16n8k32 (s8 x s8 -> s32) tiles with the
// int32 accumulators in registers.  K advances 32 bytes a step through a
// double buffer of shared tiles (rows padded to 48 bytes, so the 32-bit
// fragment loads of a warp hit 32 distinct banks): while the tensor cores
// work on one step, cp.async fills the other.  With Cin a multiple of 32 a
// K step lies inside one tap, so each pixel's 32 bytes are two 16-byte
// cp.async copies, zero-filled (src-size 0) where the tap falls outside
// the map (the SAME halo) or past the last pixel.  Other Cin (conv_0's 3,
// the narrow widths of small configs) gather the step byte by byte, with
// zeros past K.  The weight tile always streams through cp.async.
//
// Later work (ROADMAP Queue 2): wgmma s8 on swizzled tiles fed by TMA, and
// the 2x2 max-pool fused into the epilogue of a stage's last conv.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kBM = 128;      // output pixels per block
constexpr int kBN = 64;       // output channels per block
constexpr int kBK = 32;       // K bytes per step (one m16n8k32)
constexpr int kLds = 48;      // shared row stride in bytes
constexpr int kThreads = 256;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4],
                                       const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ int8_t requant(int acc, float m, float b) {
  const float y = __fmaf_rn(__int2float_rn(acc), m, b);
  const int q = __float2int_rn(y);            // half to even
  return static_cast<int8_t>(min(max(q, 0), 127));
}

__device__ __forceinline__ unsigned lds32(const int8_t* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

// kVec: Cin is a multiple of 32 (16-byte copies of the input tile).
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
int8_conv3x3_kernel(const int8_t* __restrict__ x,
                    const int8_t* __restrict__ w,
                    const float* __restrict__ m,
                    const float* __restrict__ bias,
                    int8_t* __restrict__ out, int n, int H, int W, int Cin,
                    int Cout, int Kp) {
  __shared__ __align__(16) int8_t As[2][kBM * kLds];
  __shared__ __align__(16) int8_t Bs[2][kBN * kLds];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;
  const long long M = static_cast<long long>(n) * H * W;
  const long long m0 = static_cast<long long>(blockIdx.x) * kBM;
  const int n0 = blockIdx.y * kBN;
  const int K = 9 * Cin;
  const int nk = Kp / kBK;

  // This thread's input row (an output pixel) and 16-byte half of it.
  const int a_row = tid >> 1, a_half = tid & 1;
  const long long p = m0 + a_row;
  const bool p_ok = p < M;
  int px = 0, py = 0;
  long long pi = 0;
  if (p_ok) {
    px = static_cast<int>(p % W);
    const long long q = p / W;
    py = static_cast<int>(q % H);
    pi = q / H;
  }

  auto load = [&](int buf, int kc) {
    const int k0 = kc * kBK;
    int8_t* dst = &As[buf][a_row * kLds + a_half * 16];
    if (kVec) {
      const int tap = k0 / Cin;
      const int ci = k0 - tap * Cin + a_half * 16;
      const int yy = py + tap / 3 - 1, xx = px + tap % 3 - 1;
      const bool ok = p_ok && yy >= 0 && yy < H && xx >= 0 && xx < W;
      const int8_t* src =
          ok ? x + ((static_cast<size_t>(pi) * H + yy) * W + xx) * Cin + ci
             : x;
      cp_async16(dst, src, ok ? 16 : 0);
    } else {
      unsigned words[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int k = k0 + a_half * 16 + j;
        unsigned v = 0u;
        if (p_ok && k < K) {
          const int tap = k / Cin, ci = k - tap * Cin;
          const int yy = py + tap / 3 - 1, xx = px + tap % 3 - 1;
          if (yy >= 0 && yy < H && xx >= 0 && xx < W)
            v = static_cast<uint8_t>(
                x[((static_cast<size_t>(pi) * H + yy) * W + xx) * Cin + ci]);
        }
        words[j >> 2] |= v << (8 * (j & 3));
      }
      *reinterpret_cast<uint4*>(dst) =
          make_uint4(words[0], words[1], words[2], words[3]);
    }
    if (tid < kBN * 2) {
      const int r = tid >> 1, h = tid & 1;
      const int co = n0 + r;
      const bool ok = co < Cout;
      const int8_t* src =
          ok ? w + static_cast<size_t>(co) * Kp + k0 + h * 16 : w;
      cp_async16(&Bs[buf][r * kLds + h * 16], src, ok ? 16 : 0);
    }
    cp_async_commit();
  };

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  load(0, 0);
  for (int kc = 0; kc < nk; ++kc) {
    const int buf = kc & 1;
    if (kc + 1 < nk) {
      load(buf ^ 1, kc + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int8_t* a_s = As[buf];
    const int8_t* b_s = Bs[buf];
    unsigned af[2][4], bf[4][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int r = wm * 32 + mi * 16 + g;
      af[mi][0] = lds32(a_s + r * kLds + t * 4);
      af[mi][1] = lds32(a_s + (r + 8) * kLds + t * 4);
      af[mi][2] = lds32(a_s + r * kLds + 16 + t * 4);
      af[mi][3] = lds32(a_s + (r + 8) * kLds + 16 + t * 4);
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int c = wn * 32 + ni * 8 + g;
      bf[ni][0] = lds32(b_s + c * kLds + t * 4);
      bf[ni][1] = lds32(b_s + c * kLds + 16 + t * 4);
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], af[mi], bf[ni]);
    __syncthreads();
  }

  // Epilogue: c0, c1 at row g, columns 2t, 2t+1; c2, c3 at row g + 8.
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long row = m0 + wm * 32 + mi * 16 + g + half * 8;
      if (row >= M) continue;
      int8_t* o = out + static_cast<size_t>(row) * Cout;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int co = n0 + wn * 32 + ni * 8 + t * 2;
        if (co >= Cout) continue;            // Cout is a multiple of 8
        char2 v;
        v.x = requant(acc[mi][ni][half * 2], m[co], bias[co]);
        v.y = requant(acc[mi][ni][half * 2 + 1], m[co + 1], bias[co + 1]);
        *reinterpret_cast<char2*>(o + co) = v;
      }
    }
  }
}

}  // namespace

extern "C" {

// The tile's K step: the wrapper pads the weights' K to a multiple of it.
int mmmot_int8_conv_k_step() { return kBK; }

// x [n, H, W, Cin] int8, w [Cout, Kp] int8, m / b [Cout] float32 ->
// out [n, H, W, Cout] int8 on `stream`.  Kp = 9 * Cin rounded up to a
// multiple of 32; Cout a multiple of 8; with Cin a multiple of 32, x
// starts on a 16-byte boundary; w always does.  Returns the launch's
// cudaError_t.
int mmmot_int8_conv3x3(const void* x, const void* w, const void* m,
                       const void* b, void* out, int n, int H, int W,
                       int Cin, int Cout, int Kp, void* stream) {
  const long long M = static_cast<long long>(n) * H * W;
  if (M == 0) return 0;
  const dim3 grid(static_cast<unsigned>((M + kBM - 1) / kBM),
                  static_cast<unsigned>((Cout + kBN - 1) / kBN));
  auto s = static_cast<cudaStream_t>(stream);
  const auto* xi = static_cast<const int8_t*>(x);
  const auto* wi = static_cast<const int8_t*>(w);
  const auto* mf = static_cast<const float*>(m);
  const auto* bf = static_cast<const float*>(b);
  auto* o = static_cast<int8_t*>(out);
  if (Cin % 32 == 0)
    int8_conv3x3_kernel<true><<<grid, kThreads, 0, s>>>(
        xi, wi, mf, bf, o, n, H, W, Cin, Cout, Kp);
  else
    int8_conv3x3_kernel<false><<<grid, kThreads, 0, s>>>(
        xi, wi, mf, bf, o, n, H, W, Cin, Cout, Kp);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
