// Conv bias, eval BatchNorm, ReLU and an optional 2x2 max-pool in one pass
// over a channels-last map, for Hopper (sm_90a).
//
// What it replaces.  The JAX package has no Pallas kernel for this: after
// each 3x3 conv of its VGG trunk (mmmot_tpu/models/appearance.py,
// VGGBackbone) XLA fuses the conv bias, the eval BatchNorm and the ReLU
// into one elementwise loop and runs the 2x2 max-pool that ends a stage as
// a reduce_window.  The port ran them as PyTorch's op chain
// (models/appearance.py::VGGBackbone._segment): the bias add in the compute
// dtype T (Conv3x3.forward), the eval MaskedBatchNorm in float32
// (x.float(), - mean, * inv, addcmul, .to(T)), torch.relu and
// F.max_pool2d: eight passes over the map.  For a conv output c [n, H, W, C]
// (cuDNN's channels-last layout) and per-channel float32 mean, inv =
// rsqrt(running_var + eps) (computed by torch, so its bits are the
// chain's), scale and shift, and the conv bias cb in T, per element:
//
//   t = T(float(c) + float(cb))              the bias add, rounded to T
//   w = fma((float(t) - mean) * inv, scale, shift)   each op rounded once
//   o = T(w)                                 round to nearest even
//   r = isnan(o) ? o : max(o, 0)             torch.relu (clamp_min)
//
// and with `pool` the 2x2 stride-2 VALID max of r over each window (an odd
// last row or column is dropped), taken as F.max_pool2d takes it: from
// -inf, the four pixels in row-major order, a pixel replacing the running
// maximum when it is greater or NaN.  The arithmetic uses the _rn
// intrinsics, so nvcc cannot contract the subtract and the multiply, and
// the same conversions as PyTorch's CUDA kernels (__float2bfloat16_rn,
// fmaxf): the output equals the chain's bit for bit, ±0, subnormals, ±inf
// and NaN included.
//
// What bounds it on an H100 (3.35 TB/s).  A few flops an element against
// reading the conv output once and writing the activation once: 4 bytes an
// element in bf16 (2.5 with the pool, which writes a quarter of the map),
// 8 in float32.  Memory bound; chip_smoke.py's phase 3 prints each layer's bound.
//
// Design.  A streaming pass.  A thread owns V channels (16 bytes: 8 bf16 or
// 4 float32; 1 when C is not a multiple of V or a pointer is not 16-byte
// aligned) of one channel group for the whole launch, keeps their five
// per-channel scalars in registers, and walks the pixels in a grid-stride
// loop of one wave of resident blocks: one 16-byte load and one 16-byte
// store a pixel, two pixels in flight per iteration; with `pool`, the four
// 16-byte vectors of a window and one store, the window's max taken on the
// floats (which T holds exactly) before one conversion, so the pooled
// instance converts once an output and fits 64 registers.  A block is
// groups x rows of threads (threadIdx.x the channel group, so a warp reads
// whole pixels' contiguous runs).  Indices are 32-bit: the host splits n
// so that a launch's map holds fewer than 2^31 elements.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <climits>
#include <cmath>

namespace {

constexpr int kThreads = 256;
constexpr int kErrShape = 30000;   // a single image of 2^31 elements or more

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// max(f, 0), NaN for a NaN f (PTX max.NaN): torch.relu's clamp_min,
// `isnan(f) ? f : fmaxf(f, 0)`, up to the NaN's payload, which every
// conversion to T below makes the canonical NaN in both.
__device__ __forceinline__ float relu_nan(float f) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(f), "f"(0.0f));
  return r;
}

// One channel's per-element function up to the ReLU, as a float that T
// holds exactly (or NaN): the chain's rounding points.
template <typename T>
__device__ __forceinline__ float bn_relu(T c, float cb, float mean,
                                         float inv, float scale,
                                         float shift) {
  const float t = to_float(from_float<T>(__fadd_rn(to_float(c), cb)));
  const float w = __fmaf_rn(__fmul_rn(__fsub_rn(t, mean), inv), scale,
                            shift);
  return relu_nan(to_float(from_float<T>(w)));
}

template <typename T, int V>
struct Channels {
  float cb[V], mean[V], inv[V], scale[V], shift[V];

  __device__ __forceinline__ Vec<T, V> apply(const Vec<T, V>& a) const {
    Vec<T, V> o;
#pragma unroll
    for (int k = 0; k < V; ++k)
      o.v[k] = from_float<T>(bn_relu(a.v[k], cb[k], mean[k], inv[k],
                                     scale[k], shift[k]));
    return o;
  }

  // The 2x2 window's max (F.max_pool2d's order and rule: from -inf, a
  // pixel replaces the running maximum when it is greater or NaN), taken
  // on the floats, which T holds exactly, and rounded once.
  __device__ __forceinline__ Vec<T, V> pool(const Vec<T, V>& a0,
                                            const Vec<T, V>& a1,
                                            const Vec<T, V>& a2,
                                            const Vec<T, V>& a3) const {
    const Vec<T, V>* a[4] = {&a0, &a1, &a2, &a3};
    Vec<T, V> o;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      float m = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float f = bn_relu(a[j]->v[k], cb[k], mean[k], inv[k],
                                scale[k], shift[k]);
        if (f > m || isnan(f)) m = f;
      }
      o.v[k] = from_float<T>(m);
    }
    return o;
  }
};

// x [n, H, W, C] -> out [n, Ho, Wo, C] (Ho = H / 2, Wo = W / 2 with POOL),
// `pixels` = n * Ho * Wo output pixels; blockDim.x threads cover channel
// groups (blockIdx.y the next blockDim.x of them), blockDim.y pixels.
template <typename T, bool POOL, int V>
__global__ void __launch_bounds__(kThreads)
bn_relu_kernel(const T* __restrict__ x, const T* __restrict__ conv_bias,
               const float* __restrict__ mean, const float* __restrict__ inv,
               const float* __restrict__ scale,
               const float* __restrict__ shift, T* __restrict__ out,
               int pixels, int H, int W, int Ho, int Wo, int C) {
  using VecT = Vec<T, V>;
  const int groups = C / V;
  const int g = blockIdx.y * blockDim.x + threadIdx.x;
  if (g >= groups) return;
  Channels<T, V> ch;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int c = g * V + k;
    ch.cb[k] = to_float(conv_bias[c]);
    ch.mean[k] = mean[c];
    ch.inv[k] = inv[c];
    ch.scale[k] = scale[c];
    ch.shift[k] = shift[c];
  }
  const auto* xv = reinterpret_cast<const VecT*>(x);
  auto* ov = reinterpret_cast<VecT*>(out);
  const int stride = gridDim.x * blockDim.y;
  int p = blockIdx.x * blockDim.y + threadIdx.y;
  if constexpr (!POOL) {
    for (; p + stride < pixels; p += 2 * stride) {
      const VecT a = xv[p * groups + g];
      const VecT b = xv[(p + stride) * groups + g];
      ov[p * groups + g] = ch.apply(a);
      ov[(p + stride) * groups + g] = ch.apply(b);
    }
    if (p < pixels) ov[p * groups + g] = ch.apply(xv[p * groups + g]);
  } else {
    const unsigned wo_n = Wo, ho_n = Ho;
    const int row = W * groups;
    for (; p < pixels; p += stride) {
      const unsigned q = p / wo_n, wo = p - q * wo_n;
      const unsigned img = q / ho_n, ho = q - img * ho_n;
      const int base = ((img * H + 2 * ho) * W + 2 * wo) * groups + g;
      ov[p * groups + g] = ch.pool(xv[base], xv[base + groups],
                                   xv[base + row], xv[base + row + groups]);
    }
  }
}

// The blocks of `threads` threads of `kernel` that device `dev` holds at
// once: its SM count times the blocks an SM holds (at least 1).  Both are
// constant for a device and an instance, so they are read from the runtime
// once per (kernel, device, block size) and kept; a device index past
// kMaxDevices reads them every call.
template <typename Kernel>
cudaError_t resident_blocks(Kernel kernel, int dev, int threads, int* out) {
  constexpr int kMaxDevices = 16;
  static std::atomic<int> cached[kMaxDevices][kThreads + 1];
  const bool keep = dev >= 0 && dev < kMaxDevices;
  if (keep && (*out = cached[dev][threads].load(std::memory_order_relaxed)))
    return cudaSuccess;
  int sms = 0, per_sm = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, 0);
  if (err != cudaSuccess) return err;
  *out = sms * (per_sm > 0 ? per_sm : 1);
  if (keep) cached[dev][threads].store(*out, std::memory_order_relaxed);
  return cudaSuccess;
}

template <typename T, bool POOL, int V>
int launch(const void* x, const void* conv_bias, const float* mean,
           const float* inv, const float* scale, const float* shift,
           void* out, int n, int H, int W, int C, cudaStream_t stream) {
  const int groups = C / V;
  const int bx = groups < kThreads ? groups : kThreads;
  const int by = kThreads / bx;
  const int gy = (groups + bx - 1) / bx;
  const int Ho = POOL ? H / 2 : H, Wo = POOL ? W / 2 : W;
  int dev = 0, wave = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = resident_blocks(bn_relu_kernel<T, POOL, V>, dev, bx * by, &wave);
  if (err != cudaSuccess) return err;
  wave /= gy;
  const long long in_img = static_cast<long long>(H) * W * C;
  const long long out_img = static_cast<long long>(Ho) * Wo * C;
  const int step = static_cast<int>(INT_MAX / in_img);
  const auto* xt = static_cast<const T*>(x);
  const auto* cb = static_cast<const T*>(conv_bias);
  auto* ot = static_cast<T*>(out);
  for (int n0 = 0; n0 < n; n0 += step) {
    const int nn = n - n0 < step ? n - n0 : step;
    const int pixels = nn * Ho * Wo;
    const int blocks = (pixels + by - 1) / by;
    const int gx = blocks < wave ? blocks : (wave > 0 ? wave : 1);
    bn_relu_kernel<T, POOL, V><<<dim3(gx, gy), dim3(bx, by), 0, stream>>>(
        xt + n0 * in_img, cb, mean, inv, scale, shift, ot + n0 * out_img,
        pixels, H, W, Ho, Wo, C);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return 0;
}

template <typename T, bool POOL>
int launch_aligned(const void* x, const void* conv_bias, const float* mean,
                   const float* inv, const float* scale, const float* shift,
                   void* out, int n, int H, int W, int C,
                   cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = C % V == 0 && reinterpret_cast<size_t>(x) % 16 == 0 &&
                   reinterpret_cast<size_t>(out) % 16 == 0;
  return vec ? launch<T, POOL, V>(x, conv_bias, mean, inv, scale, shift, out,
                                  n, H, W, C, stream)
             : launch<T, POOL, 1>(x, conv_bias, mean, inv, scale, shift, out,
                                  n, H, W, C, stream);
}

}  // namespace

extern "C" {

// x [n, H, W, C] (channels-last), conv_bias [C] in x's type (bf16 != 0:
// bfloat16, else float32); mean, inv, scale, shift [C] float32 -> out
// [n, H, W, C], or with `pool` [n, H / 2, W / 2, C], on `stream`.
// Returns the launch's cudaError_t, or kErrShape (nothing launched) when
// one image holds 2^31 elements or more.
int mmmot_bn_relu(const void* x, const void* conv_bias, const void* mean,
                  const void* inv, const void* scale, const void* shift,
                  void* out, int n, int H, int W, int C, int pool, int bf16,
                  void* stream) {
  if (static_cast<long long>(H) * W * C >= INT_MAX) return kErrShape;
  const int Ho = pool ? H / 2 : H, Wo = pool ? W / 2 : W;
  if (static_cast<long long>(n) * Ho * Wo * C == 0) return 0;
  const auto* m = static_cast<const float*>(mean);
  const auto* iv = static_cast<const float*>(inv);
  const auto* sc = static_cast<const float*>(scale);
  const auto* sh = static_cast<const float*>(shift);
  auto s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return pool ? launch_aligned<__nv_bfloat16, true>(x, conv_bias, m, iv, sc,
                                                      sh, out, n, H, W, C, s)
                : launch_aligned<__nv_bfloat16, false>(x, conv_bias, m, iv,
                                                       sc, sh, out, n, H, W,
                                                       C, s);
  return pool ? launch_aligned<float, true>(x, conv_bias, m, iv, sc, sh, out,
                                            n, H, W, C, s)
              : launch_aligned<float, false>(x, conv_bias, m, iv, sc, sh, out,
                                             n, H, W, C, s);
}

}  // extern "C"
