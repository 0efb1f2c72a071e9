// Fused association-cost kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel mmmot_tpu/kernels/affinity_kernel.py
// (pallas_affinity, body _kernel): for a batch of B frame pairs and K
// branches, with prev/curr embeddings a, b [B, K, N, D],
//
//   pair_k    = |a_i - b_j|                           (compute dtype)
//   h_k       = relu(BN_eval(pair_k @ W1_k + b1_k))   (dot in f32, cast,
//                                                      BN in f32, cast)
//   score_k   = h_k . w2_k + b2_k                     (f32)
//   link      = mask * sum_k score_k                  (cast)
//   link_norm = dual masked softmax(link)
//   new / end = v2 heads: max-pool link over rows / columns, then
//               relu([feat | pooled] @ Wn1 + bn1) @ wn2 + bn2, masked.
//
// Rounding points follow the TPU kernel: every value the TPU kernel holds
// in the compute dtype is rounded to it here (T = float or bfloat16);
// sums accumulate in f32.
//
// What bounds it on an H100: FLOPs = 2 B K N^2 (D H + H), 1.61 GFLOP per
// frame pair at the flagship (K=3, N=32, D=H=512), 25.8 GFLOP at B=16,
// against bytes of W1 (1.5 MB bf16) plus the embeddings (3.1 MB at B=16):
// compute-bound, about 26 us at B=16 on the 989 TFLOP/s bf16 tensor cores.
//
// Design (simple and correct first; the tensor-core version is later
// work).  Launch 1, grid (B, ceil(N*N/64)): a block owns 64 (i, j) pairs of
// one frame pair.  For each branch it builds the |a_i - b_j| tile in
// shared memory 32 features at a time and streams the matching 32 x 64
// tile of W1 from global memory (W1 is 512 KB per branch, more than a
// block's shared memory, and stays L2-resident across blocks), keeping the
// 64 x 64 hidden tile in registers (4 x 4 per thread, f32 FMA).  The
// epilogue applies bias, BN, ReLU and the w2 dot for that hidden tile and
// adds it into the pair's score, so the [N*N, H] hidden tensor never
// reaches device memory; only `link` is written.  Launch 2, grid (B): one
// block reads the N x N link matrix of a frame pair into shared memory and
// computes the dual softmax, the row/column max pools and both heads (one
// warp per detection, lanes over hidden units).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e9f;  // ops/masking.py NEG_INF (finite)
constexpr int kThreads = 256;
constexpr int kPairs = 64;        // pair rows per block (launch 1)
constexpr int kHid = 64;          // hidden columns per register tile
constexpr int kDepth = 32;        // features per shared-memory stage
constexpr int kMaxN = 64;         // launch 2 holds N x N in shared memory

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
link_kernel(const T* __restrict__ a, const T* __restrict__ b,
            const uint8_t* __restrict__ mp, const uint8_t* __restrict__ mc,
            const T* __restrict__ w1, const T* __restrict__ b1,
            const float* __restrict__ bn_mean,
            const float* __restrict__ bn_inv,
            const float* __restrict__ bn_scale,
            const float* __restrict__ bn_bias,
            const T* __restrict__ w2, const float* __restrict__ b2,
            T* __restrict__ link, int K, int N, int D, int H) {
  __shared__ __align__(16) float pair_s[kDepth][kPairs];
  __shared__ __align__(16) float w_s[kDepth][kHid];
  __shared__ float part_s[kPairs][kHid / 4 + 1];
  __shared__ float score_s[kPairs];
  __shared__ float total_s[kPairs];

  const int pb = blockIdx.x;
  const int p0 = blockIdx.y * kPairs;
  const int NN = N * N;
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // hidden columns tx*4 .. tx*4+3
  const int ty = tid / 16;  // pair rows ty*4 .. ty*4+3

  if (tid < kPairs) total_s[tid] = 0.f;
  for (int k = 0; k < K; ++k) {
    const T* ak = a + ((long)pb * K + k) * N * D;
    const T* bk = b + ((long)pb * K + k) * N * D;
    const T* w1k = w1 + (long)k * D * H;
    if (tid < kPairs) score_s[tid] = 0.f;
    for (int h0 = 0; h0 < H; h0 += kHid) {
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

      for (int d0 = 0; d0 < D; d0 += kDepth) {
        __syncthreads();  // the previous stage's tiles are consumed
        for (int e = tid; e < kPairs * kDepth; e += kThreads) {
          const int p = e % kPairs, dd = e / kPairs;
          const int gp = p0 + p, d = d0 + dd;
          float v = 0.f;
          if (gp < NN && d < D) {
            const int i = gp / N, j = gp % N;
            v = fabsf(rnd<T>(to_f(ak[i * D + d]) - to_f(bk[j * D + d])));
          }
          pair_s[dd][p] = v;
        }
        for (int e = tid; e < kDepth * kHid; e += kThreads) {
          const int hh = e % kHid, dd = e / kHid;
          const int h = h0 + hh, d = d0 + dd;
          w_s[dd][hh] = (h < H && d < D) ? to_f(w1k[(long)d * H + h]) : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int dd = 0; dd < kDepth; ++dd) {
          const float4 av = *reinterpret_cast<const float4*>(&pair_s[dd][ty * 4]);
          const float4 bv = *reinterpret_cast<const float4*>(&w_s[dd][tx * 4]);
          const float ar[4] = {av.x, av.y, av.z, av.w};
          const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(ar[r], br[c], acc[r][c]);
        }
      }

      // Epilogue for this hidden tile: bias (compute dtype), eval BN in
      // f32 (not folded), ReLU, and the partial h . w2 in f32.
      float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int h = h0 + tx * 4 + c;
        if (h >= H) continue;
        const long kh = (long)k * H + h;
        const float bias1 = to_f(b1[kh]);
        const float mean = bn_mean[kh], inv = bn_inv[kh];
        const float scale = bn_scale[kh], shift = bn_bias[kh];
        const float wout = to_f(w2[kh]);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float hd = rnd<T>(rnd<T>(acc[r][c]) + bias1);
          const float hn = rnd<T>((hd - mean) * inv * scale + shift);
          part[r] += fmaxf(hn, 0.f) * wout;
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) part_s[ty * 4 + r][tx] = part[r];
      __syncthreads();
      if (tid < kPairs) {
        float s = 0.f;
        for (int t = 0; t < kHid / 4; ++t) s += part_s[tid][t];
        score_s[tid] += s;
      }
    }
    if (tid < kPairs) total_s[tid] += score_s[tid] + b2[k];
  }
  if (tid < kPairs) {
    const int gp = p0 + tid;
    if (gp < NN) {
      const int i = gp / N, j = gp % N;
      const bool ok = mp[pb * N + i] && mc[pb * N + j];
      link[(long)pb * NN + gp] = from_f<T>(ok ? total_s[tid] : 0.f);
    }
  }
}

// One v2 head for detection n of frame pair pb, computed by one warp:
// relu(feat . W1 + pooled * wp + b1) . w2 + b2, masked.
template <typename T>
__device__ float head_one(const T* __restrict__ feat, float pooled,
                          const T* __restrict__ w1, const float* __restrict__ wp,
                          const float* __restrict__ hb1,
                          const T* __restrict__ hw2, float hb2, int D, int HH) {
  const int lane = threadIdx.x % 32;
  float part = 0.f;
  for (int h = lane; h < HH; h += 32) {
    float s = 0.f;
    for (int d = 0; d < D; ++d) s = fmaf(to_f(feat[d]), to_f(w1[(long)d * HH + h]), s);
    const float hf = s + pooled * wp[h] + hb1[h];
    part += fmaxf(rnd<T>(hf), 0.f) * to_f(hw2[h]);
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2) part += __shfl_xor_sync(0xffffffffu, part, off);
  return part + hb2;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
norm_heads_kernel(const T* __restrict__ link, const T* __restrict__ a,
                  const T* __restrict__ b, const uint8_t* __restrict__ mp,
                  const uint8_t* __restrict__ mc,
                  const T* __restrict__ wn1, const float* __restrict__ wnp,
                  const float* __restrict__ bn1, const T* __restrict__ wn2,
                  const float* __restrict__ bn2,
                  const T* __restrict__ we1, const float* __restrict__ wep,
                  const float* __restrict__ be1, const T* __restrict__ ew2,
                  const float* __restrict__ eb2,
                  T* __restrict__ norm, T* __restrict__ new_out,
                  T* __restrict__ end_out, int K, int N, int D, int HH) {
  __shared__ float link_s[kMaxN * kMaxN];
  __shared__ float row_s[kMaxN * kMaxN];
  __shared__ float rowbest_s[kMaxN], colbest_s[kMaxN];
  __shared__ float mp_s[kMaxN], mc_s[kMaxN];

  const int pb = blockIdx.x;
  const int tid = threadIdx.x;
  const int NN = N * N;
  const float neg = rnd<T>(kNegInf);
  const float tiny = rnd<T>(1e-30f);
  for (int e = tid; e < NN; e += blockDim.x) link_s[e] = to_f(link[(long)pb * NN + e]);
  for (int n = tid; n < N; n += blockDim.x) {
    mp_s[n] = mp[pb * N + n] ? 1.f : 0.f;
    mc_s[n] = mc[pb * N + n] ? 1.f : 0.f;
  }
  __syncthreads();

  // Row softmax and row max-pool (thread per prev row i).
  for (int i = tid; i < N; i += blockDim.x) {
    float mx = -INFINITY, best = -INFINITY;
    for (int j = 0; j < N; ++j) {
      const bool ok = mp_s[i] * mc_s[j] > 0.f;
      const float lg = ok ? link_s[i * N + j] : neg;
      mx = fmaxf(mx, lg);
      if (ok) best = fmaxf(best, lg);
    }
    rowbest_s[i] = best == -INFINITY ? 0.f : best;
    float den = 0.f;
    for (int j = 0; j < N; ++j) {
      const float pm = mp_s[i] * mc_s[j];
      const float lg = pm > 0.f ? link_s[i * N + j] : neg;
      den += rnd<T>(expf(rnd<T>(lg - mx))) * pm;
    }
    den = fmaxf(rnd<T>(den), tiny);
    for (int j = 0; j < N; ++j) {
      const float pm = mp_s[i] * mc_s[j];
      const float lg = pm > 0.f ? link_s[i * N + j] : neg;
      row_s[i * N + j] = rnd<T>(rnd<T>(expf(rnd<T>(lg - mx))) * pm / den);
    }
  }
  __syncthreads();  // rows read; column threads overwrite link_s below
  // Column softmax and column max-pool (thread per curr column j).
  for (int j = tid; j < N; j += blockDim.x) {
    float mx = -INFINITY, best = -INFINITY;
    for (int i = 0; i < N; ++i) {
      const bool ok = mp_s[i] * mc_s[j] > 0.f;
      const float lg = ok ? link_s[i * N + j] : neg;
      mx = fmaxf(mx, lg);
      if (ok) best = fmaxf(best, lg);
    }
    colbest_s[j] = best == -INFINITY ? 0.f : best;
    float den = 0.f;
    for (int i = 0; i < N; ++i) {
      const float pm = mp_s[i] * mc_s[j];
      const float lg = pm > 0.f ? link_s[i * N + j] : neg;
      den += rnd<T>(expf(rnd<T>(lg - mx))) * pm;
    }
    den = fmaxf(rnd<T>(den), tiny);
    for (int i = 0; i < N; ++i) {
      const float pm = mp_s[i] * mc_s[j];
      const float lg = pm > 0.f ? link_s[i * N + j] : neg;
      const float col = rnd<T>(rnd<T>(expf(rnd<T>(lg - mx))) * pm / den);
      link_s[i * N + j] = col;  // this column is no longer read as link
    }
  }
  __syncthreads();
  for (int e = tid; e < NN; e += blockDim.x)
    norm[(long)pb * NN + e] = from_f<T>(rnd<T>(0.5f * rnd<T>(row_s[e] + link_s[e])));

  // v2 heads: one warp per detection.  The embedding of branch 0 (fused)
  // feeds both heads.
  const int warp = tid / 32, n_warps = blockDim.x / 32;
  const T* a0 = a + (long)pb * K * N * D;
  const T* b0 = b + (long)pb * K * N * D;
  for (int n = warp; n < N; n += n_warps) {
    const float nv = head_one<T>(b0 + (long)n * D, colbest_s[n], wn1, wnp,
                                 bn1, wn2, bn2[0], D, HH);
    const float ev = head_one<T>(a0 + (long)n * D, rowbest_s[n], we1, wep,
                                 be1, ew2, eb2[0], D, HH);
    if (tid % 32 == 0) {
      new_out[(long)pb * N + n] = from_f<T>(nv * mc_s[n]);
      end_out[(long)pb * N + n] = from_f<T>(ev * mp_s[n]);
    }
  }
}

template <typename T>
int launch(const void* a, const void* b, const void* mp, const void* mc,
           const void* w1, const void* b1, const void* bn_mean,
           const void* bn_inv, const void* bn_scale, const void* bn_bias,
           const void* w2, const void* b2, const void* wn1, const void* wnp,
           const void* bn1, const void* wn2, const void* bn2, const void* we1,
           const void* wep, const void* be1, const void* ew2, const void* eb2,
           void* link, void* norm, void* new_out, void* end_out, int B, int K,
           int N, int D, int H, int HH, cudaStream_t stream) {
  const dim3 grid1(B, (N * N + kPairs - 1) / kPairs);
  link_kernel<T><<<grid1, kThreads, 0, stream>>>(
      (const T*)a, (const T*)b, (const uint8_t*)mp, (const uint8_t*)mc,
      (const T*)w1, (const T*)b1, (const float*)bn_mean, (const float*)bn_inv,
      (const float*)bn_scale, (const float*)bn_bias, (const T*)w2,
      (const float*)b2, (T*)link, K, N, D, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  norm_heads_kernel<T><<<B, kThreads, 0, stream>>>(
      (const T*)link, (const T*)a, (const T*)b, (const uint8_t*)mp,
      (const uint8_t*)mc, (const T*)wn1, (const float*)wnp, (const float*)bn1,
      (const T*)wn2, (const float*)bn2, (const T*)we1, (const float*)wep,
      (const float*)be1, (const T*)ew2, (const float*)eb2, (T*)norm,
      (T*)new_out, (T*)end_out, K, N, D, HH);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest N the launcher takes (launch 2 keeps an N x N tile on chip).
int mmmot_affinity_max_n(void) { return kMaxN; }

// Launch both kernels on `stream`.  Pointers are device pointers of
// contiguous tensors; `is_bf16` selects bfloat16 (else float32) for a, b,
// w1, b1, w2, wn1, wn2, we1, ew2 and the four outputs; masks are uint8
// (bool) and every other parameter is float32.  Returns the CUDA error of
// the launches (0 on success); nothing synchronises.
int mmmot_affinity(const void* a, const void* b, const void* mp,
                   const void* mc, const void* w1, const void* b1,
                   const void* bn_mean, const void* bn_inv,
                   const void* bn_scale, const void* bn_bias, const void* w2,
                   const void* b2, const void* wn1, const void* wnp,
                   const void* bn1, const void* wn2, const void* bn2,
                   const void* we1, const void* wep, const void* be1,
                   const void* ew2, const void* eb2, void* link, void* norm,
                   void* new_out, void* end_out, int B, int K, int N, int D,
                   int H, int HH, int is_bf16, void* stream) {
  if (B <= 0 || K <= 0 || N <= 0 || N > kMaxN || D <= 0 || H <= 0 || HH <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return launch<__nv_bfloat16>(a, b, mp, mc, w1, b1, bn_mean, bn_inv,
                                 bn_scale, bn_bias, w2, b2, wn1, wnp, bn1,
                                 wn2, bn2, we1, wep, be1, ew2, eb2, link, norm,
                                 new_out, end_out, B, K, N, D, H, HH, s);
  return launch<float>(a, b, mp, mc, w1, b1, bn_mean, bn_inv, bn_scale,
                       bn_bias, w2, b2, wn1, wnp, bn1, wn2, bn2, we1, wep, be1,
                       ew2, eb2, link, norm, new_out, end_out, B, K, N, D, H,
                       HH, s);
}

}  // extern "C"
