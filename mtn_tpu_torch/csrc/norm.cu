// Residual add and LayerNorm of one sublayer boundary for Hopper (sm_90a),
// bound to Python with ctypes:
//     x_new  = x + (delta + bias)
//     normed = scale * (x_new - mean) / (std + eps) + nbias
// with the unbiased std of each row (RefLayerNorm of
// mtn_tpu_torch/models/layers.py, mtn_tpu/models/layers.py).
//
// Replaces no TPU kernel: the JAX package leaves the pre-norm residual
// chain to XLA, which fuses it. On the card the same chain is a dozen and
// more small PyTorch kernels a boundary (a cast, the mean, the centring,
// the square, the sum, the division, the sqrt, the eps add, the scale, the
// bias, a cast back, and the sublayer's bias and residual adds before it),
// each a launch and a trip through device memory; a decode step has 43 such
// boundaries in the av configuration. This is one launch a boundary.
//
// Rounding follows the plain chain, so x_new is bitwise the plain chain's
// and normed differs from it only by the rounding of the row's two sums:
// delta + bias and x + that are each computed in f32 and rounded to the
// activation type (as PyTorch's bf16 adds are); the normalisation runs in
// f32 in RefLayerNorm's order of operations, every operation rounded on
// its own (the __f*_rn intrinsics, which nvcc does not contract into FMAs);
// the row's sum and its sum of squared deviations (of the f32 deviations
// x - mean, as the plain chain squares them) are taken in f64 and the mean
// and the variance rounded once to f32, where the plain chain's f32 sums
// round at every step in an order of their own; normed is rounded to the
// activation type last.
//
// Bound: a call reads x and delta and writes x_new and normed, 8·R·D bytes
// in bf16 (0.66 MB at the beam step's R = 160, D = 512), ~0.2 us at
// 3.35 TB/s; the parameters (a few KB) come from L2. At these sizes the
// kernel is bound by latency: one launch, one round trip to device memory
// and two warp reductions (in f64: a few dozen double adds a lane).
//
// Design. One warp per row, the whole row in registers: each lane loads
// 16-byte vectors (8 bf16 or 4 f32) at stride 32 vectors, K vectors at
// most (K a power of two, unused slots predicated off for rows that are not
// a multiple of 32 vectors), so a row is read from device memory once; the
// mean and then the sum of squared deviations are warp-shuffle reductions
// over the registers, each lane's part summed in f64 first. Four rows
// (warps) a block; a row's arithmetic does not depend on the number of
// rows, so a row's result is the same in a batch of 1 or of 1,024. D up to
// 4096 (K = 16 in bf16, 32 in f32: 128 floats a lane).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int WARPS = 4;  // rows a block

// E elements of a 16-byte vector of T, widened to f32
__device__ __forceinline__ void load(const float* p, float* v) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}

__device__ __forceinline__ void load(const bf16* p, float* v) {
  const uint4 t = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&w[i]);
    v[2 * i] = __low2float(h);
    v[2 * i + 1] = __high2float(h);
  }
}

// E f32 values rounded to T, stored as one 16-byte vector
__device__ __forceinline__ void store(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store(bf16* p, const float* v) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

// the parameters: f32, or of the activation type
template <typename P, int E>
__device__ __forceinline__ void load_params(const P* p, float* v) {
  if constexpr (E == 8 && sizeof(P) == 4) {
    load(p, v);
    load(p + 4, v + 4);
  } else {
    load(p, v);
  }
}

// f to T and back: the value an activation of type T holds
template <typename T>
__device__ __forceinline__ float round_to(float f) {
  if constexpr (sizeof(T) == 2) {
    return __bfloat162float(__float2bfloat16_rn(f));
  } else {
    return f;
  }
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(~0u, v, o);
  return v;
}

template <typename T, typename P, int K>
__global__ void __launch_bounds__(WARPS * 32)
add_norm_kernel(const T* __restrict__ x, const T* __restrict__ delta,
                const T* __restrict__ bias, const P* __restrict__ scale,
                const P* __restrict__ nbias, T* __restrict__ x_out,
                T* __restrict__ normed, int R, int D, float eps) {
  constexpr int E = 16 / sizeof(T);
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= R) return;  // a whole warp: no block-wide barrier follows
  const int vectors = D / E;
  const size_t base = static_cast<size_t>(row) * D;
  float v[K][E];
  double sum = 0.0;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int c = (k * 32 + lane) * E;
    if (k * 32 + lane < vectors) {
      load(x + base + c, v[k]);
      if (delta != nullptr) {
        float d[E];
        load(delta + base + c, d);
        if (bias != nullptr) {
          float b[E];
          load(bias + c, b);
#pragma unroll
          for (int e = 0; e < E; ++e) d[e] = round_to<T>(__fadd_rn(d[e], b[e]));
        }
#pragma unroll
        for (int e = 0; e < E; ++e) v[k][e] = round_to<T>(__fadd_rn(v[k][e], d[e]));
      }
      store(x_out + base + c, v[k]);
#pragma unroll
      for (int e = 0; e < E; ++e) sum += v[k][e];
    }
  }
  const float mean = __double2float_rn(warp_sum(sum) / D);
  double ss = 0.0;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (k * 32 + lane < vectors) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const double c = __fsub_rn(v[k][e], mean);
        ss += c * c;
      }
    }
  }
  const float var = __double2float_rn(warp_sum(ss) / (D - 1));
  const float den = __fadd_rn(__fsqrt_rn(var), eps);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int c = (k * 32 + lane) * E;
    if (k * 32 + lane < vectors) {
      float s[E], b[E], y[E];
      load_params<P, E>(scale + c, s);
      load_params<P, E>(nbias + c, b);
#pragma unroll
      for (int e = 0; e < E; ++e)
        y[e] = __fadd_rn(
            __fdiv_rn(__fmul_rn(s[e], __fsub_rn(v[k][e], mean)), den), b[e]);
      store(normed + base + c, y);
    }
  }
}

template <typename T, typename P, int K>
int launch_k(const void* x, const void* delta, const void* bias,
             const void* scale, const void* nbias, void* x_out, void* normed,
             int R, int D, float eps, cudaStream_t stream) {
  const int blocks = (R + WARPS - 1) / WARPS;
  add_norm_kernel<T, P, K><<<blocks, WARPS * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(delta),
      static_cast<const T*>(bias), static_cast<const P*>(scale),
      static_cast<const P*>(nbias), static_cast<T*>(x_out),
      static_cast<T*>(normed), R, D, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename P>
int launch(int K, const void* x, const void* delta, const void* bias,
           const void* scale, const void* nbias, void* x_out, void* normed,
           int R, int D, float eps, cudaStream_t s) {
#define MTN_NORM_K(k)                                                       \
  case k:                                                                   \
    return launch_k<T, P, k>(x, delta, bias, scale, nbias, x_out, normed, R, \
                             D, eps, s);
  switch (K) {
    MTN_NORM_K(1)
    MTN_NORM_K(2)
    MTN_NORM_K(4)
    MTN_NORM_K(8)
    MTN_NORM_K(16)
    default:
      break;
  }
#undef MTN_NORM_K
  // f32 rows of 2048 to 4096: 32 vectors a lane (bf16 needs at most 16)
  if constexpr (sizeof(T) == 4) {
    if (K == 32)
      return launch_k<T, P, 32>(x, delta, bias, scale, nbias, x_out, normed,
                                R, D, eps, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x, delta, x_out, normed (R, D) and bias (D) contiguous, of the activation
// type (bf16 or f32); scale and nbias (D) f32 (param_f32) or of that type;
// delta and bias may be null (no delta: x_out is a copy of x); pointers
// 16-byte aligned. Needs D a multiple of 128, at most 4096. One launch;
// returns its cudaError_t (0 on success).
extern "C" int mtn_add_norm(const void* x, const void* delta, const void* bias,
                            const void* scale, const void* nbias, void* x_out,
                            void* normed, int R, int D, int is_bf16,
                            int param_f32, float eps, void* stream) {
  if (R <= 0 || D <= 0 || D % 128 != 0 || D > 4096 ||
      (delta == nullptr && bias != nullptr) || (!is_bf16 && !param_f32))
    return static_cast<int>(cudaErrorInvalidValue);
  const int E = is_bf16 ? 8 : 4;
  int K = 1;
  while (K * 32 * E < D) K *= 2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16 && param_f32)
    return launch<bf16, float>(K, x, delta, bias, scale, nbias, x_out, normed,
                               R, D, eps, s);
  if (is_bf16)
    return launch<bf16, bf16>(K, x, delta, bias, scale, nbias, x_out, normed,
                              R, D, eps, s);
  return launch<float, float>(K, x, delta, bias, scale, nbias, x_out, normed,
                              R, D, eps, s);
}
