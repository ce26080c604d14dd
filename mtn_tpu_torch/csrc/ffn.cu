// Fused position-wise FFN for Hopper (sm_90a), bound to Python with ctypes:
//     y = relu(x . W1 + b1) . W2 + b2
//
// Replaces: mtn_tpu/ops/pallas_ffn.py::_ffn_kernel (launched by
// _pallas_ffn_2d). As there, h = relu(x.W1 + b1) is computed in f32 and
// rounded to W2's type, y = h.W2 + b2 is accumulated in f32 and stored in
// x's type, and the (rows, F) hidden activation never reaches device
// memory. W1 is (D, F) and W2 is (F, D), row-major, the JAX layout.
//
// Bound on an H100 SXM at the beam decode step's shape (160 rows = 32
// turns x beam 5, D=512, F=2048, bf16): reading W1 and W2 (4 MiB) once
// takes ~1.25 us at 3.35 TB/s, against 0.67 GFLOP / 989 TFLOP/s ~ 0.7 us,
// so it is bound by the weight bytes.
//
// Design: the TPU kernel kept both weight matrices resident in VMEM for
// one grid step. Copied to the GPU, that would give a handful of blocks
// that each read all 4 MiB while most of the 132 SMs idle. Here F is split
// across blocks instead: block (s, r) owns the d_ff slice
// [s*TF, (s+1)*TF) and the row tile [r*TM, (r+1)*TM). It keeps its x tile
// in shared memory, computes h = relu(x.W1[:, slice] + b1) in f32, rounds
// it to W2's type into shared memory, and accumulates its partial
// h.W2[slice, :] in f32 into an f32 scratch buffer (split, rows, D). Each
// weight byte is read from device memory once per row tile, and the row
// tiles of one call meet it in L2. A second small pass sums the partials in
// split order, adds b2 and casts to x's type: the result is deterministic,
// with no atomics. bf16 products run on the tensor cores (WMMA, 16x16x16
// fragments, f32 accumulators); f32 runs on the CUDA cores so that f32
// keeps full f32 products (no TF32).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

constexpr int TM = 16;        // rows per block (one WMMA fragment row)
constexpr int TF = 128;       // d_ff columns per block
constexpr int THREADS = 256;  // 8 warps
constexpr int XPAD = 8;       // shared row padding, elements
constexpr int HPAD = 8;
constexpr int FPAD = 4;
constexpr size_t kMaxSmem = 232448;  // H100: 227 KB per block, opt-in

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__host__ __device__ __forceinline__ size_t align128(size_t n) {
  return (n + 127) & ~static_cast<size_t>(127);
}

// x tile (TM, D+XPAD) in T | h in f32 (TM, TF+FPAD) | h in T (TM, TF+HPAD)
__host__ __device__ __forceinline__ void smem_layout(int D, size_t elt,
                                                     size_t* off_hf,
                                                     size_t* off_hs,
                                                     size_t* total) {
  *off_hf = align128(static_cast<size_t>(TM) * (D + XPAD) * elt);
  *off_hs = *off_hf + align128(static_cast<size_t>(TM) * (TF + FPAD) * 4);
  *total = *off_hs + static_cast<size_t>(TM) * (TF + HPAD) * elt;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    ffn_partial_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                       const T* __restrict__ b1, const T* __restrict__ w2,
                       float* __restrict__ partial, int N, int D, int F,
                       int Np) {
  extern __shared__ __align__(128) unsigned char smem[];
  size_t off_hf, off_hs, total;
  smem_layout(D, sizeof(T), &off_hf, &off_hs, &total);
  const int ldx = D + XPAD;
  const int ldf = TF + FPAD;
  const int ldh = TF + HPAD;
  T* xs = reinterpret_cast<T*>(smem);
  float* hf = reinterpret_cast<float*>(smem + off_hf);
  T* hs = reinterpret_cast<T*>(smem + off_hs);

  const int split = blockIdx.x;
  const int f0 = split * TF;
  const int r0 = blockIdx.y * TM;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;

  for (int idx = tid; idx < TM * D; idx += THREADS) {
    const int r = idx / D;
    const int d = idx - r * D;
    xs[r * ldx + d] =
        (r0 + r < N) ? x[static_cast<size_t>(r0 + r) * D + d] : from_f32<T>(0.f);
  }
  __syncthreads();

  float* part = partial + (static_cast<size_t>(split) * Np + r0) * D;
  if constexpr (sizeof(T) == 2) {
    using namespace nvcuda;
    // h slice: warp w owns columns [16w, 16w+16) of the TF = 128 slice
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
    for (int kk = 0; kk < D; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> bm;
      wmma::load_matrix_sync(a, xs + kk, ldx);
      wmma::load_matrix_sync(bm, w1 + static_cast<size_t>(kk) * F + f0 + warp * 16,
                             F);
      wmma::mma_sync(acc, a, bm, acc);
    }
    wmma::store_matrix_sync(hf + warp * 16, acc, ldf, wmma::mem_row_major);
    __syncthreads();
    for (int idx = tid; idx < TM * TF; idx += THREADS) {
      const int r = idx / TF;
      const int c = idx - r * TF;
      const float hv = hf[r * ldf + c] + to_f32(b1[f0 + c]);
      hs[r * ldh + c] = from_f32<T>(fmaxf(hv, 0.f));
    }
    __syncthreads();
    // partial y tile (TM, D): warp w owns column fragments w, w+8, ...
    for (int n = warp; n < D / 16; n += THREADS / 32) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> y;
      wmma::fill_fragment(y, 0.f);
      for (int kk = 0; kk < TF; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> bm;
        wmma::load_matrix_sync(a, hs + kk, ldh);
        wmma::load_matrix_sync(
            bm, w2 + static_cast<size_t>(f0 + kk) * D + n * 16, D);
        wmma::mma_sync(y, a, bm, y);
      }
      wmma::store_matrix_sync(part + n * 16, y, D, wmma::mem_row_major);
    }
  } else {
    // f32 on the CUDA cores. Phase 1: thread owns column c of the slice
    // and TM/2 rows; W1 reads are coalesced across the warp.
    const int c = tid % TF;
    const int rg = (tid / TF) * (TM / 2);
    float acc[TM / 2];
#pragma unroll
    for (int r = 0; r < TM / 2; ++r) acc[r] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float w = to_f32(w1[static_cast<size_t>(d) * F + f0 + c]);
#pragma unroll
      for (int r = 0; r < TM / 2; ++r)
        acc[r] = fmaf(to_f32(xs[(rg + r) * ldx + d]), w, acc[r]);
    }
    const float bias = to_f32(b1[f0 + c]);
#pragma unroll
    for (int r = 0; r < TM / 2; ++r)
      hs[(rg + r) * ldh + c] = from_f32<T>(fmaxf(acc[r] + bias, 0.f));
    __syncthreads();
    // Phase 2: thread owns output column d for all TM rows.
    for (int d = tid; d < D; d += THREADS) {
      float y[TM];
#pragma unroll
      for (int r = 0; r < TM; ++r) y[r] = 0.f;
      for (int kk = 0; kk < TF; ++kk) {
        const float w = to_f32(w2[static_cast<size_t>(f0 + kk) * D + d]);
#pragma unroll
        for (int r = 0; r < TM; ++r)
          y[r] = fmaf(to_f32(hs[r * ldh + kk]), w, y[r]);
      }
#pragma unroll
      for (int r = 0; r < TM; ++r) part[static_cast<size_t>(r) * D + d] = y[r];
    }
  }
}

template <typename T>
__global__ void ffn_reduce_kernel(const float* __restrict__ partial,
                                  const T* __restrict__ b2,
                                  T* __restrict__ out, int N, int D, int Np,
                                  int nsplit) {
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<size_t>(N) * D) return;
  const size_t n = idx / D;
  const size_t d = idx - n * D;
  float s = 0.f;
  for (int sp = 0; sp < nsplit; ++sp)
    s += partial[(static_cast<size_t>(sp) * Np + n) * D + d];
  out[idx] = from_f32<T>(s + to_f32(b2[d]));
}

template <typename T>
int launch(const void* x, const void* w1, const void* b1, const void* w2,
           const void* b2, void* partial, void* out, int N, int D, int F,
           cudaStream_t stream) {
  size_t off_hf, off_hs, smem;
  smem_layout(D, sizeof(T), &off_hf, &off_hs, &smem);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        ffn_partial_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int Np = (N + TM - 1) / TM * TM;
  const int nsplit = F / TF;
  ffn_partial_kernel<T><<<dim3(nsplit, Np / TM), THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1),
      static_cast<const T*>(b1), static_cast<const T*>(w2),
      static_cast<float*>(partial), N, D, F, Np);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t total = static_cast<size_t>(N) * D;
  const unsigned blocks = static_cast<unsigned>((total + 255) / 256);
  ffn_reduce_kernel<T><<<blocks, 256, 0, stream>>>(
      static_cast<const float*>(partial), static_cast<const T*>(b2),
      static_cast<T*>(out), N, D, Np, nsplit);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (N, D), w1 (D, F), b1 (F), w2 (F, D), b2 (D), out (N, D): contiguous,
// one type (f32 or bf16), pointers 32-byte aligned. partial: f32 scratch of
// (F/128, ceil(N/16)*16, D). Needs D % 16 == 0 and F % 128 == 0.
// Returns the cudaError_t of the launches (0 on success).
extern "C" int mtn_ffn(const void* x, const void* w1, const void* b1,
                       const void* w2, const void* b2, void* partial,
                       void* out, int N, int D, int F, int is_bf16,
                       void* stream) {
  if (N <= 0 || D <= 0 || F <= 0 || D % 16 != 0 || F % TF != 0 ||
      (N + TM - 1) / TM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(x, w1, b1, w2, b2, partial, out, N, D, F, s);
  return launch<float>(x, w1, b1, w2, b2, partial, out, N, D, F, s);
}
