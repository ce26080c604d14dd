// Fused multi-head attention for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces: mtn_tpu/ops/pallas_attention.py::_attn_kernel (launched by
// _pallas_fwd). Per (batch, head) it computes
//     softmax(where(mask, q.k^T * (1/sqrt(D)), -1e9)) . v
// with q.k^T and p.v accumulated in f32, the softmax in f32, p rounded to
// v's type before the p.v product and the output stored in q's type.
//
// Bound on an H100 SXM at the decode precompute's shapes (B=32, H=8,
// Lq=32, Lk=32..64, D=64, bf16): the bytes of q, k, v, out and the mask,
// about 3-4 MB, over 3.35 TB/s, i.e. about a microsecond, against
// ~0.13 GFLOP over 989 TFLOP/s. Both are far below a kernel launch, so the
// kernel is launch-bound; its design keeps to one launch per call and keeps
// every intermediate on chip.
//
// Design: one block per (query-row tile, head, batch). The block stages
// the head's K (rows padded so that lanes reading different keys hit
// different banks) and V in shared memory. One warp owns one query row:
// lane j computes the scores of keys j, j+32, ... into a shared score row,
// the warp reduces max and sum with shuffles, normalises, rounds p to V's
// type, then lane d accumulates output columns d, d+32, ... over all keys.
// The whole (Lq, Lk) score block stays on chip, as it did in VMEM on the
// TPU; there is no online softmax, so the numerics follow the plain
// version step by step. The mask is read through (b, q, k) strides, so a
// broadcast key-padding mask is never materialised; a fully masked row
// gets the uniform average of V, which is what the -1e9 fill gives.
//
// Shared memory per block: Lk*(D+pad) + Lk*D elements of K and V, plus
// rows*(D + Lk) floats. attention_kernel.py::smem_bytes mirrors this
// formula for the dispatch gate.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr float kMaskFill = -1e9f;
constexpr int kMaxRows = 8;             // warps (query rows) per block
constexpr size_t kMaxSmem = 232448;     // H100: 227 KB per block, opt-in

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
  return __float2bfloat16(x);  // round to nearest even, as XLA's convert
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__host__ __device__ __forceinline__ size_t align16(size_t n) {
  return (n + 15) & ~static_cast<size_t>(15);
}

// Row stride of staged K, in elements: an odd number of 32-bit words per
// row for power-of-two D, so the 32 lanes of a warp (32 keys) read 32
// different banks.
template <typename T> __host__ __device__ __forceinline__ int k_stride(int D) {
  return sizeof(T) == 4 ? D + 1 : D + 2;
}

template <typename T>
__host__ __device__ __forceinline__ void smem_layout(int rows, int Lk, int D,
                                                     size_t* off_v,
                                                     size_t* off_q,
                                                     size_t* off_s,
                                                     size_t* total) {
  *off_v = align16(static_cast<size_t>(Lk) * k_stride<T>(D) * sizeof(T));
  *off_q = *off_v + align16(static_cast<size_t>(Lk) * D * sizeof(T));
  *off_s = *off_q + align16(static_cast<size_t>(rows) * D * sizeof(float));
  *total = *off_s + static_cast<size_t>(rows) * Lk * sizeof(float);
}

template <typename T>
__global__ void attention_kernel(const T* __restrict__ q,
                                 const T* __restrict__ k,
                                 const T* __restrict__ v,
                                 const uint8_t* __restrict__ mask,
                                 T* __restrict__ out, int H, int Lq, int Lk,
                                 int D, long long m_sb, long long m_sq,
                                 long long m_sk, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rows = blockDim.x >> 5;
  size_t off_v, off_q, off_s, total;
  smem_layout<T>(rows, Lk, D, &off_v, &off_q, &off_s, &total);
  const int ks_ld = k_stride<T>(D);
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = reinterpret_cast<T*>(smem + off_v);
  float* qs = reinterpret_cast<float*>(smem + off_q);
  float* ss = reinterpret_cast<float*>(smem + off_s);

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const size_t head = static_cast<size_t>(b) * H + h;
  const T* kh = k + head * Lk * D;
  const T* vh = v + head * Lk * D;
  const T* qh = q + head * Lq * D;

  for (int idx = threadIdx.x; idx < Lk * D; idx += blockDim.x) {
    const int j = idx / D;
    const int d = idx - j * D;
    ks[j * ks_ld + d] = kh[idx];
    vs[idx] = vh[idx];
  }
  const int i = blockIdx.x * rows + warp;
  float* qrow = qs + warp * D;
  float* srow = ss + static_cast<size_t>(warp) * Lk;
  if (i < Lq) {
    for (int d = lane; d < D; d += 32) qrow[d] = to_f32(qh[(size_t)i * D + d]);
  }
  __syncthreads();
  if (i >= Lq) return;  // no block-wide barrier follows

  const uint8_t* mrow = mask ? mask + b * m_sb + i * m_sq : nullptr;
  float mx = -3.402823466e38f;
  for (int j = lane; j < Lk; j += 32) {
    const T* kr = ks + j * ks_ld;
    float acc = 0.f;
    for (int d = 0; d < D; ++d) acc = fmaf(qrow[d], to_f32(kr[d]), acc);
    float s = acc * scale;
    if (mrow && mrow[j * m_sk] == 0) s = kMaskFill;
    srow[j] = s;
    mx = fmaxf(mx, s);
  }
  mx = warp_max(mx);
  float sum = 0.f;
  for (int j = lane; j < Lk; j += 32) {
    const float e = expf(srow[j] - mx);
    srow[j] = e;
    sum += e;
  }
  sum = warp_sum(sum);
  for (int j = lane; j < Lk; j += 32)
    srow[j] = to_f32(from_f32<T>(srow[j] / sum));
  __syncwarp();

  T* orow = out + (head * Lq + i) * D;
  for (int d = lane; d < D; d += 32) {
    float acc = 0.f;
    for (int j = 0; j < Lk; ++j) acc = fmaf(srow[j], to_f32(vs[j * D + d]), acc);
    orow[d] = from_f32<T>(acc);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* mask,
           void* out, int B, int H, int Lq, int Lk, int D, long long m_sb,
           long long m_sq, long long m_sk, cudaStream_t stream) {
  const int rows = Lq < kMaxRows ? Lq : kMaxRows;
  size_t off_v, off_q, off_s, smem;
  smem_layout<T>(rows, Lk, D, &off_v, &off_q, &off_s, &smem);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((Lq + rows - 1) / rows, H, B);
  const dim3 block(32 * rows);
  // 1/sqrt(D) rounded once from double, as the Python scalar of the
  // TPU kernel and of the plain version is
  const float scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(D)));
  attention_kernel<T><<<grid, block, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const uint8_t*>(mask),
      static_cast<T*>(out), H, Lq, Lk, D, m_sb, m_sq, m_sk, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, out: (B, H, Lq, D); k, v: (B, H, Lk, D), all contiguous, f32 or bf16.
// mask: bool bytes addressed as mask[b*m_sb + i*m_sq + j*m_sk], or null.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int mtn_attention(const void* q, const void* k, const void* v,
                             const void* mask, void* out, int B, int H,
                             int Lq, int Lk, int D, long long m_sb,
                             long long m_sq, long long m_sk, int is_bf16,
                             void* stream) {
  if (B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0 || D <= 0 || B > 65535 ||
      H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(q, k, v, mask, out, B, H, Lq, Lk, D, m_sb,
                                 m_sq, m_sk, s);
  return launch<float>(q, k, v, mask, out, B, H, Lq, Lk, D, m_sb, m_sq, m_sk,
                       s);
}
