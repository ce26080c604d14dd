// Fused multi-head attention for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces: mtn_tpu/ops/pallas_attention.py::_attn_kernel (launched by
// _pallas_fwd). Per (batch, head) it computes
//     softmax(where(mask, q.k^T * (1/sqrt(D)), -1e9)) . v
// with q.k^T and p.v accumulated in f32, the softmax in f32, p normalised
// and then rounded to v's type before the p.v product, and the output
// stored in q's type. The mask is read through (b, q, k) strides, so a
// broadcast key-padding mask is never materialised; a fully masked row gets
// the uniform average of V, which is what the -1e9 fill gives.
//
// Bound on an H100 SXM at the decode precompute's shapes (B=32, H=8,
// Lq=32, Lk=32..64, D=64, bf16): the bytes of q, k, v, out and the mask,
// 3-6 MB, over 3.35 TB/s, 1-2 us, against ~0.13 GFLOP over 989 TFLOP/s,
// so it is bound by bytes.
//
// bf16 (the decode path): tensor cores, K/V streamed in key chunks.
// - One block per (query group, head, batch); each warp owns a 16-row
//   query tile and a block holds up to 4 of them, so a head's K and V are
//   read once per 64 query rows (at Lq = 32: one block of 2 warps per
//   head). Q, K and V rows are zero-padded to Dp = D rounded up to 16
//   (exact for the products) and padded by 16 bytes more in shared memory,
//   an odd number of 16-byte units, so the eight row addresses of an
//   ldmatrix phase fall in distinct banks. Rows are staged by cp.async of
//   16 bytes where D % 8 == 0 and the pointers are 16-byte aligned (every
//   MTN configuration: D = 512 / 8), element by element otherwise.
// - Q.K^T and P.V run as mma.sync.m16n8k16 (bf16 in, f32 accumulate).
//   Q is the A operand (ldmatrix), K as stored is the B operand of Q.K^T
//   (ldmatrix), V goes through ldmatrix.trans.
// - The scores of a warp's 64 keys stay in registers (16 x 64). The row
//   max and sum run over a lane's fragment values, then across the quad
//   (shuffle xor 1, 2). e = exp(s - m) by ex2.approx (__expf, a few ulp of
//   f32) and p = e * (1 / l), within an ulp of e / l: normalised before it
//   is rounded to bf16, so p's bf16 rounding point is the plain version's.
//   (The accurate expf and a division per score were most of the kernel's
//   time.) p is repacked in registers as the A fragments of P.V: the
//   m16n8 C layout of two adjacent key tiles is the m16k16 A layout.
// - Lk <= 64: one pass, the scores in registers; V is a cp.async group of
//   its own, waited for only before P.V. Above that, K and V stream in
//   stages through a double-buffered ring, so shared memory does not
//   depend on Lk, in two passes: pass 1 over the K stages for the row max
//   m and sum l (l rescaled when m grows); pass 2 recomputes the scores
//   and accumulates p.V with the final m and l, so p is still normalised
//   before rounding. No unnormalised (flash-style) accumulator: it would
//   move the point where p is rounded away from the plain version's. Each
//   warp walks all of its head's key chunks in series, so long keys at
//   small Lq leave most SMs idle (a split across blocks is the next step).
// - Output columns run in slices of NT*8 (64 or 128): an f32 accumulator
//   of 16 x 256 would not fit in registers beside the scores. With one
//   pass, P stays in registers across the slices; with two passes, pass 2
//   runs once per slice.
// - Keys past Lk get -inf (never -1e9: they would join the uniform average
//   of a fully masked row) and their K/V rows are zero-filled, so no stale
//   shared memory meets a zero probability. Query rows past Lq are
//   computed and not stored. No atomics: two calls on the same inputs give
//   the same bits.
// - At the decode path's shapes every block is resident at once, and the
//   time is one block's chain (launch, the Q/K copy's latency, the
//   products, the softmax, P.V), not bytes or tensor-core rate: a few
//   times the bound above.
//
// f32 (the card-vs-CPU reference check only): CUDA cores. One block per
// (8-row tile, head, batch) stages the head's K (rows padded so that lanes
// reading different keys hit different banks) and V; one warp owns one
// query row: lane j computes the scores of keys j, j+32, ... into a shared
// score row, the warp reduces max and sum with shuffles and normalises,
// then lane d accumulates output columns d, d+32, ... over all keys.
//
// attention_kernel.py::smem_bytes mirrors both shared-memory layouts.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace {

using bf16 = __nv_bfloat16;

constexpr float kMaskFill = -1e9f;
constexpr size_t kMaxSmem = 232448;  // H100: 227 KB per block, opt-in

// -- f32: CUDA cores ----------------------------------------------------------
constexpr int kMaxRows = 8;  // f32: warps (query rows) per block

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

// K rows of D + 1 floats: 32 lanes reading 32 keys hit 32 banks.
__host__ __device__ __forceinline__ void f32_layout(int rows, int Lk, int D,
                                                    size_t* off_v,
                                                    size_t* off_q,
                                                    size_t* off_s,
                                                    size_t* total) {
  *off_v = align16(static_cast<size_t>(Lk) * (D + 1) * sizeof(float));
  *off_q = *off_v + align16(static_cast<size_t>(Lk) * D * sizeof(float));
  *off_s = *off_q + align16(static_cast<size_t>(rows) * D * sizeof(float));
  *total = *off_s + static_cast<size_t>(rows) * Lk * sizeof(float);
}

__global__ void mtn_attention_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const uint8_t* __restrict__ mask,
    float* __restrict__ out, int H, int Lq, int Lk, int D, long long m_sb,
    long long m_sq, long long m_sk, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rows = blockDim.x >> 5;
  size_t off_v, off_q, off_s, total;
  f32_layout(rows, Lk, D, &off_v, &off_q, &off_s, &total);
  const int ks_ld = D + 1;
  float* ks = reinterpret_cast<float*>(smem);
  float* vs = reinterpret_cast<float*>(smem + off_v);
  float* qs = reinterpret_cast<float*>(smem + off_q);
  float* ss = reinterpret_cast<float*>(smem + off_s);

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const size_t head = static_cast<size_t>(b) * H + h;
  const float* kh = k + head * Lk * D;
  const float* vh = v + head * Lk * D;
  const float* qh = q + head * Lq * D;

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
    for (int d = lane; d < D; d += 32) qrow[d] = qh[(size_t)i * D + d];
  }
  __syncthreads();
  if (i >= Lq) return;  // no block-wide barrier follows

  const uint8_t* mrow = mask ? mask + b * m_sb + i * m_sq : nullptr;
  float mx = -3.402823466e38f;
  for (int j = lane; j < Lk; j += 32) {
    const float* kr = ks + j * ks_ld;
    float acc = 0.f;
    for (int d = 0; d < D; ++d) acc = fmaf(qrow[d], kr[d], acc);
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
  for (int j = lane; j < Lk; j += 32) srow[j] = srow[j] / sum;
  __syncwarp();

  float* orow = out + (head * Lq + i) * D;
  for (int d = lane; d < D; d += 32) {
    float acc = 0.f;
    for (int j = 0; j < Lk; ++j) acc = fmaf(srow[j], vs[j * D + d], acc);
    orow[d] = acc;
  }
}

int launch_f32(const void* q, const void* k, const void* v, const void* mask,
               void* out, int B, int H, int Lq, int Lk, int D, long long m_sb,
               long long m_sq, long long m_sk, float scale,
               cudaStream_t stream) {
  const int rows = Lq < kMaxRows ? Lq : kMaxRows;
  size_t off_v, off_q, off_s, smem;
  f32_layout(rows, Lk, D, &off_v, &off_q, &off_s, &smem);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        mtn_attention_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((Lq + rows - 1) / rows, H, B);
  mtn_attention_f32_kernel<<<grid, 32 * rows, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const uint8_t*>(mask),
      static_cast<float*>(out), H, Lq, Lk, D, m_sb, m_sq, m_sk, scale);
  return static_cast<int>(cudaGetLastError());
}

// -- bf16: tensor cores, K/V streamed in key chunks ---------------------------
constexpr int KC = 64;        // keys per chunk (a ring stage)
constexpr int MAX_TILES = 4;  // 16-row query tiles (warps) per block
constexpr int PAD = 8;        // row padding, elements: 16 bytes

// Shared memory, bytes: Q tiles (tiles x 16 rows) | ring (stages x stage;
// a stage is K then V, KC rows each). One stage with one pass, two with
// two passes.
struct Bf16Layout {
  int dp, ld, tiles, stages;
  size_t ring, stage, total;
};

__host__ __device__ __forceinline__ Bf16Layout bf16_layout(int Lq, int Lk,
                                                          int D) {
  Bf16Layout L;
  L.dp = (D + 15) / 16 * 16;
  L.ld = L.dp + PAD;
  const int tiles = (Lq + 15) / 16;
  L.tiles = tiles < MAX_TILES ? tiles : MAX_TILES;
  L.stages = Lk > KC ? 2 : 1;
  L.ring = static_cast<size_t>(16) * L.tiles * L.ld * 2;
  L.stage = static_cast<size_t>(2) * KC * L.ld * 2;  // K and V
  L.total = L.ring + L.stages * L.stage;
  return L;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Async copy of 16 bytes; with valid == false the destination is
// zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a (16x16, row) . b (16x8, col), bf16 in, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);  // lo: lower half
  return *reinterpret_cast<const uint32_t*>(&p);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// The keep bits (bit 0: key j, bit 1: key j + 1; j even) of one mask row
// for keys below Lk: one 2-byte load where the two bytes are adjacent.
__device__ __forceinline__ uint32_t keep_pair(const uint8_t* mr, int j, int Lk,
                                              long long m_sk, bool pairs) {
  if (j + 1 < Lk && pairs) {
    const uint32_t w = __ldg(reinterpret_cast<const unsigned short*>(mr + j));
    return ((w & 0xffu) != 0) | (((w >> 8) != 0) << 1);
  }
  uint32_t bits = 0;
  if (j < Lk) bits |= __ldg(mr + j * m_sk) != 0;
  if (j + 1 < Lk) bits |= (__ldg(mr + (j + 1) * m_sk) != 0) << 1;
  return bits;
}

// s += a . k^T over one k16 step: the A fragment at qa, the four key
// pairs' B fragments from kb (row krow, column kcol of the step).
__device__ __forceinline__ void qk_step(float (&s)[KC / 8][4], const bf16* qa,
                                        const bf16* kb, int ld) {
  uint32_t a[4], bk[KC / 16][4];
  ldsm_x4(a, qa);
#pragma unroll
  for (int p = 0; p < KC / 16; ++p) ldsm_x4(bk[p], kb + p * 16 * ld);
#pragma unroll
  for (int p = 0; p < KC / 16; ++p) {
    mma_bf16(s[2 * p], a, bk[p][0], bk[p][1]);
    mma_bf16(s[2 * p + 1], a, bk[p][2], bk[p][3]);
  }
}

// Rows [0, rows) of a (valid, D) row-major source into shared rows of ld
// elements, Dp columns each: columns past D and rows past `valid` are
// zero. vec (D % 8 == 0, 16-byte aligned pointers): cp.async of 16 bytes;
// otherwise element by element.
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src,
                                           int rows, int valid, int D, int dp,
                                           int ld, bool vec) {
  if (vec) {
    const int segs = dp / 8;
    for (int i = threadIdx.x; i < rows * segs; i += blockDim.x) {
      const int r = i / segs;
      const int c = (i - r * segs) * 8;
      const bool ok = r < valid && c < D;
      cp_async16(dst + r * ld + c,
                 ok ? src + static_cast<size_t>(r) * D + c : src, ok);
    }
  } else {
    const bf16 zero = __float2bfloat16(0.f);
    for (int i = threadIdx.x; i < rows * dp; i += blockDim.x) {
      const int r = i / dp;
      const int c = i - r * dp;
      dst[r * ld + c] = (r < valid && c < D)
                            ? src[static_cast<size_t>(r) * D + c] : zero;
    }
  }
}

// NT: n8 tiles of output columns per slice (8 for Dp <= 64, else 16).
// TWO_PASS: Lk > KC.
template <int NT, bool TWO_PASS>
__global__ void __launch_bounds__(MAX_TILES * 32)
    mtn_attention_bf16_kernel(const bf16* __restrict__ q,
                              const bf16* __restrict__ k,
                              const bf16* __restrict__ v,
                              const uint8_t* __restrict__ mask,
                              bf16* __restrict__ out, int H, int Lq, int Lk,
                              int D, long long m_sb, long long m_sq,
                              long long m_sk, float scale, bool vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Bf16Layout L = bf16_layout(Lq, Lk, D);
  const int ld = L.ld;
  const int dp = L.dp;
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ring = reinterpret_cast<bf16*>(smem + L.ring);
  const int stage_elems = static_cast<int>(L.stage / 2);

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int tile = threadIdx.x >> 5;  // this warp's 16 query rows
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;           // accumulator row (and row + 8)
  const int t2 = (lane & 3) * 2;     // accumulator column pair
  const int lrow = lane & 15;        // ldmatrix row, A and V (trans)
  const int lcol = (lane >> 4) * 8;  // ldmatrix column offset, A and V
  const int krow = ((lane >> 4) << 3) | (lane & 7);  // ldmatrix row, K
  const int kcol = ((lane >> 3) & 1) * 8;            // ldmatrix column, K
  const size_t head = static_cast<size_t>(b) * H + h;
  const int q0 = blockIdx.x * 16 * L.tiles;
  const bf16* qh = q + (head * Lq + q0) * D;
  const bf16* kh = k + head * Lk * D;
  const bf16* vh = v + head * Lk * D;

  // The stage stream: one stage with one pass. With two: the K stages of
  // pass 1, then the K and V stages of pass 2 once per column slice.
  const int rounds = (Lk + KC - 1) / KC;
  const int nslices = (dp + NT * 8 - 1) / (NT * 8);
  const int T = TWO_PASS ? rounds * (1 + nslices) : 1;
  auto issue = [&](int t) {
    const int r = t % rounds;
    const int valid = min(KC, Lk - r * KC);
    bf16* ks = ring + (t & 1) * stage_elems;
    stage_rows(ks, kh + static_cast<size_t>(r) * KC * D, KC, valid, D, dp, ld,
               vec);
    if (!TWO_PASS) cp_async_commit();  // one pass: V lands behind Q.K^T
    if (!TWO_PASS || t >= rounds)
      stage_rows(ks + KC * ld, vh + static_cast<size_t>(r) * KC * D, KC,
                 valid, D, dp, ld, vec);
    cp_async_commit();
  };
  stage_rows(qs, qh, 16 * L.tiles, min(16 * L.tiles, Lq - q0), D, dp, ld,
             vec);
  issue(0);

  // This lane's query rows, and their mask rows.
  const int qi[2] = {q0 + tile * 16 + g, q0 + tile * 16 + g + 8};
  const uint8_t* mrow[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    mrow[r] = (mask && qi[r] < Lq) ? mask + b * m_sb + qi[r] * m_sq : nullptr;
  // A key mask (m_sq == 0) gives both rows one pattern: read it once.
  const bool one_row = m_sq == 0 && mrow[1] != nullptr;
  // Adjacent keys in adjacent, 2-byte aligned bytes: one load per pair.
  const bool pairs =
      m_sk == 1 && mask && ((reinterpret_cast<uintptr_t>(mask) | m_sb |
                             m_sq) & 1) == 0;
  const bf16* qa = qs + (tile * 16 + lrow) * ld + lcol;

  float m[2] = {-INFINITY, -INFINITY};  // row max, rows g and g + 8
  float l[2] = {0.f, 0.f};              // row sum of exp(s - m)
  float o[NT][4];
  uint32_t pa[KC / 16][4];  // p as the A fragments of P.V

  for (int t = 0; t < T; ++t) {
    const int r = TWO_PASS ? t % rounds : 0;
    const int j0 = r * KC;  // first key of this stage
    // The mask bits of this stage's keys first, so their loads overlap the
    // wait for K and V: bit n * 4 + e for score element e of key tile n.
    uint32_t keep = 0;
#pragma unroll
    for (int n = 0; n < KC / 8; ++n) {
      const int j = j0 + n * 8 + t2;
      const uint32_t k0 =
          mrow[0] ? keep_pair(mrow[0], j, Lk, m_sk, pairs) : 3u;
      const uint32_t k1 =
          one_row ? k0
                  : (mrow[1] ? keep_pair(mrow[1], j, Lk, m_sk, pairs) : 3u);
      keep |= (k0 | (k1 << 2)) << (n * 4);
    }
    if (t + 1 < T) {
      issue(t + 1);
      cp_async_wait<1>();
    } else if (!TWO_PASS) {
      cp_async_wait<1>();  // Q and K; V is waited for before P.V
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* ks = ring + (t & 1) * stage_elems;
    const bf16* vs = ks + KC * ld;

    // s = q . k^T for this warp's 16 rows and 64 keys (rows past Lk are
    // zero). Straight-line for D <= 64, so that every fragment load can be
    // issued ahead of the products.
    float s[KC / 8][4];
#pragma unroll
    for (int n = 0; n < KC / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    const bf16* kb = ks + krow * ld + kcol;
    if (NT == 8) {
#pragma unroll
      for (int kk = 0; kk < 64; kk += 16)
        if (kk < dp) qk_step(s, qa + kk, kb + kk, ld);
    } else {
#pragma unroll 2
      for (int kk = 0; kk < dp; kk += 16) qk_step(s, qa + kk, kb + kk, ld);
    }
    float cmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < KC / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = j0 + n * 8 + t2 + (e & 1);
        float x = s[n][e] * scale;
        if (!((keep >> (n * 4 + e)) & 1u)) x = kMaskFill;
        if (j >= Lk) x = -INFINITY;  // past the keys: contributes nothing
        s[n][e] = x;
        cmax[e >> 1] = fmaxf(cmax[e >> 1], x);
      }

    const bool pass1 = TWO_PASS && t < rounds;
    if (!TWO_PASS || pass1) {  // m and l over these keys
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const float mn = fmaxf(m[rr], quad_max(cmax[rr]));
        float sum = 0.f;
#pragma unroll
        for (int n = 0; n < KC / 8; ++n)
#pragma unroll
          for (int e = 2 * rr; e < 2 * rr + 2; ++e) {
            const float x = __expf(s[n][e] - mn);
            if (!TWO_PASS) s[n][e] = x;  // kept: e for p below
            sum += x;
          }
        l[rr] = l[rr] * __expf(m[rr] - mn) + quad_sum(sum);
        m[rr] = mn;
      }
    }
    if (!pass1) {  // p = e / l, rounded to bf16, as A fragments
      const float inv[2] = {1.f / l[0], 1.f / l[1]};
#pragma unroll
      for (int kk = 0; kk < KC / 16; ++kk)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int n = 2 * kk + (x >> 1);
          const int rr = x & 1;
          float e0 = s[n][2 * rr], e1 = s[n][2 * rr + 1];
          if (TWO_PASS) {
            e0 = __expf(e0 - m[rr]);
            e1 = __expf(e1 - m[rr]);
          }
          pa[kk][x] = pack_bf16(e0 * inv[rr], e1 * inv[rr]);
        }
      if (!TWO_PASS) {
        cp_async_wait<0>();
        __syncthreads();
      }
      // With one pass every slice is done here; with two, this stage's
      // slice, whose accumulator lives across the rounds.
      const int s_lo = TWO_PASS ? (t - rounds) / rounds : 0;
      const int s_hi = TWO_PASS ? s_lo + 1 : (NT == 8 ? 1 : nslices);
      for (int sl = s_lo; sl < s_hi; ++sl) {
        const int c0 = sl * NT * 8;
        if (!TWO_PASS || r == 0) {
#pragma unroll
          for (int n = 0; n < NT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
        }
#pragma unroll
        for (int kk = 0; kk < KC / 16; ++kk) {  // p and V are 0 past Lk
#pragma unroll
          for (int p = 0; p < NT / 2; ++p) {
            if (c0 + p * 16 < dp) {
              uint32_t bv[4];
              ldsm_x4_t(bv, vs + (kk * 16 + lrow) * ld + c0 + p * 16 + lcol);
              mma_bf16(o[2 * p], pa[kk], bv[0], bv[1]);
              mma_bf16(o[2 * p + 1], pa[kk], bv[2], bv[3]);
            }
          }
        }
        if (TWO_PASS && r != rounds - 1) continue;
#pragma unroll
        for (int n = 0; n < NT; ++n) {  // store rows < Lq, columns < D
          const int col = c0 + n * 8 + t2;
          if (col >= D) continue;
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            if (qi[rr] >= Lq) continue;
            bf16* dst = out + (head * Lq + qi[rr]) * D + col;
            if (vec) {
              *reinterpret_cast<__nv_bfloat162*>(dst) =
                  __floats2bfloat162_rn(o[n][2 * rr], o[n][2 * rr + 1]);
            } else {
              dst[0] = __float2bfloat16(o[n][2 * rr]);
              if (col + 1 < D) dst[1] = __float2bfloat16(o[n][2 * rr + 1]);
            }
          }
        }
      }
    }
    if (TWO_PASS) __syncthreads();  // the next issue() refills this stage
  }
}

int launch_bf16(const void* q, const void* k, const void* v, const void* mask,
                void* out, int B, int H, int Lq, int Lk, int D, long long m_sb,
                long long m_sq, long long m_sk, float scale,
                cudaStream_t stream) {
  const Bf16Layout L = bf16_layout(Lq, Lk, D);
  if (L.total > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const bool narrow = L.dp <= 64;
  const bool two = Lk > KC;
  void (*kern)(const bf16*, const bf16*, const bf16*, const uint8_t*, bf16*,
               int, int, int, int, long long, long long, long long, float,
               bool) =
      narrow ? (two ? mtn_attention_bf16_kernel<8, true>
                    : mtn_attention_bf16_kernel<8, false>)
             : (two ? mtn_attention_bf16_kernel<16, true>
                    : mtn_attention_bf16_kernel<16, false>);
  if (L.total > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(L.total));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const uintptr_t any = reinterpret_cast<uintptr_t>(q) |
                        reinterpret_cast<uintptr_t>(k) |
                        reinterpret_cast<uintptr_t>(v) |
                        reinterpret_cast<uintptr_t>(out);
  const bool vec = D % 8 == 0 && any % 16 == 0;
  const dim3 grid((Lq + 16 * L.tiles - 1) / (16 * L.tiles), H, B);
  kern<<<grid, 32 * L.tiles, L.total, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const uint8_t*>(mask),
      static_cast<bf16*>(out), H, Lq, Lk, D, m_sb, m_sq, m_sk, scale, vec);
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
  // 1/sqrt(D) rounded once from double, as the Python scalar of the TPU
  // kernel and of the plain version is
  const float scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(D)));
  if (is_bf16)
    return launch_bf16(q, k, v, mask, out, B, H, Lq, Lk, D, m_sb, m_sq, m_sk,
                       scale, s);
  return launch_f32(q, k, v, mask, out, B, H, Lq, Lk, D, m_sb, m_sq, m_sk,
                    scale, s);
}
