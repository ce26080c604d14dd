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
// Design. F is cut into 256-wide slices. The G = min(8, F / 256) blocks
// (rank, tile) of one row tile form a thread-block cluster; block `rank`
// owns the slices rank, rank + G, ... For each slice it computes
// h = relu(x.W1[:, slice] + b1) into shared memory, rounded to W2's type,
// then adds h.W2[slice, :] into an f32 partial y tile that stays in its
// shared memory. Row tiles are 32 rows in bf16 (two m16 MMA tiles) and 16
// in f32.
//
// bf16 (the decode path), step A, staging: both weight slices stream
// through a ring of 3 stages of ~33 KB in shared memory (64 rows of
// W1[:, slice] or 32 rows of W2[slice, :512] each) with cp.async, 16 bytes
// a thread, neighbouring threads on neighbouring addresses. Eight producer
// warps issue the copies and signal each stage through an mbarrier
// (cp.async.mbarrier.arrive); eight consumer warps run the products on
// the stage that has landed and release it through a second mbarrier.
// Issuing the copies from the product warps themselves serialised copies
// and products; with producer warps a stall on a full memory queue stalls
// no product. Both operands of every product come from shared memory:
// ldmatrix (x4, .trans for the row-major weights) feeding
// mma.sync.m16n8k16 with f32 accumulators, rows padded by 16 bytes so that
// the eight row addresses of one ldmatrix phase fall in distinct banks.
// This replaces the chain of ~64 dependent product steps per warp whose
// weight operands came straight from L2.
//
// Step B, split-F reduction on chip: after cluster.sync(), block `rank`
// sums its 1/G share of the columns over the G partial tiles of the
// cluster in rank order, reading them through distributed shared memory
// (map_shared_rank), adds b2 (staged in shared memory with x) and stores
// its share of y. One launch, no scratch buffer in device memory, no
// atomics: the result is deterministic.
//
// Bytes per call at N = 160 (bf16, G = 8, 5 row tiles of 32, 5 clusters
// of 8 blocks): from device memory the 4 MiB of weights once (the row
// tiles of one call meet in L2), x and y (160 KB each) and the biases;
// from L2 each block streams its 512 KB of weight slices, 20 MiB in all;
// the partials (32 x 512 x 4 bytes a block) move only between the SMs of a
// cluster. Each block's 512 KB, through cp.async into shared memory and
// ldmatrix out of it, is what bounds the kernel on this card, not the
// 4 MiB of device memory: a cluster is at most 8 blocks, so no block can
// own less than 1/8 of the weights. 32-row tiles keep N <= 256 to 8
// clusters, which the card holds at once; 16-row tiles needed 16 there.
//
// f32 keeps full f32 products on the CUDA cores (no TF32), reading the
// weights straight from global memory, with the same slices and the same
// cluster reduction.
//
// Output type. y is stored in x's type, or with out_f32 in f32 whatever
// x's type: a tensor-parallel rank holds a d_ff slice of W1 and W2 (the
// Megatron column/row pair of mtn_tpu/parallel/sharding.py), and its y
// is a partial sum that the ranks add in f32 before rounding, as the
// single-device kernel adds its cluster's partials in f32 before it
// rounds (the caller then passes b2 = 0 and adds b2 once, after the sum).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;

constexpr int TM = 16;          // f32: rows per block
constexpr int MT = 2;           // bf16: m16 MMA tiles per block
constexpr int TMB = 16 * MT;    // bf16: rows per block
constexpr int FS = 256;         // d_ff columns per slice
constexpr int THREADS = 256;    // f32: 8 warps
constexpr int CW = 8;           // bf16: consumer warps
constexpr int PW = 8;           // bf16: producer warps
constexpr int BF16_THREADS = (CW + PW) * 32;
constexpr int MAX_GROUP = 8;    // blocks that share a row tile
constexpr int K1 = 64;          // W1 rows per ring stage
constexpr int K2 = 32;          // W2 rows per ring stage
constexpr int DG = 512;         // output columns per phase-2 pass
constexpr int NT1 = FS / (CW * 8);  // n8 tiles of h per consumer warp
constexpr int NT2 = DG / (CW * 8);  // n8 tiles of y per consumer warp
constexpr int STAGES = 3;
constexpr int PAD = 8;          // bf16 row padding: 16 bytes
constexpr int LD1 = FS + PAD;   // W1 stage and h row stride
constexpr int LD2 = DG + PAD;   // W2 stage row stride
constexpr int STAGE_ELEMS = K1 * LD1 > K2 * LD2 ? K1 * LD1 : K2 * LD2;
constexpr size_t kMaxSmem = 232448;  // H100: 227 KB per block, opt-in

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16(x);
}

__host__ __device__ __forceinline__ size_t align128(size_t n) {
  return (n + 127) & ~static_cast<size_t>(127);
}

// Shared memory, byte offsets. bf16: x tile (TMB, D+PAD) | h (TMB, LD1) |
// f32 partial y (TMB, D+PAD) | b2 (D) | ring (STAGES, STAGE_ELEMS). f32:
// x tile (TM, D) | h (TM, FS) | partial y (TM, D+PAD).
struct Layout {
  size_t h, part, b2, ring, total;
};

__host__ __device__ __forceinline__ Layout layout(int D, bool is_bf16) {
  Layout L;
  const size_t rows = is_bf16 ? TMB : TM;
  const size_t part = rows * (D + PAD) * 4;
  if (is_bf16) {
    L.h = align128(rows * (D + PAD) * 2);
    L.part = L.h + align128(rows * LD1 * 2);
    L.b2 = L.part + align128(part);
    L.ring = L.b2 + align128(static_cast<size_t>(D) * 2);
    L.total = L.ring + static_cast<size_t>(STAGES) * STAGE_ELEMS * 2;
  } else {
    L.h = align128(rows * D * 4);
    L.part = L.h + align128(rows * FS * 4);
    L.b2 = L.ring = L.total = L.part + part;
  }
  return L;
}

// -- PTX wrappers -------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; with valid == false the destination is zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// Arrives on the mbarrier once every cp.async this thread issued so far
// has landed (counted against the barrier's expected arrivals).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n .reg .b64 st;\n mbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::"r"(
          smem_u32(bar))
      : "memory");
}

// Waits until the barrier's phase with the given parity has completed:
// lane 0 polls, and __syncwarp() holds the other lanes until it is done.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = (threadIdx.x & 31) != 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
  __syncwarp();
}

// Barrier 1 over the consumer warps only (the producer warps never wait
// on it).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CW * 32) : "memory");
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

// The G blocks of a row tile form one thread-block cluster. Once every
// block's f32 partial y tile is complete, block `rank` sums columns
// [rank * per, (rank + 1) * per) over the cluster's partials in rank order,
// reading them through distributed shared memory, adds b2, casts and
// stores the rows below N. No partial leaves the chip and no atomics are
// used, so the result is deterministic.
template <int ROWS, typename T, typename O>
__device__ __forceinline__ void cluster_reduce(float* ps,
                                               const T* __restrict__ b2,
                                               O* __restrict__ out, int N,
                                               int D) {
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int ldp = D + PAD;
  const int group = static_cast<int>(cluster.num_blocks());
  const int per = (D / 4 + group - 1) / group * 4;  // columns, 4 at a time
  const int c0 = static_cast<int>(cluster.block_rank()) * per;
  const int quads = max(0, min(D, c0 + per) - c0) / 4;
  const int r0 = blockIdx.y * ROWS;
  for (int i = threadIdx.x; i < ROWS * quads; i += blockDim.x) {
    const int r = i / quads;
    const int c = c0 + (i - r * quads) * 4;
    if (r0 + r >= N) continue;
    float4 v[MAX_GROUP];
#pragma unroll
    for (int q = 0; q < MAX_GROUP; ++q)
      if (q < group)
        v[q] = *reinterpret_cast<const float4*>(
            cluster.map_shared_rank(ps + r * ldp + c, q));
    float4 s = v[0];
#pragma unroll
    for (int q = 1; q < MAX_GROUP; ++q) {
      if (q < group) {
        s.x += v[q].x;
        s.y += v[q].y;
        s.z += v[q].z;
        s.w += v[q].w;
      }
    }
    O* o = out + static_cast<size_t>(r0 + r) * D + c;
    o[0] = from_f32<O>(s.x + to_f32(b2[c]));
    o[1] = from_f32<O>(s.y + to_f32(b2[c + 1]));
    o[2] = from_f32<O>(s.z + to_f32(b2[c + 2]));
    o[3] = from_f32<O>(s.w + to_f32(b2[c + 3]));
  }
  cluster.sync();  // no block leaves while its partial is still being read
}

// -- bf16: staged ring, tensor cores ------------------------------------------
// Warps 0-7 consume the ring (products, epilogues); warps 8-15 produce it:
// their cp.async copies, tracked per stage by the mbarrier full[s], are
// issued while the consumers compute, and they refill stage s once all 8
// consumer warps have arrived on empty[s]. A single producer warp issued
// too slowly to keep the ring full.
template <typename O>
__global__ void __launch_bounds__(BF16_THREADS, 1)
    ffn_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                    const bf16* __restrict__ b1, const bf16* __restrict__ w2,
                    const bf16* __restrict__ b2, O* __restrict__ out, int N,
                    int D, int F) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[STAGES];
  __shared__ __align__(8) uint64_t empty[STAGES];
  const Layout L = layout(D, true);
  bf16* xs = reinterpret_cast<bf16*>(smem);
  bf16* hs = reinterpret_cast<bf16*>(smem + L.h);
  float* ps = reinterpret_cast<float*>(smem + L.part);
  bf16* b2s = reinterpret_cast<bf16*>(smem + L.b2);
  bf16* ring = reinterpret_cast<bf16*>(smem + L.ring);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int rank = blockIdx.x;
  const int group = gridDim.x;
  const int r0 = blockIdx.y * TMB;
  const int ldx = D + PAD;
  const int ldp = D + PAD;

  // The stage stream of this block, in the same order for producers and
  // consumers: for each of its slices, the W1 stages (K1 rows of D each),
  // then the W2 stages (K2 rows of the slice each) of every pass over DG
  // output columns.
  const int nslices = (F / FS - rank + group - 1) / group;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], PW * 32);
      mbar_init(&empty[s], CW);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= CW) {  // producers: warp pw copies rows pw, pw + PW, ...
    const int pw = warp - CW;
    // x tile (zero past row N) and b2; full[0] covers them.
    for (int r = pw; r < TMB; r += PW) {
      const bool ok = r0 + r < N;
      const bf16* src = x + static_cast<size_t>(ok ? r0 + r : 0) * D;
      for (int s = lane; s < D / 8; s += 32)
        cp_async16(xs + r * ldx + s * 8, src + s * 8, ok);
    }
    for (int s = pw * 32 + lane; s < D / 8; s += PW * 32)
      cp_async16(b2s + s * 8, b2 + s * 8, true);
    int c = 0;
    auto next_stage = [&]() -> bf16* {
      const int st = c % STAGES;
      if (c >= STAGES) mbar_wait(&empty[st], ((c / STAGES) - 1) & 1);
      return ring + st * STAGE_ELEMS;
    };
    auto stage_done = [&]() {
      cp_async_arrive(&full[c % STAGES]);
      ++c;
    };
    for (int j = 0; j < nslices; ++j) {
      const int f0 = (rank + j * group) * FS;
      for (int k0 = 0; k0 < D; k0 += K1) {  // W1[k0 : k0 + K1, f0 : f0 + FS]
        bf16* d = next_stage() + lane * 8;
        const bf16* src = w1 + static_cast<size_t>(k0) * F + f0 + lane * 8;
        const int rows = min(K1, D - k0);
#pragma unroll 4
        for (int r = pw; r < rows; r += PW)
          cp_async16(d + r * LD1, src + static_cast<size_t>(r) * F, true);
        stage_done();
      }
      for (int c0 = 0; c0 < D; c0 += DG) {  // W2[f0 + k : + K2, c0 : + DG]
        const int segs = min(DG, D - c0) / 8;
        for (int k = 0; k < FS; k += K2) {
          bf16* d = next_stage();
          const bf16* src = w2 + static_cast<size_t>(f0 + k) * D + c0;
#pragma unroll
          for (int r = pw; r < K2; r += PW)
            for (int s = lane; s < segs; s += 32)
              cp_async16(d + r * LD2 + s * 8,
                         src + static_cast<size_t>(r) * D + s * 8, true);
          stage_done();
        }
      }
    }
  } else {  // consumers
    const int g = lane >> 2;           // accumulator row (and row + 8)
    const int t2 = (lane & 3) * 2;     // accumulator column pair
    const int lrow = lane & 15;        // ldmatrix row address
    const int lcol = (lane >> 4) * 8;  // ldmatrix column offset
    int c = 0;
    auto wait_stage = [&]() -> const bf16* {
      const int st = c % STAGES;
      mbar_wait(&full[st], (c / STAGES) & 1);
      return ring + st * STAGE_ELEMS;
    };
    auto release_stage = [&]() {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[c % STAGES]);
      ++c;
    };
    for (int j = 0; j < nslices; ++j) {
      const int f0 = (rank + j * group) * FS;
      const int hc = warp * NT1 * 8;  // this warp's h columns in the slice
      // b1 at this thread's h columns, converted only in the epilogue: a
      // conversion here would wait for the load.
      __nv_bfloat162 bias[NT1];
#pragma unroll
      for (int n = 0; n < NT1; ++n)
        bias[n] = *reinterpret_cast<const __nv_bfloat162*>(b1 + f0 + hc +
                                                           n * 8 + t2);
      float hacc[MT][NT1][4] = {};
      for (int k0 = 0; k0 < D; k0 += K1) {  // h += x[:, k0:] . W1 stage
        const bf16* st = wait_stage();
        const int rows = min(K1, D - k0);
#pragma unroll 4
        for (int ks = 0; ks < rows; ks += 16) {
          uint32_t a[MT][4], b[NT1 / 2][4];
#pragma unroll
          for (int m = 0; m < MT; ++m)
            ldsm_x4(a[m], xs + (m * 16 + lrow) * ldx + k0 + ks + lcol);
#pragma unroll
          for (int p = 0; p < NT1 / 2; ++p)
            ldsm_x4_t(b[p], st + (ks + lrow) * LD1 + hc + p * 16 + lcol);
#pragma unroll
          for (int m = 0; m < MT; ++m)
#pragma unroll
            for (int p = 0; p < NT1 / 2; ++p) {
              mma_bf16(hacc[m][2 * p], a[m], b[p][0], b[p][1]);
              mma_bf16(hacc[m][2 * p + 1], a[m], b[p][2], b[p][3]);
            }
        }
        release_stage();
      }
      // h = relu(x.W1 + b1) in f32, rounded to bf16.
      consumers_sync();  // the previous slice's h is no longer read
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int n = 0; n < NT1; ++n) {
          const float bb0 = __low2float(bias[n]);
          const float bb1 = __high2float(bias[n]);
          bf16* h0 = hs + (m * 16 + g) * LD1 + hc + n * 8 + t2;
          *reinterpret_cast<__nv_bfloat162*>(h0) =
              __floats2bfloat162_rn(fmaxf(hacc[m][n][0] + bb0, 0.f),
                                    fmaxf(hacc[m][n][1] + bb1, 0.f));
          *reinterpret_cast<__nv_bfloat162*>(h0 + 8 * LD1) =
              __floats2bfloat162_rn(fmaxf(hacc[m][n][2] + bb0, 0.f),
                                    fmaxf(hacc[m][n][3] + bb1, 0.f));
        }
      consumers_sync();  // h is complete

      for (int c0 = 0; c0 < D; c0 += DG) {  // y[:, c0 : c0 + DG] += h . W2
        const int yc = warp * NT2 * 8;       // this warp's columns of the pass
        const int cols = min(DG, D - c0);
        float yacc[MT][NT2][4] = {};
        for (int k = 0; k < FS; k += K2) {
          const bf16* st = wait_stage();
#pragma unroll
          for (int ks = 0; ks < K2; ks += 16) {
            uint32_t a[MT][4], b[NT2 / 2][4];
#pragma unroll
            for (int m = 0; m < MT; ++m)
              ldsm_x4(a[m], hs + (m * 16 + lrow) * LD1 + k + ks + lcol);
#pragma unroll
            for (int p = 0; p < NT2 / 2; ++p)
              if (yc + p * 16 < cols)
                ldsm_x4_t(b[p], st + (ks + lrow) * LD2 + yc + p * 16 + lcol);
#pragma unroll
            for (int m = 0; m < MT; ++m)
#pragma unroll
              for (int p = 0; p < NT2 / 2; ++p) {
                if (yc + p * 16 < cols) {
                  mma_bf16(yacc[m][2 * p], a[m], b[p][0], b[p][1]);
                  mma_bf16(yacc[m][2 * p + 1], a[m], b[p][2], b[p][3]);
                }
              }
          }
          release_stage();
        }
        // This thread's own elements of the partial, set by the first slice
        // and added to by the next ones.
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int n = 0; n < NT2; ++n) {
            if (yc + n * 8 < cols) {
              float* p0 = ps + (m * 16 + g) * ldp + c0 + yc + n * 8 + t2;
              float* p1 = p0 + 8 * ldp;
              p0[0] = (j ? p0[0] : 0.f) + yacc[m][n][0];
              p0[1] = (j ? p0[1] : 0.f) + yacc[m][n][1];
              p1[0] = (j ? p1[0] : 0.f) + yacc[m][n][2];
              p1[1] = (j ? p1[1] : 0.f) + yacc[m][n][3];
            }
          }
      }
    }
  }
  cluster_reduce<TMB>(ps, b2s, out, N, D);
}

// -- f32: CUDA cores, full f32 products ---------------------------------------
__global__ void __launch_bounds__(THREADS, 1)
    ffn_f32_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                   const float* __restrict__ b1, const float* __restrict__ w2,
                   const float* __restrict__ b2, float* __restrict__ out, int N,
                   int D, int F) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = layout(D, false);
  float* xs = reinterpret_cast<float*>(smem);
  float* hs = reinterpret_cast<float*>(smem + L.h);
  float* ps = reinterpret_cast<float*>(smem + L.part);
  const int tid = threadIdx.x;
  const int rank = blockIdx.x;
  const int group = gridDim.x;
  const int r0 = blockIdx.y * TM;
  const int ldp = D + PAD;

  for (int i = tid; i < TM * D; i += THREADS) {
    const int r = i / D;
    xs[i] = (r0 + r < N) ? x[static_cast<size_t>(r0) * D + i] : 0.f;
  }
  for (int i = tid; i < TM * ldp; i += THREADS) ps[i] = 0.f;
  __syncthreads();

  for (int s = rank; s < F / FS; s += group) {
    const int f0 = s * FS;
    // h: thread tid owns column tid of the slice (FS == THREADS), all rows;
    // W1 reads are coalesced across the warp, x reads are broadcasts.
    float acc[TM];
#pragma unroll
    for (int r = 0; r < TM; ++r) acc[r] = 0.f;
    const float* wc = w1 + f0 + tid;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float w = wc[static_cast<size_t>(d) * F];
#pragma unroll
      for (int r = 0; r < TM; ++r) acc[r] = fmaf(xs[r * D + d], w, acc[r]);
    }
    const float bias = b1[f0 + tid];
#pragma unroll
    for (int r = 0; r < TM; ++r) hs[r * FS + tid] = fmaxf(acc[r] + bias, 0.f);
    __syncthreads();
    // y: thread owns output column d for all rows.
    for (int d = tid; d < D; d += THREADS) {
      float y[TM];
#pragma unroll
      for (int r = 0; r < TM; ++r) y[r] = 0.f;
      const float* wr = w2 + static_cast<size_t>(f0) * D + d;
#pragma unroll 4
      for (int k = 0; k < FS; ++k) {
        const float w = wr[static_cast<size_t>(k) * D];
#pragma unroll
        for (int r = 0; r < TM; ++r) y[r] = fmaf(hs[r * FS + k], w, y[r]);
      }
#pragma unroll
      for (int r = 0; r < TM; ++r) ps[r * ldp + d] += y[r];
    }
    __syncthreads();  // hs is rewritten by the next slice
  }
  cluster_reduce<TM>(ps, b2, out, N, D);
}

template <typename T, typename O>
int launch(void (*kern)(const T*, const T*, const T*, const T*, const T*, O*,
                        int, int, int),
           int threads, const void* x, const void* w1, const void* b1,
           const void* w2, const void* b2, void* out, int N, int D, int F,
           cudaStream_t stream) {
  const size_t smem = layout(D, sizeof(T) == 2).total;
  const size_t barriers = sizeof(T) == 2 ? 2 * STAGES * sizeof(uint64_t) : 0;
  if (smem + barriers > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  int group = 1;
  while (group * 2 <= MAX_GROUP && group * 2 <= F / FS) group *= 2;
  cudaLaunchConfig_t cfg = {};
  const int rows = sizeof(T) == 2 ? TMB : TM;
  cfg.gridDim = dim3(group, (N + rows - 1) / rows);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = group;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, kern, static_cast<const T*>(x), static_cast<const T*>(w1),
      static_cast<const T*>(b1), static_cast<const T*>(w2),
      static_cast<const T*>(b2), static_cast<O*>(out), N, D, F));
}

}  // namespace

// x (N, D), w1 (D, F), b1 (F), w2 (F, D), b2 (D): contiguous, one type
// (f32 or bf16); out (N, D) contiguous, of that type or, with out_f32,
// f32; pointers 32-byte aligned. Needs D % 16 == 0 and F % 256 == 0. One
// launch; returns its cudaError_t (0 on success).
extern "C" int mtn_ffn(const void* x, const void* w1, const void* b1,
                       const void* w2, const void* b2, void* out, int N,
                       int D, int F, int is_bf16, int out_f32,
                       void* stream) {
  if (N <= 0 || D <= 0 || F <= 0 || D % 16 != 0 || F % FS != 0 ||
      (N + TM - 1) / TM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16 && out_f32)
    return launch<bf16, float>(ffn_bf16_kernel<float>, BF16_THREADS, x, w1,
                               b1, w2, b2, out, N, D, F, s);
  if (is_bf16)
    return launch<bf16, bf16>(ffn_bf16_kernel<bf16>, BF16_THREADS, x, w1, b1,
                              w2, b2, out, N, D, F, s);
  return launch<float, float>(ffn_f32_kernel, THREADS, x, w1, b1, w2, b2, out,
                              N, D, F, s);
}
