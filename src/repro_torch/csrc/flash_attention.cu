// Causal GQA flash attention (prefill) for NVIDIA Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention.py::_kernel, the Pallas TPU
// kernel behind flash_attention() (the twin of models/layers.py
// chunked_attention, which the JAX package runs on this path).
//
// Computes o = softmax(q k^T / sqrt(D) + mask) v per (row, query head) with
// the causal mask and an optional sliding window (qpos - kpos < window).
// Query head h reads KV head h / (H / K); the KV heads are never repeated.
// Scores, the online-softmax state (m, l) and the accumulator are float32;
// the output is cast to the input type.
//
// Bound: the work is 4*B*H*S^2*D/2 FLOP (causal) against 2*B*(2H+2K)*S*D
// bytes (q, k, v read, o written); at prefill lengths that is more
// operations per byte than the card's bf16 tensor-core rate over its memory
// rate, so the tensor cores bound it, and only wgmma reaches their full
// rate. What a kernel must avoid is everything that keeps them waiting:
// synchronous tile loads, scores or products staged through shared memory
// between the two products, and the softmax's exponentials on the critical
// path of every warpgroup at once.
// Design against that bound (bf16):
//  * One block owns 128 query rows of one (row, query head): two consumer
//    warpgroups of 64 rows each, and one producer warp. Two blocks share an
//    SM (the registers allow 96 a thread), so while one warpgroup computes
//    its softmax the other three keep the tensor cores busy; within a
//    warpgroup a tile's S, softmax and P V run in turn.
//  * The producer warp's lane 0 issues TMA loads: Q once per block, then
//    the KV head's K and V tiles of 64 rows into a ring of STAGES slots in
//    shared memory. Each slot has a "full" mbarrier (the TMA's byte count)
//    and an "empty" one (every consumer thread arrives when its products
//    have read the slot), so the next tiles are in flight while the
//    consumers compute. The tensor maps are 4-D over the strided
//    (batch, head, seq) views as the model passes them, encoded on the host
//    per call and passed by value (__grid_constant__), so a CUDA graph
//    keeps them; rows at or beyond S are zero-filled by the TMA.
//    128-byte swizzle for D = 64 (a bf16 row is 128 B), 64-byte for D = 32.
//  * S = Q K^T is wgmma m64n64k16 with both operands read from shared
//    memory through descriptors (Q and K are K-major as they lie).
//    O += P V is wgmma m64nDk16 with A = P from registers: the float32
//    accumulator fragment of S, rounded to bf16 pairs, has the layout of
//    the A register fragment; V is MN-major and read with the transpose
//    bit. S, P and O never leave the registers.
//  * The softmax is online, on the accumulator registers: each thread holds
//    two rows of its warp's 16, so a row's max and sum are two shuffles
//    across the quad; ex2.approx of scores scaled by log2(e)/sqrt(D).
//  * The loop over KV tiles stops at the diagonal and starts at the
//    window's edge (per warpgroup: a tile no row of the warpgroup needs is
//    waited for and released, not computed). Only tiles that straddle the
//    diagonal or the window edge evaluate the mask.
//  * Blocks are launched heaviest-first (the last query tiles, which have
//    the most KV tiles, lead the grid), so the short tiles fill its tail.
//  * float32 inputs have no exact tensor-core path (TF32 would round
//    them), so they take a scalar kernel: one thread per query row, K/V
//    tiles in shared memory read as broadcasts.
//
// Layout: every tensor is addressed by (batch, head, seq) strides with a
// contiguous head dim, so [B,S,H,D] projections are taken as they are.
// Each entry point returns cudaGetLastError() after its launch (or the
// error of encoding a tensor map).
//
// The logsumexp: given a float32 [B,H,S] buffer (repro_flash_attention_lse),
// each kernel also writes lse = log sum_k exp(q k / sqrt(D)) of every valid
// row, the natural-log statistic the backward (flash_attention_bwd.cu)
// recomputes P from. The row max and sum are already in registers at the
// epilogue (the bf16 kernel's quad of threads holds each row's after its
// shuffles), so the write is one float a row; a null buffer skips it and
// leaves the output's arithmetic untouched.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is looked up at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr float NEG_INF = -1e30f;
constexpr int BQ = 64;    // query rows per consumer warpgroup (scalar kernel: per block)
constexpr int BK = 64;    // KV rows per tile (tensor-core kernel)
constexpr int BKS = 32;   // KV rows per tile (scalar kernel)
constexpr int CONSUMERS = 2;             // consumer warpgroups per block
constexpr int BM = BQ * CONSUMERS;       // query rows per block (tensor-core kernel)
constexpr int STAGES = 3;                // K/V slots in the ring
constexpr int THREADS = 128 * CONSUMERS + 32;  // + one producer warp

struct Strides {
  long long b, h, s;
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // [B,H,S] or null
  int H, K, S;
  Strides qs, ks, vs, os;
  int window;  // 0: no window
  float scale;
};

__device__ __forceinline__ bool valid_pair(int qp, int kp, int window) {
  return kp <= qp && (window <= 0 || qp - kp < window);
}

// Every (q, k) pair of the tile [q0, q0+BQ) x [k0, k0+bk) is valid.
__device__ __forceinline__ bool tile_full(int q0, int k0, int bk, int window) {
  bool full = k0 + bk - 1 <= q0;
  if (window > 0) full = full && (q0 + BQ - 1) - k0 < window;
  return full;
}

// KV rows [lo, hi) the query tile starting at q0 needs; lo tile-aligned.
__device__ __forceinline__ void kv_range(int q0, int S, int window, int bk,
                                         int* lo, int* hi) {
  *hi = min(q0 + BQ, S);
  int l = window > 0 ? max(q0 - window + 1, 0) : 0;
  *lo = (l / bk) * bk;
}

// ---------------------------------------------------------------------------
// Hopper building blocks: mbarriers, TMA, wgmma (inline PTX).
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

// Spin until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// One TMA box of a 4-D tensor map (dim 0 the head dim, then the seq, head
// and batch axes in the map's order) into shared memory; completion is
// counted on `bar`. `slots` packs the map dim (1..3) of seq, head and
// batch in bits 0-1, 2-3 and 4-5.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int slots, int s, int h,
                                         int b) {
  const int ps = slots & 3, ph = (slots >> 2) & 3, pb = (slots >> 4) & 3;
  const int c1 = (ps == 1 ? s : 0) + (ph == 1 ? h : 0) + (pb == 1 ? b : 0);
  const int c2 = (ps == 2 ? s : 0) + (ph == 2 ? h : 0) + (pb == 2 ? b : 0);
  const int c3 = (ps == 3 ? s : 0) + (ph == 3 ? h : 0) + (pb == 3 ? b : 0);
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_addr(bar))
      : "memory");
}

// A wgmma shared-memory matrix descriptor for a tile whose rows are D bf16
// elements (D * 2 bytes), as the TMA wrote it with the matching swizzle
// (128 B for D = 64, 64 B for D = 32): 8-row groups lie 8 * D * 2 bytes
// apart (the stride byte offset, for a K-major operand along M/N, for the
// MN-major V along K). The leading byte offset is not read for these
// shapes (one swizzle atom spans the row).
template <int D>
__device__ __forceinline__ uint64_t smem_desc(const void* tile) {
  constexpr uint64_t layout = D == 64 ? 1 : 2;  // 1: 128-byte swizzle, 2: 64-byte
  constexpr uint64_t sbo = 8 * D * 2;
  return (uint64_t)((smem_addr(tile) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((sbo >> 4) << 32) | (layout << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma (the asm statements above are ordered).
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// D[64 x 64] (+)= A[64 x 16] * B[16 x 64]; A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 64] += A[64 x 16] * B[16 x 64]; A from registers (bf16 pairs),
// B MN-major in shared memory (the transpose bit set).
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 32] += A[64 x 16] * B[16 x 32]; A from registers (bf16 pairs),
// B MN-major in shared memory (the transpose bit set).
__device__ __forceinline__ void wgmma_rs_n32(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int D>
struct PV;
template <>
struct PV<64> {
  static __device__ __forceinline__ void mma(float* d, const uint32_t* a, uint64_t db) {
    wgmma_rs_n64(d, a, db);
  }
};
template <>
struct PV<32> {
  static __device__ __forceinline__ void mma(float* d, const uint32_t* a, uint64_t db) {
    wgmma_rs_n32(d, a, db);
  }
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

struct TmaArgs {
  bf16* o;
  float* lse;  // [B,H,S] or null
  Strides os;
  int H, K, S;
  int window;        // 0: no window
  float scale_log2;  // log2(e) / sqrt(D)
  int q_slots, k_slots, v_slots;  // see tma_load
};

// Shared memory of the tensor-core kernel, from a 1024-byte aligned base
// (the swizzle pattern follows address bits 4-9): Q, the K and V rings,
// then the barriers.
template <int D>
struct Smem {
  static constexpr int TILE = BK * D * 2;  // bytes of one K or V tile
  static constexpr int Q = 0;
  static constexpr int K = Q + BM * D * 2;
  static constexpr int V = K + STAGES * TILE;
  static constexpr int BAR = V + STAGES * TILE;
  static constexpr int BYTES = BAR + (2 * STAGES + 1) * 8 + 1024;  // + alignment slack
};

// ---------------------------------------------------------------------------
// bf16: wgmma with TMA tile loads. THREADS = two consumer warpgroups of 64
// query rows each, then one producer warp.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(THREADS, 2)
    flash_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv, TmaArgs a) {
  using L = Smem<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR);
  uint64_t* empty = full + STAGES;
  uint64_t* q_full = empty + STAGES;

  const int qt = gridDim.z - 1 - blockIdx.z;  // heaviest tiles first
  const int h = blockIdx.x, b = blockIdx.y;
  const int kh = h / (a.H / a.K);
  const int q0 = qt * BM;
  const int warp = threadIdx.x / 32;

  // the KV tiles the block loads: the union of its warpgroups' ranges
  int lo, hi, lo_last;
  kv_range(q0, a.S, a.window, BK, &lo, &hi);
  const int last_wg = min(CONSUMERS - 1, (a.S - 1 - q0) / BQ);  // the last with rows
  kv_range(q0 + last_wg * BQ, a.S, a.window, BK, &lo_last, &hi);
  const int n_tiles = (hi - lo + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 128 * CONSUMERS);
    }
    mbar_init(q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * CONSUMERS) {  // producer
    if (threadIdx.x % 32 == 0) {
      mbar_expect_tx(q_full, BM * D * 2);
      tma_load(smem + L::Q, &tq, q_full, a.q_slots, q0, h, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % STAGES;
        if (it >= STAGES) mbar_wait(&empty[st], ((it / STAGES) - 1) & 1);
        mbar_expect_tx(&full[st], 2 * L::TILE);
        tma_load(smem + L::K + st * L::TILE, &tk, &full[st], a.k_slots, lo + it * BK, kh, b);
        tma_load(smem + L::V + st * L::TILE, &tv, &full[st], a.v_slots, lo + it * BK, kh, b);
      }
    }
    return;
  }

  // consumer warpgroup wg: query rows [q0w, q0w + 64), KV tiles
  // [it_lo, it_hi) of the block's
  constexpr int NS = BK / 2;  // S accumulator floats per thread
  constexpr int NO = D / 2;   // O accumulator floats per thread
  const int wg = warp / 4, t = threadIdx.x % 128, lane = threadIdx.x % 32;
  const int q0w = q0 + wg * BQ;
  int it_lo = 0, it_hi = 0;  // no rows below S: compute nothing
  if (q0w < a.S) {
    int lo_w, hi_w;
    kv_range(q0w, a.S, a.window, BK, &lo_w, &hi_w);
    it_lo = (lo_w - lo) / BK;
    it_hi = (hi_w - lo + BK - 1) / BK;
  }
  // this thread's rows (of the warpgroup's 64) and its first key column:
  // s[n*4 + i*2 + j] is row r0 + 8i, key k0 + 8n + c0 + j
  const int r0 = (t / 32) * 16 + lane / 4;
  const int qp0 = q0w + r0, qp1 = qp0 + 8;
  const int c0 = 2 * (lane % 4);

  float o[NO], s[NS];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < NS; ++i) s[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  const uint64_t dq = smem_desc<D>(smem + L::Q + wg * BQ * D * 2);

  mbar_wait(q_full, 0);
  for (int it = 0; it < it_lo; ++it) {  // tiles no row of this warpgroup needs
    mbar_wait(&full[it % STAGES], (it / STAGES) & 1);
    mbar_arrive(&empty[it % STAGES]);
  }
  for (int it = it_lo; it < it_hi; ++it) {
    const int st = it % STAGES;
    const int k0 = lo + it * BK;
    mbar_wait(&full[st], (it / STAGES) & 1);
    // S = Q K^T (64 x BK): D / 16 steps of k16 (32 bytes along a row)
    const uint64_t dk = smem_desc<D>(smem + L::K + st * L::TILE);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) wgmma_ss_n64(s, dq + 2 * kk, dk + 2 * kk, kk > 0);
    wg_commit();
    wg_wait_all();
    fence_regs<NS>(s);

    // the online softmax on the accumulator
    if (!tile_full(q0w, k0, BK, a.window)) {
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = k0 + 8 * n + c0 + (e & 1);
          if (!valid_pair(e < 2 ? qp0 : qp1, kp, a.window)) s[n * 4 + e] = -INFINITY;
        }
    }
    float x0 = -INFINITY, x1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      x0 = fmaxf(x0, fmaxf(s[n * 4], s[n * 4 + 1]));
      x1 = fmaxf(x1, fmaxf(s[n * 4 + 2], s[n * 4 + 3]));
    }
    x0 = fmaxf(x0, __shfl_xor_sync(0xffffffffu, x0, 1));
    x0 = fmaxf(x0, __shfl_xor_sync(0xffffffffu, x0, 2));
    x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, 1));
    x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, 2));
    const float n0 = fmaxf(m0, x0 * a.scale_log2), n1 = fmaxf(m1, x1 * a.scale_log2);
    // a row with no valid key yet keeps m = -inf: subtract 0 so that its
    // masked scores give exp2(-inf) = 0 and not NaN
    const float u0 = n0 == -INFINITY ? 0.f : n0, u1 = n1 == -INFINITY ? 0.f : n1;
    const float al0 = ex2(m0 - u0), al1 = ex2(m1 - u1);
    m0 = n0;
    m1 = n1;
    float p0 = 0.f, p1 = 0.f;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      s[n * 4 + 0] = ex2(fmaf(s[n * 4 + 0], a.scale_log2, -u0));
      s[n * 4 + 1] = ex2(fmaf(s[n * 4 + 1], a.scale_log2, -u0));
      s[n * 4 + 2] = ex2(fmaf(s[n * 4 + 2], a.scale_log2, -u1));
      s[n * 4 + 3] = ex2(fmaf(s[n * 4 + 3], a.scale_log2, -u1));
      p0 += s[n * 4 + 0] + s[n * 4 + 1];
      p1 += s[n * 4 + 2] + s[n * 4 + 3];
    }
    l0 = l0 * al0 + p0;  // this thread's part of the row sums
    l1 = l1 * al1 + p1;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[n * 4 + 0] *= al0;
      o[n * 4 + 1] *= al0;
      o[n * 4 + 2] *= al1;
      o[n * 4 + 3] *= al1;
    }
    // P as the A fragments of BK / 16 k16 steps: the accumulator's columns
    // 16kk .. 16kk+15 are its n8 blocks 2kk and 2kk+1
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
      pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }

    // O += P V: BK / 16 steps of k16 (16 rows of V)
    const uint64_t dv = smem_desc<D>(smem + L::V + st * L::TILE);
    fence_regs<NO>(o);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) PV<D>::mma(o, pa[kk], dv + ((16 * D * 2) >> 4) * kk);
    wg_commit();
    wg_wait_all();
    fence_regs<NO>(o);
    mbar_arrive(&empty[st]);
  }
  for (int it = it_hi; it < n_tiles; ++it) {
    mbar_wait(&full[it % STAGES], (it / STAGES) & 1);
    mbar_arrive(&empty[it % STAGES]);
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  bf16* ob = a.o + b * a.os.b + h * a.os.h;
  if (a.lse != nullptr && lane % 4 == 0) {
    // m is in log2 units of the scaled scores: lse = (m + log2 l) ln 2
    float* lb = a.lse + ((long long)b * a.H + h) * a.S;
    if (qp0 < a.S) lb[qp0] = (m0 + log2f(fmaxf(l0, 1e-30f))) * 0.6931471805599453f;
    if (qp1 < a.S) lb[qp1] = (m1 + log2f(fmaxf(l1, 1e-30f))) * 0.6931471805599453f;
  }
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    if (qp0 < a.S)
      *reinterpret_cast<uint32_t*>(ob + qp0 * a.os.s + 8 * n + c0) =
          pack_bf16(o[n * 4 + 0] * inv0, o[n * 4 + 1] * inv0);
    if (qp1 < a.S)
      *reinterpret_cast<uint32_t*>(ob + qp1 * a.os.s + 8 * n + c0) =
          pack_bf16(o[n * 4 + 2] * inv1, o[n * 4 + 3] * inv1);
  }
}

// ---------------------------------------------------------------------------
// float32: scalar FMA, one thread per query row, 64 threads per block.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(BQ) flash_f32_kernel(Args a) {
  __shared__ __align__(16) float k_s[BKS][D];
  __shared__ __align__(16) float v_s[BKS][D];

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (a.H / a.K);
  const int q0 = qt * BQ;
  const int qpos = q0 + threadIdx.x;
  const bool active = qpos < a.S;
  const float* q = static_cast<const float*>(a.q) + b * a.qs.b + h * a.qs.h;
  const float* k = static_cast<const float*>(a.k) + b * a.ks.b + kh * a.ks.h;
  const float* v = static_cast<const float*>(a.v) + b * a.vs.b + kh * a.vs.h;
  float* o = static_cast<float*>(a.o) + b * a.os.b + h * a.os.h;

  float qr[D], acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = active ? q[qpos * a.qs.s + d] * a.scale : 0.f;
    acc[d] = 0.f;
  }
  float m_run = NEG_INF, l_run = 0.f;

  int lo, hi;
  kv_range(q0, a.S, a.window, BKS, &lo, &hi);
  for (int k0 = lo; k0 < hi; k0 += BKS) {
    __syncthreads();
    for (int i = threadIdx.x; i < BKS * D / 4; i += blockDim.x) {
      const int r = i / (D / 4), c = (i % (D / 4)) * 4;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (k0 + r < a.S) {
        kv = *reinterpret_cast<const float4*>(k + (k0 + r) * a.ks.s + c);
        vv = *reinterpret_cast<const float4*>(v + (k0 + r) * a.vs.s + c);
      }
      *reinterpret_cast<float4*>(&k_s[r][c]) = kv;
      *reinterpret_cast<float4*>(&v_s[r][c]) = vv;
    }
    __syncthreads();
    if (!active) continue;

    const bool full = tile_full(q0, k0, BKS, a.window);
    float s[BKS];
    float tmax = NEG_INF;
#pragma unroll
    for (int j = 0; j < BKS; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; d += 4) {
        const float4 kk = *reinterpret_cast<const float4*>(&k_s[j][d]);
        dot += qr[d] * kk.x + qr[d + 1] * kk.y + qr[d + 2] * kk.z + qr[d + 3] * kk.w;
      }
      s[j] = dot;
      if (full || valid_pair(qpos, k0 + j, a.window)) tmax = fmaxf(tmax, dot);
    }
    const float m_new = fmaxf(m_run, tmax);
    const float alpha = expf(m_run - m_new);
    l_run *= alpha;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] *= alpha;
#pragma unroll
    for (int j = 0; j < BKS; ++j) {
      const bool ok = full || valid_pair(qpos, k0 + j, a.window);
      const float p = ok ? expf(s[j] - m_new) : 0.f;
      l_run += p;
#pragma unroll
      for (int d = 0; d < D; d += 4) {
        const float4 vv = *reinterpret_cast<const float4*>(&v_s[j][d]);
        acc[d] += p * vv.x;
        acc[d + 1] += p * vv.y;
        acc[d + 2] += p * vv.z;
        acc[d + 3] += p * vv.w;
      }
    }
    m_run = m_new;
  }
  if (active) {
    const float inv = 1.f / fmaxf(l_run, 1e-30f);
#pragma unroll
    for (int d = 0; d < D; ++d) o[qpos * a.os.s + d] = acc[d] * inv;
    if (a.lse != nullptr)
      a.lse[((long long)b * a.H + h) * a.S + qpos] = m_run + logf(fmaxf(l_run, 1e-30f));
  }
}

}  // namespace

namespace {

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime, so the library
// needs no -lcuda.
EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn) return fn;
  void* p = nullptr;
  cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
  cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &found);
#else
  cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &found);
#endif
  if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
    fn = reinterpret_cast<EncodeTiled>(p);
  return fn;
}

// A 4-D bf16 tensor map over a [.., seq, .., D] strided view: dim 0 the
// head dim, dims 1-3 the seq, head and batch axes in order of their
// strides (element strides s, h, b; extents S, n_heads, B). The box is
// `rows` seq positions of one (batch, head). Returns a cudaError_t and
// the axes' map dims packed as tma_load() reads them.
int encode(CUtensorMap* map, const void* base, int D, int S, int n_heads, int B,
           long long ss, long long sh, long long sb, int rows, int* slots) {
  EncodeTiled fn = encode_fn();
  if (!fn) return (int)cudaErrorNotSupported;
  const long long stride[3] = {ss, sh, sb};
  const long long extent[3] = {S, n_heads, B};
  int order[3] = {0, 1, 2};
  for (int i = 1; i < 3; ++i)
    for (int j = i; j > 0 && stride[order[j]] < stride[order[j - 1]]; --j) {
      const int t = order[j];
      order[j] = order[j - 1];
      order[j - 1] = t;
    }
  cuuint64_t dims[4] = {(cuuint64_t)D, 0, 0, 0};
  cuuint64_t strides[3];
  cuuint32_t box[4] = {(cuuint32_t)D, 1, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  int slot[3];
  for (int i = 0; i < 3; ++i) {
    dims[i + 1] = (cuuint64_t)extent[order[i]];
    strides[i] = (cuuint64_t)(stride[order[i]] * 2);
    slot[order[i]] = i + 1;
    if (order[i] == 0) box[i + 1] = (cuuint32_t)rows;
  }
  *slots = slot[0] | (slot[1] << 2) | (slot[2] << 4);
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
                        dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        D == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int D>
int launch_bf16(const Args& a, int B, cudaStream_t st) {
  // Encoding a tensor map needs a current context, and a host thread that
  // has made no CUDA call yet has none: bind the device's primary context.
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaSetDevice(dev);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap tq, tk, tv;
  TmaArgs t;
  int rc = encode(&tq, a.q, D, a.S, a.H, B, a.qs.s, a.qs.h, a.qs.b, BM, &t.q_slots);
  if (!rc) rc = encode(&tk, a.k, D, a.S, a.K, B, a.ks.s, a.ks.h, a.ks.b, BK, &t.k_slots);
  if (!rc) rc = encode(&tv, a.v, D, a.S, a.K, B, a.vs.s, a.vs.h, a.vs.b, BK, &t.v_slots);
  if (rc) return rc;
  t.o = static_cast<bf16*>(a.o);
  t.lse = a.lse;
  t.os = a.os;
  t.H = a.H;
  t.K = a.K;
  t.S = a.S;
  t.window = a.window;
  t.scale_log2 = a.scale * 1.4426950408889634f;
  // above 48 KB of shared memory: allowed once per kernel and device
  static unsigned long long allowed = 0;
  if (dev >= 64 || !(allowed >> dev & 1)) {
    err = cudaFuncSetAttribute(flash_bf16_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<D>::BYTES);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) allowed |= 1ull << dev;
  }
  const dim3 grid(a.H, B, (a.S + BM - 1) / BM);
  flash_bf16_kernel<D><<<grid, THREADS, Smem<D>::BYTES, st>>>(tq, tk, tv, t);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. lse: float32 [B,H,S] (contiguous) for
// the rows' logsumexp, or null. Returns a cudaError_t.
extern "C" int repro_flash_attention_lse(
    const void* q, const void* k, const void* v, void* o, float* lse,
    int B, int H, int K, int S, int D,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss,
    int window, int dtype, void* stream) {
  if (B < 1 || S < 1 || K < 1 || H % K != 0) return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q; a.k = k; a.v = v; a.o = o;
  a.lse = lse;
  a.H = H; a.K = K; a.S = S;
  a.qs = {q_sb, q_sh, q_ss};
  a.ks = {k_sb, k_sh, k_ss};
  a.vs = {v_sb, v_sh, v_ss};
  a.os = {o_sb, o_sh, o_ss};
  a.window = window;
  a.scale = 1.0f / sqrtf((float)D);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  if (dtype == 1 && D == 64) return launch_bf16<64>(a, B, st);
  if (dtype == 1 && D == 32) return launch_bf16<32>(a, B, st);
  if (dtype == 0 && D == 64) {
    flash_f32_kernel<64><<<grid, BQ, 0, st>>>(a);
  } else if (dtype == 0 && D == 32) {
    flash_f32_kernel<32><<<grid, BQ, 0, st>>>(a);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The forward alone (no logsumexp): the prefill's entry.
extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, void* o,
    int B, int H, int K, int S, int D,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss,
    int window, int dtype, void* stream) {
  return repro_flash_attention_lse(q, k, v, o, nullptr, B, H, K, S, D, q_sb, q_sh, q_ss,
                                   k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss,
                                   window, dtype, stream);
}
