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
// Design against that bound (bf16). Which kernel runs is a rule on
// (D, G, window), ws_route: flash_ws_kernel<D> at D = 64 and 128 (and at 96,
// MLA's qk head dim, on D = 128's tiles: flash_ws_kernel<128, 96, 64> beside
// V at its own 64 columns, flash_ws_kernel<128, 96> beside a V padded to
// 96), flash_bf16_kernel<32> at 32. V and O may be narrower than q and k:
// the pairs (D, Dv) the entry takes are pair_ok's (hopper.cuh), Dv = D and
// MLA's (96, 64).
//  * Common to both: TMA loads of Q, K and V tiles into shared memory, each
//    slot with a "full" mbarrier (the TMA's byte count) and an "empty" one
//    (every consumer thread arrives when its products have read the slot),
//    so the next tiles are in flight while the consumers compute. The
//    tensor maps are 4-D over the strided (batch, head, seq) views as the
//    model passes them, encoded on the host per call and passed by value
//    (__grid_constant__), so a CUDA graph keeps them; rows at or beyond S
//    are zero-filled by the TMA. 128-byte swizzle for D = 64 (a bf16 row is
//    128 B), 64-byte for D = 32. A row of 128 (256 B) is wider than the
//    swizzle's span: each tile arrives as two 64-column boxes, two TMA
//    loads into the tile's two halves ([rows][64] each), and the k16 steps
//    of S = Q K^T walk into the second half after four (hopper.cuh:
//    tma_tile, k_step). A q/k row of 96 (192 B) takes D = 128's tiles: its
//    maps are 96 columns wide, so the second box is half out of bounds and
//    the TMA fills its last 32 columns with zeros (no bytes read, only
//    shared memory spent); S = Q K^T skips the two zero k16 steps. V and O
//    at MLA's 64 columns are one 64-column box each (redesigned for Hopper,
//    with the tile order below: the first version padded V to 96 and ran
//    P V over 128 columns, 64 of them zeros, 224 column passes a tile
//    where 160 carry the function): P V is one m64n64 wgmma a step, O 32
//    floats a thread, stored as one box. S = Q K^T is wgmma with both operands read from
//    shared memory through descriptors (Q and K are K-major as they lie);
//    O += P V is wgmma with A = P from registers (the float32 accumulator
//    fragment of S, rounded to bf16 pairs, has the layout of the A register
//    fragment) and V MN-major, read with the transpose bit. S, P and O
//    never leave the registers until the epilogue. The softmax is online,
//    on the accumulator registers: each thread holds two rows of its
//    warp's 16, so a row's max and sum are two shuffles across the quad;
//    ex2.approx of scores scaled by log2(e)/sqrt(D). Only tiles that
//    straddle the diagonal or the window edge evaluate the mask.
//  * flash_bf16_kernel (D = 32): one block owns 128 query rows of one (row,
//    query head), two consumer warpgroups of 64 rows and one producer warp
//    streaming 64-row K/V tiles into a ring of STAGES slots; two blocks
//    share an SM, and within a warpgroup a tile's S, softmax and P V run in
//    turn. Blocks go heaviest first. A warpgroup's loop starts at its
//    window's edge and stops at its diagonal.
//  * flash_ws_kernel<D> (D = 64 and 128, redesigned for Hopper after
//    FlashAttention-3's forward). One block an SM: three warpgroups, a
//    producer that gives its registers up (setmaxnreg.dec 32) and two
//    consumers of 64 rows that take them (232). The consumers take turns
//    at the tensor cores through two named barriers (bar.sync /
//    bar.arrive): warpgroup 0 issues a KV tile's products, then warpgroup 1
//    issues its own while 0 runs its softmax, so the exponentials of one
//    run under the other's products (without the turns: slower at D = 64).
//    Within a warpgroup, tile j's S = Q K^T is issued
//    before tile j - 1's O += P V, and tile j's softmax runs while that
//    product is in flight (wait_group 1); O is rescaled under S. No A
//    fragment is written while a wgmma reading one is in flight, so ptxas
//    serializes nothing (no C751x note). KV tiles of 128 rows (S m64n128,
//    64 floats a thread) in rings of 2 for K and 2 for V with their own
//    barriers, so K_(j+1) loads once S_(j-1) is done and V_j once P V_(j-2)
//    is. P V is one m64nDk16 wgmma a step (at D = 128 over V's two
//    64-column TMA boxes, a descriptor whose leading byte offset spans the
//    halves). Both warpgroups walk all KV tiles of the block's 128 rows (a
//    tile outside one's window is masked whole), so that they take turns
//    evenly. The grid is persistent, one block an SM, each walking output
//    tiles in heaviest-first order dealt out as a snake over the blocks,
//    so that the next tile's loads run under this tile's last products. At
//    G = 1 (grouped_order, hopper.cuh) no two heads share K and V, and that
//    order puts 132 heads' K/V in flight at once (52 MB at minicpm3-4b's
//    shape, the L2's size), each head's tiles rounds apart: there the tiles
//    go grouped by head (TileOrder: pairs of ranks p and n - 1 - p of one
//    head, equal work, head after head, then the last heads heaviest
//    first), 33 heads in flight (at 8 tiles a head), every head's tiles at
//    once (minicpm3-4b's prefill 87.7 -> 73.7 us on an H100; the instance
//    is a template parameter, so the G > 1 launches keep their code). At
//    D = 128 Q has two buffers (the next tile's Q lands under this one); at
//    D = 64 one measured faster. O leaves through shared memory (in the
//    map's 128-byte swizzle) by TMA stores that the producer's warp 1
//    issues once a warpgroup's threads have arrived on its o_full barrier;
//    it frees the buffer (o_free) when the store has read it, so no
//    consumer thread waits on a store. Stored from the registers, 4 bytes a
//    thread with rows 10 KB apart at qwen's shape, the epilogue took a
//    fifth of the kernel. (Not kept, each measured slower: the stores from
//    the consumers or as 16-byte stores from the producer's warps; one
//    stream of KV tiles across a block's output tiles, the next tile's
//    first S issued with the last one's P V; a tile's store held until the
//    next tile's first S, C7517.) FWD_BN, FWD_QBUFS, FWD_PV_N64,
//    FWD_ONE_TILE, FWD_NOEXP, FWD_NOPV, FWD_NOLOAD and FWD_NOSTORE
//    (tools/fwd_breakdown.py) build its variants: 64-row KV tiles, one or
//    two Q buffers, two n64 products at D = 128, one block a tile (no
//    persistence), no exponentials or mask, no P V, no K/V loads after
//    each slot's first, no O stores (the last four wrong by design; with
//    no store ptxas may drop the products no output reads); K1_ORDER=0 / 2
//    (hopper.cuh) the heaviest-first walk at every G, or the grouped one.
//  * float32 inputs have no exact tensor-core path (TF32 would round
//    them), so they take a scalar kernel: one thread per query row (two at
//    D = 96 and 128, each holding half of the row's q and o, their dot products
//    joined by a shuffle), K/V tiles in shared memory read as broadcasts.
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

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
__global__ void __launch_bounds__(THREADS, D > 64 ? 1 : 2)
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
      tma_tile<D>(smem + L::Q, &tq, q_full, a.q_slots, BM, q0, h, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % STAGES;
        if (it >= STAGES) mbar_wait(&empty[st], ((it / STAGES) - 1) & 1);
        mbar_expect_tx(&full[st], 2 * L::TILE);
        tma_tile<D>(smem + L::K + st * L::TILE, &tk, &full[st], a.k_slots, BK, lo + it * BK, kh, b);
        tma_tile<D>(smem + L::V + st * L::TILE, &tv, &full[st], a.v_slots, BK, lo + it * BK, kh, b);
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
  // the warpgroup's rows of Q (of each half at D = 128)
  const uint64_t dq = smem_desc<D>(smem + L::Q + wg * BQ * box_cols<D>() * 2);

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
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(s, k_step<D>(dq, BM, kk), k_step<D>(dk, BK, kk), kk > 0);
    wg_commit();
    wg_wait<0>();
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
    for (int kk = 0; kk < BK / 16; ++kk) mma_rs<D>(o, pa[kk], dv + mn_step<D>() * kk, BK);
    wg_commit();
    wg_wait<0>();
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
// bf16, warp-specialized (flash_ws_kernel<D>, D = 128 and 64): a producer
// warpgroup and two consumer warpgroups that take turns at the tensor cores
// (FlashAttention-3's forward shape).
// ---------------------------------------------------------------------------
#ifndef FWD_BN
#define FWD_BN 128
#endif
namespace ws {
constexpr int BN = FWD_BN;                      // KV rows a tile
constexpr int NTHREADS = 128 * (CONSUMERS + 1); // the consumers, then the producer warpgroup
// At launch ptxas gives a thread 65536 / 384 = 168 registers; the producer
// warpgroup keeps 32 (at 24 its store loop spilled) and the consumers rise
// to 232: (168 - 32) x 128 >= (232 - 168) x 256
constexpr int PRODUCER_REGS = 32, CONSUMER_REGS = 232;
// Slots of the K ring, and of the V ring: two 128-row tiles (three at
// D = 64 measured no faster), or four of 64 rows
constexpr int SLOTS = BN == 64 ? 4 : 2;
// Q buffers: at D = 128 two, so that the next output tile's Q arrives
// under this one's products; at D = 64 one (its tiles are loaded sooner,
// and the second buffer measured slower there). FWD_QBUFS overrides.
template <int D>
__host__ __device__ constexpr int qbufs() {
#ifdef FWD_QBUFS
  return FWD_QBUFS;
#endif
  return D == 128 ? 2 : 1;
}

// Shared memory from a 1024-byte aligned base: the Q buffers (the block's
// 128 rows each), the K ring, the V ring, O (each warpgroup's 64 rows, at
// DV = 128 as two [64][64] halves, for the TMA store), then the barriers.
// D: Q's and K's tiles' width; DV: V's and O's (MLA's 64 beside 96)
template <int D, int DV = D>
struct Layout {
  static constexpr int QBUFS = qbufs<D>();
  static constexpr int TILE = BN * D * 2;     // bytes of one K tile
  static constexpr int V_TILE = BN * DV * 2;  // bytes of one V tile
  static constexpr int Q_TILE = BM * D * 2;
  static constexpr int Q = 0;
  static constexpr int K = Q + QBUFS * Q_TILE;
  static constexpr int V = K + SLOTS * TILE;
  static constexpr int O = V + SLOTS * V_TILE;
  static constexpr int O_WG = BQ * DV * 2;  // bytes of a warpgroup's rows of O
  static constexpr int BAR = O + CONSUMERS * O_WG;
  // full/empty of each K and V slot, q_full/q_empty of each Q buffer,
  // o_full/o_free of each warpgroup's O
  static constexpr int BYTES = BAR + (4 * SLOTS + 2 * QBUFS + 2 * CONSUMERS) * 8 + 1024;
  static_assert(BN == 128 || BN == 64, "FWD_BN is 128 or 64");
  static_assert(BYTES <= 232448, "the block's shared memory exceeds the SM's");
};
}  // namespace ws

// Keeps the compiler from sinking writes of A fragments past the
// wgmma.fence that precedes the wgmma reading them.
template <int KS>
__device__ __forceinline__ void fence_frag(uint32_t (&r)[KS][4]) {
#pragma unroll
  for (int i = 0; i < KS; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// S = Q K^T for one warpgroup: 64 x BN over DK / 16 k16 steps, both operands
// K-major in shared memory (at D = 128 their halves BM and BN rows on,
// hopper.cuh k_step). DK < D: the tiles' columns past DK are zeros (head
// dim 96 on D = 128's tiles), so their steps are skipped.
template <int D, int DK = D>
__device__ __forceinline__ void ws_qk(float* s, uint64_t dq, uint64_t dk) {
#pragma unroll
  for (int kk = 0; kk < DK / 16; ++kk) {
    if constexpr (ws::BN == 128)
      wgmma_ss_n128(s, k_step<D>(dq, BM, kk), k_step<D>(dk, ws::BN, kk), kk > 0);
    else
      wgmma_ss_n64(s, k_step<D>(dq, BM, kk), k_step<D>(dk, ws::BN, kk), kk > 0);
  }
}

// O += P V for one warpgroup: BN / 16 k16 steps of 16 rows of the V tile at
// `v`, P the A fragments. At D = 128 one m64n128 product a step over both
// halves of V (a descriptor whose leading byte offset spans them; with
// FWD_PV_N64, two m64n64 products a step, one a half); at D = 64 one m64n64.
template <int D>
__device__ __forceinline__ void ws_pv(float* o, uint32_t (*p)[4], const uint8_t* v) {
#ifdef FWD_NOPV
  return;
#endif
#pragma unroll
  for (int kk = 0; kk < ws::BN / 16; ++kk) {
#ifndef FWD_PV_N64
    if constexpr (D == 128)
      wgmma_rs_n128(o, p[kk], smem_desc_n128(v, ws::BN) + mn_step<128>() * kk);
    else
#endif
      mma_rs<D>(o, p[kk], smem_desc<D>(v) + mn_step<D>() * kk, ws::BN);
  }
}

// The online softmax of one tile on the S accumulator (this thread's rows
// qp0, qp1 and its columns from key k0 + c0): the mask unless every pair of
// the warpgroup's rows and the tile is valid, the rows' new max m (log2
// units) and the factor al by which their O and l shrink, then s = P
// (ex2 of the scaled scores less m) and l's new value. A row with no valid
// key yet keeps m = -inf and subtracts 0, so that its masked scores give
// exp2(-inf) = 0 and not NaN.
template <int NS>
__device__ __forceinline__ void ws_softmax(float* s, float& m0, float& m1, float& l0, float& l1,
                                             float& al0, float& al1, bool full, int qp0, int qp1,
                                             int k0, int c0, int window, float scale_log2) {
#ifndef FWD_NOEXP
  if (!full) {
#pragma unroll
    for (int n = 0; n < NS / 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = k0 + 8 * n + c0 + (e & 1);
        if (!valid_pair(e < 2 ? qp0 : qp1, kp, window)) s[n * 4 + e] = -INFINITY;
      }
  }
#endif
  float x0 = -INFINITY, x1 = -INFINITY;
#pragma unroll
  for (int n = 0; n < NS / 4; ++n) {
    x0 = fmaxf(x0, fmaxf(s[n * 4], s[n * 4 + 1]));
    x1 = fmaxf(x1, fmaxf(s[n * 4 + 2], s[n * 4 + 3]));
  }
  x0 = fmaxf(x0, __shfl_xor_sync(0xffffffffu, x0, 1));
  x0 = fmaxf(x0, __shfl_xor_sync(0xffffffffu, x0, 2));
  x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, 1));
  x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, 2));
  const float n0 = fmaxf(m0, x0 * scale_log2), n1 = fmaxf(m1, x1 * scale_log2);
  const float u0 = n0 == -INFINITY ? 0.f : n0, u1 = n1 == -INFINITY ? 0.f : n1;
  al0 = ex2(m0 - u0);
  al1 = ex2(m1 - u1);
  m0 = n0;
  m1 = n1;
  float p0 = 0.f, p1 = 0.f;
#pragma unroll
  for (int n = 0; n < NS / 4; ++n) {
#ifdef FWD_NOEXP
    s[n * 4 + 0] = fmaf(s[n * 4 + 0], scale_log2, -u0);
    s[n * 4 + 1] = fmaf(s[n * 4 + 1], scale_log2, -u0);
    s[n * 4 + 2] = fmaf(s[n * 4 + 2], scale_log2, -u1);
    s[n * 4 + 3] = fmaf(s[n * 4 + 3], scale_log2, -u1);
#else
    s[n * 4 + 0] = ex2(fmaf(s[n * 4 + 0], scale_log2, -u0));
    s[n * 4 + 1] = ex2(fmaf(s[n * 4 + 1], scale_log2, -u0));
    s[n * 4 + 2] = ex2(fmaf(s[n * 4 + 2], scale_log2, -u1));
    s[n * 4 + 3] = ex2(fmaf(s[n * 4 + 3], scale_log2, -u1));
#endif
    p0 += s[n * 4 + 0] + s[n * 4 + 1];
    p1 += s[n * 4 + 2] + s[n * 4 + 3];
  }
  l0 = l0 * al0 + p0;  // this thread's part of the row sums
  l1 = l1 * al1 + p1;
}

// The 64 x BN accumulator as the A fragments of BN / 16 k16 steps, rounded
// to bf16: columns 16kk .. 16kk+15 are its n8 blocks 2kk and 2kk+1.
template <int KS>
__device__ __forceinline__ void acc_to_a(uint32_t (&r)[KS][4], const float* c) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    r[kk][0] = pack_bf16(c[8 * kk + 0], c[8 * kk + 1]);
    r[kk][1] = pack_bf16(c[8 * kk + 2], c[8 * kk + 3]);
    r[kk][2] = pack_bf16(c[8 * kk + 4], c[8 * kk + 5]);
    r[kk][3] = pack_bf16(c[8 * kk + 6], c[8 * kk + 7]);
  }
}

template <int NO>
__device__ __forceinline__ void rescale(float* o, float al0, float al1) {
#pragma unroll
  for (int n = 0; n < NO / 4; ++n) {
    o[n * 4 + 0] *= al0;
    o[n * 4 + 1] *= al0;
    o[n * 4 + 2] *= al1;
    o[n * 4 + 3] *= al1;
  }
}

// A tile's place: tile i of the walk over the B H heads (head b H + h)
// and their n_qt query tiles, rank 0 the heaviest (the last query rows of
// each (row, head), which walk the most KV tiles): heaviest first (rank i
// / (B H)) or grouped by head (TileOrder, hopper.cuh); the KV tiles [lo,
// lo + n BN) both warpgroups walk, from the window's edge of the block's
// first row to the diagonal of its last.
template <bool GROUPED>
struct WsTile {
  int q0, h, b, lo, n;
  __device__ __forceinline__ WsTile(int i, const TileOrder& ord, int B, int n_qt,
                                    const TmaArgs& a) {
    int head, rank;
    if constexpr (GROUPED) {
      ord.at(i, &head, &rank);
    } else {
      rank = i / (a.H * B);
      head = i % (a.H * B);
    }
    q0 = (n_qt - 1 - rank) * BM;
    h = head % a.H;
    b = head / a.H;
    int hi;
    kv_range(q0, a.S, a.window, ws::BN, &lo, &hi);
    hi = min(q0 + BM, a.S);
    n = (hi - lo + ws::BN - 1) / ws::BN;
  }
};

// Grid: one block an SM (at most one a tile), each walking its share of
// the B H ceil(S / BM) output tiles heaviest first (snake_tile) or, with
// GROUPED (at grouped_order(G)), grouped by head (TileOrder);
// ws::NTHREADS threads; ws::Layout<D, DV>::BYTES of dynamic shared memory.
// D is Q's and K's tiles' width and DK the head dim (DK = 96 on D = 128:
// the maps' rows are 96 wide, so the TMA fills each tile's columns 96-127
// with zeros); DV is V's and O's tiles' width, 64 for MLA's V (one
// 64-column box: P V one m64n64 product a step, O 32 floats a thread,
// stored as one box), or D (at DK = 96 the zero-filled columns of a padded
// V, of which O stores the first 96). Warpgroups
// 0 and 1 consume query rows [q0 + 64 wg, + 64) of each tile; warpgroup 2
// is the producer, whose first thread issues the TMA loads. The K and V
// rings run on across the block's tiles, and the next tile's Q is loaded
// once the consumers' last S = Q K^T of this one is done, so that the
// next tile's loads run under this tile's last P V and its epilogue.
template <int D, int DK = D, int DV = D, bool GROUPED = false>
__global__ void __launch_bounds__(ws::NTHREADS, 1)
    flash_ws_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap to, TmaArgs a, int o_slots, int B) {
  using namespace ws;
  using L = Layout<D, DV>;
  constexpr int TILE = L::TILE, V_TILE = L::V_TILE, Q = L::Q, K = L::K, V = L::V, O = L::O,
                O_WG = L::O_WG, BAR = L::BAR, Q_TILE = L::Q_TILE, QBUFS = L::QBUFS;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full_k = reinterpret_cast<uint64_t*>(smem + BAR);
  uint64_t* empty_k = full_k + SLOTS;
  uint64_t* full_v = empty_k + SLOTS;
  uint64_t* empty_v = full_v + SLOTS;
  uint64_t* q_full = empty_v + SLOTS;
  uint64_t* q_empty = q_full + QBUFS;
  uint64_t* o_full = q_empty + QBUFS;       // a warpgroup's O is in shared memory
  uint64_t* o_free = o_full + CONSUMERS;    // its store has read it
  const int n_qt = (a.S + BM - 1) / BM;
  const int total = n_qt * a.H * B;
  const TileOrder ord(a.H * B, n_qt, gridDim.x, blockIdx.x);  // (GROUPED)
  // the block's k-th output tile, -1 past its last
  auto tile_of = [&](int k) {
    if constexpr (GROUPED)
      return ord.of_block(k);
    else
      return snake_tile(k, total);
  };
  const int warp = warp_index();

  if (threadIdx.x == 0) {
    for (int i = 0; i < SLOTS; ++i) {
      mbar_init(&full_k[i], 1);
      mbar_init(&empty_k[i], 128 * CONSUMERS);
      mbar_init(&full_v[i], 1);
      mbar_init(&empty_v[i], 128 * CONSUMERS);
    }
    for (int i = 0; i < QBUFS; ++i) {
      mbar_init(&q_full[i], 1);
      mbar_init(&q_empty[i], 128 * CONSUMERS);
    }
    for (int i = 0; i < CONSUMERS; ++i) {
      mbar_init(&o_full[i], 128);
      mbar_init(&o_free[i], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * CONSUMERS) {  // producer warpgroup
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 128 * CONSUMERS + 32) {  // warp 1: each tile's O, as TMA stores
      for (int k = 0, i; (i = tile_of(k)) >= 0; ++k) {
        const WsTile<GROUPED> t(i, ord, B, n_qt, a);
        for (int wg = 0; wg < CONSUMERS; ++wg) {
          mbar_wait(&o_full[wg], k & 1);
#ifndef FWD_NOSTORE
          if (t.q0 + wg * BQ < a.S) {  // (rows past S are not written)
#pragma unroll
            for (int c = 0; c < DV; c += 64)
              tma_store(&to, smem + O + wg * O_WG + (c / 64) * (BQ * 128), o_slots,
                        t.q0 + wg * BQ, t.h, t.b, c);
          }
#endif
          bulk_commit();
        }
        bulk_wait_read<1>();
        mbar_arrive(&o_free[0]);
        bulk_wait_read<0>();
        mbar_arrive(&o_free[1]);
      }
      bulk_wait<0>();  // the last stores are done before the block leaves
    }
    // warp 0: per tile Q, then K_0, then K_it and V_(it-1) in turn
    if (threadIdx.x == 128 * CONSUMERS) {
      int kv = 0;  // K (and V) tiles loaded before this output tile
      for (int k = 0, i; (i = tile_of(k)) >= 0; ++k) {
        const WsTile<GROUPED> t(i, ord, B, n_qt, a);
        const int kh = t.h / (a.H / a.K);
        const int qb = k % QBUFS;
        if (k >= QBUFS) mbar_wait(&q_empty[qb], ((k / QBUFS) - 1) & 1);
        mbar_expect_tx(&q_full[qb], Q_TILE);
        tma_tile<D>(smem + Q + qb * Q_TILE, &tq, &q_full[qb], a.q_slots, BM, t.q0, t.h, t.b);
        for (int it = 0; it <= t.n; ++it) {
          if (it < t.n) {
            const int j = kv + it, st = j % SLOTS;
            if (j >= SLOTS) mbar_wait(&empty_k[st], ((j / SLOTS) - 1) & 1);
#ifdef FWD_NOLOAD
            if (j >= SLOTS) {  // the slot keeps its first tile: no load
              mbar_arrive(&full_k[st]);
            } else
#endif
            {
              mbar_expect_tx(&full_k[st], TILE);
              tma_tile<D>(smem + K + st * TILE, &tk, &full_k[st], a.k_slots, BN, t.lo + it * BN,
                          kh, t.b);
            }
          }
          if (it > 0) {
            const int j = kv + it - 1, st = j % SLOTS;
            if (j >= SLOTS) mbar_wait(&empty_v[st], ((j / SLOTS) - 1) & 1);
#ifdef FWD_NOLOAD
            if (j >= SLOTS) {
              mbar_arrive(&full_v[st]);
            } else
#endif
            {
              mbar_expect_tx(&full_v[st], V_TILE);
              tma_tile<DV>(smem + V + st * V_TILE, &tv, &full_v[st], a.v_slots, BN,
                           t.lo + (it - 1) * BN, kh, t.b);
            }
          }
        }
        kv += t.n;
      }
    }
    return;
  }
  setmaxnreg_inc<CONSUMER_REGS>();

  // consumer warpgroup wg. Both walk all t.n KV tiles of each output tile
  // (a tile outside a warpgroup's window is masked whole), so that they
  // take turns evenly: warpgroup wg issues its products after
  // bar_sync(1 + wg) and then lets the other issue theirs (bar_arrive(2 -
  // wg)), so one warpgroup's softmax runs under the other's products.
  // Within a warpgroup, KV tile it's S = Q K^T is issued before tile
  // it - 1's O += P V, and tile it's softmax runs while that product is in
  // flight.
  constexpr int NS = BN / 2;  // S accumulator floats a thread
  constexpr int NO = DV / 2;  // O accumulator floats a thread
  constexpr int KS = BN / 16; // k16 steps of P V
  const int wg = warp / 4, t128 = threadIdx.x % 128, lane = threadIdx.x % 32;
  // this thread's rows (of the warpgroup's 64) and its first key column:
  // s[n*4 + i*2 + j] is row r0 + 8i, key k0 + 8n + c0 + j
  const int r0 = (t128 / 32) * 16 + lane / 4;
  const int c0 = 2 * (lane % 4);
  const int mine = 1 + wg, theirs = 2 - wg;
  const uint64_t dk0 = smem_desc<D>(smem + K);
  // the warpgroup's rows of Q buffer qb (of each half)
  auto q_desc = [&](int qb) {
    return smem_desc<D>(smem + Q + qb * Q_TILE + wg * BQ * box_cols<D>() * 2);
  };

  float o[NO], s[NS];
  uint32_t p[KS][4];
#pragma unroll
  for (int i = 0; i < NS; ++i) s[i] = 0.f;
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;

  // The epilogue of the block's k-th output tile t, whose O is in o: the
  // rows' logsumexp, then O through shared memory, the warpgroup's rows as
  // the map's 128-byte swizzle lays them (16-byte piece c of row r at
  // piece c ^ (r % 8), so a quad's 16 bytes of 8 rows hit 8 distinct
  // banks). The producer's warp 1 stores them by TMA once every thread has
  // arrived on o_full, and frees the buffer (o_free) when its store has
  // read it: no thread of the consumers waits on a store.
  auto epilogue = [&](int k, const WsTile<GROUPED>& t, float m0, float m1, float l0, float l1) {
    const int qp0 = t.q0 + wg * BQ + r0, qp1 = qp0 + 8;
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
    if (a.lse != nullptr && lane % 4 == 0) {
      // m is in log2 units of the scaled scores: lse = (m + log2 l) ln 2
      float* lb = a.lse + ((long long)t.b * a.H + t.h) * a.S;
      if (qp0 < a.S) lb[qp0] = (m0 + log2f(fmaxf(l0, 1e-30f))) * 0.6931471805599453f;
      if (qp1 < a.S) lb[qp1] = (m1 + log2f(fmaxf(l1, 1e-30f))) * 0.6931471805599453f;
    }
    uint8_t* ow = smem + O + wg * O_WG;
    if (k > 0) mbar_wait(&o_free[wg], (k - 1) & 1);
#ifndef FWD_NOSTORE
#pragma unroll
    for (int n = 0; n < DV / 8; ++n) {
      uint8_t* half = ow + (n / 8) * (BQ * 128);
      const int piece = n % 8, off = c0 * 2;
      *reinterpret_cast<uint32_t*>(half + r0 * 128 + ((piece ^ (r0 % 8)) * 16) + off) =
          pack_bf16(o[n * 4 + 0] * inv0, o[n * 4 + 1] * inv0);
      *reinterpret_cast<uint32_t*>(half + (r0 + 8) * 128 + ((piece ^ ((r0 + 8) % 8)) * 16) + off) =
          pack_bf16(o[n * 4 + 2] * inv1, o[n * 4 + 3] * inv1);
    }
#endif
    fence_proxy_async();
    mbar_arrive(&o_full[wg]);
  };

  if (wg == 1) bar_arrive(1, 256);  // warpgroup 0 goes first
  int kv = 0;  // K (and V) tiles consumed before this output tile
  for (int k = 0, i; (i = tile_of(k)) >= 0; ++k) {
    const WsTile<GROUPED> t(i, ord, B, n_qt, a);
    // warpgroup 1's last turn of the block hands on nothing
    const bool last_tile = tile_of(k + 1) < 0;
    const int q0w = t.q0 + wg * BQ;
    const int qp0 = q0w + r0, qp1 = qp0 + 8;
    const int qb = k % QBUFS;
    const uint64_t dq = q_desc(qb);
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f, al0 = 1.f, al1 = 1.f;
#pragma unroll
    for (int j = 0; j < NO; ++j) o[j] = 0.f;

    mbar_wait(&q_full[qb], (k / QBUFS) & 1);
    // KV tile 0: S alone
    {
      const int st = kv % SLOTS;
      mbar_wait(&full_k[st], (kv / SLOTS) & 1);
      bar_sync(mine, 256);
      fence_regs<NS>(s);
      wg_fence();
      ws_qk<D, DK>(s, dq, dk0 + (uint64_t)((st * TILE) >> 4));
      wg_commit();
      if (wg == 0 || !(last_tile && t.n == 1)) bar_arrive(theirs, 256);
      wg_wait<0>();
      fence_regs<NS>(s);
      mbar_arrive(&empty_k[st]);
      if (t.n == 1) mbar_arrive(&q_empty[qb]);  // Q is read
      ws_softmax<NS>(s, m0, m1, l0, l1, al0, al1, tile_full(q0w, t.lo, BN, a.window), qp0,
                     qp1, t.lo, c0, a.window, a.scale_log2);
      acc_to_a<KS>(p, s);
    }
    for (int it = 1; it < t.n; ++it) {
      const int sk = (kv + it) % SLOTS, sv = (kv + it - 1) % SLOTS;
      const int k0 = t.lo + it * BN;
      mbar_wait(&full_k[sk], ((kv + it) / SLOTS) & 1);
      bar_sync(mine, 256);
      fence_regs<NS>(s);
      wg_fence();
      ws_qk<D, DK>(s, dq, dk0 + (uint64_t)((sk * TILE) >> 4));
      wg_commit();
      rescale<NO>(o, al0, al1);  // under S: tile it - 1's factor
      mbar_wait(&full_v[sv], ((kv + it - 1) / SLOTS) & 1);
      fence_regs<NO>(o);
      fence_frag(p);
      wg_fence();
      ws_pv<DV>(o, p, smem + V + sv * V_TILE);
      wg_commit();
      if (wg == 0 || !(last_tile && it == t.n - 1)) bar_arrive(theirs, 256);
      wg_wait<1>();  // S of tile it is in; its P V in flight
      fence_regs<NS>(s);
      mbar_arrive(&empty_k[sk]);
      if (it == t.n - 1) mbar_arrive(&q_empty[qb]);  // Q is read
      ws_softmax<NS>(s, m0, m1, l0, l1, al0, al1, tile_full(q0w, k0, BN, a.window), qp0,
                     qp1, k0, c0, a.window, a.scale_log2);
      wg_wait<0>();
      fence_regs<NO>(o);
      mbar_arrive(&empty_v[sv]);
      acc_to_a<KS>(p, s);
    }
    // the last KV tile's P V
    const int sv = (kv + t.n - 1) % SLOTS;
    rescale<NO>(o, al0, al1);
    mbar_wait(&full_v[sv], ((kv + t.n - 1) / SLOTS) & 1);
    fence_regs<NO>(o);
    fence_frag(p);
    wg_fence();
    ws_pv<DV>(o, p, smem + V + sv * V_TILE);
    wg_commit();
    wg_wait<0>();
    fence_regs<NO>(o);
    mbar_arrive(&empty_v[sv]);
    kv += t.n;
    epilogue(k, t, m0, m1, l0, l1);
  }
}

// ---------------------------------------------------------------------------
// float32: scalar FMA, one thread per query row (f32_tpr<D>() threads: each
// holds DP = D / f32_tpr<D>() columns of the row's q and VP = DV /
// f32_tpr<D>() of its o; DV, V's width, is D or MLA's 64 beside 96), 64
// rows a block.
// ---------------------------------------------------------------------------
template <int D>
__host__ __device__ constexpr int f32_tpr() {
  return D > 64 ? 2 : 1;
}

template <int D, int DV = D>
__global__ void __launch_bounds__(BQ * f32_tpr<D>()) flash_f32_kernel(Args a) {
  constexpr int TPR = f32_tpr<D>(), DP = D / TPR, VP = DV / TPR;
  __shared__ __align__(16) float k_s[BKS][D];
  __shared__ __align__(16) float v_s[BKS][DV];

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (a.H / a.K);
  const int q0 = qt * BQ;
  const int qpos = q0 + threadIdx.x / TPR;
  const int d0 = (threadIdx.x % TPR) * DP;  // this thread's first column of q
  const int v0 = (threadIdx.x % TPR) * VP;  // and of v and o
  const bool active = qpos < a.S;
  const float* q = static_cast<const float*>(a.q) + b * a.qs.b + h * a.qs.h;
  const float* k = static_cast<const float*>(a.k) + b * a.ks.b + kh * a.ks.h;
  const float* v = static_cast<const float*>(a.v) + b * a.vs.b + kh * a.vs.h;
  float* o = static_cast<float*>(a.o) + b * a.os.b + h * a.os.h;

  float qr[DP], acc[VP];
#pragma unroll
  for (int d = 0; d < DP; ++d) qr[d] = active ? q[qpos * a.qs.s + d0 + d] * a.scale : 0.f;
#pragma unroll
  for (int d = 0; d < VP; ++d) acc[d] = 0.f;
  float m_run = NEG_INF, l_run = 0.f;

  int lo, hi;
  kv_range(q0, a.S, a.window, BKS, &lo, &hi);
  for (int k0 = lo; k0 < hi; k0 += BKS) {
    __syncthreads();
    for (int i = threadIdx.x; i < BKS * D / 4; i += blockDim.x) {
      const int r = i / (D / 4), c = (i % (D / 4)) * 4;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k0 + r < a.S) kv = *reinterpret_cast<const float4*>(k + (k0 + r) * a.ks.s + c);
      *reinterpret_cast<float4*>(&k_s[r][c]) = kv;
    }
    for (int i = threadIdx.x; i < BKS * DV / 4; i += blockDim.x) {
      const int r = i / (DV / 4), c = (i % (DV / 4)) * 4;
      float4 vv = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k0 + r < a.S) vv = *reinterpret_cast<const float4*>(v + (k0 + r) * a.vs.s + c);
      *reinterpret_cast<float4*>(&v_s[r][c]) = vv;
    }
    __syncthreads();
    // (with TPR > 1 every thread goes on: the shuffles below need the
    // whole warp; a row past S computes on zeros and writes nothing)
    if (TPR == 1 && !active) continue;

    const bool full = tile_full(q0, k0, BKS, a.window);
    float s[BKS];
    float tmax = NEG_INF;
#pragma unroll
    for (int j = 0; j < BKS; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < DP; d += 4) {
        const float4 kk = *reinterpret_cast<const float4*>(&k_s[j][d0 + d]);
        dot += qr[d] * kk.x + qr[d + 1] * kk.y + qr[d + 2] * kk.z + qr[d + 3] * kk.w;
      }
#pragma unroll
      for (int off = TPR / 2; off > 0; off /= 2) dot += __shfl_xor_sync(0xffffffffu, dot, off);
      s[j] = dot;
      if (full || valid_pair(qpos, k0 + j, a.window)) tmax = fmaxf(tmax, dot);
    }
    const float m_new = fmaxf(m_run, tmax);
    const float alpha = expf(m_run - m_new);
    l_run *= alpha;
#pragma unroll
    for (int d = 0; d < VP; ++d) acc[d] *= alpha;
#pragma unroll
    for (int j = 0; j < BKS; ++j) {
      const bool ok = full || valid_pair(qpos, k0 + j, a.window);
      const float p = ok ? expf(s[j] - m_new) : 0.f;
      l_run += p;
#pragma unroll
      for (int d = 0; d < VP; d += 4) {
        const float4 vv = *reinterpret_cast<const float4*>(&v_s[j][v0 + d]);
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
    for (int d = 0; d < VP; ++d) o[qpos * a.os.s + v0 + d] = acc[d] * inv;
    if (a.lse != nullptr && d0 == 0)
      a.lse[((long long)b * a.H + h) * a.S + qpos] = m_run + logf(fmaxf(l_run, 1e-30f));
  }
}

}  // namespace

namespace {

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

// The warp-specialized bf16 forward: tensor maps of 128-row Q boxes and
// BN-row K boxes DK columns wide (the head dim; D the tiles' width), BN-row
// V and 64-row O boxes as wide as V's rows (DV's tiles; DK where DV is D's
// padded width). Once per device: its shared memory above 48 KB, and the
// check that its register count at launch leaves room for the consumers'
// setmaxnreg.inc from what the producer gives up (an increase the pool
// cannot serve would never return).
template <int D, int DK = D, int DV = D, bool GROUPED = false>
int launch_ws(const Args& a, int B, cudaStream_t st) {
  using namespace ws;
  constexpr int BYTES = Layout<D, DV>::BYTES, VW = DV < DK ? DV : DK;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaSetDevice(dev);  // bind the primary context
  if (err != cudaSuccess) return (int)err;
  CUtensorMap tq, tk, tv;
  TmaArgs t;
  int rc = encode(&tq, a.q, DK, a.S, a.H, B, a.qs.s, a.qs.h, a.qs.b, BM, &t.q_slots);
  if (!rc) rc = encode(&tk, a.k, DK, a.S, a.K, B, a.ks.s, a.ks.h, a.ks.b, BN, &t.k_slots);
  if (!rc) rc = encode(&tv, a.v, VW, a.S, a.K, B, a.vs.s, a.vs.h, a.vs.b, BN, &t.v_slots);
  CUtensorMap to;
  int o_slots = 0;
  if (!rc) rc = encode(&to, a.o, VW, a.S, a.H, B, a.os.s, a.os.h, a.os.b, BQ, &o_slots);
  if (rc) return rc;
  t.o = static_cast<bf16*>(a.o);
  t.lse = a.lse;
  t.os = a.os;
  t.H = a.H;
  t.K = a.K;
  t.S = a.S;
  t.window = a.window;
  t.scale_log2 = a.scale * 1.4426950408889634f;
  static unsigned long long ready = 0;
  static int sms[64];  // SMs of each device: the persistent grid's blocks
  if (dev >= 64 || !(ready >> dev & 1)) {
    int n = 0;
    if ((err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return (int)err;
    sms[dev < 64 ? dev : 0] = n;
    err = cudaFuncSetAttribute(flash_ws_kernel<D, DK, DV, GROUPED>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, BYTES);
    if (err != cudaSuccess) return (int)err;
    cudaFuncAttributes attr;
    if ((err = cudaFuncGetAttributes(&attr, flash_ws_kernel<D, DK, DV, GROUPED>)) != cudaSuccess)
      return (int)err;
    const int r = attr.numRegs;
    if (r > CONSUMER_REGS || r < PRODUCER_REGS ||
        (r - PRODUCER_REGS) * 128 < (CONSUMER_REGS - r) * 128 * CONSUMERS)
      return (int)cudaErrorInvalidConfiguration;
    if (dev < 64) ready |= 1ull << dev;
  }
  const int tiles = (a.S + BM - 1) / BM * a.H * B;
#ifdef FWD_ONE_TILE
  const int grid = tiles;
#else
  const int grid = tiles < sms[dev < 64 ? dev : 0] ? tiles : sms[dev < 64 ? dev : 0];
#endif
  flash_ws_kernel<D, DK, DV, GROUPED><<<grid, NTHREADS, BYTES, st>>>(tq, tk, tv, to, t, o_slots, B);
  return (int)cudaGetLastError();
}

// flash_ws_kernel at (D, Dv), its tiles grouped by head or not: <128> at
// 128, <128, 96, 64> at MLA's (96, 64), <128, 96> at 96 (V padded to 96, on
// 128's tiles), <64> at 64.
template <bool GROUPED>
int launch_ws_as(int D, int Dv, const Args& a, int B, cudaStream_t st) {
  if (D == 128) return launch_ws<128, 128, 128, GROUPED>(a, B, st);
  if (D == 96 && Dv == 64) return launch_ws<128, 96, 64, GROUPED>(a, B, st);
  if (D == 96) return launch_ws<128, 96, 128, GROUPED>(a, B, st);
  if (D == 64) return launch_ws<64, 64, 64, GROUPED>(a, B, st);
  return (int)cudaErrorInvalidValue;
}
int launch_ws_at(int D, int Dv, bool grouped, const Args& a, int B, cudaStream_t st) {
  return grouped ? launch_ws_as<true>(D, Dv, a, B, st) : launch_ws_as<false>(D, Dv, a, B, st);
}

// Which bf16 kernel runs at head dim D with G = H / K query heads a KV
// head and a window (0: none): flash_ws_kernel where this holds (at D = 96,
// MLA's qk head dim, on D = 128's tiles), flash_bf16_kernel<D> elsewhere
// (kernels/flash_attention.py fwd_kernel mirrors it). At D = 64
// flash_ws_kernel was measured faster than flash_bf16_kernel at every G and
// window the models run (PERF.md), so the rule rests on D alone.
bool ws_route(int D, int G, int window) {
  return D == 128 || D == 96 || D == 64;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. v and o are Dv columns wide, the scale
// 1 / sqrt(D). lse: float32 [B,H,S] (contiguous) for the rows'
// logsumexp, or null. Returns a cudaError_t.
extern "C" int repro_flash_attention_v(
    const void* q, const void* k, const void* v, void* o, float* lse,
    int B, int H, int K, int S, int D, int Dv,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss,
    int window, int dtype, void* stream) {
  if (B < 1 || S < 1 || K < 1 || H % K != 0 || !pair_ok(D, Dv))
    return (int)cudaErrorInvalidValue;
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
  const bool ws = dtype == 1 && ws_route(D, H / K, window);
  if (ws) return launch_ws_at(D, Dv, grouped_order(H / K), a, B, st);
  if (dtype == 1 && !ws && D == 32) return launch_bf16<32>(a, B, st);
  constexpr int wide = BQ * f32_tpr<128>();  // threads a float32 block at D = 96 and 128
  if (dtype == 0 && D == 128) {
    flash_f32_kernel<128><<<grid, wide, 0, st>>>(a);
  } else if (dtype == 0 && D == 96 && Dv == 64) {
    flash_f32_kernel<96, 64><<<grid, wide, 0, st>>>(a);
  } else if (dtype == 0 && D == 96) {
    flash_f32_kernel<96><<<grid, wide, 0, st>>>(a);
  } else if (dtype == 0 && D == 64) {
    flash_f32_kernel<64><<<grid, BQ, 0, st>>>(a);
  } else if (dtype == 0 && D == 32) {
    flash_f32_kernel<32><<<grid, BQ, 0, st>>>(a);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The entry with v as wide as q (Dv = D), and the logsumexp.
extern "C" int repro_flash_attention_lse(
    const void* q, const void* k, const void* v, void* o, float* lse,
    int B, int H, int K, int S, int D,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss,
    int window, int dtype, void* stream) {
  return repro_flash_attention_v(q, k, v, o, lse, B, H, K, S, D, D, q_sb, q_sh, q_ss, k_sb,
                                 k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss, window, dtype,
                                 stream);
}

// The forward alone (no logsumexp), v as wide as q: the prefill's entry.
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
