// The backward of causal GQA flash attention (K1) for NVIDIA Hopper (sm_90a).
//
// Replaces: no Pallas kernel. The JAX package differentiates the plain-XLA
// models/layers.py chunked_attention with jax.value_and_grad (steps.py); the
// port's training step runs K1's forward (flash_attention.cu) on every
// layer, so its gradient is this kernel. Its plain version is
// kernels/ref.py flash_attention_bwd.
//
// Computes, per (row, query head h, KV head h / G) with s = q k^T / sqrt(D)
// under K1's mask (kpos <= qpos, qpos - kpos < window), the forward's
// logsumexp lse and its output o, and the output's gradient dO:
//   P = exp(s - lse), dV = P^T dO, dP = dO V^T, Dr = rowsum(dO o),
//   dS = P (dP - Dr), dQ = dS K / sqrt(D), dK = dS^T Q / sqrt(D),
// with dK and dV summed over the G query heads of each KV head.
//
// Bound: five products of K1's size (S, dP, dV, dK, dQ: 2.5x the forward's
// work, 10 B H S^2 D / 2 FLOP causal) against reading q, k, v, o, dO and
// writing dq, dk, dv once: operations, at the tensor cores' rate, which
// only wgmma reaches.
//
// Deterministic: no atomics. Each output row is owned by one block, which
// sums its terms in a fixed order, so two runs on the same inputs agree bit
// for bit (the port's recovery is held byte for byte to an uninterrupted
// run). That is why there are two kernels and not one: a fused kernel would
// do five products, but its dQ rows would be summed across the blocks of
// the KV tiles, by atomics (an order that changes from run to run) or by
// waits between blocks. The cost of determinism is S and dP computed in
// both kernels: seven products instead of five, 7/5 of the bound.
//
// Design (bf16), on the forward's machinery (flash_attention.cu):
//  * dQ, launched first (at D <= 64; D = 128 below): a block owns 192
//    query rows of one (b, query head): three consumer warpgroups of 64
//    rows and a producer warpgroup.
//    One producer thread issues TMA loads of Q, dO and O once, then the KV
//    head's K and V tiles of 64 rows into a ring of STAGES slots, each with
//    a "full" mbarrier (the TMA's bytes) and an "empty" one (every consumer
//    thread arrives when its products have read the slot). The prologue
//    takes each row's Dr = rowsum(dO o) in float32 from the O and dO tiles
//    in shared memory (two threads a row; the swizzle permutes 16-byte
//    chunks within a row the same way in both tiles, so a row's products
//    pair up as they are) and writes it to a float32 [B,H,S] buffer for the
//    dK/dV kernel: no launch of its own. Per KV tile: S = Q K^T and dP =
//    dO V^T by wgmma with both operands in shared memory (K-major, as they
//    lie); P = ex2(s log2e / sqrt(D) - lse log2e) and dS = P (dP - Dr) on
//    the accumulator registers; dQ += dS K by wgmma with A = dS rounded to
//    bf16 pairs from registers (the accumulator fragment has the layout of
//    the A fragment) and B = the same K tile read MN-major through the
//    transpose bit. The loop runs from the window's edge to the diagonal;
//    only tiles that straddle an edge evaluate the mask; blocks go
//    heaviest first.
//  * dK/dV, launched second: a block owns 128 KV rows of one (b, KV head),
//    two consumer warpgroups of 64 rows, K and V loaded once by TMA. The
//    producer's first warp streams, for gi = 0..G-1 and then the query
//    tiles in order, head kh G + gi's Q and dO tiles of kv_bn<D>() rows
//    (64; 32 at D = 128) into the ring, with that tile's lse (times log2e)
//    and Dr in a per-slot float32
//    vector (written by the warp's 32 lanes, 0 past S, each lane arriving
//    on the full barrier after its stores). Per tile: S^T = K Q^T and dP^T
//    = V dO^T (wgmma, K-major both), P^T and dS^T on the registers with lse
//    and Dr indexed by column, then dV += P^T dO and dK += dS^T Q (wgmma, A
//    from registers, dO and Q read MN-major). dK and dV stay in registers
//    for the whole walk and are written once. The sum order is fixed: gi
//    outer, the query tile inner. Heaviest blocks (the low KV tiles) first.
//  * One tile of look-ahead in both: a warpgroup commits the next tile's
//    two products and this tile's second product(s) as one group, so the
//    tensor cores get them back to back and it waits once a tile. The A
//    fragments are pinned before the wgmma.fence, or ptxas fences the
//    group again in the middle. Overlapping this tile's second product
//    with the next tile's exponentials would write A fragments while a
//    wgmma reading others is in flight, and ptxas then serializes every
//    wgmma (C7513): not done.
//  * Registers: one block an SM. The producer warpgroup gives its
//    registers up (setmaxnreg.dec to 24) and the consumers take them: dK/dV
//    (two consumer warpgroups, 168 at launch) holds four 64 x 64 float32
//    accumulators, 128 registers a thread, and rises to 240; dQ holds
//    three and, on three warpgroups (128 at launch), rises to 160. No
//    spills. The launch checks first that the count at launch leaves room.
//  * 128-byte swizzle for D = 64 (a bf16 row is 128 B), 64-byte for D = 32;
//    every tile starts on 1024 bytes. The tensor maps are 4-D over the
//    strided (batch, head, seq) views, encoded per call and passed by value
//    (__grid_constant__), so a CUDA graph keeps them; rows at or past S are
//    zero-filled by the TMA and never stored. A row of 128 (256 B) is wider
//    than the swizzle's span: each tile arrives as two 64-column boxes into
//    its two halves ([rows][64] each), as in the forward (hopper.cuh:
//    tma_tile, k_step; a product by D's columns is two n64 wgmma, mma_rs).
//  * dQ at D = 128 (dq_d128_kernel, redesigned for Hopper): persistent,
//    one block an SM walking 128-row output tiles heaviest first, dealt as
//    a snake. Two consumer warpgroups of 64 rows (three would not fit: Q
//    and dO of 192 rows alone take 96 KB) and a producer warpgroup whose
//    warps split the work: warp 0 streams the 64-row K/V tiles into a
//    3-slot ring on across the block's tiles, warp 1 loads each tile's Q
//    and dO into one of two buffers and stores dQ, warps 2-3 take Dr =
//    rowsum(dO o) from O in global memory and dO in shared memory (the
//    same sums in the same order as dq_bf16_kernel's two-thread pass). O
//    never enters shared memory; that is what makes room for the second
//    Q/dO buffer, so the next tile's rows and Dr arrive under this tile's
//    products. dQ leaves through the warpgroup's rows of the tile's Q
//    buffer (free once its last S is done): the consumers write it in the
//    map's swizzle and arrive on dq_ready, and warp 1 stores it by TMA
//    before it loads that buffer again (in place of store_acc's 4-byte
//    writes from the registers, rows 10 KB apart). The first dS K
//    of a tile overwrites dQ (the wgmma's accumulate flag): zeroing it
//    with other instructions in the persistent loop made ptxas serialize
//    every wgmma (C7515). The producer keeps 56 registers (its Dr pass),
//    the consumers rise to 224. Its sums are dq_bf16_kernel<128>'s, in
//    the same order: dQ and Dr are the parent's bits.
//  * dK/dV at D = 128 (redesigned for Hopper, as FlashAttention-3's
//    backward at this head dim) keeps two consumer warpgroups of 64 KV rows
//    and a producer at setmaxnreg.dec 24, and streams the query tiles at 32
//    rows in a ring of 4 slots: S^T = K Q^T and dP^T = V dO^T are m64n32
//    wgmma (16 floats a thread each), P^T and dS^T two k16 A fragments
//    each, and dV += P^T dO, dK += dS^T Q two k16 steps of two n64 halves,
//    so a consumer holds dK and dV (128 floats), S^T and dP^T (32) and the
//    fragments (16) under its 240 registers. (One consumer warpgroup with
//    64-row tiles, 250 registers at launch, had ptxas serialize its wgmma,
//    C7511, and left the SM's tensor cores to one chain.) K and V of 128
//    rows take 64 KB, the ring 64 KB.
//  * MLA's pair (minicpm3-4b: q and k at 96, V, O and dO at 64; redesigned
//    for Hopper, the first version padded V to 96 and ran D = 128's tiles,
//    768 column passes of the seven products where 576 carry the function)
//    runs dq_d128_kernel<96, 96, 64> and dkdv_bf16_kernel<96, 96, 64>. A
//    96-column row is three 32-column boxes in the 64-byte swizzle
//    (hopper.cuh box_cols, as CUTLASS lays out a 96-wide operand): S = Q K^T
//    and S^T = K Q^T run six k16 steps, dQ += dS K and dK += dS^T Q one
//    m64n96 wgmma a step (B MN-major, the boxes the descriptor's leading
//    byte offset apart); dO and V are one 64-column box, so dP runs four k16
//    steps and dV += P^T dO one m64n64 product a step. dK/dV's 48 + 32
//    accumulator floats leave room for 64-row query tiles (4 slots), where
//    D = 128 streams 32. The pair (96, 96) (V padded) keeps D = 128's
//    tiles (dq_d128_kernel<128, 96>, dkdv_bf16_kernel<128, 96>: maps 96
//    columns wide, the TMA zero-filling the rest; S and dP skip the zero
//    k16 steps). minicpm3-4b's training shape on an H100: dQ 177.9 ->
//    141.3 us, dK/dV 255.4 -> 180.7 us.
//  * At G = 1 (grouped_order, hopper.cuh) the persistent dQ grid walks its
//    tiles grouped by head (TileOrder), as the forward does, and the dK/dV
//    grid becomes one-dimensional, block i taking tile i of the grouped
//    order over the (b, KV head) pairs and their KV tiles, so that the
//    blocks in flight read few heads' Q and dO; the heaviest-first walk
//    (the first KV tiles of every head first) keeps a 3-D grid elsewhere.
//    Each kernel is built both ways (a template parameter GROUPED), so the
//    G > 1 launches keep their code.
//  * Diagnostic macros (tools/bwd_breakdown.py): BWD_DQ_WGS (dQ's consumer
//    warpgroups at D <= 64), BWD_NOEXP (P = its exponent's argument, no
//    mask), BWD_NOSECOND (no dQ, dV, dK products), BWD_NOLOAD (dq_d128_kernel
//    loads no K/V tile after each ring slot's first) and BWD_NOSTORE
//    (dq_d128_kernel stores no dQ), the last four giving wrong gradients by
//    design (and with no store ptxas may drop the products no output
//    reads); K1_ORDER=0 / 2 (hopper.cuh): the heaviest-first walk at every
//    G, or the grouped one.
// float32 inputs have no exact tensor-core path (TF32 would round them), so
// they take scalar kernels (one thread a row, two at D = 96 and 128, each with half
// the row's columns; the other side's rows read
// from shared memory as broadcasts); their dQ kernel also computes each
// row's Dr from its own O and dO row, writes it, and runs first.
//
// Layout: every tensor is addressed by (batch, head, seq) strides with a
// contiguous head dim; lse and Dr are float32 [B,H,S] contiguous. One C
// entry (repro_flash_attention_bwd_v: D and V's Dv; repro_flash_attention_bwd
// with Dv = D keeps the earlier signature) launches either kernel and
// returns cudaGetLastError() after its launch (or the error of encoding a
// tensor map).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr float LOG2E = 1.4426950408889634f;
constexpr int WG_ROWS = 64;                    // rows of a consumer warpgroup
// A bf16 block: NC consumer warpgroups of WG_ROWS rows each, then a
// producer warpgroup, one block an SM. At launch ptxas gives a thread
// 65536 / (128 (NC + 1)) registers (168 for NC = 2, 128 for NC = 3); the
// producer keeps PRODUCER_REGS and the consumers rise to REGS:
// (168 - 24) x 128 = (240 - 168) x 256 and (128 - 24) x 128 >= (160 - 128) x 384.
#ifndef BWD_DQ_WGS
#define BWD_DQ_WGS 3
#endif
template <int D>
__host__ __device__ constexpr int dq_wgs() {
  return D > 64 ? 2 : BWD_DQ_WGS;
}
constexpr int KV_WGS = 2;                      // dK/dV's consumer warpgroups
constexpr int PRODUCER_REGS = 24;
template <int NC>
struct Shape {
  static constexpr int ROWS = WG_ROWS * NC;   // rows a block owns
  static constexpr int THREADS = 128 * (NC + 1);
  static constexpr int REGS = NC == 2 ? 240 : 160;  // a consumer's, after setmaxnreg
};
constexpr int BN = 64;                         // rows of dQ's streamed K/V tiles
constexpr int STAGES = 3;                      // slots of dQ's ring
// dK/dV's streamed query tiles: 64 rows in 3 slots at D <= 64; 32 rows in
// 4 slots at D = 128, so that S^T and dP^T (64 x 32, 16 floats a thread
// each) and their A fragments fit beside dK and dV (128 floats) under the
// 240 registers a consumer of two warpgroups rises to; 64 rows in 4 slots
// at D = 96 beside V's 64 (MLA's pair: dK and dV 48 + 32 floats, so S^T
// and dP^T of 64 x 64 fit with their fragments)
template <int D>
__host__ __device__ constexpr int kv_bn() {
  return D == 128 ? 32 : 64;
}
template <int D>
__host__ __device__ constexpr int kv_stages() {
  return D > 64 ? 4 : 3;
}
// The float32 kernels' shape: a block owns FT rows, TPR threads a row (each
// DP = D / TPR of its columns), and walks the other side in FB-row tiles. At
// D = 128 two threads a row keep the sums to 64 columns a thread, and the
// smaller tiles keep the rows in 48 KB of static shared memory.
template <int D>
struct F32 {
  static constexpr int TPR = D > 64 ? 2 : 1;
  static constexpr int DP = D / TPR;
  static constexpr int FT = D > 64 ? 32 : 64;
  static constexpr int FB = D > 64 ? 8 : 16;
};

struct Strides {
  long long b, h, s;
};

struct Args {
  const void *q, *k, *v, *o, *dout;
  const float* lse;  // [B,H,S]
  float* delta;      // [B,H,S]: written by the dQ kernel, read by dK/dV
  void *dq, *dk, *dv;
  int H, K, S;
  Strides qs, ks, vs, os, dos, dqs, dks, dvs;
  int window;  // 0: no window
  float scale;
};

__device__ __forceinline__ bool valid_pair(int qp, int kp, int S, int window) {
  return qp < S && kp <= qp && (window <= 0 || qp - kp < window);
}

// The same for A fragments: they are written before the wgmma.fence that
// precedes the wgmma reading them, not sunk past it.
template <int KS>
__device__ __forceinline__ void fence_frag(uint32_t (&r)[KS][4]) {
#pragma unroll
  for (int i = 0; i < KS; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}


// A barrier of one consumer warpgroup's 128 threads (ids 1, 2; 0 is
// __syncthreads's)
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
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

// The 64 x 16 KS accumulator as the A fragments of KS k16 steps, rounded
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

// Write a warpgroup's 64 x D float32 accumulator (times `mul`) as bf16
// rows: the thread's rows p0 and p0 + 8 (below S), columns 8n + c0, +1.
template <int D>
__device__ __forceinline__ void store_acc(const float* acc, float mul, void* dst,
                                          const Strides& st, int b, int h, int p0, int c0,
                                          int S) {
  bf16* base = static_cast<bf16*>(dst) + b * st.b + h * st.h;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    if (p0 < S)
      *reinterpret_cast<uint32_t*>(base + p0 * st.s + 8 * n + c0) =
          pack_bf16(acc[n * 4 + 0] * mul, acc[n * 4 + 1] * mul);
    if (p0 + 8 < S)
      *reinterpret_cast<uint32_t*>(base + (p0 + 8) * st.s + 8 * n + c0) =
          pack_bf16(acc[n * 4 + 2] * mul, acc[n * 4 + 3] * mul);
  }
}

struct TmaArgs {
  const float* lse;  // [B,H,S]
  float* delta;      // [B,H,S]
  void *dq, *dk, *dv;
  Strides dqs, dks, dvs;
  int H, K, S;
  int window;        // 0: no window
  float scale;       // 1 / sqrt(D)
  float scale_log2;  // log2(e) / sqrt(D)
  int q_slots, k_slots, v_slots, o_slots, do_slots;  // see tma_load
};

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024 - (smem_addr(p) & 1023)) & 1023);
}

// ---------------------------------------------------------------------------
// bf16 dQ (and Dr): DQ_WGS consumer warpgroups of 64 query rows, then the
// producer warpgroup (one thread of it issues the loads).
// ---------------------------------------------------------------------------
// Shared memory from a 1024-byte aligned base (the swizzle follows address
// bits 4-9): Q, dO, O (the block's rows each), the K and V rings, Dr, the
// barriers.
template <int D>
struct DqSmem {
  static constexpr int BM = Shape<dq_wgs<D>()>::ROWS;
  static constexpr int ROWS = BM * D * 2;  // bytes of a tile of the block's rows
  static constexpr int TILE = BN * D * 2;  // bytes of a 64-row tile
  static constexpr int Q = 0;
  static constexpr int DO = Q + ROWS;
  static constexpr int O = DO + ROWS;
  static constexpr int K = O + ROWS;
  static constexpr int V = K + STAGES * TILE;
  static constexpr int DR = V + STAGES * TILE;  // float [BM]
  static constexpr int BAR = DR + BM * 4;
  static constexpr int BYTES = BAR + (2 * STAGES + 1) * 8 + 1024;  // + alignment slack
};

// KV rows [lo, hi) the 64 query rows from q0 need; lo tile-aligned.
__device__ __forceinline__ void kv_range(int q0, int S, int window, int* lo, int* hi) {
  *hi = min(q0 + WG_ROWS, S);
  const int l = window > 0 ? max(q0 - window + 1, 0) : 0;
  *lo = (l / BN) * BN;
}

// A dQ consumer thread's rows: the warpgroup's first query row, the
// thread's two rows and first key column, their lse (log2 units) and Dr.
struct DqRows {
  int q0w, qp0, qp1, c0;
  float l0, l1, d0, d1;
};

// One tile of a dQ warpgroup's run [it_lo, it_hi) of the block's tiles,
// with one tile of look-ahead. In flight on entry, as one group: tile it's
// S and dP and tile it - 1's dS K. This waits for the group, releases tile
// it - 1's slot, computes dS, and commits tile it + 1's S and dP (when the
// run has it) and tile it's dS K as the next group, so that the tensor
// cores get both back to back and the warpgroup waits once a tile. (Two
// groups, dS of the next tile computed while this tile's product runs,
// would need dS written while a wgmma reading A from registers is in
// flight: ptxas then serializes every wgmma, C7513.)
template <int D>
__device__ __forceinline__ void dq_step(int it, int it_lo, int it_hi, int lo, float* s, float* dp,
                                        float* dq, uint64_t* full, uint64_t* empty,
                                        uint64_t desc_q, uint64_t desc_do, uint64_t desc_k0,
                                        uint64_t desc_v0, const DqRows& r, const TmaArgs& a) {
  constexpr uint64_t SLOT = (BN * D * 2) >> 4;  // a ring slot in descriptor units
  wg_wait<0>();
  fence_regs<BN / 2>(s);
  fence_regs<BN / 2>(dp);
  fence_regs<D / 2>(dq);
  if (it > it_lo) mbar_arrive(&empty[(it - 1) % STAGES]);

  // P under K1's mask, then dS = P (dP - Dr) in place of dP
  const int k0 = lo + it * BN;
  const bool whole =
      k0 + BN - 1 <= r.q0w && (a.window <= 0 || r.q0w + WG_ROWS - 1 - k0 < a.window);
#pragma unroll
  for (int n = 0; n < BN / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = n * 4 + e;
#ifdef BWD_NOEXP
      float p = fmaf(s[i], a.scale_log2, -(e < 2 ? r.l0 : r.l1));
#else
      float p = ex2(fmaf(s[i], a.scale_log2, -(e < 2 ? r.l0 : r.l1)));
      if (!whole && !valid_pair(e < 2 ? r.qp0 : r.qp1, k0 + 8 * n + r.c0 + (e & 1), a.S, a.window))
        p = 0.f;
#endif
      dp[i] = p * (dp[i] - (e < 2 ? r.d0 : r.d1));
    }
  uint32_t ds[BN / 16][4];
  acc_to_a<BN / 16>(ds, dp);
  fence_frag(ds);
  fence_regs<BN / 2>(s);
  fence_regs<BN / 2>(dp);

  wg_fence();
  if (it + 1 < it_hi) {  // S = Q K^T and dP = dO V^T (64 x 64 each) of the next tile
    const int nx = (it + 1) % STAGES;
    mbar_wait(&full[nx], ((it + 1) / STAGES) & 1);
    issue_two<D>(s, dp, desc_q, desc_k0 + SLOT * nx, desc_do, desc_v0 + SLOT * nx,
                 DqSmem<D>::BM, BN);
  }
#ifndef BWD_NOSECOND
  // dQ += dS K: K read MN-major, BN / 16 k16 steps of 16 key rows
  const uint64_t dk = desc_k0 + SLOT * (it % STAGES);
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) mma_rs<D>(dq, ds[kk], dk + mn_step<D>() * kk, BN);
#endif
  wg_commit();
}

template <int D>
__global__ void __launch_bounds__(Shape<dq_wgs<D>()>::THREADS, 1)
    dq_bf16_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                   const __grid_constant__ CUtensorMap to, const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, TmaArgs a) {
  using L = DqSmem<D>;
  constexpr int DQ_WGS = dq_wgs<D>();
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR);
  uint64_t* empty = full + STAGES;
  uint64_t* rows_full = empty + STAGES;
  float* dr_s = reinterpret_cast<float*>(smem + L::DR);

  const int qt = gridDim.z - 1 - blockIdx.z;  // heaviest tiles first
  const int h = blockIdx.x, b = blockIdx.y;
  const int kh = h / (a.H / a.K);
  const int q0 = qt * L::BM;
  const int warp = warp_index();

  // the KV tiles the block loads: the union of its warpgroups' ranges
  int lo, hi, lo_last;
  kv_range(q0, a.S, a.window, &lo, &hi);
  const int last_wg = min(DQ_WGS - 1, (a.S - 1 - q0) / WG_ROWS);  // the last with rows
  kv_range(q0 + last_wg * WG_ROWS, a.S, a.window, &lo_last, &hi);
  const int n_tiles = (hi - lo + BN - 1) / BN;

  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 128 * DQ_WGS);
    }
    mbar_init(rows_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * DQ_WGS) {  // producer: its first thread works
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 128 * DQ_WGS) {
      mbar_expect_tx(rows_full, 3 * L::ROWS);
      tma_tile<D>(smem + L::Q, &tq, rows_full, a.q_slots, L::BM, q0, h, b);
      tma_tile<D>(smem + L::DO, &tdo, rows_full, a.do_slots, L::BM, q0, h, b);
      tma_tile<D>(smem + L::O, &to, rows_full, a.o_slots, L::BM, q0, h, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % STAGES;
        if (it >= STAGES) mbar_wait(&empty[st], ((it / STAGES) - 1) & 1);
        mbar_expect_tx(&full[st], 2 * L::TILE);
        tma_tile<D>(smem + L::K + st * L::TILE, &tk, &full[st], a.k_slots, BN, lo + it * BN, kh, b);
        tma_tile<D>(smem + L::V + st * L::TILE, &tv, &full[st], a.v_slots, BN, lo + it * BN, kh, b);
      }
    }
  } else {  // consumer warpgroup wg: query rows [q0w, q0w + 64)
    setmaxnreg_inc<Shape<DQ_WGS>::REGS>();  // DQ_WGS >= 2
    constexpr int NS = BN / 2;  // S and dP accumulator floats a thread
    constexpr int NQ = D / 2;   // dQ accumulator floats a thread
    const int wg = warp / 4, t = threadIdx.x % 128, lane = threadIdx.x % 32;
    const int q0w = q0 + wg * WG_ROWS;
    int it_lo = 0, it_hi = 0;  // no rows below S: compute nothing
    if (q0w < a.S) {
      int lo_w, hi_w;
      kv_range(q0w, a.S, a.window, &lo_w, &hi_w);
      it_lo = (lo_w - lo) / BN;
      it_hi = (hi_w - lo + BN - 1) / BN;
    }
    // this thread's rows (of the warpgroup's 64) and its first key column:
    // s[n*4 + i*2 + j] is row r0 + 8i, key k0 + 8n + c0 + j
    const int r0 = (t / 32) * 16 + lane / 4;
    const int qp0 = q0w + r0, qp1 = qp0 + 8;
    const int c0 = 2 * (lane % 4);
    const long long row = ((long long)b * a.H + h) * a.S;

    // Dr = rowsum(dO o) of the warpgroup's rows: two threads a row, each
    // one half of the row's bytes in both tiles (at D = 128 the row's part
    // in one of the tile's halves); rows past S are zeros
    mbar_wait(rows_full, 0);
    {
      const int rr = wg * WG_ROWS + t / 2;
      const int off = D > 64 ? (t & 1) * L::BM * 128 + rr * 128 : rr * D * 2 + (t & 1) * D;
      const uint4* po = reinterpret_cast<const uint4*>(smem + L::O + off);
      const uint4* pd = reinterpret_cast<const uint4*>(smem + L::DO + off);
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < D / 16; ++i) {
        const uint4 x = po[i], y = pd[i];
        const __nv_bfloat162* xs = reinterpret_cast<const __nv_bfloat162*>(&x);
        const __nv_bfloat162* ys = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 fx = __bfloat1622float2(xs[j]), fy = __bfloat1622float2(ys[j]);
          acc = fmaf(fx.x, fy.x, acc);
          acc = fmaf(fx.y, fy.y, acc);
        }
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      if ((t & 1) == 0) {
        dr_s[rr] = acc;
        if (q0 + rr < a.S) a.delta[row + q0 + rr] = acc;
      }
    }
    wg_sync(wg);
    DqRows r;
    r.q0w = q0w;
    r.qp0 = qp0;
    r.qp1 = qp1;
    r.c0 = c0;
    r.l0 = qp0 < a.S ? a.lse[row + qp0] * LOG2E : 0.f;
    r.l1 = qp1 < a.S ? a.lse[row + qp1] * LOG2E : 0.f;
    r.d0 = dr_s[wg * WG_ROWS + r0];
    r.d1 = dr_s[wg * WG_ROWS + r0 + 8];

    float dq[NQ], s[NS], dp[NS];
#pragma unroll
    for (int i = 0; i < NQ; ++i) dq[i] = 0.f;
#pragma unroll
    for (int i = 0; i < NS; ++i) s[i] = dp[i] = 0.f;
    const uint64_t desc_q = smem_desc<D>(smem + L::Q + wg * WG_ROWS * box_cols<D>() * 2);
    const uint64_t desc_do = smem_desc<D>(smem + L::DO + wg * WG_ROWS * box_cols<D>() * 2);
    const uint64_t desc_k0 = smem_desc<D>(smem + L::K), desc_v0 = smem_desc<D>(smem + L::V);

    for (int it = 0; it < it_lo; ++it) {  // tiles no row of this warpgroup needs
      mbar_wait(&full[it % STAGES], (it / STAGES) & 1);
      mbar_arrive(&empty[it % STAGES]);
    }
    if (it_lo < it_hi) {
      const int st = it_lo % STAGES;
      mbar_wait(&full[st], (it_lo / STAGES) & 1);
      wg_fence();
      issue_two<D>(s, dp, desc_q, desc_k0 + (L::TILE >> 4) * st, desc_do,
                   desc_v0 + (L::TILE >> 4) * st, L::BM, BN);
      wg_commit();
      for (int it = it_lo; it < it_hi; ++it)
        dq_step<D>(it, it_lo, it_hi, lo, s, dp, dq, full, empty, desc_q, desc_do, desc_k0,
                   desc_v0, r, a);
      wg_wait<0>();
      fence_regs<NQ>(dq);
      mbar_arrive(&empty[(it_hi - 1) % STAGES]);
    }
    for (int it = it_hi; it < n_tiles; ++it) {
      mbar_wait(&full[it % STAGES], (it / STAGES) & 1);
      mbar_arrive(&empty[it % STAGES]);
    }
    store_acc<D>(dq, a.scale, a.dq, a.dqs, b, h, qp0, c0, a.S);
  }
}

// ---------------------------------------------------------------------------
// bf16 dQ (and Dr) at D = 128, redesigned for Hopper: persistent, one block
// an SM walking 128-row output tiles heaviest first, dealt as a snake; two
// consumer warpgroups of 64 rows and a producer warpgroup whose warps split
// the work: warp 0's first thread streams the K/V ring, warp 1's loads each
// tile's Q and dO into one of two buffers, and warps 2-3 take each row's
// Dr = rowsum(dO o) of the next tile from O in global memory and dO in
// shared memory. O never enters shared memory, and that is what makes room
// for two Q/dO buffers beside a 3-slot ring: the next tile's Q, dO and Dr
// arrive under this tile's products. dQ leaves through the tile's Q
// buffer (free once the warpgroup's last S = Q K^T is done) by TMA stores,
// one a 64-column half.
// ---------------------------------------------------------------------------
namespace dq128 {
constexpr int NC = 2;                       // consumer warpgroups
constexpr int BM = WG_ROWS * NC;            // 128 query rows a tile
constexpr int THREADS = 128 * (NC + 1);
constexpr int SLOTS = 3;                    // K/V ring slots of BN rows
constexpr int DR_THREADS = 64;              // the producer's warps 2-3
// At launch ptxas gives a thread 65536 / 384 = 168 registers; the producer
// warpgroup keeps 56 (its Dr pass holds a 16-byte load of O and one of dO
// in flight) and the consumers rise to 224: (168 - 56) x 128 = (224 - 168) x 256
constexpr int PRODUCER_REGS = 56, CONSUMER_REGS = 224;
static_assert((224 - 168) * 128 * NC == (168 - 56) * 128, "the register split");
}  // namespace dq128

// dq_d128_kernel's shared memory from a 1024-byte aligned base, for Q's and
// K's tiles D columns wide and dO's and V's DV: Q[2], dO[2] (each as its
// boxes: two [BM][64] halves at 128, three [BM][32] at 96, one [BM][64] at
// 64), the K and V rings, Dr[2][BM], the barriers
template <int D, int DV>
struct Dq128Smem {
  static constexpr int ROWS = dq128::BM * D * 2;      // a tile's Q rows (32 KB at 128)
  static constexpr int DO_ROWS = dq128::BM * DV * 2;  // its dO rows
  static constexpr int TILE = BN * D * 2;             // a K tile (16 KB at 128)
  static constexpr int V_TILE = BN * DV * 2;          // a V tile
  static constexpr int Q = 0;
  static constexpr int DO = Q + 2 * ROWS;
  static constexpr int K = DO + 2 * DO_ROWS;
  static constexpr int V = K + dq128::SLOTS * TILE;
  static constexpr int DR = V + dq128::SLOTS * V_TILE;
  static constexpr int BAR = DR + 2 * dq128::BM * 4;
  // full[SLOTS], empty[SLOTS], rows_full[2], dq_ready[2], dr_full[2], dr_free[2]
  static constexpr int BYTES = BAR + (2 * dq128::SLOTS + 8) * 8 + 1024;  // + alignment slack
  static_assert(BYTES <= 232448, "the block's shared memory exceeds the SM's");
};

// Output tile i of the walk over the B H heads (head b H + h), rank 0 the
// heaviest (the last query rows of each (row, head)): heaviest first (rank
// i / (B H)) or grouped by head (TileOrder, hopper.cuh); the KV tiles [lo,
// lo + n BN) the block streams for it: from the window's edge of its first
// row to the diagonal of its last.
template <bool GROUPED>
struct Dq128Tile {
  int q0, h, b, lo, n;
  __device__ __forceinline__ Dq128Tile(int i, const TileOrder& ord, int B, int n_qt,
                                       const TmaArgs& a) {
    int head, rank;
    if constexpr (GROUPED) {
      ord.at(i, &head, &rank);
    } else {
      rank = i / (a.H * B);
      head = i % (a.H * B);
    }
    q0 = (n_qt - 1 - rank) * dq128::BM;
    h = head % a.H;
    b = head / a.H;
    int hi;
    kv_range(q0, a.S, a.window, &lo, &hi);
    hi = min(q0 + dq128::BM, a.S);
    n = (hi - lo + BN - 1) / BN;
  }
};

// dq_step on the persistent ring, in two halves: KV tile it of the output
// tile sits in ring slot (j0 + it) % SLOTS, j0 the ring's count of tiles
// before it. dq128_wait waits for the group in flight (tile it's S and dP,
// and tile it - 1's dS K) and releases tile it - 1's slot; dq128_issue
// then commits the next group.
template <int D>
__device__ __forceinline__ void dq128_wait(int it, int it_lo, int j0, float* s, float* dp,
                                           float* dq, uint64_t* empty) {
  using namespace dq128;
  wg_wait<0>();
  fence_regs<BN / 2>(s);
  fence_regs<BN / 2>(dp);
  fence_regs<D / 2>(dq);
  if (it > it_lo) mbar_arrive(&empty[(j0 + it - 1) % SLOTS]);
}

// D, DK, DV: as dq_d128_kernel's
template <int D, int DK, int DV>
__device__ __forceinline__ void dq128_issue(int it, int it_lo, int it_hi, int lo, int j0, float* s,
                                            float* dp, float* dq, uint64_t* full,
                                            uint64_t desc_q, uint64_t desc_do, uint64_t desc_k0,
                                            uint64_t desc_v0, const DqRows& r, const TmaArgs& a) {
  using namespace dq128;
  using L = Dq128Smem<D, DV>;
  constexpr int VW = DV < DK ? DV : DK;  // V's columns
  constexpr uint64_t SLOT = L::TILE >> 4, V_SLOT = L::V_TILE >> 4;  // ring slots, descriptor units
  // P under K1's mask, then dS = P (dP - Dr) in place of dP
  const int k0 = lo + it * BN;
  const bool whole =
      k0 + BN - 1 <= r.q0w && (a.window <= 0 || r.q0w + WG_ROWS - 1 - k0 < a.window);
#pragma unroll
  for (int n = 0; n < BN / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = n * 4 + e;
#ifdef BWD_NOEXP
      float p = fmaf(s[i], a.scale_log2, -(e < 2 ? r.l0 : r.l1));
#else
      float p = ex2(fmaf(s[i], a.scale_log2, -(e < 2 ? r.l0 : r.l1)));
      if (!whole && !valid_pair(e < 2 ? r.qp0 : r.qp1, k0 + 8 * n + r.c0 + (e & 1), a.S, a.window))
        p = 0.f;
#endif
      dp[i] = p * (dp[i] - (e < 2 ? r.d0 : r.d1));
    }
  uint32_t ds[BN / 16][4];
  acc_to_a<BN / 16>(ds, dp);
  fence_frag(ds);
  fence_regs<BN / 2>(s);
  fence_regs<BN / 2>(dp);

  wg_fence();
  if (it + 1 < it_hi) {  // S = Q K^T and dP = dO V^T (64 x 64 each) of the next tile
    const int nx = (j0 + it + 1) % SLOTS;
    mbar_wait(&full[nx], ((j0 + it + 1) / SLOTS) & 1);
    issue_two<D, 64, DK, DV, VW>(s, dp, desc_q, desc_k0 + SLOT * nx, desc_do,
                                 desc_v0 + V_SLOT * nx, BM, BN);
  }
#ifndef BWD_NOSECOND
  // dQ (+)= dS K: K read MN-major, BN / 16 k16 steps of 16 key rows. The
  // output tile's first step overwrites dQ: zeroing it with other
  // instructions in the persistent loop made ptxas serialize every wgmma
  // (C7515; 206.7 against 168.0 us at qwen2.5-14b's shape on an H100)
  const uint64_t dk = desc_k0 + SLOT * ((j0 + it) % SLOTS);
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
    mma_rs<D>(dq, ds[kk], dk + mn_step<D>() * kk, BN, it > it_lo || kk > 0);
#endif
  wg_commit();
}

// Grid: min(tiles, SMs) blocks of dq128::THREADS threads and
// Dq128Smem<D, DV>::BYTES of dynamic shared memory, over the B H ceil(S /
// 128) output tiles, each block walking its share heaviest first
// (snake_tile) or, with GROUPED (at grouped_order(G)), grouped by head
// (TileOrder). `o`/`os`: O and its
// strides, read by the Dr pass; `tdq`: dQ's map, 64-row boxes. D: Q's and
// K's tiles' width, DK the head dim, DV dO's and V's tiles' width:
// <128, 128, 128>; <128, 96, 128> (head dim 96 and a V padded to it, on
// 128's tiles: the maps 96 columns wide, so the TMA fills the tiles' last
// 32 columns with zeros and stores none of dQ's, S and dP skip their two
// zero k16 steps, and the Dr pass reads O's 96); <96, 96, 64> (MLA's pair:
// Q, K and dQ as three 32-column boxes in the 64-byte swizzle, dQ += dS K
// one m64n96 product a step; dO and V one 64-column box, dP over its four
// k16 steps).
template <int D, int DK = D, int DV = D, bool GROUPED = false>
__global__ void __launch_bounds__(dq128::THREADS, 1)
    dq_d128_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                   const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap tdq, TmaArgs a, const bf16* o, Strides os,
                   int dq_slots, int B) {
  using namespace dq128;
  using L = Dq128Smem<D, DV>;
  constexpr int ROWS = L::ROWS, DO_ROWS = L::DO_ROWS, TILE = L::TILE, V_TILE = L::V_TILE,
                Q = L::Q, DO = L::DO, K = L::K, V = L::V, DR = L::DR, BAR = L::BAR;
  constexpr int VW = DV < DK ? DV : DK;  // O's columns
  constexpr int QW = box_cols<D>(), VB = box_cols<DV>();  // a box's columns
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + BAR);
  uint64_t* empty = full + SLOTS;
  uint64_t* rows_full = empty + SLOTS;  // Q and dO of buffer 0, 1 landed
  uint64_t* dq_ready = rows_full + 2;   // buffer 0, 1 read, its dQ staged
  uint64_t* dr_full = dq_ready + 2;     // Dr of buffer 0, 1 written
  uint64_t* dr_free = dr_full + 2;      // Dr of buffer 0, 1 read
  float* dr_s = reinterpret_cast<float*>(smem + DR);
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
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 128 * NC);
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(&rows_full[i], 1);
      mbar_init(&dq_ready[i], 128 * NC);
      mbar_init(&dr_full[i], DR_THREADS);
      mbar_init(&dr_free[i], 128 * NC);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * NC) {  // producer warpgroup
    setmaxnreg_dec<dq128::PRODUCER_REGS>();
    const int pw = warp - 4 * NC, lane = threadIdx.x % 32;
    if (pw == 0 && lane == 0) {  // the K/V ring, on across the block's tiles
      int kv = 0;
      for (int k = 0, i; (i = tile_of(k)) >= 0; ++k) {
        const Dq128Tile<GROUPED> t(i, ord, B, n_qt, a);
        const int kh = t.h / (a.H / a.K);
        for (int it = 0; it < t.n; ++it) {
          const int j = kv + it, st = j % SLOTS;
          if (j >= SLOTS) mbar_wait(&empty[st], ((j / SLOTS) - 1) & 1);
#ifdef BWD_NOLOAD
          if (j >= SLOTS) {  // the slot keeps its first tiles: no load
            mbar_arrive(&full[st]);
            continue;
          }
#endif
          mbar_expect_tx(&full[st], TILE + V_TILE);
          tma_tile<D>(smem + K + st * TILE, &tk, &full[st], a.k_slots, BN, t.lo + it * BN, kh, t.b);
          tma_tile<DV>(smem + V + st * V_TILE, &tv, &full[st], a.v_slots, BN, t.lo + it * BN, kh,
                       t.b);
        }
        kv += t.n;
      }
    } else if (pw == 1 && lane == 0) {
      // each tile's Q and dO into buffer k % 2; once tile k - 2 staged its
      // dQ in that buffer, dQ out by TMA stores first (a warpgroup's rows
      // of each of its boxes; rows past S are not written)
      auto store = [&](int k) {
        const Dq128Tile<GROUPED> t(tile_of(k), ord, B, n_qt, a);
        const int buf = k & 1;
        mbar_wait(&dq_ready[buf], (k >> 1) & 1);
#ifndef BWD_NOSTORE
        for (int wg = 0; wg < NC; ++wg) {
          const int q0w = t.q0 + wg * WG_ROWS;
          if (q0w >= a.S) continue;
          uint8_t* rows = smem + Q + buf * ROWS + wg * WG_ROWS * QW * 2;
#pragma unroll
          for (int c = 0; c < D; c += QW)
            tma_store(&tdq, rows + c * BM * 2, dq_slots, q0w, t.h, t.b, c);
        }
#endif
        bulk_commit();
      };
      int k = 0;
      for (int i; (i = tile_of(k)) >= 0; ++k) {
        const Dq128Tile<GROUPED> t(i, ord, B, n_qt, a);
        const int buf = k & 1;
        if (k >= 2) {
          store(k - 2);
          bulk_wait_read<0>();
        }
        mbar_expect_tx(&rows_full[buf], ROWS + DO_ROWS);
        tma_tile<D>(smem + Q + buf * ROWS, &tq, &rows_full[buf], a.q_slots, BM, t.q0, t.h, t.b);
        tma_tile<DV>(smem + DO + buf * DO_ROWS, &tdo, &rows_full[buf], a.do_slots, BM, t.q0, t.h,
                     t.b);
      }
      for (int j = k >= 2 ? k - 2 : 0; j < k; ++j) store(j);
      bulk_wait<0>();  // the last stores are done before the block leaves
    } else if (pw >= 2) {  // Dr = rowsum(dO o): rows u and u + 64 of each tile
      const int u = threadIdx.x - 128 * NC - 64;
      for (int k = 0, i; (i = tile_of(k)) >= 0; ++k) {
        const Dq128Tile<GROUPED> t(i, ord, B, n_qt, a);
        const int buf = k & 1;
        mbar_wait(&rows_full[buf], (k >> 1) & 1);
        if (k >= 2) mbar_wait(&dr_free[buf], ((k - 2) >> 1) & 1);
        const long long row = ((long long)t.b * a.H + t.h) * a.S;
#pragma unroll 1
        for (int rr = u; rr < BM; rr += DR_THREADS) {
          const int qp = t.q0 + rr;
          // the row's 64-column halves (one at DV = 64) in turn, each over
          // the 16-byte chunks in the order the swizzled tile holds them
          // (chunk c ^ (rr % 8) at place c), as the two-thread pass of
          // dq_bf16_kernel sums them
          float acc[2] = {0.f, 0.f};
          if (qp < a.S) {
            const bf16* orow = o + t.b * os.b + t.h * os.h + qp * os.s;
#pragma unroll
            for (int hf = 0; hf < DV / VB; ++hf) {
              const uint4* pd = reinterpret_cast<const uint4*>(smem + DO + buf * DO_ROWS +
                                                               hf * BM * 128 + rr * 128);
#pragma unroll 4
              for (int c = 0; c < 8; ++c) {
                if (hf * 64 + (c ^ (rr % 8)) * 8 >= VW) continue;  // dO's zero columns
                const uint4 x = __ldg(reinterpret_cast<const uint4*>(orow + hf * 64) + (c ^ (rr % 8)));
                const uint4 y = pd[c];
                const __nv_bfloat162* xs = reinterpret_cast<const __nv_bfloat162*>(&x);
                const __nv_bfloat162* ys = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                  const float2 fx = __bfloat1622float2(xs[j]), fy = __bfloat1622float2(ys[j]);
                  acc[hf] = fmaf(fx.x, fy.x, acc[hf]);
                  acc[hf] = fmaf(fx.y, fy.y, acc[hf]);
                }
              }
            }
          }
          const float dr = acc[0] + acc[1];
          dr_s[buf * BM + rr] = dr;
          if (qp < a.S) a.delta[row + qp] = dr;
        }
        mbar_arrive(&dr_full[buf]);
      }
    }
    return;
  }
  setmaxnreg_inc<dq128::CONSUMER_REGS>();

  // consumer warpgroup wg: query rows [q0 + 64 wg, + 64) of each tile
  constexpr int NS = BN / 2;  // S and dP accumulator floats a thread
  constexpr int NQ = D / 2;   // dQ accumulator floats a thread
  const int wg = warp / 4, t128 = threadIdx.x % 128, lane = threadIdx.x % 32;
  // this thread's rows (of the warpgroup's 64) and its first key column:
  // s[n*4 + i*2 + j] is row r0 + 8i, key k0 + 8n + c0 + j
  const int r0 = (t128 / 32) * 16 + lane / 4;
  const int c0 = 2 * (lane % 4);
  const uint64_t desc_k0 = smem_desc<D>(smem + K), desc_v0 = smem_desc<DV>(smem + V);
  float dq[NQ], s[NS], dp[NS];
#pragma unroll
  for (int i = 0; i < NQ; ++i) dq[i] = 0.f;
#pragma unroll
  for (int i = 0; i < NS; ++i) s[i] = dp[i] = 0.f;
  auto skip = [&](int j) {  // a ring tile no row of this warpgroup needs
    mbar_wait(&full[j % SLOTS], (j / SLOTS) & 1);
    mbar_arrive(&empty[j % SLOTS]);
  };
  int kv = 0;  // ring tiles before this output tile
  for (int k = 0, i; (i = tile_of(k)) >= 0; ++k) {
    const Dq128Tile<GROUPED> t(i, ord, B, n_qt, a);
    const int buf = k & 1;
    const int q0w = t.q0 + wg * WG_ROWS;
    int it_lo = 0, it_hi = 0;  // no rows below S: compute nothing
    if (q0w < a.S) {
      int lo_w, hi_w;
      kv_range(q0w, a.S, a.window, &lo_w, &hi_w);
      it_lo = (lo_w - t.lo) / BN;
      it_hi = (hi_w - t.lo + BN - 1) / BN;
    }
    const long long row = ((long long)t.b * a.H + t.h) * a.S;
    DqRows r;
    r.q0w = q0w;
    r.qp0 = q0w + r0;
    r.qp1 = r.qp0 + 8;
    r.c0 = c0;
    r.l0 = r.qp0 < a.S ? a.lse[row + r.qp0] * LOG2E : 0.f;
    r.l1 = r.qp1 < a.S ? a.lse[row + r.qp1] * LOG2E : 0.f;
    uint8_t* qb = smem + Q + buf * ROWS;
    const uint64_t desc_q = smem_desc<D>(qb + wg * WG_ROWS * QW * 2);
    const uint64_t desc_do = smem_desc<DV>(smem + DO + buf * DO_ROWS + wg * WG_ROWS * VB * 2);

    mbar_wait(&rows_full[buf], (k >> 1) & 1);
    for (int it = 0; it < it_lo; ++it) skip(kv + it);
    if (it_lo < it_hi) {  // the first tile's S and dP, under the waits below
      const int j = kv + it_lo;
      mbar_wait(&full[j % SLOTS], (j / SLOTS) & 1);
      wg_fence();
      issue_two<D, 64, DK, DV, VW>(s, dp, desc_q, desc_k0 + (TILE >> 4) * (j % SLOTS), desc_do,
                                   desc_v0 + (V_TILE >> 4) * (j % SLOTS), BM, BN);
      wg_commit();
    }
    mbar_wait(&dr_full[buf], (k >> 1) & 1);
    r.d0 = dr_s[buf * BM + wg * WG_ROWS + r0];
    r.d1 = dr_s[buf * BM + wg * WG_ROWS + r0 + 8];
    mbar_arrive(&dr_free[buf]);

    for (int it = it_lo; it < it_hi; ++it) {
      dq128_wait<D>(it, it_lo, kv, s, dp, dq, empty);
      dq128_issue<D, DK, DV>(it, it_lo, it_hi, t.lo, kv, s, dp, dq, full, desc_q, desc_do,
                             desc_k0, desc_v0, r, a);
    }
    // (unconditional: ptxas then knows no product is in flight when dQ is
    // read for the store)
    wg_wait<0>();
    fence_regs<NQ>(dq);
    fence_regs<NS>(s);
    fence_regs<NS>(dp);
    if (it_lo < it_hi) mbar_arrive(&empty[(kv + it_hi - 1) % SLOTS]);
    for (int it = it_hi; it < t.n; ++it) skip(kv + it);
    kv += t.n;

    // dQ into the warpgroup's rows of this tile's Q buffer (every S of the
    // warpgroup is done), as the map's swizzle lays them (swizzled). The
    // producer's warp 1 stores them once every consumer thread has arrived
    // on dq_ready (which also frees the buffer's Q and dO): no consumer
    // waits on a store.
#ifndef BWD_NOSTORE
    if (q0w < a.S) {
      uint8_t* rows = qb + wg * WG_ROWS * QW * 2;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        *reinterpret_cast<uint32_t*>(rows + swizzled<QW>(BM, r0, 8 * n + c0)) =
            pack_bf16(dq[n * 4 + 0] * a.scale, dq[n * 4 + 1] * a.scale);
        *reinterpret_cast<uint32_t*>(rows + swizzled<QW>(BM, r0 + 8, 8 * n + c0)) =
            pack_bf16(dq[n * 4 + 2] * a.scale, dq[n * 4 + 3] * a.scale);
      }
    }
#endif
    fence_proxy_async();
    mbar_arrive(&dq_ready[buf]);
  }
}

// ---------------------------------------------------------------------------
// bf16 dK/dV: KV_WGS consumer warpgroups of 64 KV rows, then the producer
// warpgroup (one warp of it fills the ring).
// ---------------------------------------------------------------------------
// Shared memory from a 1024-byte aligned base: K, V (128 rows each), the Q
// and dO rings, the per-slot lse (log2 units) and Dr vectors, the barriers.
// D: K's and Q's tiles' width; DV: V's and dO's (MLA's 64 beside 96).
template <int D, int DV = D>
struct KvSmem {
  static constexpr int BN = kv_bn<D>();         // rows of a streamed tile
  static constexpr int STAGES = kv_stages<D>();  // slots of the ring
  static constexpr int BM = Shape<KV_WGS>::ROWS;
  static constexpr int ROWS = BM * D * 2;     // K
  static constexpr int V_ROWS = BM * DV * 2;  // V
  static constexpr int TILE = BN * D * 2;     // a ring slot's Q
  static constexpr int DO_TILE = BN * DV * 2; // its dO
  static constexpr int K = 0;
  static constexpr int V = K + ROWS;
  static constexpr int Q = V + V_ROWS;
  static constexpr int DO = Q + STAGES * TILE;
  static constexpr int LSE = DO + STAGES * DO_TILE;  // float [STAGES][BN]
  static constexpr int DR = LSE + STAGES * BN * 4;  // float [STAGES][BN]
  static constexpr int BAR = DR + STAGES * BN * 4;
  static constexpr int BYTES = BAR + (2 * STAGES + 1) * 8 + 1024;  // + alignment slack
};

// A dK/dV consumer thread's keys and the block's query tiles: the
// warpgroup's first key, the thread's first key and query column, the
// block's first query tile and query tiles a head.
struct KvCols {
  int k0w, kp0, c0, qt_lo, n_qt;
};

// One tile of a dK/dV warpgroup's run [it_lo, it_hi) of the block's tiles
// (one head's query tiles that its keys see), with one tile of look-ahead
// as dq_step: tile it's dV and dK products go in one group behind tile
// it + 1's S^T (over DK of the tiles' D columns) and dP^T (over V's).
template <int D, int DK = D, int DV = D>
__device__ __forceinline__ void kv_step(int it, int it_lo, int it_hi, float* s, float* dp,
                                        float* dk, float* dv, uint64_t* full, uint64_t* empty,
                                        const float* lse_s, const float* dr_s, uint64_t desc_k,
                                        uint64_t desc_v, uint64_t desc_q0, uint64_t desc_do0,
                                        const KvCols& c, const TmaArgs& a) {
  using L = KvSmem<D, DV>;
  constexpr int BN = L::BN, STAGES = L::STAGES, VW = DV < DK ? DV : DK;
  constexpr uint64_t SLOT = L::TILE >> 4, DO_SLOT = L::DO_TILE >> 4;  // descriptor units
  wg_wait<0>();
  fence_regs<BN / 2>(s);
  fence_regs<BN / 2>(dp);
  fence_regs<D / 2>(dk);
  fence_regs<DV / 2>(dv);
  if (it > it_lo) mbar_arrive(&empty[(it - 1) % STAGES]);

  // P^T under K1's mask (queries past S dropped), then dS^T = P^T (dP^T -
  // Dr), lse and Dr indexed by the column (query)
  const int st = it % STAGES;
  const int q0 = (c.qt_lo + it % c.n_qt) * BN;
  const float* ls = lse_s + st * BN;
  const float* rs = dr_s + st * BN;
  const bool whole = c.k0w + WG_ROWS - 1 <= q0 && q0 + BN <= a.S &&
                     (a.window <= 0 || q0 + BN - 1 - c.k0w < a.window);
#pragma unroll
  for (int n = 0; n < BN / 8; ++n) {
    const float2 l = *reinterpret_cast<const float2*>(ls + 8 * n + c.c0);
    const float2 d = *reinterpret_cast<const float2*>(rs + 8 * n + c.c0);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = n * 4 + e;
#ifdef BWD_NOEXP
      float p = fmaf(s[i], a.scale_log2, -(e & 1 ? l.y : l.x));
#else
      float p = ex2(fmaf(s[i], a.scale_log2, -(e & 1 ? l.y : l.x)));
      if (!whole &&
          !valid_pair(q0 + 8 * n + c.c0 + (e & 1), e < 2 ? c.kp0 : c.kp0 + 8, a.S, a.window))
        p = 0.f;
#endif
      s[i] = p;
      dp[i] = p * (dp[i] - (e & 1 ? d.y : d.x));
    }
  }
  uint32_t pa[BN / 16][4], sa[BN / 16][4];
  acc_to_a<BN / 16>(pa, s);
  acc_to_a<BN / 16>(sa, dp);
  fence_frag(pa);
  fence_frag(sa);
  fence_regs<BN / 2>(s);
  fence_regs<BN / 2>(dp);

  wg_fence();
  if (it + 1 < it_hi) {  // S^T = K Q^T and dP^T = V dO^T of the next tile
    const int nx = (it + 1) % STAGES;
    mbar_wait(&full[nx], ((it + 1) / STAGES) & 1);
    issue_two<D, BN, DK, DV, VW>(s, dp, desc_k, desc_q0 + SLOT * nx, desc_v,
                                 desc_do0 + DO_SLOT * nx, L::BM, BN);
  }
#ifndef BWD_NOSECOND
  // dV += P^T dO, dK += dS^T Q: dO and Q read MN-major, BN / 16 k16 steps
  // of 16 query rows
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
    mma_rs<DV>(dv, pa[kk], desc_do0 + DO_SLOT * st + mn_step<DV>() * kk, BN);
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
    mma_rs<D>(dk, sa[kk], desc_q0 + SLOT * st + mn_step<D>() * kk, BN);
#endif
  wg_commit();
}

// D: K's and Q's tiles' width; DK: the head dim (96 on D = 128's tiles, as
// dq_d128_kernel<128, 96>: dK written for the first 96 columns; or on
// 96's, three 32-column boxes, dK += dS^T Q one m64n96 product a step);
// DV: V's and dO's tiles' width (D, or MLA's 64: dP^T over its four k16
// steps, dV += P^T dO one m64n64 product a step). The grid: (K, B,
// ceil(S / 128)) blocks, blockIdx.z slowest, so the first KV tiles (the
// heaviest under the causal mask) start first; or, with GROUPED (at
// grouped_order(G)), a 1-D grid of as many, block i taking tile i of the
// TileOrder over the B K heads (head b K + kh) and their KV tiles, rank 0
// the first, its rounds counted in `sms` SMs.
template <int D, int DK = D, int DV = D, bool GROUPED = false>
__global__ void __launch_bounds__(Shape<KV_WGS>::THREADS, 1)
    dkdv_bf16_kernel(const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tdo, TmaArgs a, int B, int sms) {
  using L = KvSmem<D, DV>;
  constexpr int BN = L::BN, STAGES = L::STAGES, VW = DV < DK ? DV : DK;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR);
  uint64_t* empty = full + STAGES;
  uint64_t* kv_full = empty + STAGES;
  float* lse_s = reinterpret_cast<float*>(smem + L::LSE);
  float* dr_s = reinterpret_cast<float*>(smem + L::DR);

  const int G = a.H / a.K;
  int kh = blockIdx.x, b = blockIdx.y, k0 = blockIdx.z * L::BM;
  if constexpr (GROUPED) {
    int head, rank;
    TileOrder(a.K * B, (a.S + L::BM - 1) / L::BM, sms).at(blockIdx.x, &head, &rank);
    kh = head % a.K;
    b = head / a.K;
    k0 = rank * L::BM;
  }
  const int warp = warp_index(), lane = threadIdx.x % 32;

  // the query tiles the block loads for each head: from the tile of its
  // first key to its last key's window edge
  const int last = min(k0 + L::BM, a.S) - 1;
  const int q_hi = a.window > 0 ? min(a.S, last + a.window) : a.S;
  const int qt_lo = k0 / BN, n_qt = (q_hi + BN - 1) / BN - qt_lo;
  const int n_it = G * n_qt;

  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], 32);  // the producer's lanes (lane 0's with the bytes)
      mbar_init(&empty[i], 128 * KV_WGS);
    }
    mbar_init(kv_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * KV_WGS) {  // producer: its first warp's 32 lanes work
    setmaxnreg_dec<PRODUCER_REGS>();
    if (warp > 4 * KV_WGS) return;
    if (lane == 0) {
      mbar_expect_tx(kv_full, L::ROWS + L::V_ROWS);
      tma_tile<D>(smem + L::K, &tk, kv_full, a.k_slots, L::BM, k0, kh, b);
      tma_tile<DV>(smem + L::V, &tv, kv_full, a.v_slots, L::BM, k0, kh, b);
    }
    for (int it = 0; it < n_it; ++it) {
      const int st = it % STAGES;
      const int h = kh * G + it / n_qt, q0 = (qt_lo + it % n_qt) * BN;
      if (it >= STAGES) mbar_wait(&empty[st], ((it / STAGES) - 1) & 1);
      const long long row = ((long long)b * a.H + h) * a.S;
#pragma unroll
      for (int i = lane; i < BN; i += 32) {
        const int qp = q0 + i;
        lse_s[st * BN + i] = qp < a.S ? a.lse[row + qp] * LOG2E : 0.f;
        dr_s[st * BN + i] = qp < a.S ? a.delta[row + qp] : 0.f;
      }
      if (lane == 0) {
        mbar_expect_tx(&full[st], L::TILE + L::DO_TILE);
        tma_tile<D>(smem + L::Q + st * L::TILE, &tq, &full[st], a.q_slots, BN, q0, h, b);
        tma_tile<DV>(smem + L::DO + st * L::DO_TILE, &tdo, &full[st], a.do_slots, BN, q0, h, b);
      } else {
        mbar_arrive(&full[st]);
      }
    }
  } else {  // consumer warpgroup wg: KV rows [k0w, k0w + 64)
    setmaxnreg_inc<Shape<KV_WGS>::REGS>();
    constexpr int NS = BN / 2;  // S^T and dP^T accumulator floats a thread
    constexpr int NK = D / 2;   // dK accumulator floats a thread
    constexpr int NV = DV / 2;  // dV accumulator floats a thread
    const int wg = warp / 4, t = threadIdx.x % 128;
    const int k0w = k0 + wg * WG_ROWS;
    // the query tiles [j_lo, j_hi) of each head's n_qt that these rows see
    int j_lo = 0, j_hi = 0;  // no rows below S: compute nothing
    if (k0w < a.S) {
      const int last_w = min(k0w + WG_ROWS, a.S) - 1;
      const int q_hi_w = a.window > 0 ? min(a.S, last_w + a.window) : a.S;
      j_lo = k0w / BN - qt_lo;
      j_hi = (q_hi_w + BN - 1) / BN - qt_lo;
    }
    // this thread's rows (keys) and its first query column: s[n*4 + i*2 + j]
    // is key kp0 + 8i, query q0 + 8n + c0 + j
    const int kp0 = k0w + (t / 32) * 16 + lane / 4;
    const int c0 = 2 * (lane % 4);

    float dk[NK], dv[NV], s[NS], dp[NS];
#pragma unroll
    for (int i = 0; i < NK; ++i) dk[i] = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) dv[i] = 0.f;
#pragma unroll
    for (int i = 0; i < NS; ++i) s[i] = dp[i] = 0.f;
    const uint64_t desc_k = smem_desc<D>(smem + L::K + wg * WG_ROWS * box_cols<D>() * 2);
    const uint64_t desc_v = smem_desc<DV>(smem + L::V + wg * WG_ROWS * box_cols<DV>() * 2);

    const uint64_t desc_q0 = smem_desc<D>(smem + L::Q), desc_do0 = smem_desc<DV>(smem + L::DO);
    KvCols c;
    c.k0w = k0w;
    c.kp0 = kp0;
    c.c0 = c0;
    c.qt_lo = qt_lo;
    c.n_qt = n_qt;
    auto skip = [&](int it) {  // a tile no key of this warpgroup sees
      mbar_wait(&full[it % STAGES], (it / STAGES) & 1);
      mbar_arrive(&empty[it % STAGES]);
    };

    mbar_wait(kv_full, 0);
    for (int gi = 0; gi < G; ++gi) {  // head kh G + gi's query tiles, a run of them ours
      const int base = gi * n_qt, lo_it = base + j_lo, hi_it = base + j_hi;
      for (int it = base; it < lo_it; ++it) skip(it);
      if (lo_it < hi_it) {
        const int st = lo_it % STAGES;
        mbar_wait(&full[st], (lo_it / STAGES) & 1);
        wg_fence();
        issue_two<D, BN, DK, DV, VW>(s, dp, desc_k, desc_q0 + (L::TILE >> 4) * st, desc_v,
                                     desc_do0 + (L::DO_TILE >> 4) * st, L::BM, BN);
        wg_commit();
        // two steps a trip: ptxas schedules dK/dV's better so (dQ's, on
        // three warpgroups, worse), as measured on an H100
        for (int it = lo_it;;) {
          kv_step<D, DK, DV>(it, lo_it, hi_it, s, dp, dk, dv, full, empty, lse_s, dr_s, desc_k,
                             desc_v, desc_q0, desc_do0, c, a);
          if (++it == hi_it) break;
          kv_step<D, DK, DV>(it, lo_it, hi_it, s, dp, dk, dv, full, empty, lse_s, dr_s, desc_k,
                             desc_v, desc_q0, desc_do0, c, a);
          if (++it == hi_it) break;
        }
        wg_wait<0>();
        fence_regs<NV>(dv);
        fence_regs<NK>(dk);
        mbar_arrive(&empty[(hi_it - 1) % STAGES]);
      }
      for (int it = hi_it; it < base + n_qt; ++it) skip(it);
    }
    store_acc<DK>(dk, a.scale, a.dk, a.dks, b, kh, kp0, c0, a.S);
    store_acc<VW>(dv, 1.f, a.dv, a.dvs, b, kh, kp0, c0, a.S);
  }
}

// ---------------------------------------------------------------------------
// float32: scalar FMA. A block owns F32<D>::FT rows (TPR threads each, the
// row in shared memory with a padded stride, the sums in registers) and
// walks the other side in FB-row tiles read as broadcasts. DV: V's, O's and
// dO's width (D, or MLA's 64 beside 96), of which a thread holds DV / TPR.
// ---------------------------------------------------------------------------
template <int D>
__device__ __forceinline__ void load_rows_f32(float (*dst)[D + 1], const void* src,
                                              const Strides& st, int b, int h, int r0, int n,
                                              int S) {
  const float* base = static_cast<const float*>(src) + b * st.b + h * st.h;
  for (int i = threadIdx.x; i < n * D; i += blockDim.x) {
    const int r = i / D, c = i % D;
    dst[r][c] = r0 + r < S ? base[(r0 + r) * st.s + c] : 0.f;
  }
}

// The sum of a dot product's parts over the TPR threads of a row (a pair of
// neighbouring lanes): both get the same bits (a + b == b + a).
template <int TPR>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = TPR / 2; off > 0; off /= 2) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int D, int DV = D>
__global__ void __launch_bounds__(F32<D>::FT * F32<D>::TPR) dkdv_f32_kernel(Args a) {
  constexpr int FT = F32<D>::FT, FB = F32<D>::FB, TPR = F32<D>::TPR, DP = F32<D>::DP;
  constexpr int VP = DV / TPR;
  __shared__ float k_s[FT][D + 1], v_s[FT][DV + 1];
  __shared__ float q_s[FB][D + 1], do_s[FB][DV + 1];
  __shared__ float lse_s[FB], dr_s[FB];

  const int kt = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int G = a.H / a.K;
  const int k0 = kt * FT, j = threadIdx.x / TPR, kp = k0 + j;
  const int d0 = (threadIdx.x % TPR) * DP;  // this thread's first column of q and k
  const int e0 = (threadIdx.x % TPR) * VP;  // and of v and dO
  load_rows_f32<D>(k_s, a.k, a.ks, b, kh, k0, FT, a.S);
  load_rows_f32<DV>(v_s, a.v, a.vs, b, kh, k0, FT, a.S);
  float dk[DP], dv[VP];
#pragma unroll
  for (int d = 0; d < DP; ++d) dk[d] = 0.f;
#pragma unroll
  for (int d = 0; d < VP; ++d) dv[d] = 0.f;

  const int q_hi = a.window > 0 ? min(a.S, k0 + FT - 1 + a.window) : a.S;
  for (int gi = 0; gi < G; ++gi) {
    const int h = kh * G + gi;
    const float* lse = a.lse + ((long long)b * a.H + h) * a.S;
    const float* dr = a.delta + ((long long)b * a.H + h) * a.S;
    for (int q0 = (k0 / FB) * FB; q0 < q_hi; q0 += FB) {
      __syncthreads();
      load_rows_f32<D>(q_s, a.q, a.qs, b, h, q0, FB, a.S);
      load_rows_f32<DV>(do_s, a.dout, a.dos, b, h, q0, FB, a.S);
      if (threadIdx.x < FB) {
        const int qp = q0 + threadIdx.x;
        lse_s[threadIdx.x] = qp < a.S ? lse[qp] : 0.f;
        dr_s[threadIdx.x] = qp < a.S ? dr[qp] : 0.f;
      }
      __syncthreads();
      for (int i = 0; i < FB; ++i) {
        const bool ok = valid_pair(q0 + i, kp, a.S, a.window);
        // (with TPR > 1 the row's threads go on to the shuffles together)
        if (TPR == 1 && !ok) continue;
        float s = 0.f, dp = 0.f;
#pragma unroll
        for (int d = 0; d < DP; ++d) s += q_s[i][d0 + d] * k_s[j][d0 + d];
#pragma unroll
        for (int d = 0; d < VP; ++d) dp += do_s[i][e0 + d] * v_s[j][e0 + d];
        s = row_sum<TPR>(s);
        dp = row_sum<TPR>(dp);
        if (!ok) continue;
        const float p = expf(s * a.scale - lse_s[i]);
        const float ds = p * (dp - dr_s[i]);
#pragma unroll
        for (int d = 0; d < VP; ++d) dv[d] += p * do_s[i][e0 + d];
#pragma unroll
        for (int d = 0; d < DP; ++d) dk[d] += ds * q_s[i][d0 + d];
      }
    }
  }
  if (kp < a.S) {
    float* dkr = static_cast<float*>(a.dk) + b * a.dks.b + kh * a.dks.h + kp * a.dks.s + d0;
    float* dvr = static_cast<float*>(a.dv) + b * a.dvs.b + kh * a.dvs.h + kp * a.dvs.s + e0;
#pragma unroll
    for (int d = 0; d < DP; ++d) dkr[d] = dk[d] * a.scale;
#pragma unroll
    for (int d = 0; d < VP; ++d) dvr[d] = dv[d];
  }
}

// dQ of FT query rows, and their Dr = rowsum(dO o), written for dK/dV
template <int D, int DV = D>
__global__ void __launch_bounds__(F32<D>::FT * F32<D>::TPR) dq_f32_kernel(Args a) {
  constexpr int FT = F32<D>::FT, FB = F32<D>::FB, TPR = F32<D>::TPR, DP = F32<D>::DP;
  constexpr int VP = DV / TPR;
  __shared__ float q_s[FT][D + 1], do_s[FT][DV + 1];
  __shared__ float k_s[FB][D + 1], v_s[FB][DV + 1];

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (a.H / a.K);
  const int q0 = qt * FT, i = threadIdx.x / TPR, qp = q0 + i;
  const int d0 = (threadIdx.x % TPR) * DP;  // this thread's first column of q and k
  const int e0 = (threadIdx.x % TPR) * VP;  // and of v, o and dO
  load_rows_f32<D>(q_s, a.q, a.qs, b, h, q0, FT, a.S);
  load_rows_f32<DV>(do_s, a.dout, a.dos, b, h, q0, FT, a.S);
  __syncthreads();
  const long long row = ((long long)b * a.H + h) * a.S + qp;
  float lse = 0.f, dr = 0.f;
  if (qp < a.S) {
    const float* o = static_cast<const float*>(a.o) + b * a.os.b + h * a.os.h + qp * a.os.s;
#pragma unroll
    for (int d = 0; d < VP; ++d) dr += do_s[i][e0 + d] * o[e0 + d];
  }
  dr = row_sum<TPR>(dr);  // (a row past S: both threads hold 0)
  if (qp < a.S) {
    if (d0 == 0) a.delta[row] = dr;
    lse = a.lse[row];
  }
  float dq[DP];
#pragma unroll
  for (int d = 0; d < DP; ++d) dq[d] = 0.f;

  const int k_lo = a.window > 0 ? max(q0 - a.window + 1, 0) : 0;
  const int k_hi = min(q0 + FT, a.S);
  for (int k0 = (k_lo / FB) * FB; k0 < k_hi; k0 += FB) {
    __syncthreads();
    load_rows_f32<D>(k_s, a.k, a.ks, b, kh, k0, FB, a.S);
    load_rows_f32<DV>(v_s, a.v, a.vs, b, kh, k0, FB, a.S);
    __syncthreads();
    for (int j = 0; j < FB; ++j) {
      const bool ok = valid_pair(qp, k0 + j, a.S, a.window);
      if (TPR == 1 && !ok) continue;
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < DP; ++d) s += q_s[i][d0 + d] * k_s[j][d0 + d];
#pragma unroll
      for (int d = 0; d < VP; ++d) dp += do_s[i][e0 + d] * v_s[j][e0 + d];
      s = row_sum<TPR>(s);
      dp = row_sum<TPR>(dp);
      if (!ok) continue;
      const float ds = expf(s * a.scale - lse) * (dp - dr);
#pragma unroll
      for (int d = 0; d < DP; ++d) dq[d] += ds * k_s[j][d0 + d];
    }
  }
  if (qp < a.S) {
    float* dqr = static_cast<float*>(a.dq) + b * a.dqs.b + h * a.dqs.h + qp * a.dqs.s + d0;
#pragma unroll
    for (int d = 0; d < DP; ++d) dqr[d] = dq[d] * a.scale;
  }
}

// ---------------------------------------------------------------------------
// Host side: tensor maps and launches.
// ---------------------------------------------------------------------------
// The SMs of device `dev`: the persistent dQ grid's blocks, and the rounds
// the dK/dV grid's TileOrder counts.
int sm_count(int dev, int* n) {
  static int sms[64];
  if (dev < 64 && sms[dev]) {
    *n = sms[dev];
    return 0;
  }
  const cudaError_t err = cudaDeviceGetAttribute(n, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && dev < 64) sms[dev] = *n;
  return (int)err;
}

// Once per kernel and device: allow its dynamic shared memory above 48 KB,
// and check that its register count at launch leaves room for the
// consumers' setmaxnreg.inc from the registers the producer warpgroup
// gives up (an increase the pool cannot serve would never return).
template <int NC, typename Kernel>
int prepare(Kernel kernel, int smem, unsigned long long* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 64 && (*done >> dev & 1)) return 0;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  const int r = attr.numRegs;
  constexpr int cons = Shape<NC>::REGS;
  if (r > cons || r < PRODUCER_REGS || (r - PRODUCER_REGS) * 128 < (cons - r) * 128 * NC)
    return (int)cudaErrorInvalidConfiguration;
  if (dev < 64) *done |= 1ull << dev;
  return 0;
}

// dq_d128_kernel<D, DK, DV, GROUPED>: tensor maps of 128-row Q and dO boxes, 64-row
// K, V and dQ boxes, Q's, K's and dQ's DK columns wide and dO's and V's
// VW, each in its tiles' boxes (box_cols); a persistent grid of one block
// an SM (at most one a tile). Once per device: its shared memory above 48
// KB, and the check that its register count at launch leaves room for the
// consumers' setmaxnreg.inc.
template <int D, int DK, int DV, bool GROUPED>
int launch_dq128(const Args& a, int B, TmaArgs t, cudaStream_t st) {
  using namespace dq128;
  constexpr int VW = DV < DK ? DV : DK, BYTES = Dq128Smem<D, DV>::BYTES;
  constexpr int QW = box_cols<D>(), VB = box_cols<DV>();
  CUtensorMap tq, tdo, tk, tv, tdq;
  int dq_slots = 0;
  int rc = encode(&tq, a.q, DK, a.S, a.H, B, a.qs.s, a.qs.h, a.qs.b, BM, &t.q_slots, QW);
  if (!rc)
    rc = encode(&tdo, a.dout, VW, a.S, a.H, B, a.dos.s, a.dos.h, a.dos.b, BM, &t.do_slots, VB);
  if (!rc) rc = encode(&tk, a.k, DK, a.S, a.K, B, a.ks.s, a.ks.h, a.ks.b, BN, &t.k_slots, QW);
  if (!rc) rc = encode(&tv, a.v, VW, a.S, a.K, B, a.vs.s, a.vs.h, a.vs.b, BN, &t.v_slots, VB);
  if (!rc)
    rc = encode(&tdq, a.dq, DK, a.S, a.H, B, a.dqs.s, a.dqs.h, a.dqs.b, WG_ROWS, &dq_slots, QW);
  if (rc) return rc;
  int dev = 0, n_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if ((rc = sm_count(dev, &n_sm))) return rc;
  static unsigned long long ready = 0;
  if (dev >= 64 || !(ready >> dev & 1)) {
    err = cudaFuncSetAttribute(dq_d128_kernel<D, DK, DV, GROUPED>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, BYTES);
    if (err != cudaSuccess) return (int)err;
    cudaFuncAttributes attr;
    if ((err = cudaFuncGetAttributes(&attr, dq_d128_kernel<D, DK, DV, GROUPED>)) != cudaSuccess)
      return (int)err;
    const int r = attr.numRegs, prod = dq128::PRODUCER_REGS, cons = dq128::CONSUMER_REGS;
    if (r > cons || r < prod || (r - prod) * 128 < (cons - r) * 128 * NC)
      return (int)cudaErrorInvalidConfiguration;
    if (dev < 64) ready |= 1ull << dev;
  }
  const int tiles = (a.S + BM - 1) / BM * a.H * B;
  dq_d128_kernel<D, DK, DV, GROUPED><<<tiles < n_sm ? tiles : n_sm, THREADS, BYTES, st>>>(
      tq, tdo, tk, tv, tdq, t, static_cast<const bf16*>(a.o), a.os, dq_slots, B);
  return (int)cudaGetLastError();
}

// D: K's and Q's tiles' width, DK the head dim (96 on D = 128's tiles or on
// 96's), DV V's and dO's tiles' width.
template <int D, int DK = D, int DV = D, bool GROUPED = false>
int launch_bf16(int kernel, const Args& a, int B, cudaStream_t st) {
  // Encoding a tensor map needs a current context, and a host thread that
  // has made no CUDA call yet (the autograd engine's worker, when this is
  // its first) has none: bind the device's primary context.
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaSetDevice(dev);
  if (err != cudaSuccess) return (int)err;
  TmaArgs t;
  t.lse = a.lse;
  t.delta = a.delta;
  t.dq = a.dq;
  t.dk = a.dk;
  t.dv = a.dv;
  t.dqs = a.dqs;
  t.dks = a.dks;
  t.dvs = a.dvs;
  t.H = a.H;
  t.K = a.K;
  t.S = a.S;
  t.window = a.window;
  t.scale = a.scale;
  t.scale_log2 = a.scale * LOG2E;
  int rc;
  if (kernel == 1) {
    if constexpr (D > 64) {  // 96 and 128: dq_d128_kernel
      return launch_dq128<D, DK, DV, GROUPED>(a, B, t, st);
    } else {
      CUtensorMap tq, tdo, to, tk, tv;
      constexpr int BM = DqSmem<D>::BM;
      rc = encode(&tq, a.q, D, a.S, a.H, B, a.qs.s, a.qs.h, a.qs.b, BM, &t.q_slots);
      if (!rc)
        rc = encode(&tdo, a.dout, D, a.S, a.H, B, a.dos.s, a.dos.h, a.dos.b, BM, &t.do_slots);
      if (!rc) rc = encode(&to, a.o, D, a.S, a.H, B, a.os.s, a.os.h, a.os.b, BM, &t.o_slots);
      if (!rc) rc = encode(&tk, a.k, D, a.S, a.K, B, a.ks.s, a.ks.h, a.ks.b, BN, &t.k_slots);
      if (!rc) rc = encode(&tv, a.v, D, a.S, a.K, B, a.vs.s, a.vs.h, a.vs.b, BN, &t.v_slots);
      static unsigned long long done = 0;
      constexpr int NC = dq_wgs<D>();
      if (!rc) rc = prepare<NC>(dq_bf16_kernel<D>, DqSmem<D>::BYTES, &done);
      if (rc) return rc;
      dq_bf16_kernel<D><<<dim3(a.H, B, (a.S + BM - 1) / BM), Shape<NC>::THREADS,
                          DqSmem<D>::BYTES, st>>>(
          tq, tdo, to, tk, tv, t);
    }
  } else {
    CUtensorMap tk, tv, tq, tdo;
    using L = KvSmem<D, DV>;
    constexpr int BM = L::BM, QR = L::BN, VW = DV < DK ? DV : DK;
    constexpr int KB = box_cols<D>(), VB = box_cols<DV>();
    rc = encode(&tk, a.k, DK, a.S, a.K, B, a.ks.s, a.ks.h, a.ks.b, BM, &t.k_slots, KB);
    if (!rc) rc = encode(&tv, a.v, VW, a.S, a.K, B, a.vs.s, a.vs.h, a.vs.b, BM, &t.v_slots, VB);
    if (!rc) rc = encode(&tq, a.q, DK, a.S, a.H, B, a.qs.s, a.qs.h, a.qs.b, QR, &t.q_slots, KB);
    if (!rc)
      rc = encode(&tdo, a.dout, VW, a.S, a.H, B, a.dos.s, a.dos.h, a.dos.b, QR, &t.do_slots, VB);
    int n_sm = 0;  // (the grouped order's rounds)
    if (!rc && GROUPED) rc = sm_count(dev, &n_sm);
    static unsigned long long done = 0;
    if (!rc) rc = prepare<KV_WGS>(dkdv_bf16_kernel<D, DK, DV, GROUPED>, L::BYTES, &done);
    if (rc) return rc;
    const dim3 grid = GROUPED ? dim3(a.K * B * ((a.S + BM - 1) / BM))
                              : dim3(a.K, B, (a.S + BM - 1) / BM);
    dkdv_bf16_kernel<D, DK, DV, GROUPED><<<grid, Shape<KV_WGS>::THREADS, L::BYTES, st>>>(
        tk, tv, tq, tdo, t, B, n_sm);
  }
  return (int)cudaGetLastError();
}

// D: the bf16 tiles' width of q and k, DK their head dim, DV v's tiles'
// width (the float32 kernels take DK and V's VW columns as they are).
template <int D, int DK = D, int DV = D>
int launch(int kernel, const Args& a, int B, int dtype, cudaStream_t st) {
  if (dtype == 1)
    return grouped_order(a.H / a.K) ? launch_bf16<D, DK, DV, true>(kernel, a, B, st)
                                    : launch_bf16<D, DK, DV, false>(kernel, a, B, st);
  constexpr int VW = DV < DK ? DV : DK;
  constexpr int rows = F32<DK>::FT, threads = F32<DK>::FT * F32<DK>::TPR;
  if (kernel == 1)
    dq_f32_kernel<DK, VW><<<dim3((a.S + rows - 1) / rows, a.H, B), threads, 0, st>>>(a);
  else
    dkdv_f32_kernel<DK, VW><<<dim3((a.S + rows - 1) / rows, a.K, B), threads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// kernel: 1 = dQ (it also writes delta = rowsum(dO o)), 2 = dK/dV (it reads
// that delta, so it runs after kernel 1 on the same stream). D: q's and k's
// head dim (the scale 1 / sqrt(D)); Dv: v's, o's and dO's (pair_ok).
// strides: the (batch, head, seq) element strides of q, k, v, o, dO, dq,
// dk, dv in that order (24 values). lse and delta: float32 [B,H,S]
// contiguous. dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t.
extern "C" int repro_flash_attention_bwd_v(int kernel, const void* q, const void* k,
                                           const void* v, const void* o, const void* dout,
                                           const float* lse, float* delta, void* dq, void* dk,
                                           void* dv, int B, int H, int K, int S, int D, int Dv,
                                           const long long* strides, int window, int dtype,
                                           void* stream) {
  if (B < 1 || S < 1 || K < 1 || H % K != 0 || kernel < 1 || kernel > 2 ||
      (dtype != 0 && dtype != 1) || !pair_ok(D, Dv))
    return (int)cudaErrorInvalidValue;
  Args a = {};
  a.q = q; a.k = k; a.v = v; a.o = o; a.dout = dout;
  a.lse = lse; a.delta = delta;
  a.dq = dq; a.dk = dk; a.dv = dv;
  a.H = H; a.K = K; a.S = S;
  Strides* all[8] = {&a.qs, &a.ks, &a.vs, &a.os, &a.dos, &a.dqs, &a.dks, &a.dvs};
  for (int i = 0; i < 8; ++i) *all[i] = {strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  a.window = window;
  a.scale = 1.0f / sqrtf((float)D);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 128) return launch<128>(kernel, a, B, dtype, st);
  if (D == 96 && Dv == 64) return launch<96, 96, 64>(kernel, a, B, dtype, st);
  if (D == 96) return launch<128, 96>(kernel, a, B, dtype, st);
  if (D == 64) return launch<64>(kernel, a, B, dtype, st);
  if (D == 32) return launch<32>(kernel, a, B, dtype, st);
  return (int)cudaErrorInvalidValue;
}

// The entry with v, o and dO as wide as q (Dv = D).
extern "C" int repro_flash_attention_bwd(int kernel, const void* q, const void* k,
                                         const void* v, const void* o, const void* dout,
                                         const float* lse, float* delta, void* dq, void* dk,
                                         void* dv, int B, int H, int K, int S, int D,
                                         const long long* strides, int window, int dtype,
                                         void* stream) {
  return repro_flash_attention_bwd_v(kernel, q, k, v, o, dout, lse, delta, dq, dk, dv, B, H, K,
                                     S, D, D, strides, window, dtype, stream);
}
