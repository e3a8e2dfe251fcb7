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
//  * dQ, launched first: a block owns 192 query rows of one (b, query
//    head): three consumer warpgroups of 64 rows and a producer warpgroup.
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
//    tiles in order, head kh G + gi's Q and dO tiles of 64 rows into the
//    ring, with that tile's lse (times log2e) and Dr in a per-slot float32
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
//    zero-filled by the TMA and never stored.
//  * Diagnostic macros (tools/bwd_breakdown.py): BWD_DQ_WGS (dQ's consumer
//    warpgroups), BWD_NOEXP (P = its exponent's argument, no mask) and
//    BWD_NOSECOND (no dQ, dV, dK products); the last two give wrong
//    gradients by design.
// float32 inputs have no exact tensor-core path (TF32 would round them), so
// they take scalar kernels (one thread a row, the other side's rows read
// from shared memory as broadcasts); their dQ kernel also computes each
// row's Dr from its own O and dO row, writes it, and runs first.
//
// Layout: every tensor is addressed by (batch, head, seq) strides with a
// contiguous head dim; lse and Dr are float32 [B,H,S] contiguous. One C
// entry launches either kernel and returns cudaGetLastError() after its
// launch (or the error of encoding a tensor map).

#include <cuda.h>  // CUtensorMap and its enums; the encoder is looked up at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
constexpr int DQ_WGS = BWD_DQ_WGS, KV_WGS = 2;
constexpr int PRODUCER_REGS = 24;
template <int NC>
struct Shape {
  static constexpr int ROWS = WG_ROWS * NC;   // rows a block owns
  static constexpr int THREADS = 128 * (NC + 1);
  static constexpr int REGS = NC == 2 ? 240 : 160;  // a consumer's, after setmaxnreg
};
constexpr int BN = 64;                         // rows of a streamed tile
constexpr int STAGES = 3;                      // slots of the ring
constexpr int FT = 64;  // rows a block owns (float32 kernels: a thread each)
constexpr int FB = 16;  // rows of the other side's broadcast tile (float32)

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

// ---------------------------------------------------------------------------
// Hopper building blocks (inline PTX), as flash_attention.cu has them.
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
// apart. The same descriptor serves a K-major read (k16 steps of 32 bytes
// along a row: + 2) and an MN-major read under the transpose bit (k16
// steps of 16 rows: + mn_step), since one swizzle atom spans the row.
template <int D>
__device__ __forceinline__ uint64_t smem_desc(const void* tile) {
  constexpr uint64_t layout = D == 64 ? 1 : 2;  // 1: 128-byte swizzle, 2: 64-byte
  constexpr uint64_t sbo = 8 * D * 2;
  return (uint64_t)((smem_addr(tile) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((sbo >> 4) << 32) | (layout << 62);
}
template <int D>
__device__ __forceinline__ constexpr uint64_t mn_step() {
  return (16 * D * 2) >> 4;
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed groups of this warpgroup's wgmma are in
// flight (they complete in order).
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma (the asm statements above are ordered).
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
// The same for A fragments: they are written before the wgmma.fence that
// precedes the wgmma reading them, not sunk past it.
__device__ __forceinline__ void fence_frag(uint32_t (&r)[BN / 16][4]) {
#pragma unroll
  for (int i = 0; i < BN / 16; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
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

// s = A_s B_s^T and dp = A_p B_p^T, 64 x 64 each over D: every operand
// K-major in shared memory (descriptors of its first k16 step)
template <int D>
__device__ __forceinline__ void issue_two(float* s, float* dp, uint64_t as, uint64_t bs,
                                          uint64_t ap, uint64_t bp) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) wgmma_ss_n64(s, as + 2 * kk, bs + 2 * kk, kk > 0);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) wgmma_ss_n64(dp, ap + 2 * kk, bp + 2 * kk, kk > 0);
}

// acc[64 x D] += A[64 x 16] (registers) * B[16 x D] (MN-major)
template <int D>
__device__ __forceinline__ void mma_rs(float* d, const uint32_t* a, uint64_t db) {
  if constexpr (D == 64)
    wgmma_rs_n64(d, a, db);
  else
    wgmma_rs_n32(d, a, db);
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// threadIdx.x / 32 through a shuffle, so that the compiler knows it is the
// same in every lane: branches on it (and on the warpgroup index) are then
// not divergent, and the wgmma inside them need not be serialized
__device__ __forceinline__ int warp_index() {
  return __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
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

// The 64 x 64 accumulator as the A fragments of four k16 steps, rounded to
// bf16: columns 16kk .. 16kk+15 are its n8 blocks 2kk and 2kk+1.
__device__ __forceinline__ void acc_to_a(uint32_t (&r)[BN / 16][4], const float* c) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
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
  static constexpr int BM = Shape<DQ_WGS>::ROWS;
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
  acc_to_a(ds, dp);
  fence_frag(ds);
  fence_regs<BN / 2>(s);
  fence_regs<BN / 2>(dp);

  wg_fence();
  if (it + 1 < it_hi) {  // S = Q K^T and dP = dO V^T (64 x 64 each) of the next tile
    const int nx = (it + 1) % STAGES;
    mbar_wait(&full[nx], ((it + 1) / STAGES) & 1);
    issue_two<D>(s, dp, desc_q, desc_k0 + SLOT * nx, desc_do, desc_v0 + SLOT * nx);
  }
#ifndef BWD_NOSECOND
  // dQ += dS K: K read MN-major, BN / 16 k16 steps of 16 key rows
  const uint64_t dk = desc_k0 + SLOT * (it % STAGES);
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) mma_rs<D>(dq, ds[kk], dk + mn_step<D>() * kk);
#endif
  wg_commit();
}

template <int D>
__global__ void __launch_bounds__(Shape<DQ_WGS>::THREADS, 1)
    dq_bf16_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                   const __grid_constant__ CUtensorMap to, const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, TmaArgs a) {
  using L = DqSmem<D>;
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
      tma_load(smem + L::Q, &tq, rows_full, a.q_slots, q0, h, b);
      tma_load(smem + L::DO, &tdo, rows_full, a.do_slots, q0, h, b);
      tma_load(smem + L::O, &to, rows_full, a.o_slots, q0, h, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % STAGES;
        if (it >= STAGES) mbar_wait(&empty[st], ((it / STAGES) - 1) & 1);
        mbar_expect_tx(&full[st], 2 * L::TILE);
        tma_load(smem + L::K + st * L::TILE, &tk, &full[st], a.k_slots, lo + it * BN, kh, b);
        tma_load(smem + L::V + st * L::TILE, &tv, &full[st], a.v_slots, lo + it * BN, kh, b);
      }
    }
  } else {  // consumer warpgroup wg: query rows [q0w, q0w + 64)
    setmaxnreg_inc<Shape<DQ_WGS>::REGS>();
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
    // one half of the row's bytes in both tiles; rows past S are zeros
    mbar_wait(rows_full, 0);
    {
      const int rr = wg * WG_ROWS + t / 2;
      const uint4* po = reinterpret_cast<const uint4*>(smem + L::O + rr * D * 2 + (t & 1) * D);
      const uint4* pd = reinterpret_cast<const uint4*>(smem + L::DO + rr * D * 2 + (t & 1) * D);
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
    const uint64_t desc_q = smem_desc<D>(smem + L::Q + wg * WG_ROWS * D * 2);
    const uint64_t desc_do = smem_desc<D>(smem + L::DO + wg * WG_ROWS * D * 2);
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
                   desc_v0 + (L::TILE >> 4) * st);
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
// bf16 dK/dV: KV_WGS consumer warpgroups of 64 KV rows, then the producer
// warpgroup (one warp of it fills the ring).
// ---------------------------------------------------------------------------
// Shared memory from a 1024-byte aligned base: K, V (128 rows each), the Q
// and dO rings, the per-slot lse (log2 units) and Dr vectors, the barriers.
template <int D>
struct KvSmem {
  static constexpr int BM = Shape<KV_WGS>::ROWS;
  static constexpr int ROWS = BM * D * 2;
  static constexpr int TILE = BN * D * 2;
  static constexpr int K = 0;
  static constexpr int V = K + ROWS;
  static constexpr int Q = V + ROWS;
  static constexpr int DO = Q + STAGES * TILE;
  static constexpr int LSE = DO + STAGES * TILE;  // float [STAGES][BN]
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
// it + 1's S^T and dP^T.
template <int D>
__device__ __forceinline__ void kv_step(int it, int it_lo, int it_hi, float* s, float* dp,
                                        float* dk, float* dv, uint64_t* full, uint64_t* empty,
                                        const float* lse_s, const float* dr_s, uint64_t desc_k,
                                        uint64_t desc_v, uint64_t desc_q0, uint64_t desc_do0,
                                        const KvCols& c, const TmaArgs& a) {
  constexpr uint64_t SLOT = (BN * D * 2) >> 4;  // a ring slot in descriptor units
  wg_wait<0>();
  fence_regs<BN / 2>(s);
  fence_regs<BN / 2>(dp);
  fence_regs<D / 2>(dk);
  fence_regs<D / 2>(dv);
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
  acc_to_a(pa, s);
  acc_to_a(sa, dp);
  fence_frag(pa);
  fence_frag(sa);
  fence_regs<BN / 2>(s);
  fence_regs<BN / 2>(dp);

  wg_fence();
  if (it + 1 < it_hi) {  // S^T = K Q^T and dP^T = V dO^T of the next tile
    const int nx = (it + 1) % STAGES;
    mbar_wait(&full[nx], ((it + 1) / STAGES) & 1);
    issue_two<D>(s, dp, desc_k, desc_q0 + SLOT * nx, desc_v, desc_do0 + SLOT * nx);
  }
#ifndef BWD_NOSECOND
  // dV += P^T dO, dK += dS^T Q: dO and Q read MN-major, BN / 16 k16 steps
  // of 16 query rows
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
    mma_rs<D>(dv, pa[kk], desc_do0 + SLOT * st + mn_step<D>() * kk);
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
    mma_rs<D>(dk, sa[kk], desc_q0 + SLOT * st + mn_step<D>() * kk);
#endif
  wg_commit();
}

template <int D>
__global__ void __launch_bounds__(Shape<KV_WGS>::THREADS, 1)
    dkdv_bf16_kernel(const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tdo, TmaArgs a) {
  using L = KvSmem<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR);
  uint64_t* empty = full + STAGES;
  uint64_t* kv_full = empty + STAGES;
  float* lse_s = reinterpret_cast<float*>(smem + L::LSE);
  float* dr_s = reinterpret_cast<float*>(smem + L::DR);

  const int kh = blockIdx.x, b = blockIdx.y;
  const int k0 = blockIdx.z * L::BM;  // the low KV tiles, heaviest under causal, first
  const int G = a.H / a.K;
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
      mbar_expect_tx(kv_full, 2 * L::ROWS);
      tma_load(smem + L::K, &tk, kv_full, a.k_slots, k0, kh, b);
      tma_load(smem + L::V, &tv, kv_full, a.v_slots, k0, kh, b);
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
        mbar_expect_tx(&full[st], 2 * L::TILE);
        tma_load(smem + L::Q + st * L::TILE, &tq, &full[st], a.q_slots, q0, h, b);
        tma_load(smem + L::DO + st * L::TILE, &tdo, &full[st], a.do_slots, q0, h, b);
      } else {
        mbar_arrive(&full[st]);
      }
    }
  } else {  // consumer warpgroup wg: KV rows [k0w, k0w + 64)
    setmaxnreg_inc<Shape<KV_WGS>::REGS>();
    constexpr int NS = BN / 2;  // S^T and dP^T accumulator floats a thread
    constexpr int NK = D / 2;   // dK, dV accumulator floats a thread
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

    float dk[NK], dv[NK], s[NS], dp[NS];
#pragma unroll
    for (int i = 0; i < NK; ++i) dk[i] = dv[i] = 0.f;
#pragma unroll
    for (int i = 0; i < NS; ++i) s[i] = dp[i] = 0.f;
    const uint64_t desc_k = smem_desc<D>(smem + L::K + wg * WG_ROWS * D * 2);
    const uint64_t desc_v = smem_desc<D>(smem + L::V + wg * WG_ROWS * D * 2);

    const uint64_t desc_q0 = smem_desc<D>(smem + L::Q), desc_do0 = smem_desc<D>(smem + L::DO);
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
        issue_two<D>(s, dp, desc_k, desc_q0 + (L::TILE >> 4) * st, desc_v,
                     desc_do0 + (L::TILE >> 4) * st);
        wg_commit();
        // two steps a trip: ptxas schedules dK/dV's better so (dQ's, on
        // three warpgroups, worse), as measured on an H100
        for (int it = lo_it;;) {
          kv_step<D>(it, lo_it, hi_it, s, dp, dk, dv, full, empty, lse_s, dr_s, desc_k, desc_v,
                     desc_q0, desc_do0, c, a);
          if (++it == hi_it) break;
          kv_step<D>(it, lo_it, hi_it, s, dp, dk, dv, full, empty, lse_s, dr_s, desc_k, desc_v,
                     desc_q0, desc_do0, c, a);
          if (++it == hi_it) break;
        }
        wg_wait<0>();
        fence_regs<NK>(dv);
        fence_regs<NK>(dk);
        mbar_arrive(&empty[(hi_it - 1) % STAGES]);
      }
      for (int it = hi_it; it < base + n_qt; ++it) skip(it);
    }
    store_acc<D>(dk, a.scale, a.dk, a.dks, b, kh, kp0, c0, a.S);
    store_acc<D>(dv, 1.f, a.dv, a.dvs, b, kh, kp0, c0, a.S);
  }
}

// ---------------------------------------------------------------------------
// float32: scalar FMA. A block owns FT rows (one thread each, the row in
// shared memory with a padded stride, the sums in registers) and walks the
// other side in FB-row tiles read as broadcasts.
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

template <int D>
__global__ void __launch_bounds__(FT) dkdv_f32_kernel(Args a) {
  __shared__ float k_s[FT][D + 1], v_s[FT][D + 1];
  __shared__ float q_s[FB][D + 1], do_s[FB][D + 1];
  __shared__ float lse_s[FB], dr_s[FB];

  const int kt = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int G = a.H / a.K;
  const int k0 = kt * FT, j = threadIdx.x, kp = k0 + j;
  load_rows_f32<D>(k_s, a.k, a.ks, b, kh, k0, FT, a.S);
  load_rows_f32<D>(v_s, a.v, a.vs, b, kh, k0, FT, a.S);
  float dk[D], dv[D];
#pragma unroll
  for (int d = 0; d < D; ++d) dk[d] = dv[d] = 0.f;

  const int q_hi = a.window > 0 ? min(a.S, k0 + FT - 1 + a.window) : a.S;
  for (int gi = 0; gi < G; ++gi) {
    const int h = kh * G + gi;
    const float* lse = a.lse + ((long long)b * a.H + h) * a.S;
    const float* dr = a.delta + ((long long)b * a.H + h) * a.S;
    for (int q0 = (k0 / FB) * FB; q0 < q_hi; q0 += FB) {
      __syncthreads();
      load_rows_f32<D>(q_s, a.q, a.qs, b, h, q0, FB, a.S);
      load_rows_f32<D>(do_s, a.dout, a.dos, b, h, q0, FB, a.S);
      if (threadIdx.x < FB) {
        const int qp = q0 + threadIdx.x;
        lse_s[threadIdx.x] = qp < a.S ? lse[qp] : 0.f;
        dr_s[threadIdx.x] = qp < a.S ? dr[qp] : 0.f;
      }
      __syncthreads();
      for (int i = 0; i < FB; ++i) {
        if (!valid_pair(q0 + i, kp, a.S, a.window)) continue;
        float s = 0.f, dp = 0.f;
#pragma unroll
        for (int d = 0; d < D; ++d) {
          s += q_s[i][d] * k_s[j][d];
          dp += do_s[i][d] * v_s[j][d];
        }
        const float p = expf(s * a.scale - lse_s[i]);
        const float ds = p * (dp - dr_s[i]);
#pragma unroll
        for (int d = 0; d < D; ++d) {
          dv[d] += p * do_s[i][d];
          dk[d] += ds * q_s[i][d];
        }
      }
    }
  }
  if (kp < a.S) {
    float* dkr = static_cast<float*>(a.dk) + b * a.dks.b + kh * a.dks.h + kp * a.dks.s;
    float* dvr = static_cast<float*>(a.dv) + b * a.dvs.b + kh * a.dvs.h + kp * a.dvs.s;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      dkr[d] = dk[d] * a.scale;
      dvr[d] = dv[d];
    }
  }
}

// dQ of FT query rows, and their Dr = rowsum(dO o), written for dK/dV
template <int D>
__global__ void __launch_bounds__(FT) dq_f32_kernel(Args a) {
  __shared__ float q_s[FT][D + 1], do_s[FT][D + 1];
  __shared__ float k_s[FB][D + 1], v_s[FB][D + 1];

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (a.H / a.K);
  const int q0 = qt * FT, i = threadIdx.x, qp = q0 + i;
  load_rows_f32<D>(q_s, a.q, a.qs, b, h, q0, FT, a.S);
  load_rows_f32<D>(do_s, a.dout, a.dos, b, h, q0, FT, a.S);
  __syncthreads();
  const long long row = ((long long)b * a.H + h) * a.S + qp;
  float lse = 0.f, dr = 0.f;
  if (qp < a.S) {
    const float* o = static_cast<const float*>(a.o) + b * a.os.b + h * a.os.h + qp * a.os.s;
#pragma unroll
    for (int d = 0; d < D; ++d) dr += do_s[i][d] * o[d];
    a.delta[row] = dr;
    lse = a.lse[row];
  }
  float dq[D];
#pragma unroll
  for (int d = 0; d < D; ++d) dq[d] = 0.f;

  const int k_lo = a.window > 0 ? max(q0 - a.window + 1, 0) : 0;
  const int k_hi = min(q0 + FT, a.S);
  for (int k0 = (k_lo / FB) * FB; k0 < k_hi; k0 += FB) {
    __syncthreads();
    load_rows_f32<D>(k_s, a.k, a.ks, b, kh, k0, FB, a.S);
    load_rows_f32<D>(v_s, a.v, a.vs, b, kh, k0, FB, a.S);
    __syncthreads();
    for (int j = 0; j < FB; ++j) {
      if (!valid_pair(qp, k0 + j, a.S, a.window)) continue;
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        s += q_s[i][d] * k_s[j][d];
        dp += do_s[i][d] * v_s[j][d];
      }
      const float ds = expf(s * a.scale - lse) * (dp - dr);
#pragma unroll
      for (int d = 0; d < D; ++d) dq[d] += ds * k_s[j][d];
    }
  }
  if (qp < a.S) {
    float* dqr = static_cast<float*>(a.dq) + b * a.dqs.b + h * a.dqs.h + qp * a.dqs.s;
#pragma unroll
    for (int d = 0; d < D; ++d) dqr[d] = dq[d] * a.scale;
  }
}

// ---------------------------------------------------------------------------
// Host side: tensor maps and launches.
// ---------------------------------------------------------------------------
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
// strides (element strides of st; extents S, n_heads, B). The box is
// `rows` seq positions of one (batch, head). Returns a cudaError_t and
// the axes' map dims packed as tma_load() reads them.
int encode(CUtensorMap* map, const void* base, int D, int S, int n_heads, int B,
           const Strides& st, int rows, int* slots) {
  EncodeTiled fn = encode_fn();
  if (!fn) return (int)cudaErrorNotSupported;
  const long long stride[3] = {st.s, st.h, st.b};
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

template <int D>
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
    CUtensorMap tq, tdo, to, tk, tv;
    constexpr int BM = DqSmem<D>::BM;
    rc = encode(&tq, a.q, D, a.S, a.H, B, a.qs, BM, &t.q_slots);
    if (!rc) rc = encode(&tdo, a.dout, D, a.S, a.H, B, a.dos, BM, &t.do_slots);
    if (!rc) rc = encode(&to, a.o, D, a.S, a.H, B, a.os, BM, &t.o_slots);
    if (!rc) rc = encode(&tk, a.k, D, a.S, a.K, B, a.ks, BN, &t.k_slots);
    if (!rc) rc = encode(&tv, a.v, D, a.S, a.K, B, a.vs, BN, &t.v_slots);
    static unsigned long long done = 0;
    if (!rc) rc = prepare<DQ_WGS>(dq_bf16_kernel<D>, DqSmem<D>::BYTES, &done);
    if (rc) return rc;
    dq_bf16_kernel<D><<<dim3(a.H, B, (a.S + BM - 1) / BM), Shape<DQ_WGS>::THREADS,
                        DqSmem<D>::BYTES, st>>>(
        tq, tdo, to, tk, tv, t);
  } else {
    CUtensorMap tk, tv, tq, tdo;
    constexpr int BM = KvSmem<D>::BM;
    rc = encode(&tk, a.k, D, a.S, a.K, B, a.ks, BM, &t.k_slots);
    if (!rc) rc = encode(&tv, a.v, D, a.S, a.K, B, a.vs, BM, &t.v_slots);
    if (!rc) rc = encode(&tq, a.q, D, a.S, a.H, B, a.qs, BN, &t.q_slots);
    if (!rc) rc = encode(&tdo, a.dout, D, a.S, a.H, B, a.dos, BN, &t.do_slots);
    static unsigned long long done = 0;
    if (!rc) rc = prepare<KV_WGS>(dkdv_bf16_kernel<D>, KvSmem<D>::BYTES, &done);
    if (rc) return rc;
    dkdv_bf16_kernel<D><<<dim3(a.K, B, (a.S + BM - 1) / BM), Shape<KV_WGS>::THREADS,
                          KvSmem<D>::BYTES, st>>>(
        tk, tv, tq, tdo, t);
  }
  return (int)cudaGetLastError();
}

template <int D>
int launch(int kernel, const Args& a, int B, int dtype, cudaStream_t st) {
  if (dtype == 1) return launch_bf16<D>(kernel, a, B, st);
  if (kernel == 1)
    dq_f32_kernel<D><<<dim3((a.S + FT - 1) / FT, a.H, B), FT, 0, st>>>(a);
  else
    dkdv_f32_kernel<D><<<dim3((a.S + FT - 1) / FT, a.K, B), FT, 0, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// kernel: 1 = dQ (it also writes delta = rowsum(dO o)), 2 = dK/dV (it reads
// that delta, so it runs after kernel 1 on the same stream). strides: the
// (batch, head, seq) element strides of q, k, v, o, dO, dq, dk, dv in that
// order (24 values). lse and delta: float32 [B,H,S] contiguous. dtype: 0 =
// float32, 1 = bfloat16. Returns a cudaError_t.
extern "C" int repro_flash_attention_bwd(int kernel, const void* q, const void* k,
                                         const void* v, const void* o, const void* dout,
                                         const float* lse, float* delta, void* dq, void* dk,
                                         void* dv, int B, int H, int K, int S, int D,
                                         const long long* strides, int window, int dtype,
                                         void* stream) {
  if (B < 1 || S < 1 || K < 1 || H % K != 0 || kernel < 1 || kernel > 2 ||
      (dtype != 0 && dtype != 1))
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
  if (D == 64) return launch<64>(kernel, a, B, dtype, st);
  if (D == 32) return launch<32>(kernel, a, B, dtype, st);
  return (int)cudaErrorInvalidValue;
}
