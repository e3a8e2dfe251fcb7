// Hopper building blocks shared by the port's wgmma + TMA kernels
// (flash_attention.cu, flash_attention_bwd.cu, gla_chunk.cu): mbarriers,
// TMA loads of 4-D tensor maps, wgmma descriptors and instructions (inline
// PTX, sm_90a), and the host's tensor-map encoder. Include it outside any
// namespace; everything here has internal linkage.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder is looked up at run time
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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
// batch in bits 0-1, 2-3 and 4-5; `c0` is the box's first head-dim column.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int slots, int s, int h,
                                         int b, int c0 = 0) {
  const int ps = slots & 3, ph = (slots >> 2) & 3, pb = (slots >> 4) & 3;
  const int c1 = (ps == 1 ? s : 0) + (ph == 1 ? h : 0) + (pb == 1 ? b : 0);
  const int c2 = (ps == 2 ? s : 0) + (ph == 2 ? h : 0) + (pb == 2 ? b : 0);
  const int c3 = (ps == 3 ? s : 0) + (ph == 3 ? h : 0) + (pb == 3 ? b : 0);
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_addr(bar))
      : "memory");
}

// The bf16 columns of one swizzled box. A row of D <= 64 (at most 128
// bytes) is one box; a row of 128 (256 bytes, wider than the 128-byte
// swizzle's span) is two boxes of 64 columns, and a tile of such rows lies
// as two halves, [rows][64] each, the second after the first. A row of 96
// (192 bytes: no whole number of 128-byte spans) is three boxes of 32
// columns in the 64-byte swizzle, [rows][32] each (as CUTLASS lays out a
// 96-wide wgmma operand), so that no zero column is loaded or multiplied.
template <int D>
__host__ __device__ constexpr int box_cols() {
  return D == 96 ? 32 : D > 64 ? 64 : D;
}

// A wgmma shared-memory matrix descriptor for a tile whose box rows are
// box_cols<D>() bf16 elements, as the TMA wrote it with the matching
// swizzle (128 B for 64 columns, 64 B for 32): 8-row groups lie 8 rows of
// the box apart. The same descriptor serves a K-major read (k16 steps of 32
// bytes along a row: k_step) and an MN-major read under the transpose bit
// (k16 steps of 16 rows: + mn_step), since one swizzle atom spans the box.
template <int D>
__device__ __forceinline__ uint64_t smem_desc(const void* tile) {
  constexpr int W = box_cols<D>();
  constexpr uint64_t layout = W == 64 ? 1 : 2;  // 1: 128-byte swizzle, 2: 64-byte
  constexpr uint64_t sbo = 8 * W * 2;
  return (uint64_t)((smem_addr(tile) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((sbo >> 4) << 32) | (layout << 62);
}
template <int D>
__device__ __forceinline__ constexpr uint64_t mn_step() {
  return (16 * box_cols<D>() * 2) >> 4;
}
// The descriptor of k16 step kk of a K-major tile of `rows` rows whose
// first step is `desc`: 32 bytes a step along a box's row, then on into
// the next half (D = 128).
template <int D>
__device__ __forceinline__ uint64_t k_step(uint64_t desc, int rows, int kk) {
  constexpr int PER = box_cols<D>() / 16;  // k16 steps a box holds
  return desc + (uint64_t)((kk / PER) * ((rows * box_cols<D>() * 2) >> 4) + 2 * (kk % PER));
}

// The byte offset, in a tile of `rows`-row boxes W (64 or 32) bf16 columns
// wide as the TMA lays them in W's swizzle (128 or 64 bytes), of row r's
// column col (even; the 4 bytes from there lie in one 16-byte piece): box
// col / W, then the row's piece p at p ^ (r % 8) (128-byte swizzle) or
// p ^ (r / 2 % 4) (64-byte), as the address bits 7-9 (7-8) permute bits 4-6
// (4-5) from a 1024-byte aligned tile.
template <int W>
__device__ __forceinline__ int swizzled(int rows, int r, int col) {
  const int c = col % W, p = c / 8;
  const int sp = W == 64 ? p ^ (r % 8) : p ^ ((r >> 1) % 4);
  return (col / W) * rows * W * 2 + r * W * 2 + sp * 16 + (c % 8) * 2;
}

// A tile of `rows` rows of a D-column map at (s, h, b): one box, or for
// D = 128 two 64-column boxes into the tile's two halves (three 32-column
// boxes for D = 96).
template <int D>
__device__ __forceinline__ void tma_tile(uint8_t* dst, const CUtensorMap* map, uint64_t* bar,
                                         int slots, int rows, int s, int h, int b) {
#pragma unroll
  for (int c = 0; c < D; c += box_cols<D>()) tma_load(dst + c * rows * 2, map, bar, slots, s, h, b, c);
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

// D[64 x 32] (+)= A[64 x 16] * B[16 x 32]; A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n32(float* d, uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 64] (+)= A[64 x 16] * B[16 x 64]; A from registers (bf16 pairs),
// B MN-major in shared memory (the transpose bit set); accumulate 0
// overwrites D.
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a, uint64_t db,
                                             int accumulate = 1) {
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
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

// s = A_s B_s^T and dp = A_p B_p^T, 64 x N each (N 64 or 32): s over KS of
// its tiles' DS columns and dp over KP of its tiles' DP columns (KS < DS:
// the rest are zeros, head dim 96 on D = 128's tiles; DP < DS where V is
// narrower than the qk head dim, MLA's 64 beside 96): every operand K-major
// in shared memory (descriptors of its first k16 step); the A operands'
// tiles have ra rows, the B operands' rb (their boxes' offsets)
template <int DS, int N = 64, int KS = DS, int DP = DS, int KP = KS>
__device__ __forceinline__ void issue_two(float* s, float* dp, uint64_t as, uint64_t bs,
                                          uint64_t ap, uint64_t bp, int ra, int rb) {
  static_assert(N == 64 || N == 32, "issue_two: N is 64 or 32");
#pragma unroll
  for (int kk = 0; kk < KS / 16; ++kk) {
    if constexpr (N == 64)
      wgmma_ss_n64(s, k_step<DS>(as, ra, kk), k_step<DS>(bs, rb, kk), kk > 0);
    else
      wgmma_ss_n32(s, k_step<DS>(as, ra, kk), k_step<DS>(bs, rb, kk), kk > 0);
  }
#pragma unroll
  for (int kk = 0; kk < KP / 16; ++kk) {
    if constexpr (N == 64)
      wgmma_ss_n64(dp, k_step<DP>(ap, ra, kk), k_step<DP>(bp, rb, kk), kk > 0);
    else
      wgmma_ss_n32(dp, k_step<DP>(ap, ra, kk), k_step<DP>(bp, rb, kk), kk > 0);
  }
}

// D[64 x 96] (+)= A[64 x 16] (registers, bf16 pairs) * B[16 x 96], B
// MN-major in shared memory (the transpose bit set) as three 32-column
// boxes in the 64-byte swizzle, the descriptor's leading byte offset apart
// (mma_rs<96>). d[4n + e] is column 8n + ..., as for every width.
__device__ __forceinline__ void wgmma_rs_n96(float* d, const uint32_t* a, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// acc[64 x D] += A[64 x 16] (registers) * B[16 x D] (MN-major). At D = 128
// the B tile (of `rows` rows) lies in two 64-column halves: two n64
// products, acc[0..31] the first half's columns and acc[32..63] the second's,
// so acc[4n + e] is column 8n + ... for every D. At D = 96 one n96 product
// over the tile's three 32-column boxes (`rows` x 64 bytes apart: the
// descriptor's leading byte offset). accumulate 0 overwrites acc (D = 64,
// 96 and 128).
template <int D>
__device__ __forceinline__ void mma_rs(float* d, const uint32_t* a, uint64_t db, int rows = 0,
                                       int accumulate = 1) {
  if constexpr (D == 128) {
    wgmma_rs_n64(d, a, db, accumulate);
    wgmma_rs_n64(d + 32, a, db + (uint64_t)((rows * 128) >> 4), accumulate);
  } else if constexpr (D == 96) {
    wgmma_rs_n96(d, a, (db & ~((uint64_t)0x3FFF << 16)) | ((uint64_t)((rows * 64) >> 4) << 16),
                 accumulate);
  } else if constexpr (D == 64) {
    wgmma_rs_n64(d, a, db, accumulate);
  } else {
    wgmma_rs_n32(d, a, db);
  }
}

// D[64 x 16] (+)= A[64 x 16] * B[16 x 16]; A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n16(float* d, uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 16] += A[64 x 16] * B[16 x 16]; A from registers (bf16 pairs), B
// K-major in shared memory (the transpose bit clear).
__device__ __forceinline__ void wgmma_rs_n16(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// Orders this thread's generic-proxy writes to shared memory before later
// reads of it by the async proxy (a wgmma's shared-memory operands).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// threadIdx.x / 32 through a shuffle, so that the compiler knows it is the
// same in every lane: branches on it (and on the warpgroup index) are then
// not divergent, and the wgmma inside them need not be serialized
__device__ __forceinline__ int warp_index() {
  return __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
}

// D[64 x 128] (+)= A[64 x 16] * B[16 x 128]; A and B K-major in shared
// memory (B's 128 rows in a swizzled box of 128 rows, smem_desc's layout).
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 128] += A[64 x 16] (registers, bf16 pairs) * B[16 x 128], B
// MN-major in shared memory (the transpose bit set) through a descriptor of
// smem_desc_n128: its two 64-column halves are the descriptor's leading
// byte offset apart. d[4n + e] is column 8n + ..., as for two n64 halves.
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// The descriptor of an MN-major read of all 128 columns of a D = 128 tile
// of `rows` rows, which lies as two [rows][64] halves (tma_tile): within a
// half as smem_desc<128>, the halves one leading byte offset (rows x 128
// bytes) apart. k16 steps of 16 rows: + mn_step<128>().
__device__ __forceinline__ uint64_t smem_desc_n128(const void* tile, int rows) {
  return (smem_desc<128>(tile) & ~((uint64_t)0x3FFF << 16)) |
         ((uint64_t)((rows * 128) >> 4) << 16);
}

// One TMA box from shared memory to a 4-D tensor map's (s, h, b) at
// head-dim column c0 (coordinates as tma_load's; rows past the map's
// extents are not written), as one bulk group of this thread's.
__device__ __forceinline__ void tma_store(const CUtensorMap* map, const void* src, int slots, int s,
                                          int h, int b, int c0) {
  const int ps = slots & 3, ph = (slots >> 2) & 3, pb = (slots >> 4) & 3;
  const int c1 = (ps == 1 ? s : 0) + (ph == 1 ? h : 0) + (pb == 1 ? b : 0);
  const int c2 = (ps == 2 ? s : 0) + (ph == 2 ? h : 0) + (pb == 2 ? b : 0);
  const int c3 = (ps == 3 ? s : 0) + (ph == 3 ? h : 0) + (pb == 3 ? b : 0);
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%1, %2, %3, %4}], [%5];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(smem_addr(src))
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's bulk groups are still reading
// their shared-memory source (the source may then be overwritten).
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
// Wait until at most N of this thread's bulk groups are incomplete.
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// Named barriers (ids 1..15; 0 is __syncthreads's) over `n` threads, a
// multiple of 32: bar_sync waits for the barrier's phase, bar_arrive
// counts toward it and goes on.
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// ---------------------------------------------------------------------------
// The order of K1's output tiles (flash_attention.cu, flash_attention_bwd.cu).
// ---------------------------------------------------------------------------
// The pairs of q's and k's head dim D and v's (and o's) Dv that K1's
// kernels take (kernels/flash_attention.py pair_ok mirrors it): Dv = D, and
// MLA's (96, 64) (minicpm3-4b: qk_nope 64 + qk_rope 32 beside v 64).
__host__ __device__ constexpr bool pair_ok(int D, int Dv) {
  return Dv == D || (D == 96 && Dv == 64);
}

// K1_ORDER: 0 heaviest first over every head (each head's tiles far apart
// in time); 1 grouped by head (below) where a KV head has one query head
// (G = 1: no two heads share K and V, so the heaviest-first order's wave
// of 132 tiles holds 132 heads' rows in the L2); 2 grouped at every G.
#ifndef K1_ORDER
#define K1_ORDER 1
#endif
// Whether a launch at G query heads a KV head walks its tiles grouped by
// head (TileOrder; kernels/flash_attention.py grouped_order mirrors it).
// Each kernel is built both ways (a template parameter): the heaviest-first
// walk is the arithmetic it always had, so the G > 1 launches run the code
// they ran before the grouped order was added.
__host__ __device__ constexpr bool grouped_order(int G) {
  return K1_ORDER == 2 || (K1_ORDER == 1 && G == 1);
}

// The heaviest-first walk of a persistent grid of g blocks over `total`
// tiles (tile index i counts from the heaviest down): block x's k-th tile
// (k = 0, 1, ...) is k g + x in even rounds, k g + g - 1 - x in odd ones (a
// snake, which leaves the blocks' sums of work close); -1 past the last.
// But each head's tiles are then rounds apart, and each reads the head's
// rows from memory again.
__device__ __forceinline__ int snake_tile(int k, int total) {
  const int g = gridDim.x, x = blockIdx.x;
  const int i = k * g + ((k & 1) ? g - 1 - x : x);
  return i < total ? i : -1;
}

// The walk grouped by head, over the n tiles of each of `heads` heads,
// rank 0 the heaviest (a causal output tile's work grows with its distance
// from the first row), for a grid of g blocks: first whole heads as items
// of two tiles, ranks p and n - 1 - p (p < n / 2: each item the same work
// under the causal mask), head after head, dealt to the blocks as the same
// snake for all but the last round of items; so a round's blocks cover
// g / (n / 2) heads, each head's tiles at once. Then the other heads'
// tiles (and the middle rank of every head for odd n) heaviest first, so
// that the last rounds are the lightest tiles. The order moves no output
// row's sums: a tile is computed as in any order.
struct TileOrder {
  int heads, n, g, x, per, hp, n1, ht, tail, items;
  // of a grid of g blocks, block x's walk (of_block; at() needs no x)
  __host__ __device__ TileOrder(int heads_, int n_, int g_, int x_ = 0)
      : heads(heads_), n(n_), g(g_), x(x_) {
    per = n / 2;                                     // items a head
    const int rounds = per ? heads * per / g : 0;    // full rounds of items
    const int pair_rounds = rounds > 1 ? rounds - 1 : 0;
    hp = per ? pair_rounds * g / per : 0;            // heads taken as items
    if (hp > heads) hp = heads;
    n1 = hp * per;                                   // items, two tiles each
    ht = heads - hp;                                 // heads of the tail
    tail = ht * n + (n % 2 ? hp : 0);
    const int r1 = (n1 + g - 1) / g;                 // rounds of items
    const int last = (r1 - 1) * g + ((r1 - 1) % 2 ? g - 1 - x : x);
    items = r1 ? r1 - 1 + (last < n1) : 0;           // block x's items
  }
  // Tile i (0 <= i < heads n) of the sequence: its head and rank.
  __host__ __device__ void at(int i, int* head, int* rank) const {
    if (i < 2 * n1) {
      const int p = (i / 2) % per;
      *head = i / 2 / per;
      *rank = i % 2 ? n - 1 - p : p;
      return;
    }
    int j = i - 2 * n1;
    const int m = n / 2;  // the middle rank, for odd n
    if (n % 2 == 0 || j < m * ht) {
      *rank = j / ht;
      *head = hp + j % ht;
      return;
    }
    j -= m * ht;
    if (j < heads) {
      *rank = m;
      *head = j;
      return;
    }
    j -= heads;
    *rank = m + 1 + j / ht;
    *head = hp + j % ht;
  }
  // The k-th tile (k = 0, 1, ...) of block x: an index of the sequence, or
  // -1 past its last.
  __host__ __device__ int of_block(int k) const {
    if (k < 2 * items) {
      const int r = k / 2;
      return 2 * (r * g + (r % 2 ? g - 1 - x : x)) + k % 2;
    }
    k -= 2 * items;
    const int t = k * g + (k % 2 ? g - 1 - x : x);
    return t < tail ? 2 * n1 + t : -1;
  }
};

// ---------------------------------------------------------------------------
// Host side: tensor maps.
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
// strides (element strides s, h, b; extents S, n_heads, B). The box is
// `rows` seq positions of one (batch, head) and `w` columns (0: 64 for
// D > 64, else D; a tile of several boxes is tma_tile's), in the 128-byte
// swizzle for 64 columns and the 64-byte one for 32. Returns a cudaError_t
// and the axes' map dims packed as tma_load() reads them.
int encode(CUtensorMap* map, const void* base, int D, int S, int n_heads, int B,
           long long ss, long long sh, long long sb, int rows, int* slots, int w = 0) {
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
  const int W = w ? w : D > 64 ? 64 : D;
  cuuint32_t box[4] = {(cuuint32_t)W, 1, 1, 1};
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
                        W == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace
