// The sLSTM recurrence's backward (xLSTM's scalar-memory block) for NVIDIA
// Hopper (sm_90a): one launch runs a layer's reverse scan over S positions.
//
// Replaces: no Pallas kernel. The JAX package differentiates its
// jax.lax.scan (src/repro/models/xlstm.py slstm_apply, run_scan, :145-161)
// by XLA's autodiff, a second compiled loop; stepped from Python it would
// be some 20 launches a position. Its plain version is
// repro_torch.kernels.ref.slstm_scan_bwd, the analytic reverse recurrence.
//
// Computes, for each row b and head h, for t = S-1..0 in order (T bfloat16
// or float32):
//   dh    = dhs_t + T(dg_{t+1} @ R_h^T)   (float32 sums rounded to T; none at S-1)
//   dg_t  = T(the cell's backward at t)   (slstm.cuh: m held constant)
//   dwx_t = dg_t
// carrying dc and dn per (row, unit) in float32; then the start state's
// dc, dn and dh = T(dg_0 @ R_h^T). Inputs: R [H, dh, 4 dh] (T); the start
// state c0, n0, m0 [B, H, dh] float32; the training forward's gates gs
// [B, S, H 4 dh] (T, wx's layout) and states cs, ns, ms [B, S, H, dh]
// float32 (slstm_scan.cu, repro_slstm_scan_states); dhs [B, S, H, dh] (T).
// Writes dwx [B, S, H 4 dh] (T) and dc0, dn0, dh0 [B, H, dh] float32. dR =
// sum_t h_{t-1}^T dg_t is one large product after the scan, the wrapper's.
//
// Bound: the function reads gs, dhs, cs, ns, ms and R once and writes dwx
// (122 MB at B 4, S 1024, xlstm-350m's H 4 and dh 256, bf16: 36 us at 3.35
// TB/s) and does 2 dh FLOP a (row, gate column, position). But as in the
// forward its positions are a chain: dh_{t-1} needs all of dg_t. So one
// step's latency bounds it, and the design keeps on the chain only what
// needs the incoming dh.
//
// Design: the forward's grid. Per (head, group of up to ROWS = 8 rows), a
// cluster of CLUSTER = 8 blocks; block `rank` owns units [rank dh / 8,
// (rank + 1) dh / 8) of the head, their dc, dn in registers, and their 4
// dh / 8 gate columns (gate-major: block column j is gate j / (dh / 8) of
// unit j % (dh / 8)). The product is the transpose of the forward's:
// dh_{t-1}[k] needs every gate column of dg_t against R_h's row k. So each
// block forms the partial dh over ALL dh units from its own columns (dg_t[:,
// cols] @ R_h[:, cols]^T) and the eight partials are reduce-scattered:
// block p receives every block's partial of its units and sums the eight
// as a fixed tree. No atomics: equal inputs give equal bits, and a row's
// result does not depend on the other rows.
// bf16 (slstm_bwd_mma_kernel<DH>, dh / 32 warps), one step:
//  * off the chain, before the wait: the cell's coefficients of position
//    t (cell_bwd_coef, slstm.cuh: every exponential and division of the
//    cell's backward, which depend on the saved gates and states alone)
//    were computed a step earlier and are read from shared memory; the
//    loads of position t - 2 are issued and t - 1's coefficients computed;
//  * on the chain: the partials' tree, dh rounded to T, the cell's linear
//    map (cell_bwd_apply: FMAs only), dg_t into a double-buffered tile in
//    shared memory ([row][column], rows past the group's zero), one block
//    barrier, the product, the st.async;
//  * after the exchange: the dwx stores, from the tile.
// A thread has two roles: the chain of its cell (row tid / (dh / 8), unit
// tid % (dh / 8): dc, dn, the partials, the map) and the work off the chain
// of the cell ROWS / 2 rows on (its loads, coefficients, and dwx), handed
// over through shared memory (double-buffered, ordered by the block
// barrier). At B <= 4 the warps without cells do all of that, so the
// cells' warps only wait, apply and multiply; a warp's loads and stores
// are contiguous (adjacent units of one row). The loaded bf16 values stay
// raw until used a step later: converting them where they load would wait
// there for device memory (a step's ~1,000 cycles, tools/slstm_breakdown.py
// --bwd's clock). The product runs on mma.sync m16n8k16
// with the head's units as M and the group's rows as N (half the tiles of
// rows as M at B <= 8): each warp owns 32 units (two m tiles) over the
// block's dh / 2 columns, their A fragments (R_h) in registers for the
// whole scan, four independent accumulators an m tile summed in a fixed
// order. A lane then holds two rows of one unit, which it sends as one
// 8-byte st.async into the owning block's buffer of the step's parity
// ([source block][row pair][unit][2]), counted on that buffer's mbarrier, as the
// forward sends h (the same double-buffer argument: a block overwrites a
// buffer only after every block sent the partials read from it last, each
// after that read).
// float32 (slstm_bwd_f32_kernel<NR>, exact FMA, no TF32, the cell in one
// piece, cell_bwd): the block's columns of R in shared memory, transposed,
// thread k sums unit k's partial for the group's rows in column order and
// stores it into the owner's buffer, one cluster barrier (release/acquire)
// a step; the partials in rank order.
//
// Diagnostic macros (tools/slstm_breakdown.py --bwd; the bf16 kernel's
// results are wrong under any of them, they only time what is left):
// SLSTM_BWD_NO_MMA (no product), SLSTM_BWD_NO_CELL (the coefficients the
// inputs themselves, no exponentials), SLSTM_BWD_NO_DWX (dwx not written),
// SLSTM_BWD_NO_SYNC (no block barrier between the cell and the product),
// SLSTM_BWD_LOCAL (each block's partials sent to itself, the bytes its
// mbarrier counts: no DSMEM traffic); SLSTM_BWD_CLOCK (results right: each
// warp of one block prints its mean clock64 cycles a step in each phase).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

#include "slstm.cuh"

#ifdef SLSTM_BWD_CLOCK
#include <cstdio>
#define BWD_STAMP(i) stamp[i] = clock64()
#else
#define BWD_STAMP(i)
#endif

namespace cg = cooperative_groups;

namespace slstm {

template <int DH>
constexpr size_t bwd_mma_smem_bytes() {
  // the partials received [2][CLUSTER][ROWS / 2][DH / 8][2] float32, the
  // cells' coefficients and dhs [2][10][ROWS][DH / 8] float32, the dg tiles
  // [2][ROWS][DH / 2 + 8] bf16, then an mbarrier per partials buffer
  return (size_t)2 * CLUSTER * (DH / CLUSTER) * ROWS * 4 + (size_t)2 * 10 * ROWS * (DH / 8) * 4 +
         (size_t)2 * ROWS * (DH / 2 + 8) * 2 + 2 * sizeof(uint64_t);
}

// one cell's inputs at a position: its gates and dhs, and the state before
// it. The bf16 values stay as loaded until used a step later: converting
// them where they load would wait there for device memory
struct BwdIn {
  __nv_bfloat16 g[4], dh;
  float c, n, m;
};

template <int DH>
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(DH)
    slstm_bwd_mma_kernel(const __nv_bfloat16* __restrict__ r, const float* __restrict__ c0,
                         const float* __restrict__ n0, const float* __restrict__ m0,
                         const __nv_bfloat16* __restrict__ gs, const float* __restrict__ cs,
                         const float* __restrict__ ns, const float* __restrict__ ms,
                         const __nv_bfloat16* __restrict__ dhs, __nv_bfloat16* __restrict__ dwx,
                         float* __restrict__ dc0, float* __restrict__ dn0,
                         float* __restrict__ dh0, int B, int S, int H) {
  constexpr int UPB = DH / CLUSTER;  // units a block
  constexpr int NCOL = 4 * UPB;      // its gate columns
  constexpr int KSTEPS = NCOL / 16;
  constexpr int MT = 2;              // m tiles a warp: 32 of the head's units, so DH / 32 warps
  constexpr int CHAINS = 4;          // independent accumulators an m tile (k step mod 4)
  constexpr int ASTR = NCOL + 8;     // a dg row in the tile, 16 bytes of pad
  constexpr int NK = 10;             // a cell's record: its 9 coefficients and dhs
  static_assert(DH % 32 == 0 && DH <= MAX_DH, "dh: a multiple of 32 up to 256");
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int head = blockIdx.y;
  const int row0 = blockIdx.z * ROWS;
  const int rows = min(ROWS, B - row0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;  // the mma fragments' row (group) and column pair
  const int u0 = rank * UPB;

  extern __shared__ __align__(16) unsigned char smem[];
  // [2][CLUSTER][ROWS / 2][UPB][2]: a (source, row pair) holds the pair of
  // each unit as 8 bytes
  float* recv = reinterpret_cast<float*>(smem);
  float* rec = recv + 2 * CLUSTER * UPB * ROWS;  // [2][NK][ROWS][UPB]
  __nv_bfloat16* at = reinterpret_cast<__nv_bfloat16*>(rec + 2 * NK * ROWS * UPB);
  uint64_t* bar = reinterpret_cast<uint64_t*>(at + 2 * ROWS * ASTR);  // [2]

  for (int i = threadIdx.x; i < 2 * ROWS * ASTR; i += blockDim.x) at[i] = __float2bfloat16_rn(0.f);
  if (threadIdx.x == 0) {
    mbar_init(&bar[0], 1);
    mbar_init(&bar[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the warp's A fragments (R_h restricted to the block's columns, as
  // [unit][column]) for the whole scan: m tile j holds the head's units
  // 32 warp + 16 j + (g, g + 8), k the block's columns 16 ks + 2q, + 1 and
  // + 8, + 9; block column k is R_h's column (k / UPB) DH + u0 + k % UPB, so
  // a pair is one aligned 4-byte load
  const __nv_bfloat16* rh = r + (size_t)head * DH * 4 * DH;
  uint32_t afr[KSTEPS][MT][4];
#pragma unroll
  for (int ks = 0; ks < KSTEPS; ++ks) {
#pragma unroll
    for (int j = 0; j < MT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int u = 32 * warp + 16 * j + g + 8 * (e & 1);
        const int k = 16 * ks + 8 * (e >> 1) + 2 * q;
        afr[ks][j][e] = *reinterpret_cast<const uint32_t*>(rh + (size_t)u * 4 * DH +
                                                           (k / UPB) * DH + u0 + k % UPB);
      }
    }
  }
  // where this lane's partials go: m tile j's unit 32 warp + 16 j + g (+ 8
  // for e = 1), rows 2q and 2q + 1, belongs to block u / UPB, unit u % UPB
  // of row pair q of its buffer; the lane sends only where 2q < rows
  uint32_t dst_buf[MT][2], dst_bar[MT][2];
#pragma unroll
  for (int j = 0; j < MT; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int u = 32 * warp + 16 * j + g + 8 * e;
#ifndef SLSTM_BWD_LOCAL
      const int p = u / UPB;
#else
      const int p = rank;
#endif
      dst_buf[j][e] = map_rank(recv + ((rank * ROWS / 2 + q) * UPB + u % UPB) * 2, p);
      dst_bar[j][e] = map_rank(&bar[0], p);
    }
  }
  const bool sends = 2 * q < rows;

  // Two roles a thread. Its cell: row cr of the group, block unit cu, whose
  // chain it runs (dc, dn, the partials' sum, the linear map). Its helped
  // cell: row hr = cr + ROWS / 2 (mod ROWS), the same unit, whose inputs it
  // loads and whose coefficients it computes and hands over in `rec`, and
  // whose dwx it stores from the tile. So at B <= 4 the warps without cells
  // do all the work off the chain; a warp's loads and stores are
  // contiguous (adjacent units of one row).
  const int cr = threadIdx.x / UPB, cu = threadIdx.x % UPB;
  const int hr = (cr + ROWS / 2) % ROWS;
  const bool cell = cr < rows, helps = hr < rows;
  const size_t XS = (size_t)4 * H * DH, SS = (size_t)H * DH;  // a position's strides
  const size_t sidx = ((size_t)(row0 + (cell ? cr : 0)) * H + head) * DH + u0 + cu;
  const int hrow = row0 + (helps ? hr : 0);
  const size_t hidx = ((size_t)hrow * H + head) * DH + u0 + cu;
  const __nv_bfloat16* g_row = gs + (size_t)hrow * S * XS + (size_t)head * 4 * DH + u0 + cu;
  __nv_bfloat16* dwx_row = dwx + (size_t)hrow * S * XS + (size_t)head * 4 * DH + u0 + cu;
  const size_t soff = (size_t)hrow * S * SS + (size_t)head * DH + u0 + cu;
  float* rec_out = rec + hr * UPB + cu;  // + (buffer NK + field) ROWS UPB
  const float* rec_in = rec + cr * UPB + cu;
  // the helped cell's inputs at position t (none before 0)
  auto load = [&](int t) {
    const __nv_bfloat16 z = __float2bfloat16_rn(0.f);
    BwdIn in = {{z, z, z, z}, z, 0.f, 0.f, 0.f};
    if (helps && t >= 0) {
#pragma unroll
      for (int gt = 0; gt < 4; ++gt) in.g[gt] = g_row[(size_t)t * XS + gt * DH];
      in.dh = dhs[soff + (size_t)t * SS];
      in.c = t > 0 ? cs[soff + (size_t)(t - 1) * SS] : c0[hidx];
      in.n = t > 0 ? ns[soff + (size_t)(t - 1) * SS] : n0[hidx];
      in.m = t > 0 ? ms[soff + (size_t)(t - 1) * SS] : m0[hidx];
    }
    return in;
  };
  // position t's record of the helped cell, from its inputs and the state
  // after it, into buffer t & 1
  auto publish = [&](int t, const BwdIn& in, float c, float n, float m) {
    float gf[4];
#pragma unroll
    for (int gt = 0; gt < 4; ++gt) gf[gt] = __bfloat162float(in.g[gt]);
#ifndef SLSTM_BWD_NO_CELL
    const BwdCoef k = cell_bwd_coef(gf, in.c, in.n, in.m, c, n, m);
#else
    const BwdCoef k = {gf[0], gf[1], gf[2], gf[3], in.c, in.n, in.m, c, n + m};
#endif
    const float v[NK] = {k.o_dh, k.c_dh, k.n_dh, k.z_dc, k.i_dc,
                         k.i_dn, k.f_dc, k.f_dn, k.fs,   __bfloat162float(in.dh)};
    float* o = rec_out + (t & 1) * NK * ROWS * UPB;
#pragma unroll
    for (int f = 0; f < NK; ++f) o[f * ROWS * UPB] = v[f];
  };

  // every block receives all rows' partials of its units from all eight
  // blocks each step: (rows + 1) / 2 row pairs of DH units' 8 bytes
  const uint32_t step_bytes = (uint32_t)((rows + 1) / 2) * DH * 8;
  if (threadIdx.x == 0) {
    // the partials for h_x land in buffer (x + 1) & 1: h_{S-2}'s and h_{S-3}'s
    mbar_expect_tx(&bar[(S - 1) & 1], step_bytes);
    if (S > 1) mbar_expect_tx(&bar[S & 1], step_bytes);
  }

  // the helper's pipeline, at the top of step t: in0 position t's inputs
  // (its state before is the state after t - 1), in1 position t - 1's;
  // each step loads position t - 2's and publishes t - 1's record, which
  // the cell reads a step later (the block barrier between orders them)
  float dc = 0.f, dn = 0.f;
  BwdIn in0 = load(S - 1), in1 = load(S - 2);
  if (helps)
    publish(S - 1, in0, cs[soff + (size_t)(S - 1) * SS], ns[soff + (size_t)(S - 1) * SS],
            ms[soff + (size_t)(S - 1) * SS]);
#ifdef SLSTM_BWD_CLOCK
  long long stamp[7], phase[6] = {};
#endif
  // every block has started and set its mbarriers up before any block
  // sends; the first records are published
  cluster.sync();

  for (int t = S - 1; t >= 0; --t) {
    BWD_STAMP(0);
    // the cell's record of position t
    float k[NK];
#pragma unroll
    for (int f = 0; f < NK; ++f) k[f] = cell ? rec_in[((t & 1) * NK + f) * ROWS * UPB] : 0.f;
    const BwdIn in2 = load(t - 2);
    if (helps && t > 0) publish(t - 1, in1, in0.c, in0.n, in0.m);
    BWD_STAMP(1);
    const int cur = (t + 1) & 1;  // the buffer of the partials for h_t
    if (t < S - 1) {
      // phase (S - 2 - t) / 2 of its mbarrier; then it expects h_{t-2}'s
      mbar_wait(&bar[cur], ((S - 2 - t) >> 1) & 1);
      if (threadIdx.x == 0 && t >= 1) mbar_expect_tx(&bar[cur], step_bytes);
    }
    BWD_STAMP(2);
    if (cell) {
      float dhr = 0.f;
      if (t < S - 1) {
        // the eight blocks' partials as a fixed tree
        const float* rv =
            recv + cur * CLUSTER * UPB * ROWS + ((cr >> 1) * UPB + cu) * 2 + (cr & 1);
        constexpr int P = UPB * ROWS;
        dhr = round_t<__nv_bfloat16>(((rv[0] + rv[P]) + (rv[2 * P] + rv[3 * P])) +
                                     ((rv[4 * P] + rv[5 * P]) + (rv[6 * P] + rv[7 * P])));
      }
      const BwdCoef kc = {k[0], k[1], k[2], k[3], k[4], k[5], k[6], k[7], k[8]};
      float dg[4];
      cell_bwd_apply(kc, k[9] + dhr, dc, dn, dg);
      __nv_bfloat16* arow = at + ((t & 1) * ROWS + cr) * ASTR + cu;
#pragma unroll
      for (int gt = 0; gt < 4; ++gt) arow[gt * UPB] = __float2bfloat16_rn(dg[gt]);
    }
    BWD_STAMP(3);
#ifndef SLSTM_BWD_NO_SYNC
    __syncthreads();
#endif
    BWD_STAMP(4);
    // the partials of h_{t-1}: the warp's 32 units (M) over the block's
    // columns (K) for the group's rows (N, zero past the group's)
    const __nv_bfloat16* brow = at + ((t & 1) * ROWS + g) * ASTR + 2 * q;
    float acc[MT][CHAINS][4] = {};
#ifndef SLSTM_BWD_NO_MMA
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      const uint32_t b0 = *reinterpret_cast<const uint32_t*>(brow + 16 * ks);
      const uint32_t b1 = *reinterpret_cast<const uint32_t*>(brow + 16 * ks + 8);
#pragma unroll
      for (int j = 0; j < MT; ++j)
        mma_bf16(acc[j][ks % CHAINS], afr[ks][j][0], afr[ks][j][1], afr[ks][j][2],
                 afr[ks][j][3], b0, b1);
    }
#else
    acc[0][0][0] = __bfloat162float(brow[0]);
#endif
    if (sends) {
      const uint32_t off = (uint32_t)((t & 1) * CLUSTER * UPB * ROWS * 4);
#pragma unroll
      for (int j = 0; j < MT; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          // the chains in a fixed order
          float v[2];
#pragma unroll
          for (int x = 0; x < 2; ++x)
            v[x] = (acc[j][0][2 * e + x] + acc[j][1][2 * e + x]) +
                   (acc[j][2][2 * e + x] + acc[j][3][2 * e + x]);
          st_async_v2(dst_buf[j][e] + off, __float_as_uint(v[0]), __float_as_uint(v[1]),
                      dst_bar[j][e] + 8 * (t & 1));
        }
      }
    }
    BWD_STAMP(5);
    // the helped cell's dwx from the tile, after the exchange, off the chain
#ifndef SLSTM_BWD_NO_DWX
    if (helps) {
      const __nv_bfloat16* hrow_t = at + ((t & 1) * ROWS + hr) * ASTR + cu;
#pragma unroll
      for (int gt = 0; gt < 4; ++gt) dwx_row[(size_t)t * XS + gt * DH] = hrow_t[gt * UPB];
    }
#endif
    BWD_STAMP(6);
#ifdef SLSTM_BWD_CLOCK
    if (t > 0 && t < S - 1) {
#pragma unroll
      for (int i = 0; i < 6; ++i) phase[i] += stamp[i + 1] - stamp[i];
    }
#endif
    in0 = in1;
    in1 = in2;
  }
  // the partials for h_{-1} (the start state's dh) in buffer 0; each block
  // leaves only once its own have all landed
  mbar_wait(&bar[0], ((S - 1) >> 1) & 1);
  if (cell) {
    const float* rv = recv + ((cr >> 1) * UPB + cu) * 2 + (cr & 1);
    constexpr int P = UPB * ROWS;
    dh0[sidx] = round_t<__nv_bfloat16>(((rv[0] + rv[P]) + (rv[2 * P] + rv[3 * P])) +
                                       ((rv[4 * P] + rv[5 * P]) + (rv[6 * P] + rv[7 * P])));
    dc0[sidx] = dc;
    dn0[sidx] = dn;
  }
#ifdef SLSTM_BWD_CLOCK
  if (rank == 0 && head == 0 && blockIdx.z == 0 && lane == 0 && S > 2)
    printf("[clock] slstm_bwd_mma_kernel block 0 warp %d (%s), clock64 cycles a step over "
           "%d steps: loads + coefficients %lld, wait %lld, cell %lld, block barrier %lld, "
           "product + st.async %lld, dwx %lld\n",
           warp, cell ? "cells" : "no cells", S - 2, phase[0] / (S - 2), phase[1] / (S - 2),
           phase[2] / (S - 2), phase[3] / (S - 2), phase[4] / (S - 2), phase[5] / (S - 2));
#endif
  cluster.sync();
}

// shared memory of one float32 block: R's columns of the block transposed
// [dh / 2][dh], the dg rows [nr][dh / 2], the partials [2][CLUSTER][nr][dh / 8]
__host__ __device__ constexpr size_t bwd_f32_smem_bytes(int dh, int nr) {
  return (size_t)(dh / 2) * dh * sizeof(float) + (size_t)nr * (dh / 2) * sizeof(float) +
         (size_t)2 * CLUSTER * nr * (dh / CLUSTER) * sizeof(float);
}

template <int NR>
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(MAX_DH)
    slstm_bwd_f32_kernel(const float* __restrict__ r, const float* __restrict__ c0,
                         const float* __restrict__ n0, const float* __restrict__ m0,
                         const float* __restrict__ gs, const float* __restrict__ cs,
                         const float* __restrict__ ns, const float* __restrict__ ms,
                         const float* __restrict__ dhs, float* __restrict__ dwx,
                         float* __restrict__ dc0, float* __restrict__ dn0,
                         float* __restrict__ dh0, int B, int S, int H, int dh) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int head = blockIdx.y;
  const int row0 = blockIdx.z * NR;
  const int rows = min(NR, B - row0);
  const int upb = dh / CLUSTER;  // units this block owns
  const int ncol = 4 * upb;      // its gate columns, gate-major
  const int u0 = rank * upb;
  const int tid = threadIdx.x;   // blockDim.x = dh: thread k sums unit k's partial

  extern __shared__ __align__(16) unsigned char smem[];
  float* rst = reinterpret_cast<float*>(smem);  // [ncol][dh]
  float* dgs = rst + ncol * dh;                  // [NR][ncol]
  float* recv = dgs + NR * ncol;                 // [2][CLUSTER][NR][upb]

  // rst[j][k] = R[head][k][(j / upb) dh + u0 + j % upb], read along j
  const float* rh = r + (size_t)head * dh * 4 * dh;
  for (int i = tid; i < ncol * dh; i += blockDim.x) {
    const int k = i / ncol, j = i % ncol;
    rst[j * dh + k] = rh[(size_t)k * 4 * dh + (j / upb) * dh + u0 + j % upb];
  }
  for (int i = tid; i < NR * ncol; i += blockDim.x) dgs[i] = 0.f;

  const int cr = tid / upb, cu = tid % upb;
  const bool cell = cr < rows;
  const int crow = row0 + (cell ? cr : 0);
  const size_t sidx = ((size_t)crow * H + head) * dh + u0 + cu;
  const size_t XS = (size_t)4 * H * dh, SS = (size_t)H * dh;
  const float* g_row = gs + (size_t)crow * S * XS + (size_t)head * 4 * dh + u0 + cu;
  float* dwx_row = dwx + (size_t)crow * S * XS + (size_t)head * 4 * dh + u0 + cu;
  const size_t soff = (size_t)crow * S * SS + (size_t)head * dh + u0 + cu;

  float wg[4] = {0.f, 0.f, 0.f, 0.f}, wdh = 0.f, cc = 0.f, cn = 0.f, cm = 0.f;
  float pc = 0.f, pn = 0.f, pm = 0.f, dc = 0.f, dn = 0.f;
  if (cell) {
    const size_t t = S - 1;
#pragma unroll
    for (int g = 0; g < 4; ++g) wg[g] = g_row[t * XS + g * dh];
    wdh = dhs[soff + t * SS];
    cc = cs[soff + t * SS];
    cn = ns[soff + t * SS];
    cm = ms[soff + t * SS];
    pc = S > 1 ? cs[soff + (t - 1) * SS] : c0[sidx];
    pn = S > 1 ? ns[soff + (t - 1) * SS] : n0[sidx];
    pm = S > 1 ? ms[soff + (t - 1) * SS] : m0[sidx];
  }
  // the block that owns this thread's unit, and its slot there
  float* dst = cluster.map_shared_rank(recv, tid / upb) + tid % upb;
  cluster.sync();

  for (int t = S - 1; t >= 0; --t) {
    float ng[4] = {0.f, 0.f, 0.f, 0.f}, ndh = 0.f, qc = 0.f, qn = 0.f, qm = 0.f;
    if (cell && t > 0) {
      const size_t tp = t - 1;
#pragma unroll
      for (int g = 0; g < 4; ++g) ng[g] = g_row[tp * XS + g * dh];
      ndh = dhs[soff + tp * SS];
      qc = t > 1 ? cs[soff + (tp - 1) * SS] : c0[sidx];
      qn = t > 1 ? ns[soff + (tp - 1) * SS] : n0[sidx];
      qm = t > 1 ? ms[soff + (tp - 1) * SS] : m0[sidx];
    }
    if (cell) {
      float dhr = 0.f;
      if (t < S - 1) {  // the partials for h_t, in buffer (t + 1) & 1
        const float* rv = recv + ((size_t)((t + 1) & 1) * CLUSTER * NR + cr) * upb + cu;
        dhr = rv[0];
#pragma unroll
        for (int p = 1; p < CLUSTER; ++p) dhr += rv[p * NR * upb];
      }
      float dg[4];
      cell_bwd(wg, pc, pn, pm, cc, cn, cm, wdh + dhr, dc, dn, dg);
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        dwx_row[(size_t)t * XS + g * dh] = dg[g];
        dgs[cr * ncol + g * upb + cu] = dg[g];
      }
    }
    __syncthreads();
    // unit tid's partial of h_{t-1} for each row, over the block's columns
    // in order, into the owner's buffer t & 1
    float acc[NR];
#pragma unroll
    for (int qq = 0; qq < NR; ++qq) acc[qq] = 0.f;
    for (int j = 0; j < ncol; ++j) {
      const float rv = rst[j * dh + tid];
#pragma unroll
      for (int qq = 0; qq < NR; ++qq) acc[qq] = fmaf(dgs[qq * ncol + j], rv, acc[qq]);
    }
    float* out = dst + (size_t)((t & 1) * CLUSTER + rank) * NR * upb;
#pragma unroll
    for (int qq = 0; qq < NR; ++qq)
      if (qq < rows) out[qq * upb] = acc[qq];
    // the partials are in their owners' buffers, and this step's reads of
    // dgs and of the other buffer are done, before any block goes on
    cluster.sync();
#pragma unroll
    for (int g = 0; g < 4; ++g) wg[g] = ng[g];
    wdh = ndh;
    cc = pc;
    cn = pn;
    cm = pm;
    pc = qc;
    pn = qn;
    pm = qm;
  }
  if (cell) {
    const float* rv = recv + (size_t)cr * upb + cu;  // buffer 0: h_{-1}'s
    float s = rv[0];
#pragma unroll
    for (int p = 1; p < CLUSTER; ++p) s += rv[p * NR * upb];
    dh0[sidx] = s;
    dc0[sidx] = dc;
    dn0[sidx] = dn;
  }
}

template <int DH>
int launch_bwd_mma(const void* r, const float* c0, const float* n0, const float* m0,
                   const void* gs, const float* cs, const float* ns, const float* ms,
                   const void* dhs, void* dwx, float* dc0, float* dn0, float* dh0, int B, int S,
                   int H, cudaStream_t stream) {
  const size_t smem = bwd_mma_smem_bytes<DH>();
  cudaError_t err = cudaFuncSetAttribute(slstm_bwd_mma_kernel<DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(CLUSTER, H, (B + ROWS - 1) / ROWS);
  slstm_bwd_mma_kernel<DH><<<grid, DH, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(r), c0, n0, m0, static_cast<const __nv_bfloat16*>(gs), cs,
      ns, ms, static_cast<const __nv_bfloat16*>(dhs), static_cast<__nv_bfloat16*>(dwx), dc0, dn0,
      dh0, B, S, H);
  return (int)cudaGetLastError();
}

template <int NR>
int launch_bwd_f32(const void* r, const float* c0, const float* n0, const float* m0,
                   const void* gs, const float* cs, const float* ns, const float* ms,
                   const void* dhs, void* dwx, float* dc0, float* dn0, float* dh0, int B, int S,
                   int H, int dh, cudaStream_t stream) {
  const size_t smem = bwd_f32_smem_bytes(dh, NR);
  cudaError_t err = cudaFuncSetAttribute(slstm_bwd_f32_kernel<NR>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(CLUSTER, H, (B + NR - 1) / NR);
  slstm_bwd_f32_kernel<NR><<<grid, dh, smem, stream>>>(
      static_cast<const float*>(r), c0, n0, m0, static_cast<const float*>(gs), cs, ns, ms,
      static_cast<const float*>(dhs), static_cast<float*>(dwx), dc0, dn0, dh0, B, S, H, dh);
  return (int)cudaGetLastError();
}

}  // namespace slstm

// r [H, dh, 4 dh] (dtype 0: float32, 1: bfloat16); the start state c0, n0,
// m0 [B, H, dh] float32; the training forward's gs [B, S, H 4 dh] (r's
// dtype) and cs, ns, ms [B, S, H, dh] float32; dhs [B, S, H, dh] (r's
// dtype). Writes dwx [B, S, H 4 dh] (r's dtype) and the start state's dc0,
// dn0, dh0 [B, H, dh] float32 (all contiguous; the outputs must not overlap
// the inputs). dh a multiple of 32 up to 256. Returns a cudaError_t.
extern "C" int repro_slstm_scan_bwd(const void* r, const float* c0, const float* n0,
                                    const float* m0, const void* gs, const float* cs,
                                    const float* ns, const float* ms, const void* dhs, void* dwx,
                                    float* dc0, float* dn0, float* dh0, int B, int S, int H,
                                    int dh, int dtype, void* stream) {
  if (B < 1 || S < 1 || H < 1 || dh % 32 || dh < 32 || dh > slstm::MAX_DH || H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    switch (dh) {
#define SLSTM_BWD_MMA(D) \
  case D:                \
    return slstm::launch_bwd_mma<D>(r, c0, n0, m0, gs, cs, ns, ms, dhs, dwx, dc0, dn0, dh0, B, S, H, st);
      SLSTM_BWD_MMA(32)
      SLSTM_BWD_MMA(64)
      SLSTM_BWD_MMA(96)
      SLSTM_BWD_MMA(128)
      SLSTM_BWD_MMA(160)
      SLSTM_BWD_MMA(192)
      SLSTM_BWD_MMA(224)
      SLSTM_BWD_MMA(256)
#undef SLSTM_BWD_MMA
    }
    return (int)cudaErrorInvalidValue;
  }
  if (dtype != 0) return (int)cudaErrorInvalidValue;
#define SLSTM_BWD_F32(N) \
  slstm::launch_bwd_f32<N>(r, c0, n0, m0, gs, cs, ns, ms, dhs, dwx, dc0, dn0, dh0, B, S, H, dh, st)
  switch (slstm::group_rows(B)) {
    case 1:
      return SLSTM_BWD_F32(1);
    case 2:
      return SLSTM_BWD_F32(2);
    case 4:
      return SLSTM_BWD_F32(4);
    default:
      return SLSTM_BWD_F32(8);
  }
#undef SLSTM_BWD_F32
}
