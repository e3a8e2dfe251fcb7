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
//   dg_t  = T(the cell's backward at t)   (cell_bwd, slstm.cuh: m held constant)
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
// step's latency bounds it: the product, the cell's exponentials, and the
// exchange among the blocks that share the head.
//
// Design: the forward's. Per (head, group of up to ROWS = 8 rows), a
// cluster of CLUSTER = 8 blocks; block `rank` owns units [rank dh / 8,
// (rank + 1) dh / 8) of the head, their dc, dn in registers, and their 4
// dh / 8 gate columns (gate-major: block column j is gate j / (dh / 8) of
// unit j % (dh / 8)). The one difference is the product: dh_{t-1}[k] needs
// every gate column of dg_t against R_h's row k, the transpose of the
// forward's column slice. So each block forms the partial dh over ALL dh
// units from its own columns (dg_t[:, cols] @ R_h[:, cols]^T) and the eight
// partials are reduce-scattered: block p receives every block's partial of
// its units and sums the eight in rank order. No atomics: equal inputs give
// equal bits, and a row's result does not depend on the other rows.
// bf16 (slstm_bwd_mma_kernel<DH>, dh / 32 warps): the cell writes dg_t
// into a double-buffered A tile in shared memory (rows past the group's
// zero); after one block barrier each warp runs mma.sync m16n8k16 over the
// block's dh / 2 columns for 4 n tiles (32 of R_h's rows, its B fragments
// in registers for the whole scan); each lane sends its row's two units'
// partials as one 8-byte st.async into the owning block's buffer of the
// step's parity, counted on that buffer's mbarrier, as the forward sends h
// (the same double-buffer argument: a block overwrites a buffer only after
// every block sent the partials read from it last, each after that read).
// float32 (slstm_bwd_f32_kernel<NR>, exact FMA, no TF32): the block's
// columns of R in shared memory, transposed, thread k sums unit k's partial
// for the group's rows in column order and stores it into the owner's
// buffer, one cluster barrier (release/acquire) a step.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

#include "slstm.cuh"

namespace cg = cooperative_groups;

namespace slstm {

template <int DH>
constexpr size_t bwd_mma_smem_bytes() {
  // the partials received [2][CLUSTER][ROWS][DH / 8] float32, then the dg
  // tiles [2][ROWS][DH / 2 + 8] bf16, then an mbarrier per partials buffer
  return (size_t)2 * CLUSTER * ROWS * (DH / CLUSTER) * 4 + (size_t)2 * ROWS * (DH / 2 + 8) * 2 +
         2 * sizeof(uint64_t);
}

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
  constexpr int NT = 4;              // n tiles a warp: 32 units, so DH / 32 warps
  constexpr int ASTR = NCOL + 8;     // a dg row in the tile, 16 bytes of pad
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
  float* recv = reinterpret_cast<float*>(smem);  // [2][CLUSTER][ROWS][UPB]
  __nv_bfloat16* at = reinterpret_cast<__nv_bfloat16*>(recv + 2 * CLUSTER * ROWS * UPB);
  uint64_t* bar = reinterpret_cast<uint64_t*>(at + 2 * ROWS * ASTR);  // [2]

  for (int i = threadIdx.x; i < 2 * ROWS * ASTR; i += blockDim.x) at[i] = __float2bfloat16_rn(0.f);
  if (threadIdx.x == 0) {
    mbar_init(&bar[0], 1);
    mbar_init(&bar[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the warp's B fragments for the whole scan: tile j holds R_h's rows
  // (units) 32 warp + 8 j + n, this lane's n = g, k = the block's columns
  // 16 ks + 2q, + 1 (b0) and + 8 (b1); block column k is R_h's column
  // (k / UPB) DH + u0 + k % UPB, so a pair is one aligned 4-byte load
  const __nv_bfloat16* rh = r + (size_t)head * DH * 4 * DH;
  uint32_t bfr[KSTEPS][NT][2];
#pragma unroll
  for (int ks = 0; ks < KSTEPS; ++ks) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int n = 32 * warp + 8 * j + g;
        const int k = 16 * ks + 8 * half + 2 * q;
        bfr[ks][j][half] = *reinterpret_cast<const uint32_t*>(
            rh + (size_t)n * 4 * DH + (k / UPB) * DH + u0 + k % UPB);
      }
    }
  }
  // where this lane's partials go: n tile j's units 32 warp + 8 j + 2q, + 1
  // belong to block p = unit / UPB, slot unit % UPB of its buffer
  uint32_t dst_off[NT], dst_buf[NT], dst_bar[NT];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int n = 32 * warp + 8 * j + 2 * q;
    dst_buf[j] = map_rank(recv, n / UPB);
    dst_bar[j] = map_rank(&bar[0], n / UPB);
    dst_off[j] = (uint32_t)(((rank * ROWS + g) * UPB + n % UPB) * 4);
  }

  // this thread's cell: row cr of the group, block unit cu
  const int cr = threadIdx.x / UPB, cu = threadIdx.x % UPB;
  const bool cell = cr < rows;
  const int crow = row0 + (cell ? cr : 0);
  const size_t sidx = ((size_t)crow * H + head) * DH + u0 + cu;
  const size_t XS = (size_t)4 * H * DH, SS = (size_t)H * DH;  // a position's strides
  const __nv_bfloat16* g_row = gs + (size_t)crow * S * XS + (size_t)head * 4 * DH + u0 + cu;
  __nv_bfloat16* dwx_row = dwx + (size_t)crow * S * XS + (size_t)head * 4 * DH + u0 + cu;
  const size_t soff = (size_t)crow * S * SS + (size_t)head * DH + u0 + cu;

  // every block receives all rows' partials of its units from all eight
  // blocks each step
  const uint32_t step_bytes = (uint32_t)rows * DH * 4;
  if (threadIdx.x == 0) {
    // the partials for h_x land in buffer (x + 1) & 1: h_{S-2}'s and h_{S-3}'s
    mbar_expect_tx(&bar[(S - 1) & 1], step_bytes);
    if (S > 1) mbar_expect_tx(&bar[S & 1], step_bytes);
  }

  // position t's gates, dhs and state after it, and the state before it
  float wg[4] = {0.f, 0.f, 0.f, 0.f}, wdh = 0.f, cc = 0.f, cn = 0.f, cm = 0.f;
  float pc = 0.f, pn = 0.f, pm = 0.f, dc = 0.f, dn = 0.f;
  if (cell) {
    const size_t t = S - 1;
#pragma unroll
    for (int gt = 0; gt < 4; ++gt) wg[gt] = __bfloat162float(g_row[t * XS + gt * DH]);
    wdh = __bfloat162float(dhs[soff + t * SS]);
    cc = cs[soff + t * SS];
    cn = ns[soff + t * SS];
    cm = ms[soff + t * SS];
    pc = S > 1 ? cs[soff + (t - 1) * SS] : c0[sidx];
    pn = S > 1 ? ns[soff + (t - 1) * SS] : n0[sidx];
    pm = S > 1 ? ms[soff + (t - 1) * SS] : m0[sidx];
  }
  // every block has started and set its mbarriers up before any block sends
  cluster.sync();

  for (int t = S - 1; t >= 0; --t) {
    // the next position's inputs, a step ahead
    float ng[4] = {0.f, 0.f, 0.f, 0.f}, ndh = 0.f, qc = 0.f, qn = 0.f, qm = 0.f;
    if (cell && t > 0) {
      const size_t tp = t - 1;
#pragma unroll
      for (int gt = 0; gt < 4; ++gt) ng[gt] = __bfloat162float(g_row[tp * XS + gt * DH]);
      ndh = __bfloat162float(dhs[soff + tp * SS]);
      qc = t > 1 ? cs[soff + (tp - 1) * SS] : c0[sidx];
      qn = t > 1 ? ns[soff + (tp - 1) * SS] : n0[sidx];
      qm = t > 1 ? ms[soff + (tp - 1) * SS] : m0[sidx];
    }
    const int cur = (t + 1) & 1;  // the buffer of the partials for h_t
    if (t < S - 1) {
      // phase (S - 2 - t) / 2 of its mbarrier; then it expects h_{t-2}'s
      mbar_wait(&bar[cur], ((S - 2 - t) >> 1) & 1);
      if (threadIdx.x == 0 && t >= 1) mbar_expect_tx(&bar[cur], step_bytes);
    }
    if (cell) {
      float dhr = 0.f;
      if (t < S - 1) {
        const float* rv = recv + ((size_t)cur * CLUSTER * ROWS + cr) * UPB + cu;
        float s = rv[0];
#pragma unroll
        for (int p = 1; p < CLUSTER; ++p) s += rv[p * ROWS * UPB];
        dhr = round_t<__nv_bfloat16>(s);
      }
      float dg[4];
      cell_bwd<true>(wg, pc, pn, pm, cc, cn, cm, wdh + dhr, dc, dn, dg);
      __nv_bfloat16* arow = at + ((t & 1) * ROWS + cr) * ASTR + cu;
#pragma unroll
      for (int gt = 0; gt < 4; ++gt) {
        const __nv_bfloat16 v = __float2bfloat16_rn(dg[gt]);
        dwx_row[(size_t)t * XS + gt * DH] = v;
        arow[gt * UPB] = v;
      }
    }
    __syncthreads();
    // the partials of h_{t-1}: this warp's 32 units over the block's columns
    const __nv_bfloat16* arow = at + ((t & 1) * ROWS + g) * ASTR;
    float acc[NT][4] = {};
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      const uint32_t a0 = *reinterpret_cast<const uint32_t*>(arow + 16 * ks + 2 * q);
      const uint32_t a2 = *reinterpret_cast<const uint32_t*>(arow + 16 * ks + 8 + 2 * q);
#pragma unroll
      for (int j = 0; j < NT; ++j)
        mma_bf16(acc[j], a0, 0u, a2, 0u, bfr[ks][j][0], bfr[ks][j][1]);
    }
    if (g < rows) {
      const uint32_t off = (uint32_t)((t & 1) * CLUSTER * ROWS * UPB * 4);
#pragma unroll
      for (int j = 0; j < NT; ++j)
        st_async_v2(dst_buf[j] + off + dst_off[j], __float_as_uint(acc[j][0]),
                    __float_as_uint(acc[j][1]), dst_bar[j] + 8 * (t & 1));
    }
#pragma unroll
    for (int gt = 0; gt < 4; ++gt) wg[gt] = ng[gt];
    wdh = ndh;
    cc = pc;
    cn = pn;
    cm = pm;
    pc = qc;
    pn = qn;
    pm = qm;
  }
  // the partials for h_{-1} (the start state's dh) in buffer 0; each block
  // leaves only once its own have all landed
  mbar_wait(&bar[0], ((S - 1) >> 1) & 1);
  if (cell) {
    const float* rv = recv + (size_t)cr * UPB + cu;
    float s = rv[0];
#pragma unroll
    for (int p = 1; p < CLUSTER; ++p) s += rv[p * ROWS * UPB];
    dh0[sidx] = round_t<__nv_bfloat16>(s);
    dc0[sidx] = dc;
    dn0[sidx] = dn;
  }
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
      cell_bwd<false>(wg, pc, pn, pm, cc, cn, cm, wdh + dhr, dc, dn, dg);
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
