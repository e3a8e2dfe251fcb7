// The sLSTM recurrence (xLSTM's scalar-memory block) for NVIDIA Hopper
// (sm_90a): one launch runs a layer's whole scan over S positions.
//
// Replaces: no Pallas kernel. The JAX package runs the recurrence as a
// jax.lax.scan (src/repro/models/xlstm.py slstm_apply, run_scan's body,
// :153-157), one compiled loop; stepped from Python it would be some 20
// launches a position. This kernel is that loop: the prefill runs it over
// the prompt from the start state, each decode step at S = 1 from the
// cached state.
//
// Computes, for each row b and head h, for t = 0..S-1 in order:
//   rh    = T(h_{t-1} as T  @  R_h)          (float32 sums, rounded to T)
//   gates = T(wx[b, t, h] + rh)               (the add in the compute type T)
//   (c, n, m, h)_t = the stabilized exp-gated cell on gates, in float32
// wx: [B, S, H, 4, dh] (the hoisted input projection, head-major as the
// reference lays its gates out: i, f, z, o); R: [H, dh, 4 dh] (r_gates);
// the state c, n, m, h: [B, H, dh] float32. Writes hs [B, S, H, dh] = T(h_t)
// and the final state. T is bfloat16 or float32 (then nothing rounds).
//
// Bound: the function reads wx and R once and writes hs (44 MB at B 4, S
// 1024, xlstm-350m's H 4 and dh 256, bf16: 13 us at 3.35 TB/s) and does 2
// dh FLOP a (row, gate column, position). But its positions are a chain:
// step t needs all of h_{t-1}. So the latency of one step bounds it: a
// product over dh, the cell, and the exchange of the new h among the
// blocks that share the head. Nothing of R or h travels through device
// memory inside the chain.
//
// Design. Per (head, group of up to ROWS = 8 rows), a cluster of CLUSTER =
// 8 blocks. Block `rank` owns units [rank dh / 8, (rank + 1) dh / 8) of the
// head, 4 dh / 8 gate columns of R_h, and each step:
//  * computes its columns of h_{t-1} R for the group's rows;
//  * runs the cell for its (row, unit) pairs, its c, n, m in registers,
//    with wx loaded one step ahead;
//  * writes T(h_t) to hs and its new h into every peer block's shared
//    memory (DSMEM), in the buffer of the next step's parity.
// bf16 (slstm_mma_kernel<DH>, dh / 32 warps): the product on the tensor
// cores, mma.sync m16n8k16, h the A operand (the group's rows, padded to
// 16 with zeros) and R the B operand. Each warp owns 4 units, 16 columns
// ordered unit-major (column 4 u + g is gate g of unit u), and holds their
// B fragments in registers for the whole scan (dh / 2 of them at dh 256),
// built once from R's slice, which the copy engine stages (cp.async, all
// copies in flight). A step is dh / 16 pairs of mma, in four independent
// accumulator chains a tile summed in a fixed order, on A fragments read
// from a 16-byte-padded h buffer (no bank conflicts); a lane's sums then
// hold two gates of one unit and row, its neighbour lane the other two, so
// one shuffle pair gives each lane the four gates of its own (row, unit)
// cell: no shared memory and no block barrier between the product and the
// cell. The exchange is the Hopper producer/consumer idiom: each lane pair
// sends its two units' h as one 4-byte st.async into every peer's buffer,
// counted on that buffer's mbarrier (complete_tx), and a block starts a
// step by waiting on its own mbarrier for every row's h from all eight
// blocks, which then expects the step after next (expect_tx). No cluster
// barrier and no release fence inside the loop: the first step's
// barrier-and-fence round trip was 0.65 us of 2.18 (tools/slstm_breakdown.py).
// A block may only overwrite a buffer that every block has finished
// reading: it writes h_t into the buffer of h_{t-2}, after receiving h_{t-1}
// from every block's every warp, each of which sent it after its own
// product over h_{t-2}. A block leaves only once h_{S-1} has all landed.
// float32 (slstm_f32_kernel<NR>, exact scalar products: no TF32): each
// block keeps its columns of R in shared memory (128 KB at dh 256), each
// thread sums one column over half of dh for the group's rows with FMA in
// k order, the halves add in a fixed order through shared memory, one
// thread per (row, unit) runs the cell and stores its h into every peer,
// and one cluster barrier (release/acquire) ends each step.
// A row's arithmetic is the same whatever the other rows of its group, the
// group's size or S (a tensor-core product's element depends on its own
// row and column alone; the FMA sums run in k order), so rows at B = 4
// equal the same rows at B = 1, and scan(S + 1) equals scan(S) then
// scan(1) from its final state, bit for bit. Nothing sums across rows or
// positions, and every sum runs in a fixed order.
//
// What bounds it then: the chain of steps, each a product, a cell's
// exponentials and the exchange's round trip (repro_slstm_barrier times S
// cluster barriers in a launch of the same shape, a floor of the same
// kind).
//
// The training forward (STATES, repro_slstm_scan_states) runs the same
// code and also saves each position's gates, as the cell took them, and
// its c, n, m: what the backward (slstm_scan_bwd.cu) reads. hs and the
// final state keep the serving launch's bits. Nothing is stored ahead of
// the step's st.async to the peers (0.21 us a step when the saves went
// first, tools/slstm_breakdown.py --states). Seven scattered stores a cell
// a step after it still cost 0.10 us a step (the cells' 8-byte pieces of
// four rows, an LSU transaction each), so where a block's slice of a gate
// row is a multiple of 16 bytes (dh 64, 128, 192, 256) the cells write
// them into shared memory instead, in chunks of KCH positions laid out as
// TMA boxes, double-buffered; one more warp, the store warp, writes each
// full chunk out by four TMA stores (gates, c, n, m, each a box of the
// block's units, KCH positions and the group's rows) and hands the buffer
// back once they have read it (an mbarrier each way, the cells' writes
// ordered before the TMA's reads by fence.proxy.async). No fence on the
// chain waits for them; they are all done before the block leaves.
//
// Diagnostic macros (tools/slstm_breakdown.py; the bf16 kernel's results
// are wrong under any of them, they only time what is left): SLSTM_NO_MMA
// (no product), SLSTM_NO_CELL (h is a gate's sum, no exponentials),
// SLSTM_NO_HS (hs not written), SLSTM_LOCAL (each block's h pairs sent to
// itself eight times, the bytes its mbarrier counts: no DSMEM traffic);
// SLSTM_NO_SAVES (the training forward saves nothing: no stores, and staged
// its chunks go out unwritten).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

#include "hopper.cuh"  // the host's tensor-map encoder, bulk-group waits
#include "slstm.cuh"

namespace cg = cooperative_groups;

namespace slstm {

constexpr int KCH = 8;  // positions a staged chunk of the training forward's saves

// the training forward's saves go through shared memory and TMA stores
// where a block's slice of a gate row is a multiple of 16 bytes (dh 64,
// 128, 192, 256); elsewhere each cell stores its own
template <int DH, bool STATES>
__host__ __device__ constexpr bool staged() {
  return STATES && (DH / CLUSTER) % 8 == 0;
}

// one staged chunk: gates [ROWS][KCH][4][DH / 8] bf16, then c, n and m
// each [ROWS][KCH][DH / 8] float32 (the TMA boxes' layouts)
template <int DH>
__host__ __device__ constexpr size_t stage_bytes() {
  return (size_t)ROWS * KCH * (DH / CLUSTER) * (4 * 2 + 3 * 4);
}

template <int DH, bool STATES>
__host__ __device__ constexpr size_t mma_smem_bytes() {
  // R's slice [DH][4 gates][DH / 8] bf16, then h [2][ROWS][DH + 8] bf16,
  // then an mbarrier per h buffer; staged, from the next 128 bytes two
  // chunks' saves, then the chunks' full and empty mbarriers
  const size_t base = (size_t)DH * DH + (size_t)2 * ROWS * (DH + 8) * 2 + 2 * sizeof(uint64_t);
  if constexpr (!staged<DH, STATES>()) return base;
  return (base + 127) / 128 * 128 + 2 * stage_bytes<DH>() + 4 * sizeof(uint64_t);
}

// the training forward's saves as 4-D tensor maps: gates [B][S][4 H][dh]
// and c, n, m [B][S][H][dh], boxes of a block's dh / 8 units, (4 gates,) KCH
// positions and ROWS rows (positions and rows past the tensors are not
// written)
struct SaveMaps {
  CUtensorMap g, c, n, m;
};

// one TMA box from shared memory to a 4-D tensor map at (c0, c1, c2, c3),
// in this thread's bulk group
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%1, %2, %3, %4}], [%5];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(smem_u32(src))
      : "memory");
}

template <int DH, bool STATES>
__global__ void __cluster_dims__(CLUSTER, 1, 1)
    __launch_bounds__(DH + (staged<DH, STATES>() ? 32 : 0))
    slstm_mma_kernel(const __nv_bfloat16* __restrict__ wx, const __nv_bfloat16* __restrict__ r,
                     const float* __restrict__ c0, const float* __restrict__ n0,
                     const float* __restrict__ m0, const float* __restrict__ h0,
                     __nv_bfloat16* __restrict__ hs, float* __restrict__ c1,
                     float* __restrict__ n1, float* __restrict__ m1, float* __restrict__ h1,
                     __nv_bfloat16* __restrict__ gs, float* __restrict__ cs,
                     float* __restrict__ ns, float* __restrict__ ms,
                     const __grid_constant__ SaveMaps maps, int B, int S, int H) {
  constexpr int UPB = DH / CLUSTER;  // units a block; 4 a warp, so DH / 32 warps
  constexpr int KSTEPS = DH / 16;
  constexpr int CHAINS = 4;          // independent accumulators a tile (k step mod 4)
  constexpr int HSTR = DH + 8;       // an h row in the buffer, 16 bytes of pad
  // bf16 elements a staging copy: 16 bytes, or 8 where UPB is not a
  // multiple of 8 (dh 96, 160, 224), so that every copy stays aligned
  constexpr int CHE = UPB % 8 == 0 ? 8 : 4;
  constexpr bool STAGE = staged<DH, STATES>();
  constexpr int NW = DH / 32;  // the warps with cells; staged, warp NW stores the chunks
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
  __nv_bfloat16* rs = reinterpret_cast<__nv_bfloat16*>(smem);           // [DH][4][UPB]
  __nv_bfloat16* hb = rs + DH * 4 * UPB;                                 // [2][ROWS][HSTR]
  uint64_t* bar = reinterpret_cast<uint64_t*>(hb + 2 * ROWS * HSTR);    // [2]
  // staged: chunk buffer b's gates, c, n, m at stage + b * stage_bytes, and
  // its mbarriers full[b] (every cell warp's thread has written it) and
  // empty[b] (its TMA stores have read it)
  unsigned char* stage =
      smem + (STAGE ? mma_smem_bytes<DH, STATES>() - 2 * stage_bytes<DH>() - 4 * sizeof(uint64_t)
                    : 0);
  uint64_t* full = reinterpret_cast<uint64_t*>(stage + 2 * stage_bytes<DH>());
  uint64_t* empty = full + 2;

  // R's columns of this block's units by the copy engine, 8 or 16 bytes a
  // copy, all in flight: rs[k][gate][u] = R[head][k][gate DH + u0 + u]
  const __nv_bfloat16* rh = r + (size_t)head * DH * 4 * DH;
  constexpr int PARTS = UPB / CHE;
  for (int i = threadIdx.x; i < DH * 4 * PARTS; i += blockDim.x) {
    const int k = i / (4 * PARTS), gate = i / PARTS % 4, part = i % PARTS;
    cp_async<CHE * 2>(rs + (k * 4 + gate) * UPB + part * CHE,
                      rh + (size_t)k * 4 * DH + gate * DH + u0 + part * CHE);
  }
  // both h buffers zero (the rows past the group's stay so), then h_{-1}
  for (int i = threadIdx.x; i < 2 * ROWS * HSTR; i += blockDim.x) hb[i] = __float2bfloat16_rn(0.f);
  if (threadIdx.x == 0) {
    mbar_init(&bar[0], 1);
    mbar_init(&bar[1], 1);
    if constexpr (STAGE) {
      for (int b = 0; b < 2; ++b) {
        mbar_init(&full[b], DH);
        mbar_init(&empty[b], 1);
      }
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  for (int i = threadIdx.x; i < rows * DH; i += blockDim.x) {
    const int rr = i / DH, k = i % DH;
    hb[rr * HSTR + k] = __float2bfloat16_rn(h0[((size_t)(row0 + rr) * H + head) * DH + k]);
  }
  // the warp's B fragments for the whole scan: tile j holds the block's
  // columns 16 warp + 8 j + n, column 4 u + gate of the block's unit u; this
  // lane's are n = g, k = 2q, 2q + 1 (b0) and 2q + 8, 2q + 9 (b1) of each
  // 16-row k step
  uint32_t bfr[KSTEPS][2][2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int c = 16 * warp + 8 * j + g;
    const __nv_bfloat16* col = rs + (c % 4) * UPB + c / 4;
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int k = 16 * ks + 8 * half + 2 * q;
        bfr[ks][j][half] = pack_bf16(col[k * 4 * UPB], col[(k + 1) * 4 * UPB]);
      }
    }
  }

  // this lane's cell: row g of the group, block unit 4 warp + 2 jt + q / 2
  // with jt = q % 2; its own accumulators of tile jt hold gates (0, 1) when
  // q is even and (2, 3) when odd, lane q ^ 1's the other two. Lanes q and
  // q + 2 hold adjacent units (4 warp + 2 jt and + 1), which lane q (q < 2)
  // sends as one bf16 pair
  const int jt = q & 1;
  const int unit = 4 * warp + 2 * jt + (q >> 1);
  // (staged, the store warp holds none; the test stays out of the serving
  // kernel, whose step it slows by 0.06 us)
  const bool cell = g < rows && (!STAGE || warp < NW);
  const int crow = row0 + (cell ? g : 0);
  const size_t sidx = ((size_t)crow * H + head) * DH + u0 + unit;
  float c = 0.f, n = 0.f, m = 0.f, h = 0.f;
  if (cell) {
    c = c0[sidx];
    n = n0[sidx];
    m = m0[sidx];
    h = h0[sidx];
  }
  const __nv_bfloat16* wx_row = wx + (size_t)crow * S * 4 * H * DH + (size_t)head * 4 * DH + u0 +
                                unit;
  __nv_bfloat16* hs_row = hs + (size_t)crow * S * H * DH + (size_t)head * DH + u0 + unit;
  // STATES: each position's gates (wx's layout) and state after it (hs's)
  const size_t xoff = (size_t)crow * S * 4 * H * DH + (size_t)head * 4 * DH + u0 + unit;
  const size_t soff = (size_t)crow * S * H * DH + (size_t)head * DH + u0 + unit;
  // where this lane's pair goes in each peer: buffer 0's slot, buffer 1's
  // a fixed offset on, and the peer's two mbarriers
  const int pair_slot = g * HSTR + u0 + 4 * warp + 2 * q;
  uint32_t peer_h[CLUSTER], peer_bar[CLUSTER];
#pragma unroll
  for (int p = 0; p < CLUSTER; ++p) {
    peer_h[p] = map_rank(hb + pair_slot, p);
    peer_bar[p] = map_rank(&bar[0], p);
  }
  // every block receives all rows' h from all eight blocks each step
  const uint32_t step_bytes = (uint32_t)rows * DH * 2;
  if (threadIdx.x == 0) {
    mbar_expect_tx(&bar[1], step_bytes);  // h_0
    if (S > 1) mbar_expect_tx(&bar[0], step_bytes);  // h_1
  }

  // the next step's input gates, as loaded: converted only when the step
  // uses them (converting them where they load would wait there for device
  // memory)
  __nv_bfloat16 wn[4];
#pragma unroll
  for (int gt = 0; gt < 4; ++gt) wn[gt] = cell ? wx_row[gt * DH] : __float2bfloat16_rn(0.f);
  // every block has started, staged h_{-1} and set its mbarriers up before
  // any block sends
  cluster.sync();

  if constexpr (STAGE) {
    if (warp == NW) {
      // the store warp: each chunk, once every cell warp's thread has
      // written it, goes out by four TMA stores, and its buffer is handed
      // back once they have read it; all are done before the block leaves
      const int nch = (S + KCH - 1) / KCH;
      for (int ch = 0; ch < nch; ++ch) {
        const int b = ch & 1;
        unsigned char* sb = stage + b * stage_bytes<DH>();
        constexpr size_t GB = (size_t)ROWS * KCH * 4 * UPB * 2, SB = (size_t)ROWS * KCH * UPB * 4;
        mbar_wait(&full[b], (ch >> 1) & 1);
        if (lane == 0) {
          tma_store_4d(&maps.g, sb, u0, 4 * head, ch * KCH, row0);
          tma_store_4d(&maps.c, sb + GB, u0, head, ch * KCH, row0);
          tma_store_4d(&maps.n, sb + GB + SB, u0, head, ch * KCH, row0);
          tma_store_4d(&maps.m, sb + GB + 2 * SB, u0, head, ch * KCH, row0);
          bulk_commit();
          bulk_wait_read<0>();
          mbar_arrive(&empty[b]);
        }
        __syncwarp();
      }
      if (lane == 0) bulk_wait<0>();
      cluster.sync();
      return;
    }
  }

  for (int t = 0; t < S; ++t) {
    const int cur = t & 1;
    if (t > 0) {
      // h_{t-1}, from every block, is in buffer cur: the phase (t - 1) / 2
      // of its mbarrier; then that mbarrier expects h_{t+1}
      mbar_wait(&bar[cur], ((t - 1) >> 1) & 1);
      if (threadIdx.x == 0 && t + 1 < S) mbar_expect_tx(&bar[cur], step_bytes);
    }
    float wg[4];
#pragma unroll
    for (int gt = 0; gt < 4; ++gt) wg[gt] = __bfloat162float(wn[gt]);
    if (cell && t + 1 < S) {
      const __nv_bfloat16* w = wx_row + (size_t)(t + 1) * 4 * H * DH;
#pragma unroll
      for (int gt = 0; gt < 4; ++gt) wn[gt] = w[gt * DH];
    }
    const __nv_bfloat16* hrow = hb + cur * ROWS * HSTR + g * HSTR;
    float acc[2][CHAINS][4] = {};
#ifndef SLSTM_NO_MMA
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      const uint32_t a0 = *reinterpret_cast<const uint32_t*>(hrow + 16 * ks + 2 * q);
      const uint32_t a2 = *reinterpret_cast<const uint32_t*>(hrow + 16 * ks + 8 + 2 * q);
      mma_bf16(acc[0][ks % CHAINS], a0, 0u, a2, 0u, bfr[ks][0][0], bfr[ks][0][1]);
      mma_bf16(acc[1][ks % CHAINS], a0, 0u, a2, 0u, bfr[ks][1][0], bfr[ks][1][1]);
    }
#else
    acc[0][0][0] = __bfloat162float(hrow[2 * q]);
#endif
    // the chains in a fixed order, then the partner's two gates
    float s[2][2], y[2][2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[j][e] = (acc[j][0][e] + acc[j][1][e]) + (acc[j][2][e] + acc[j][3][e]);
        y[j][e] = __shfl_xor_sync(0xffffffffu, s[j][e], 1);
      }
    }
    uint32_t hbits = 0;
    float gate[4];
    if (cell) {
      const float o0 = jt ? s[1][0] : s[0][0], o1 = jt ? s[1][1] : s[0][1];
      const float p0 = jt ? y[1][0] : y[0][0], p1 = jt ? y[1][1] : y[0][1];
      const float sum[4] = {jt ? p0 : o0, jt ? p1 : o1, jt ? o0 : p0, jt ? o1 : p1};
#ifndef SLSTM_NO_CELL
      h = cell_step<__nv_bfloat16, true>(wg, sum, c, n, m, gate);
#else
      h = wg[0] + sum[0];
#pragma unroll
      for (int gt = 0; gt < 4; ++gt) gate[gt] = wg[gt];
#endif
      hbits = __bfloat16_as_ushort(__float2bfloat16_rn(h));
    }
    // lane q < 2 packs lane q + 2's h (the next unit) above its own
    const uint32_t up = __shfl_down_sync(0xffffffffu, hbits, 2);
    if (cell && q < 2) {
      const uint32_t v = hbits | (up << 16);
      const uint32_t off = (uint32_t)(((t + 1) & 1) * ROWS * HSTR * 2);
      const int nxt = (t + 1) & 1;
#ifndef SLSTM_LOCAL
#pragma unroll
      for (int p = 0; p < CLUSTER; ++p) st_async(peer_h[p] + off, v, peer_bar[p] + 8 * nxt);
#else
      for (int p = 0; p < CLUSTER; ++p) st_async(peer_h[rank] + off, v, peer_bar[rank] + 8 * nxt);
#endif
    }
    // hs and the training forward's saves after the exchange: nothing on
    // the memory path ahead of the st.async (each asm volatile keeps the
    // order it is written in)
    if (cell) {
#ifndef SLSTM_NO_HS
      hs_row[(size_t)t * H * DH] = __ushort_as_bfloat16((unsigned short)hbits);
#endif
#ifndef SLSTM_NO_SAVES
      if constexpr (STATES && !STAGE) {
#pragma unroll
        for (int gt = 0; gt < 4; ++gt)
          gs[xoff + (size_t)t * 4 * H * DH + gt * DH] = __float2bfloat16_rn(gate[gt]);
        cs[soff + (size_t)t * H * DH] = c;
        ns[soff + (size_t)t * H * DH] = n;
        ms[soff + (size_t)t * H * DH] = m;
      }
#endif
    }
    if constexpr (STAGE) {
      // into chunk t / KCH's buffer at slot t % KCH, once the TMA stores
      // of the chunk two before have read it; the chunk's last position
      // hands it to the store warp
      const int ch = t / KCH, slot = t % KCH, b = ch & 1;
      if (slot == 0 && ch >= 2) mbar_wait(&empty[b], ((ch - 2) >> 1) & 1);
#ifndef SLSTM_NO_SAVES
      if (cell) {
        unsigned char* sb = stage + b * stage_bytes<DH>();
        __nv_bfloat16* sg = reinterpret_cast<__nv_bfloat16*>(sb) + (g * KCH + slot) * 4 * UPB + unit;
        float* sc = reinterpret_cast<float*>(sb + (size_t)ROWS * KCH * 4 * UPB * 2) +
                    (g * KCH + slot) * UPB + unit;
#pragma unroll
        for (int gt = 0; gt < 4; ++gt) sg[gt * UPB] = __float2bfloat16_rn(gate[gt]);
        sc[0] = c;
        sc[ROWS * KCH * UPB] = n;
        sc[2 * ROWS * KCH * UPB] = m;
      }
#endif
      if (slot == KCH - 1 || t == S - 1) {
        // the generic proxy's writes ordered before the TMA's reads
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_arrive(&full[b]);
      }
    }
  }
  // h_{S-1} from every block has landed here before this block exits (no
  // peer's store may reach a block that has gone), and the others likewise
  mbar_wait(&bar[S & 1], ((S - 1) >> 1) & 1);
  if (cell) {
    c1[sidx] = c;
    n1[sidx] = n;
    m1[sidx] = m;
    h1[sidx] = h;
  }
  cluster.sync();
}

// ---- float32: exact scalar products --------------------------------------

// shared memory of one block: R's slice [dh][4 dh / 8] float32, then
// h_{t-1} [2 parities][dh][NR], then the partial sums [KS][NR][4 dh / 8]
__host__ __device__ constexpr size_t f32_smem_bytes(int dh, int nr) {
  return (size_t)dh * (dh / 2) * sizeof(float) + (size_t)2 * dh * nr * sizeof(float) +
         (size_t)KS * nr * (dh / 2) * sizeof(float);
}

template <int NR, bool STATES>
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(MAX_DH)
    slstm_f32_kernel(const float* __restrict__ wx, const float* __restrict__ r,
                     const float* __restrict__ c0, const float* __restrict__ n0,
                     const float* __restrict__ m0, const float* __restrict__ h0,
                     float* __restrict__ hs, float* __restrict__ c1, float* __restrict__ n1,
                     float* __restrict__ m1, float* __restrict__ h1, float* __restrict__ gs,
                     float* __restrict__ cs, float* __restrict__ ns, float* __restrict__ ms,
                     int B, int S, int H, int dh) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int head = blockIdx.y;
  const int row0 = blockIdx.z * NR;
  const int rows = min(NR, B - row0);
  const int upb = dh / CLUSTER;  // units this block owns
  const int ncol = 4 * upb;      // its gate columns: column g upb + u is gate g of unit u
  const int u0 = rank * upb;
  const int tid = threadIdx.x;   // blockDim.x = KS ncol = dh

  extern __shared__ __align__(16) unsigned char smem[];
  float* rs = reinterpret_cast<float*>(smem);
  float* hb = rs + dh * ncol;
  float* red = hb + 2 * dh * NR;

  // R's columns of this block's units, once: rs[k][g upb + u] = R[head][k][g
  // dh + u0 + u], eight loads in flight a thread before their stores
  const float* rh_src = r + (size_t)head * dh * 4 * dh;
  for (int i0 = tid; i0 < dh * ncol; i0 += 8 * blockDim.x) {
    float v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int i = i0 + e * blockDim.x;
      v[e] = i < dh * ncol ? rh_src[(size_t)(i / ncol) * 4 * dh + (i % ncol / upb) * dh + u0 +
                                    i % ncol % upb]
                           : 0.f;
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int i = i0 + e * blockDim.x;
      if (i < dh * ncol) rs[i] = v[e];
    }
  }
  // h_{-1} of the group's rows (zeros past them: their sums are computed
  // and never read)
  for (int i = tid; i < dh * NR; i += blockDim.x) {
    const int k = i / NR, qq = i % NR;
    hb[i] = qq < rows ? h0[((size_t)(row0 + qq) * H + head) * dh + k] : 0.f;
  }

  // the cell this thread runs: row `cr` of the group, unit u0 + `cu`
  const int cr = tid / upb, cu = tid % upb;
  const bool cell = cr < rows;
  const int crow = row0 + (cell ? cr : 0);
  const size_t sidx = ((size_t)crow * H + head) * dh + u0 + cu;
  float c = 0.f, n = 0.f, m = 0.f, h = 0.f;
  if (cell) {
    c = c0[sidx];
    n = n0[sidx];
    m = m0[sidx];
    h = h0[sidx];
  }
  const float* wx_row = wx + (size_t)crow * S * 4 * H * dh + (size_t)head * 4 * dh + u0 + cu;
  float* hs_row = hs + (size_t)crow * S * H * dh + (size_t)head * dh + u0 + cu;
  const size_t xoff = (size_t)crow * S * 4 * H * dh + (size_t)head * 4 * dh + u0 + cu;
  const size_t soff = (size_t)crow * S * H * dh + (size_t)head * dh + u0 + cu;
  float* peer[CLUSTER];
#pragma unroll
  for (int p = 0; p < CLUSTER; ++p) peer[p] = cluster.map_shared_rank(hb, p);

  const int col = tid % ncol, kp = tid / ncol, kl = dh / KS;
  float wn[4] = {0.f, 0.f, 0.f, 0.f};
  if (cell) {
#pragma unroll
    for (int g = 0; g < 4; ++g) wn[g] = wx_row[g * dh];
  }
  cluster.sync();

  for (int t = 0; t < S; ++t) {
    float wg[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) wg[g] = wn[g];
    if (cell && t + 1 < S) {
      const float* w = wx_row + (size_t)(t + 1) * 4 * H * dh;
#pragma unroll
      for (int g = 0; g < 4; ++g) wn[g] = w[g * dh];
    }
    const float* hcur = hb + (t & 1) * dh * NR;
    float acc[NR];
#pragma unroll
    for (int qq = 0; qq < NR; ++qq) acc[qq] = 0.f;
    for (int k = kp * kl; k < (kp + 1) * kl; ++k) {
      const float rv = rs[k * ncol + col];
      const float* hk = hcur + k * NR;
#pragma unroll
      for (int qq = 0; qq < NR; ++qq) acc[qq] = fmaf(hk[qq], rv, acc[qq]);
    }
#pragma unroll
    for (int qq = 0; qq < NR; ++qq) red[(kp * NR + qq) * ncol + col] = acc[qq];
    __syncthreads();

    if (cell) {
      float sum[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        float s = red[cr * ncol + g * upb + cu];
#pragma unroll
        for (int p = 1; p < KS; ++p) s += red[(p * NR + cr) * ncol + g * upb + cu];
        sum[g] = s;
      }
      float gate[4];
      h = cell_step<float, false>(wg, sum, c, n, m, gate);
      hs_row[(size_t)t * H * dh] = h;
      if constexpr (STATES) {
#pragma unroll
        for (int g = 0; g < 4; ++g) gs[xoff + (size_t)t * 4 * H * dh + g * dh] = gate[g];
        cs[soff + (size_t)t * H * dh] = c;
        ns[soff + (size_t)t * H * dh] = n;
        ms[soff + (size_t)t * H * dh] = m;
      }
      const int slot = ((t + 1) & 1) * dh * NR + (u0 + cu) * NR + cr;
#pragma unroll
      for (int p = 0; p < CLUSTER; ++p) peer[p][slot] = h;
    }
    // the new h is in every block's buffer, and this step's reads of `red`
    // and of the old buffer are done, before any block goes on
    cluster.sync();
  }
  if (cell) {
    c1[sidx] = c;
    n1[sidx] = n;
    m1[sidx] = m;
    h1[sidx] = h;
  }
}

// S cluster barriers in a launch of the scan's shape: the latency floor of
// S steps (what the chain costs with no work in it)
__global__ void __cluster_dims__(CLUSTER, 1, 1) barrier_kernel(int S) {
  cg::cluster_group cluster = cg::this_cluster();
  for (int t = 0; t <= S; ++t) cluster.sync();
}

// the pointers of one launch: the inputs, the outputs, and (the training
// forward's, else null) each position's gates and state
struct Args {
  const void *wx, *r;
  const float *c0, *n0, *m0, *h0;
  void* hs;
  float *c1, *n1, *m1, *h1;
  void* gs;
  float *cs, *ns, *ms;
};

// a 4-D tensor map over one save (SaveMaps): inner dims dh, then `lanes`
// (4 H gate rows or H heads), S positions and B rows; `esize`-byte elements
int encode_save(CUtensorMap* map, CUtensorMapDataType type, int esize, void* base, int dh,
                int lanes, int S, int B, int box_lanes) {
  EncodeTiled fn = encode_fn();
  if (!fn) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)dh, (cuuint64_t)lanes, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)dh * esize, (cuuint64_t)lanes * dh * esize,
                                 (cuuint64_t)S * lanes * dh * esize};
  const cuuint32_t box[4] = {(cuuint32_t)(dh / CLUSTER), (cuuint32_t)box_lanes, KCH, ROWS};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, type, 4, base, dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int DH, bool STATES>
int launch_mma(const Args& a, int B, int S, int H, cudaStream_t stream) {
  constexpr bool STAGE = staged<DH, STATES>();
  SaveMaps maps{};  // unused unless staged
  if constexpr (STAGE) {
    int rc = encode_save(&maps.g, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a.gs, DH, 4 * H, S, B, 4);
    if (!rc) rc = encode_save(&maps.c, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, a.cs, DH, H, S, B, 1);
    if (!rc) rc = encode_save(&maps.n, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, a.ns, DH, H, S, B, 1);
    if (!rc) rc = encode_save(&maps.m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, a.ms, DH, H, S, B, 1);
    if (rc) return rc;
  }
  const size_t smem = mma_smem_bytes<DH, STATES>();
  cudaError_t err = cudaFuncSetAttribute(slstm_mma_kernel<DH, STATES>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(CLUSTER, H, (B + ROWS - 1) / ROWS);
  slstm_mma_kernel<DH, STATES><<<grid, DH + (STAGE ? 32 : 0), smem, stream>>>(
      static_cast<const __nv_bfloat16*>(a.wx), static_cast<const __nv_bfloat16*>(a.r), a.c0, a.n0,
      a.m0, a.h0, static_cast<__nv_bfloat16*>(a.hs), a.c1, a.n1, a.m1, a.h1,
      static_cast<__nv_bfloat16*>(a.gs), a.cs, a.ns, a.ms, maps, B, S, H);
  return (int)cudaGetLastError();
}

template <int NR, bool STATES>
int launch_f32(const Args& a, int B, int S, int H, int dh, cudaStream_t stream) {
  const size_t smem = f32_smem_bytes(dh, NR);
  cudaError_t err = cudaFuncSetAttribute(slstm_f32_kernel<NR, STATES>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(CLUSTER, H, (B + NR - 1) / NR);
  slstm_f32_kernel<NR, STATES><<<grid, dh, smem, stream>>>(
      static_cast<const float*>(a.wx), static_cast<const float*>(a.r), a.c0, a.n0, a.m0, a.h0,
      static_cast<float*>(a.hs), a.c1, a.n1, a.m1, a.h1, static_cast<float*>(a.gs), a.cs, a.ns,
      a.ms, B, S, H, dh);
  return (int)cudaGetLastError();
}

template <bool STATES>
int launch(const Args& a, int B, int S, int H, int dh, int dtype, cudaStream_t st) {
  if (B < 1 || S < 1 || H < 1 || dh % 32 || dh < 32 || dh > MAX_DH || H > 65535)
    return (int)cudaErrorInvalidValue;
  if (dtype == 1) {
    switch (dh) {
#define SLSTM_MMA(D) \
  case D:            \
    return launch_mma<D, STATES>(a, B, S, H, st);
      SLSTM_MMA(32)
      SLSTM_MMA(64)
      SLSTM_MMA(96)
      SLSTM_MMA(128)
      SLSTM_MMA(160)
      SLSTM_MMA(192)
      SLSTM_MMA(224)
      SLSTM_MMA(256)
#undef SLSTM_MMA
    }
    return (int)cudaErrorInvalidValue;
  }
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  switch (group_rows(B)) {
    case 1:
      return launch_f32<1, STATES>(a, B, S, H, dh, st);
    case 2:
      return launch_f32<2, STATES>(a, B, S, H, dh, st);
    case 4:
      return launch_f32<4, STATES>(a, B, S, H, dh, st);
    default:
      return launch_f32<8, STATES>(a, B, S, H, dh, st);
  }
}

}  // namespace slstm

// wx [B, S, H 4 dh], r [H, dh, 4 dh] (dtype 0: float32, 1: bfloat16), the
// start state c0, n0, m0, h0 [B, H, dh] float32; writes hs [B, S, H, dh]
// in wx's dtype and the final state c1, n1, m1, h1 [B, H, dh] float32 (all
// contiguous; the outputs must not overlap the inputs). dh a multiple of 32
// up to 256. Returns a cudaError_t.
extern "C" int repro_slstm_scan(const void* wx, const void* r, const float* c0, const float* n0,
                                const float* m0, const float* h0, void* hs, float* c1, float* n1,
                                float* m1, float* h1, int B, int S, int H, int dh, int dtype,
                                void* stream) {
  const slstm::Args a{wx, r, c0, n0, m0, h0, hs, c1, n1, m1, h1, nullptr, nullptr, nullptr, nullptr};
  return slstm::launch<false>(a, B, S, H, dh, dtype, static_cast<cudaStream_t>(stream));
}

// The training forward: repro_slstm_scan, and also each position's gates gs
// [B, S, H 4 dh] in wx's dtype (as the cell took them: rounded to it) and
// its state after it cs, ns, ms [B, S, H, dh] float32, what the backward
// (slstm_scan_bwd.cu) reads. hs and the final state are the same bits as
// repro_slstm_scan's. Returns a cudaError_t.
extern "C" int repro_slstm_scan_states(const void* wx, const void* r, const float* c0,
                                       const float* n0, const float* m0, const float* h0,
                                       void* hs, float* c1, float* n1, float* m1, float* h1,
                                       void* gs, float* cs, float* ns, float* ms, int B, int S,
                                       int H, int dh, int dtype, void* stream) {
  const slstm::Args a{wx, r, c0, n0, m0, h0, hs, c1, n1, m1, h1, gs, cs, ns, ms};
  return slstm::launch<true>(a, B, S, H, dh, dtype, static_cast<cudaStream_t>(stream));
}

// S + 1 cluster barriers (the scan's S and its first) on the bf16 kernel's
// grid at B rows, H heads and dh threads a block. Returns a cudaError_t.
extern "C" int repro_slstm_barrier(int B, int S, int H, int dh, void* stream) {
  if (B < 1 || S < 0 || H < 1 || dh < 32 || dh > slstm::MAX_DH) return (int)cudaErrorInvalidValue;
  const dim3 grid(slstm::CLUSTER, H, (B + slstm::ROWS - 1) / slstm::ROWS);
  slstm::barrier_kernel<<<grid, dh, 0, static_cast<cudaStream_t>(stream)>>>(S);
  return (int)cudaGetLastError();
}
