// MLA's absorbed decode (one query token per row; every query head attends
// to one latent head) for NVIDIA Hopper (sm_90a).
//
// Replaces: src/repro/kernels/decode_attention.py::_kernel, and ::_paged_kernel
// through a page table, at the shape MLA's decode gives them:
// src/repro/models/layers.py mla_apply calls decode_attention(...,
// n_kv_heads=1, v_dim=r) with the absorbed queries q_eff [B, H (r + rope)]
// over one fused latent cache, so K = 1, G = H and the key and value are the
// same rows (the value their first r columns).
//
// Computes, for each row b and query head h, softmax(scale q_h L^T) L[:, :DV]
// over positions [0, length_b), L the row's latent rows [S, DK]. q: [B,H,DK]
// contiguous; out: [B,H,DV]. Scores, softmax and sums are float32; the
// output is cast to the input type.
//
// Bound: each latent row (DK elements) serves all H heads at 2 H (DK + DV)
// FLOP, H (DK + DV) / DK = 75 FLOP a bf16 byte at minicpm3-4b's H 40, DK
// 288, DV 256: fewer than the card's 989e12 / 3.35e12 = 295, so the cache's
// bytes in device memory bound it (2 DK length bytes a row): 0.78 us for
// four rows of 1056 positions, 0.19 us for one. What a launch costs beyond
// that is latency: the launch, a row's first bytes, the chain of products,
// and the combine of the row's partials, which only the whole card hides.
//
// The plan of a row (bf16; it depends on the row's length L and the built
// shape alone, so the paged form over pages in order gives the contiguous
// form's bits, a B = 1 lane a batched row's, and a cache or table wider
// than the length the exact fit's; kernels/latent_decode_attention.py
// mirrors it and tests/test_torch_latent_route.py holds the two together):
//  * The row's positions are cut into n_spans(L) spans of whole CHUNKs of 64
//    positions, at most NSMAX = 32 of them (one CHUNK a span up to 2048
//    positions, two up to 4096, ...), and the query heads into tiles of HT =
//    16 (three at H 40, the last half empty). An item is one (row, span,
//    head tile): its block stages the span's rows chunk by chunk and the
//    tile's query rows, and computes the tile's softmax and P L over the
//    span, online across chunks. A span that holds no position below L is
//    no item: nothing of it is staged, written or read. 1056 positions are
//    17 spans, 51 items a row.
//  * A row of one span writes its output directly. Otherwise each item
//    writes an unnormalised partial (m, l [HT], o [HT, DV] float32) and
//    takes a ticket on its (row, head tile)'s counter; once the count is
//    the row's n_spans (a spin on the counter), each item's block combines
//    its own slice of the tile's outputs, span s the s-th of n_spans equal
//    runs of the tile's (head, 4 columns) pieces, over the partials in span
//    order: the combine runs on as many SMs as the row has items, each
//    reading 1/n_spans of the partials. The weights exp2(m_p - max) / den
//    are computed once a (head, partial) into shared memory, one lane a
//    partial, while the first partials' loads are in flight. A second
//    ticket after the combine counts the blocks out and the last one sets
//    the counter back to zero. Atomics only count: every sum runs in a
//    fixed order, so two launches agree bit for bit.
//  * The spin needs every block of the launch resident at once: the grid
//    is at most one wave (the occupancy times the SM count, read once per
//    device), and a block walks items blockIdx.x, + gridDim.x, ... . It
//    runs all its items' products first and only then its combines, so no
//    combine waits on an item that a block has yet to start.
//  * bf16 (latent_mma_kernel, four warps, three blocks an SM): a chunk's 64
//    latent rows and (on a span's first chunk) the tile's query rows are
//    staged by the copy engine (cp.async.bulk) in four groups of 16 rows,
//    each counted on an mbarrier (the query rows with group 0), so warp w
//    starts on its rows while the others' land. Rows lie in pairs, the
//    pairs 16 bytes apart, so that the 8 rows of an ldmatrix start in 8
//    distinct bank groups and a pair adjacent in memory (a contiguous cache,
//    the query rows) is one copy. The last group's rows past the length are
//    copies of the last row below it (finite under P = 0: nothing past the
//    length is read), and query rows past H are left as they are (they make
//    only their own heads' rows of S, P and O, which nothing writes out).
//    (Staged by cp.async, 16 bytes a thread, the copies' issue alone took
//    2.8-3.2 us a block; a bulk copy a row, 1.2 us: PERF.md section 6.) S = q
//    L^T on mma.sync m16n8k16: warp w takes the 16 heads (M) and its 16
//    positions (two n8 tiles) over DK / 16 = 18 k16 steps, in three sums
//    (steps k mod 3, six independent chains) added in order, and writes
//    them to shared memory. Every warp then reads the whole S, forms P =
//    exp2(s - m) (bf16 high and low parts, about 16 bits of P, as
//    decode_mma_kernel) and computes P L for its own 64 of the DV columns
//    through ldmatrix.trans, so all four warps multiply and none merges.
//    The partials are stored 16 bytes a lane (lane pairs swap halves).
//  * float32 (latent_f32_kernel, eight warps): a block a (row, CHUNK), the
//    latent rows staged as floats with a 289-float stride (32 rows read by
//    32 lanes hit 32 banks), q scaled into shared memory; a warp a head at
//    a time: each lane scores two positions, the max and sum by shuffles,
//    then each lane sums eight of the DV columns over the 64 positions, P
//    broadcast by shuffles. Exact scalar products, no TF32. Its own plan:
//    ceil(L / CHUNK) partials a row, counted by a ticket whose last block
//    combines them in order; blocks past the length return at once.
//
// Diagnostic macros (tools/latent_breakdown.py builds each and times the
// differences): LAT_EMPTY (every block returns at once), LAT_STAGE_ONLY
// (rows staged, nothing computed or written), LAT_NO_PL (S and the
// softmax, no P L, nothing written), LAT_NO_WRITE (no partial or output
// written), LAT_NOCOMBINE (no spin and no combine). None is defined in the
// shipped build.
//
// Each entry point launches one kernel on the caller's stream and returns
// cudaGetLastError().

#include "decode_split.cuh"
#include "hopper.cuh"  // the mbarriers

// A named namespace, not an unnamed one: the header's own unnamed namespace
// inside decode_split would make the kernels' registration ambiguous.
namespace latent {

using namespace decode_split;

constexpr int DK = 288;    // latent row: kv_lora_rank 256 + qk_rope_dim 32
constexpr int DV = 256;    // its value columns: kv_lora_rank
constexpr int HMAX = 48;   // query heads a launch takes: three head tiles
constexpr int CHUNK = 64;  // positions a block stages at once; a span is whole chunks
constexpr int NSMAX = 32;  // spans a row is cut into at most
constexpr int HT = 16;     // query heads a tile: one m16 tile

// chunks of CHUNK positions over `positions`
__host__ __device__ constexpr int n_chunks(long long positions) {
  return (int)((positions + CHUNK - 1) / CHUNK);
}
// chunks a span of a row of length L takes: as few as keep the spans at
// most NSMAX
__host__ __device__ constexpr int span_chunks(int L) {
  return n_chunks(L) > NSMAX ? (n_chunks(L) + NSMAX - 1) / NSMAX : 1;
}
// spans (items a head tile) of a row of length L; a row of no position is
// one span that writes zeros
__host__ __device__ constexpr int n_spans(int L) {
  return L < 1 ? 1 : (n_chunks(L) + span_chunks(L) - 1) / span_chunks(L);
}
// partial slots a launch keeps a (row, head tile) over `positions` cache
// positions: at least n_spans(L) for every length L <= positions
__host__ __device__ constexpr int span_slots(long long positions) {
  return n_chunks(positions) < 1 ? 1 : n_chunks(positions) < NSMAX ? n_chunks(positions) : NSMAX;
}

namespace lt {  // the bf16 kernel
constexpr int NWARP = 4;
constexpr int THREADS = NWARP * 32;
constexpr int RESIDENT = 3;       // blocks an SM: the registers and shared memory allow three
constexpr int ROWB = DK * 2;      // bytes of a row
// rows are staged in pairs, a pair's two rows back to back and the pairs
// 16 bytes apart: 8 consecutive rows then start in 8 distinct 16-byte bank
// groups (73 p + 36 (r & 1) mod 8 for row r of pair p), so an ldmatrix is
// free of conflicts, and two rows adjacent in memory are one bulk copy
constexpr int PAIR = 2 * ROWB + 16;
__host__ __device__ constexpr int row_at(int r) { return (r >> 1) * PAIR + (r & 1) * ROWB; }
constexpr int NT = CHUNK / 8;     // n8 tiles of S over a chunk
constexpr int RG = CHUNK / NWARP; // rows a group (and a warp's S) takes: 16
constexpr int L_S = 0;
constexpr int Q_S = L_S + CHUNK / 2 * PAIR;
constexpr int X_S = Q_S + HT / 2 * PAIR;   // S ([NT][32 lanes] float4); later the combine's weights
constexpr int BYTES = X_S + NT * 32 * 16;  // 50,816
static_assert(RG == 16 && DK % 16 == 0, "a warp's S is one m16 x two n8 tiles over k16 steps");
static_assert(NWARP * 64 == DV, "each warp 64 columns of P L");
static_assert(NSMAX <= 32, "a lane a partial in the combine's weights");
static_assert(HT * NSMAX * 4 <= BYTES - X_S, "the weights fit where S was");
}  // namespace lt

namespace lf {  // the float32 kernel
constexpr int NWARP = 8;
constexpr int THREADS = NWARP * 32;
constexpr int ROWF = DK + 1;  // floats of a staged row
constexpr int Q_S = CHUNK * ROWF;
constexpr int BYTES = (Q_S + HMAX * DK) * 4;  // 129,280
static_assert(CHUNK == 64 && DV % 32 == 0, "a lane scores two positions and sums DV / 32 columns");
}  // namespace lf

#ifdef LAT_CLOCK
// one launch's timeline: for each block (up to 4096), clock64 at the phases
// of its first item (0 start, 1 the mbarriers set up, 2 the row offsets
// read and the bytes expected, 3 past the barrier, 4 its copies issued
// (thread 0's), 5 warp 0's rows landed, 6 S written, 7 P L done, 8 the partial
// stored, 9 counted, 10 the spin over, 11 the combine done), then the
// globaltimer (ns) at its start and end and its SM; read by
// repro_latent_clock
constexpr int NSTAMP = 15;
__device__ long long lat_clock[4096][NSTAMP];
__device__ __forceinline__ long long gtime() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define LAT_STAMP(k)                                                           \
  do {                                                                         \
    if (threadIdx.x == 0 && first && blockIdx.x < 4096)                        \
      lat_clock[blockIdx.x][k] = clock64();                                    \
  } while (0)
#else
#define LAT_STAMP(k)
#endif

// `bytes` from global memory to shared memory by the copy engine (one
// bulk copy; 16-byte aligned, a multiple of 16 bytes), counted on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}
__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// the wait for every row group of the current chunk
__device__ __forceinline__ void wait_all(uint64_t* bars, uint32_t phase) {
#pragma unroll
  for (int g = 0; g < lt::NWARP; ++g) mbar_wait(&bars[g], phase);
}

// One item of latent_mma_kernel: head tile t (heads 16 t ..) of row b over
// span s; L the row's length, ns its spans. Writes the output (ns == 1) or
// the item's partial, then takes the first ticket.
template <typename KV>
__device__ __forceinline__ void run_item(const bf16* __restrict__ q, const bf16* __restrict__ lat,
                                         bf16* __restrict__ out, float* __restrict__ part_o,
                                         float* __restrict__ part_m, float* __restrict__ part_l,
                                         int* __restrict__ counters, const KV& kv, int H, int n_t,
                                         int n_slot, int b, int s, int t, int L, int ns,
                                         float scale, uint32_t& phase, uint8_t* smem,
                                         uint64_t* bars, long long* roff, bool first) {
  using namespace lt;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int h0 = t * HT;
  bf16* o = out + ((long long)b * H + h0) * DV;
  if (L < 1) {  // a row of no position: zeros
    for (int e = tid; e < min(HT, H - h0) * DV; e += THREADS) o[e] = __float2bfloat16(0.f);
    return;
  }
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int cps = span_chunks(L);
  const int p0 = s * cps * CHUNK, p_end = min(p0 + cps * CHUNK, L);
  const int r = lane / 4, cq = 2 * (lane % 4);
  const bf16* qb = q + ((long long)b * H + h0) * DK;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

#pragma unroll 1
  for (int j0 = p0; j0 < p_end; j0 += CHUNK) {
    const int n = min(CHUNK, p_end - j0);  // the chunk's positions below the length
    const int nq = j0 == p0 ? min(HT, H - h0) : 0;  // query rows staged with it
    // the rows staged: the groups of 16 that hold a position below the
    // length, whole; a row past it (in the last group) a copy of the last
    // row below it, finite under P = 0 (nothing past the length is read).
    // Query rows past H are left as they are: they make only their own
    // heads' rows of S, P and O, which nothing writes out.
    const int nr = RG * ((n + RG - 1) / RG);
    if (tid < nr) roff[tid] = kv.row(b, j0 + min(tid, n - 1), 0);
    if (tid == 0)
#pragma unroll
      for (int g = 0; g < NWARP; ++g)
        mbar_expect_tx(&bars[g], ((RG * g < nr ? RG : 0) + (g == 0 ? nq : 0)) * ROWB);
    LAT_STAMP(2);
    __syncthreads();
    LAT_STAMP(3);
    // a copy a pair of rows that lie back to back in memory (the query rows,
    // a contiguous cache, a page whose rows are contiguous), else a copy a
    // row; the query rows on group 0's mbarrier, rows 16 g .. 16 g + 15 on
    // group g's. Pair e goes to lane e / NWARP of warp e % NWARP: a copy
    // instruction issues its lanes' copies one after another, so the pairs
    // are spread over the warps.
    {
      const int nqp = (nq + 1) / 2, e = lane * NWARP + warp;
      if (e < nqp) {
        bulk_load(base + Q_S + e * PAIR, qb + (long long)2 * e * DK,
                  (2 * e + 1 < nq ? 2 : 1) * ROWB, &bars[0]);
      } else if (e < nqp + nr / 2) {
        const int pr = e - nqp;
        const long long r0 = roff[2 * pr], r1 = roff[2 * pr + 1];
        uint64_t* bar = &bars[2 * pr / RG];
        if (r1 == r0 + DK) {
          bulk_load(base + L_S + pr * PAIR, lat + r0, 2 * ROWB, bar);
        } else {
          bulk_load(base + L_S + pr * PAIR, lat + r0, ROWB, bar);
          bulk_load(base + L_S + pr * PAIR + ROWB, lat + r1, ROWB, bar);
        }
      }
    }
    LAT_STAMP(4);
#ifdef LAT_STAGE_ONLY
    wait_all(bars, phase);
    __syncthreads();
    phase ^= 1;
    continue;
#endif
    // S = q L^T for the warp's 16 positions over the DK / 16 k16 steps, in
    // three sums (steps k mod 3) for six independent chains, added in order
    mbar_wait(&bars[0], phase);
    if (warp) mbar_wait(&bars[warp], phase);
    LAT_STAMP(5);
    float4* xs = reinterpret_cast<float4*>(smem + X_S);  // S, [NT][32 lanes]
    if (RG * warp < n) {
      float sa[3][2][4];
#pragma unroll
      for (int u = 0; u < 3; ++u)
#pragma unroll
        for (int i = 0; i < 2; ++i) sa[u][i][0] = sa[u][i][1] = sa[u][i][2] = sa[u][i][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DK / 16; ++kk) {
        uint32_t qa[4], kf[4];
        ldsm(qa, base + Q_S + row_at(lane % 16) + (2 * kk + lane / 16) * 16);
        ldsm(kf, base + L_S + row_at(RG * warp + (lane / 16) * 8 + lane % 8) +
                     (2 * kk + (lane / 8) % 2) * 16);
        mma(sa[kk % 3][0], qa, kf[0], kf[1]);
        mma(sa[kk % 3][1], qa, kf[2], kf[3]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = (sa[0][i][e] + sa[1][i][e]) + sa[2][i][e];
        xs[(2 * warp + i) * 32 + lane] = make_float4(v[0], v[1], v[2], v[3]);
      }
    }
    __syncthreads();
    LAT_STAMP(6);
    // every warp: the whole S, scaled to the log2 domain, masked past the
    // length (the tiles of warps past it were not written); the rows'
    // running max
    float sc[NT][4];
    float cm0 = NEG_INF, cm1 = NEG_INF;
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      const float4 x = xs[i * 32 + lane];
      const int jc = 8 * i + cq;
      const bool ok0 = jc < n, ok1 = jc + 1 < n;
      sc[i][0] = ok0 ? x.x * scale : NEG_INF;
      sc[i][1] = ok1 ? x.y * scale : NEG_INF;
      sc[i][2] = ok0 ? x.z * scale : NEG_INF;
      sc[i][3] = ok1 ? x.w * scale : NEG_INF;
      cm0 = fmaxf(cm0, fmaxf(sc[i][0], sc[i][1]));
      cm1 = fmaxf(cm1, fmaxf(sc[i][2], sc[i][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off *= 2) {
      cm0 = fmaxf(cm0, __shfl_xor_sync(0xffffffffu, cm0, off));
      cm1 = fmaxf(cm1, __shfl_xor_sync(0xffffffffu, cm1, off));
    }
    const float mn0 = fmaxf(m0, cm0), mn1 = fmaxf(m1, cm1);
    const float a0 = ex2(m0 - mn0), a1 = ex2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    l0 *= a0;
    l1 *= a1;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      acc[i][0] *= a0;
      acc[i][1] *= a0;
      acc[i][2] *= a1;
      acc[i][3] *= a1;
    }
    // P = exp2(s - m) as the A fragments of the four k16 steps of P L (the
    // C fragments of S tiles 2 kk and 2 kk + 1), high and low parts
    uint32_t ph[4][4], pl[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float p[8] = {sc[2 * kk][0],     sc[2 * kk][1],     sc[2 * kk][2],     sc[2 * kk][3],
                    sc[2 * kk + 1][0], sc[2 * kk + 1][1], sc[2 * kk + 1][2], sc[2 * kk + 1][3]};
#pragma unroll
      for (int e = 0; e < 8; ++e) p[e] = ex2(p[e] - ((e & 2) ? m1 : m0));
      l0 += (p[0] + p[1]) + (p[4] + p[5]);
      l1 += (p[2] + p[3]) + (p[6] + p[7]);
#pragma unroll
      for (int i = 0; i < 4; ++i) split_hi_lo(p[2 * i], p[2 * i + 1], ph[kk][i], pl[kk][i]);
    }
#ifndef LAT_NO_PL
    // P L[:, 64 w .. 64 w + 63], the rows through ldmatrix.trans; every group
    // is waited for (its columns are read), k16 steps past the chunk's
    // positions skipped
    wait_all(bars, phase);
    const int nk = (n + 15) / 16;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (kk < nk) {
#pragma unroll
        for (int t2 = 0; t2 < 4; ++t2) {  // n8 tiles 2 t2 and 2 t2 + 1
          uint32_t vb[4];
          ldsm_t(vb, base + L_S + row_at(16 * kk + lane % 16) +
                         (8 * warp + 2 * t2 + lane / 16) * 16);
          mma(acc[2 * t2], ph[kk], vb[0], vb[1]);
          mma(acc[2 * t2], pl[kk], vb[0], vb[1]);
          mma(acc[2 * t2 + 1], ph[kk], vb[2], vb[3]);
          mma(acc[2 * t2 + 1], pl[kk], vb[2], vb[3]);
        }
      }
    }
#endif
    __syncthreads();  // the chunk's rows and S read before the next chunk lands
    LAT_STAMP(7);
    phase ^= 1;
  }
#pragma unroll
  for (int off = 1; off < 4; off *= 2) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
#if defined(LAT_STAGE_ONLY)
#elif defined(LAT_NO_PL) || defined(LAT_NO_WRITE)
  {  // keep what was computed alive, write nothing
    float z = m0 + m1 + l0 + l1;
#pragma unroll
    for (int i = 0; i < 8; ++i) z += acc[i][0] + acc[i][1] + acc[i][2] + acc[i][3];
    if (z == 1234.5f) part_l[0] = z;
  }
#else
  const int g0 = r, g1 = r + 8;  // the lane's two heads of the tile
  if (ns == 1) {
    const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int col = 64 * warp + 8 * i + cq;
      if (h0 + g0 < H)
        *reinterpret_cast<__nv_bfloat162*>(o + (long long)g0 * DV + col) =
            __floats2bfloat162_rn(acc[i][0] * inv0, acc[i][1] * inv0);
      if (h0 + g1 < H)
        *reinterpret_cast<__nv_bfloat162*>(o + (long long)g1 * DV + col) =
            __floats2bfloat162_rn(acc[i][2] * inv1, acc[i][3] * inv1);
    }
  } else {
    // the real heads' rows, 16 bytes a store: lane pairs swap halves, the
    // even lane storing four columns of head g0, the odd one of head g1
    const long long slot = (long long)(b * n_t + t) * n_slot + s;
    float* po = part_o + slot * HT * DV;
    const bool ev = (lane & 1) == 0;
    const int gs = ev ? g0 : g1;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float r0 = __shfl_xor_sync(0xffffffffu, ev ? acc[i][2] : acc[i][0], 1);
      const float r1 = __shfl_xor_sync(0xffffffffu, ev ? acc[i][3] : acc[i][1], 1);
      const int col = 64 * warp + 8 * i + cq - (ev ? 0 : 2);
      if (h0 + gs < H)
        *reinterpret_cast<float4*>(po + gs * DV + col) =
            ev ? make_float4(acc[i][0], acc[i][1], r0, r1)
               : make_float4(r0, r1, acc[i][2], acc[i][3]);
    }
    if (warp == 0 && cq == 0) {
      if (h0 + g0 < H) {
        part_m[slot * HT + g0] = m0;
        part_l[slot * HT + g0] = l0;
      }
      if (h0 + g1 < H) {
        part_m[slot * HT + g1] = m1;
        part_l[slot * HT + g1] = l1;
      }
    }
  }
#endif
  if (ns == 1) return;
  // the partial written (every thread's stores before the barrier, ordered
  // by the ticket's release), count it
  __syncthreads();
  LAT_STAMP(8);
  if (tid == 0) ticket(&counters[b * n_t + t]);
  LAT_STAMP(9);
}

// The combine of item (b, s, t): once every span of the (row, head tile) has
// counted its partial, this block's slice of the tile's outputs, summed
// over the partials in span order; then the second ticket (the last block
// out sets the counter back to zero).
__device__ __forceinline__ void combine_slice(bf16* __restrict__ out,
                                              const float* __restrict__ part_o,
                                              const float* __restrict__ part_m,
                                              const float* __restrict__ part_l,
                                              int* __restrict__ counters, int H, int n_t,
                                              int n_slot, int b, int s, int t, int ns,
                                              uint8_t* smem, bool first) {
  using namespace lt;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  int* cnt = counters + b * n_t + t;
#ifndef LAT_NOCOMBINE
  if (tid == 0)
    while (load_acquire(cnt) < ns) __nanosleep(32);
  __syncthreads();
  LAT_STAMP(10);
  constexpr int PH = DV / 4;  // float4 pieces a head
  const int h0 = t * HT, nh = min(HT, H - h0);
  const int pc0 = s * nh * PH / ns, pc1 = (s + 1) * nh * PH / ns;
  const int ha = pc0 / PH, hb = (pc1 - 1) / PH;  // the slice's heads
  const long long slot0 = (long long)(b * n_t + t) * n_slot;
  const float4* po = reinterpret_cast<const float4*>(part_o) + slot0 * (HT * PH);
  // the thread's first piece: its first PRE partials' loads in flight
  // beside the weights' (one round trip to L2 for both)
  constexpr int PRE = 24;
  float4 y[PRE];
  const int pc_first = pc0 + tid;
  if (pc_first < pc1) {
#pragma unroll
    for (int p = 0; p < PRE; ++p)
      if (p < ns) y[p] = __ldcg(po + (long long)p * (HT * PH) + pc_first);
  }
  float* wts = reinterpret_cast<float*>(smem + X_S);  // [HT][NSMAX]
  for (int hl = ha + warp; hl <= hb; hl += NWARP) {
    const bool in = lane < ns;
    const float m = in ? __ldcg(part_m + (slot0 + lane) * HT + hl) : NEG_INF;
    const float l = in ? __ldcg(part_l + (slot0 + lane) * HT + hl) : 0.f;
    float mx = m;
#pragma unroll
    for (int off = 16; off > 0; off /= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float w = in ? ex2(m - mx) : 0.f;
    float den = w * l;
#pragma unroll
    for (int off = 16; off > 0; off /= 2) den += __shfl_xor_sync(0xffffffffu, den, off);
    wts[hl * NSMAX + lane] = w / fmaxf(den, 1e-30f);
  }
  __syncthreads();
  bf16* o = out + ((long long)b * H + h0) * DV;
  for (int pc = pc_first; pc < pc1; pc += THREADS) {
    const float* wh = wts + (pc / PH) * NSMAX;
    if (pc != pc_first) {
#pragma unroll
      for (int p = 0; p < PRE; ++p)
        if (p < ns) y[p] = __ldcg(po + (long long)p * (HT * PH) + pc);
    }
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int p = 0; p < PRE; ++p) {
      if (p < ns) {
        const float c = wh[p];
        a.x += c * y[p].x;
        a.y += c * y[p].y;
        a.z += c * y[p].z;
        a.w += c * y[p].w;
      }
    }
#pragma unroll 8
    for (int p = PRE; p < ns; ++p) {
      const float c = wh[p];
      const float4 v = __ldcg(po + (long long)p * (HT * PH) + pc);
      a.x += c * v.x;
      a.y += c * v.y;
      a.z += c * v.z;
      a.w += c * v.w;
    }
    const __nv_bfloat162 lo = __floats2bfloat162_rn(a.x, a.y), hi = __floats2bfloat162_rn(a.z, a.w);
    uint2 v;
    v.x = *reinterpret_cast<const uint32_t*>(&lo);
    v.y = *reinterpret_cast<const uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(o + (long long)pc * 4) = v;
  }
  __syncthreads();
  LAT_STAMP(11);
#endif
  if (tid == 0 && ticket(cnt) == 2 * ns - 1) *cnt = 0;
}

// Grid: at most one wave (latent_wave), each block walking the launch's
// n_items items, item i = ((b n_slot) + s) n_t + t; n_slot the partial slots
// a (row, head tile) has. lt::THREADS threads, lt::BYTES of dynamic shared
// memory. Partials: part_o [B, n_t, n_slot, HT, DV], part_m and part_l
// [B, n_t, n_slot, HT]; counters [B n_t], zero (left zero). scale: the
// scores' scale times log2(e).
template <typename KV>
__global__ void __launch_bounds__(lt::THREADS, lt::RESIDENT) latent_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ lat, bf16* __restrict__ out,
    float* __restrict__ part_o, float* __restrict__ part_m, float* __restrict__ part_l,
    int* __restrict__ counters, KV kv, int H, int n_slot, int n_items, float scale) {
  using namespace lt;
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ __align__(8) uint64_t bars[NWARP];
  __shared__ long long roff[CHUNK];
#ifdef LAT_EMPTY
  return;
#endif
#ifdef LAT_CLOCK
  const long long g0 = gtime();
  {
    const bool first = true;
    LAT_STAMP(0);
  }
#endif
  const int n_t = (H + HT - 1) / HT;
  if (threadIdx.x == 0)
    for (int g = 0; g < NWARP; ++g) mbar_init(&bars[g], 1);
  __syncthreads();
#ifdef LAT_CLOCK
  {
    const bool first = true;
    LAT_STAMP(1);
  }
#endif
  uint32_t phase = 0;  // the parity of the groups' next phase
  for (int i = blockIdx.x; i < n_items; i += gridDim.x) {
    const int b = i / (n_slot * n_t), s = i / n_t % n_slot, t = i % n_t;
    const int L = kv.length(b), ns = n_spans(L);
    if (s < ns)
      run_item(q, lat, out, part_o, part_m, part_l, counters, kv, H, n_t, n_slot, b, s, t, L,
               ns, scale, phase, smem, bars, roff, i == blockIdx.x);
    __syncthreads();  // shared memory free for the next item
  }
  for (int i = blockIdx.x; i < n_items; i += gridDim.x) {
    const int b = i / (n_slot * n_t), s = i / n_t % n_slot, t = i % n_t;
    const int ns = n_spans(kv.length(b));
    if (s < ns && ns > 1)
      combine_slice(out, part_o, part_m, part_l, counters, H, n_t, n_slot, b, s, t, ns, smem,
                    i == blockIdx.x);
  }
#ifdef LAT_CLOCK
  if (threadIdx.x == 0 && blockIdx.x < 4096) {
    unsigned sm;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    lat_clock[blockIdx.x][NSTAMP - 3] = g0;
    lat_clock[blockIdx.x][NSTAMP - 2] = gtime();
    lat_clock[blockIdx.x][NSTAMP - 1] = sm;
  }
#endif
}

// The last block of row b combines the row's n_live partials (stride n_p)
// in block order into out[b] (H x DV); m_s and den_s are HMAX floats of
// shared memory each.
template <typename T>
__device__ __forceinline__ void combine(T* __restrict__ out, const float* __restrict__ part_o,
                                        const float* __restrict__ part_m,
                                        const float* __restrict__ part_l, int b, int H, int n_p,
                                        int n_live, float* m_s, float* den_s) {
  const long long pm = (long long)b * n_p * H;  // the row's first (m, l)
  for (int g = threadIdx.x; g < H; g += blockDim.x) {
    float mx = NEG_INF, den = 0.f;
    for (int p = 0; p < n_live; ++p) mx = fmaxf(mx, __ldcg(part_m + pm + (long long)p * H + g));
    for (int p = 0; p < n_live; ++p)
      den += ex2(__ldcg(part_m + pm + (long long)p * H + g) - mx) *
             __ldcg(part_l + pm + (long long)p * H + g);
    m_s[g] = mx;
    den_s[g] = den;
  }
  __syncthreads();
  const float4* po = reinterpret_cast<const float4*>(part_o + pm * DV);
  const int n_pc = H * DV / 4;  // float4 pieces of the row's output
  T* o = out + (long long)b * H * DV;
  for (int pc = threadIdx.x; pc < n_pc; pc += blockDim.x) {
    const int g = pc * 4 / DV;
    const float mx = m_s[g];
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int p = 0; p < n_live; ++p) {
      const float w = ex2(__ldcg(part_m + pm + (long long)p * H + g) - mx);
      const float4 y = __ldcg(po + (long long)p * n_pc + pc);
      s.x += w * y.x;
      s.y += w * y.y;
      s.z += w * y.z;
      s.w += w * y.w;
    }
    const float den = fmaxf(den_s[g], 1e-30f);
    o[pc * 4 + 0] = from_f<T>(s.x / den);
    o[pc * 4 + 1] = from_f<T>(s.y / den);
    o[pc * 4 + 2] = from_f<T>(s.z / den);
    o[pc * 4 + 3] = from_f<T>(s.w / den);
  }
}

// float32: grid (n_p, B), block blk positions [blk CHUNK, + CHUNK) of row b;
// a block at or past the row's length returns at once. lf::THREADS threads,
// lf::BYTES of dynamic shared memory. Partials [B, n_p, H, DV] and
// [B, n_p, H]; counters [B].
template <typename KV>
__global__ void __launch_bounds__(lf::THREADS) latent_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ lat, float* __restrict__ out,
    float* __restrict__ part_o, float* __restrict__ part_m, float* __restrict__ part_l,
    int* __restrict__ counters, KV kv, int H, float scale) {
  using namespace lf;
  extern __shared__ __align__(16) float fs[];
  __shared__ int last;
  __shared__ float m_s[HMAX], den_s[HMAX];
  float* l_s = fs;          // [CHUNK][ROWF]
  float* q_s = fs + Q_S;    // [H][DK], scaled
  const int blk = blockIdx.x, b = blockIdx.y, n_p = gridDim.x;
  const int L = kv.length(b);
  const int n_live = L < 1 ? 1 : n_chunks(L);
  if (blk >= n_live) return;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  float* o = out + (long long)b * H * DV;
  if (L < 1) {  // a row of no position: zeros
    for (int e = tid; e < H * DV; e += THREADS) o[e] = 0.f;
    return;
  }
  const int start = blk * CHUNK;
  const int j1 = min(start + CHUNK, L);
  const long long pm = ((long long)b * n_p + blk) * H;

  for (int i = tid; i < CHUNK * DK; i += THREADS) {
    const int r = i / DK, d = i % DK;
    l_s[r * ROWF + d] = start + r < j1 ? __ldg(lat + kv.row(b, start + r, 0) + d) : 0.f;
  }
  const float* qb = q + (long long)b * H * DK;
  for (int i = tid; i < H * DK; i += THREADS) q_s[i] = __ldg(qb + i) * scale;
  __syncthreads();
  const bool ok0 = start + lane < j1, ok1 = start + lane + 32 < j1;
  for (int g = warp; g < H; g += NWARP) {
    float s0 = 0.f, s1 = 0.f;
    const float* qg = q_s + g * DK;
#pragma unroll 8
    for (int d = 0; d < DK; ++d) {
      const float qv = qg[d];
      s0 = fmaf(qv, l_s[lane * ROWF + d], s0);
      s1 = fmaf(qv, l_s[(lane + 32) * ROWF + d], s1);
    }
    s0 = ok0 ? s0 : NEG_INF;
    s1 = ok1 ? s1 : NEG_INF;
    float mx = fmaxf(s0, s1);
#pragma unroll
    for (int off = 16; off > 0; off /= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float p0 = ok0 ? ex2(s0 - mx) : 0.f, p1 = ok1 ? ex2(s1 - mx) : 0.f;
    float l = p0 + p1;
#pragma unroll
    for (int off = 16; off > 0; off /= 2) l += __shfl_xor_sync(0xffffffffu, l, off);
    float acc[DV / 32];
#pragma unroll
    for (int k = 0; k < DV / 32; ++k) acc[k] = 0.f;
#pragma unroll 4
    for (int j = 0; j < 32; ++j) {
      const float pj = __shfl_sync(0xffffffffu, p0, j);
#pragma unroll
      for (int k = 0; k < DV / 32; ++k) acc[k] = fmaf(pj, l_s[j * ROWF + lane + 32 * k], acc[k]);
    }
#pragma unroll 4
    for (int j = 0; j < 32; ++j) {
      const float pj = __shfl_sync(0xffffffffu, p1, j);
#pragma unroll
      for (int k = 0; k < DV / 32; ++k)
        acc[k] = fmaf(pj, l_s[(j + 32) * ROWF + lane + 32 * k], acc[k]);
    }
    if (n_live == 1) {
      const float den = fmaxf(l, 1e-30f);
#pragma unroll
      for (int k = 0; k < DV / 32; ++k) o[(long long)g * DV + lane + 32 * k] = acc[k] / den;
    } else {
#pragma unroll
      for (int k = 0; k < DV / 32; ++k) part_o[(pm + g) * DV + lane + 32 * k] = acc[k];
      if (lane == 0) {
        part_m[pm + g] = mx;
        part_l[pm + g] = l;
      }
    }
  }
  if (n_live == 1) return;
  __syncthreads();
  if (tid == 0) last = ticket(&counters[b]) == n_live - 1;
  __syncthreads();
  if (!last) return;
  combine<float>(out, part_o, part_m, part_l, b, H, n_p, n_live, m_s, den_s);
  if (tid == 0) counters[b] = 0;
}

}  // namespace latent

namespace {
// Per device: whether a kernel may take its dynamic shared memory (above 48
// KB it must be allowed once), and the bf16 kernel's wave (blocks the card
// holds at once; 0: not read yet). In an unnamed namespace: a static of a
// template of the named one would be one object across every loaded build
// of this source (GNU unique symbols).
template <typename KV>
int* mma_wave_of() {
  static int wave[64];
  return wave;
}
template <typename KV>
bool* f32_ready() {
  static bool ready[64];
  return ready;
}

// The bf16 kernel's wave on the current device: its resident blocks an SM
// times the SMs. Returns a cudaError_t.
template <typename KV>
int mma_wave(int* blocks) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  int* cached = mma_wave_of<KV>();
  if (dev < 64 && cached[dev]) {
    *blocks = cached[dev];
    return 0;
  }
  auto kernel = latent::latent_mma_kernel<KV>;
  int per_sm = 0, sms = 0;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             latent::lt::BYTES);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, latent::lt::THREADS,
                                                        latent::lt::BYTES);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  if (per_sm * sms < 1) return (int)cudaErrorInvalidConfiguration;
  *blocks = per_sm * sms;
  if (dev < 64) cached[dev] = *blocks;
  return 0;
}

// dtype 0 = float32, 1 = bfloat16. `positions`: the cache positions the
// launch covers, `exact`: whether they are every row's length (the
// contiguous form) or a capacity (the paged one). Scratch as
// kernels/latent_decode_attention.py scratch() sizes it: bf16 part_o
// [B, n_t, n_slot, HT, DV], part_ml [2, B, n_t, n_slot, HT], counters
// [B n_t]; float32 part_o [B, n_p, H, DV], part_ml [2, B, n_p, H], counters
// [B]; all float32 but the int32 counters, which are zero (left zero).
template <typename KV>
int launch_latent(int dtype, const void* q, const void* lat, void* o, void* part_o,
                  void* part_ml, void* counters, const KV& kv, int B, int H,
                  long long positions, bool exact, int dk, int dv, float scale, void* stream) {
  using namespace latent;
  if (B < 1 || H < 1 || H > HMAX || positions < 1 || dk != DK || dv != DV)
    return (int)cudaErrorInvalidValue;
  float* pm = static_cast<float*>(part_ml);
  float* po = static_cast<float*>(part_o);
  int* cnt = static_cast<int*>(counters);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float s2 = scale * 1.4426950408889634f;  // the log2 domain
  if (dtype == 1) {
    const int n_t = (H + HT - 1) / HT;
    const int n_slot = exact ? n_spans((int)positions) : span_slots(positions);
    const long long n_items = (long long)B * n_t * n_slot;
    int wave = 0;
    if (int rc = mma_wave<KV>(&wave)) return rc;
    const int grid = (int)(n_items < wave ? n_items : wave);
    latent_mma_kernel<KV><<<grid, lt::THREADS, lt::BYTES, st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(lat), static_cast<bf16*>(o), po,
        pm, pm + n_items * HT, cnt, kv, H, n_slot, (int)n_items, s2);
  } else if (dtype == 0) {
    const int n_p = n_chunks(positions);
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    bool* ready = f32_ready<KV>();
    if (dev >= 64 || !ready[dev]) {
      err = cudaFuncSetAttribute(latent_f32_kernel<KV>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, lf::BYTES);
      if (err != cudaSuccess) return (int)err;
      if (dev < 64) ready[dev] = true;
    }
    latent_f32_kernel<KV><<<dim3(n_p, B), lf::THREADS, lf::BYTES, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(lat), static_cast<float*>(o), po,
        pm, pm + (long long)B * n_p * H, cnt, kv, H, s2);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
}  // namespace

// The latent cache [B,S,DK] contiguous, one length for every row (1 <=
// length <= S): the launch covers the length's positions alone. Returns a
// cudaError_t.
extern "C" int repro_latent_decode_attention(const void* q, const void* lat, void* o,
                                             void* part_o, void* part_ml, void* counters, int B,
                                             int H, int S, int length, int dk, int dv,
                                             float scale, int dtype, void* stream) {
  if (S < 1 || length < 1 || length > S) return (int)cudaErrorInvalidValue;
  const decode_split::ContigKV kv{S, 1, latent::DK, length};
  return launch_latent(dtype, q, lat, o, part_o, part_ml, counters, kv, B, H, length, true, dk,
                       dv, scale, stream);
}

// The latent pages [n_pool_pages, page_size, DK] by their element strides
// (a layer's strided view of the fleet's stacked store; rows contiguous), a
// [B, n_tab] int32 page table and [B] int32 lengths (clamped to the table's
// n_tab page_size positions, which the launch covers). Returns a
// cudaError_t.
extern "C" int repro_paged_latent_decode_attention(
    const void* q, const void* lat, void* o, void* part_o, void* part_ml, void* counters,
    const void* page_table, const void* lengths, int B, int H, int n_tab, int page_size,
    long long page_stride, long long row_stride, int dk, int dv, float scale, int dtype,
    void* stream) {
  if (n_tab < 1 || page_size < 1) return (int)cudaErrorInvalidValue;
  const decode_split::PagedKV kv{static_cast<const int*>(page_table),
                                 static_cast<const int*>(lengths),
                                 n_tab,
                                 page_size,
                                 page_stride,
                                 row_stride,
                                 0};
  return launch_latent(dtype, q, lat, o, part_o, part_ml, counters, kv, B, H,
                       (long long)n_tab * page_size, false, dk, dv, scale, stream);
}

#ifdef LAT_CLOCK
// The timeline of the last launch (lat_clock) into host memory `dst`, n
// blocks' rows of NSTAMP int64, and cleared. Returns a cudaError_t.
extern "C" int repro_latent_clock(void* dst, int n) {
  const size_t bytes = (size_t)n * latent::NSTAMP * sizeof(long long);
  cudaError_t err = cudaMemcpyFromSymbol(dst, latent::lat_clock, bytes);
  if (err == cudaSuccess) {
    void* p = nullptr;
    err = cudaGetSymbolAddress(&p, latent::lat_clock);
    if (err == cudaSuccess) err = cudaMemset(p, 0, sizeof(latent::lat_clock));
  }
  return (int)err;
}
#endif

// The bf16 kernel's wave on the current device (contiguous: paged = 0,
// paged: 1): blocks the card holds at once, the most a launch's grid takes;
// a negative cudaError_t on failure.
extern "C" int repro_latent_wave(int paged) {
  int blocks = 0;
  const int rc = paged ? mma_wave<decode_split::PagedKV>(&blocks)
                       : mma_wave<decode_split::ContigKV>(&blocks);
  return rc ? -rc : blocks;
}
