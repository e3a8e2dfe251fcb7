// Split-KV flash-decoding shared by the contiguous-cache decode
// (decode_attention.cu, kernel 2, also over a ring-buffer window cache) and
// the paged-pool decode (paged_decode_attention.cu, kernel 3). Included by
// both; not compiled on its own.
//
// Replaces the split/page loops of src/repro/kernels/decode_attention.py
// (_kernel and _paged_kernel), which carry (m, l, acc) across a sequential
// split (or page) axis of one TPU core.
//
// Computes, for each row b and query head h, softmax(q k^T / sqrt(D)) v over
// cache positions [max(length_b - window, 0), length_b), with query head h
// reading KV head h / (H / K). q: [B,H,D]; out: [B,H,D]. Where the K/V row of
// (row b, position j, KV head kh) lies is the one thing the callers differ
// in: an addressing functor (ContigKV, RingKV, PagedKV) gives its element
// offset and each row's length. Scores, softmax and sums are float32; the
// output is cast to the input type.
//
// Bound: each cache position's K and V rows (2*D elements) serve the G = H/K
// query heads of their KV head at 4*D FLOP per head, so the work is G FLOP
// per cache byte in bf16, far fewer operations per byte than the card's
// compute rate over its memory rate: device-memory bytes bound it, the
// 2*length*K*D cache elements below each row's length. At decode sizes
// those bytes are few, so what a kernel has to avoid is waiting: on one
// round trip to device memory per block with nothing else in flight, on
// __syncthreads between phases, and on a second launch.
// Design against that bound:
//  * One launch. The splits are parallel blocks: one block per (row, KV
//    head, split of split_len<D>() logical positions: 128 at D <= 64, 64 at
//    D = 128, whatever B, the length or the addressing; on the tensor-core
//    kernel a block takes 128 positions, two splits at D = 128). Each block
//    writes an unnormalised partial (m, l, o) for the KV head's G query
//    heads, then takes a ticket from a per-(row, KV head) counter (after
//    __syncthreads, one atomicAdd with release and acquire semantics, which
//    also does a __threadfence's work); the block that draws the last
//    ticket combines the partials in index order, as a separate
//    combine kernel did, and sets the counter back to 0. The atomic only
//    elects the block: every sum runs in a fixed order, so the result is
//    deterministic and the same whichever block combines. The combine's
//    loads are batched (up to 16 splits' (m, l, o) per batch, the largest
//    m taken from the registers when one batch holds every split), so the
//    tail after the last ticket is one or two round trips to L2. With a
//    single partial the block writes the output.
//  * Streaming (float32 at every D, bf16 at D = 32 for G > 1: decode_kernel,
//    4 warps). Each warp takes split_len<D>() / 4 positions; D * sizeof(T) / 16 lanes read
//    one K or V row (8 lanes for a bf16 row of 64), 16 bytes each, so a
//    warp's load covers one or more whole rows. Every K and V load of a
//    thread is issued before any is used (up to batch<D>() of each at once), and
//    nothing waits on another warp before the merge, so one warp's math
//    overlaps the other warps' (and blocks') loads. 128-position splits
//    rather than 64 halve the partials the combine reads, while each warp
//    keeps twice the loads in flight, so the card holds as many bytes in
//    flight. At D = 128 a float32 row takes the whole warp, 16 loads of K
//    and of V a lane, in two batches of 8, the second's (m, l, P V) merged
//    into the first's in shared memory, so the loads stay in registers.
//  * Per query head of the KV head, a warp computes its positions' scores
//    (a lane's slice of q from shared memory against its slice of the K
//    row, summed over the row's lanes by shuffles), its online-softmax
//    (m, l) by shuffles across the row groups, and its P V sum in
//    registers; the 4 warps' partials are merged through shared memory in
//    warp order. Scores are in the log2 domain (q scaled by
//    log2(e) / sqrt(D)) and exponentiated with ex2.approx.
//  * bf16 at G > 1 and at D = 128 (decode_mma_kernel<D>, 4 warps,
//    redesigned for Hopper; the route is mma_route, a rule on (D, G)): the
//    G <= 16 query heads of the KV head go through the tensor cores
//    together, so every K/V row is read from shared memory once for all of
//    them and no shuffle reduces a dot product, and no register holds a
//    load (at D = 64 decode_kernel's lanes held 16 loads each and reduced
//    each head's dot products by shuffles, one head after another). A
//    block takes 128 positions (one split at D = 64, two at 128). It stages
//    q (G rows, zeros to 16) and its K rows as one cp.async group and its V
//    rows as a second (16 bytes a copy, 16-byte padded rows so that an
//    ldmatrix's 8 rows lie in distinct banks; zeros outside the window), so
//    every byte of the block is in flight at once and the scores run while
//    V lands; each thread computes its rows' addresses first (a paged pool:
//    its table reads, issued together), so no load waits on a table read
//    after that. Each warp takes 32 of the positions: S = q K^T by mma.sync
//    m16n8k16 (q the A operand, zero-padded to 16 rows; the K rows as they
//    lie, [pos][D], the B operand through ldmatrix), scaled to the log2
//    domain and masked in registers; the rows' max over its positions (a
//    quad of shuffles); P = ex2(s - m) as the A fragments of P V, straight
//    from S's C fragments (as FlashAttention-2 does on Ampere), split into
//    a bf16 high and low part so that P V keeps about 16 bits of P; P V
//    for all D columns, V through ldmatrix.trans. No score goes through
//    shared memory and each exponential is taken once. The 4 warps' (m, l,
//    P V) then meet in shared memory where the K rows were and merge in
//    warp order. Two splits a block at D = 128 leave 9 partials at 1056
//    positions rather than 17, so the combine stages them all in one round
//    at every G <= 8 (llava-next-34b's G = 7 took two rounds of 12 and 5)
//    and reads half the bytes; 288 blocks at B = 4 run in one wave at three
//    an SM. The combine copies the partial outputs into the block's shared
//    memory by cp.async while one warp a head takes the head's largest m,
//    weighted l and each partial's weight: one round trip to L2 for the
//    whole tail, no registers held by the copies. Clusters of blocks that
//    merge their partials through distributed shared memory before the
//    global combine were slower at every size on an H100 (PERF.md).
//  * bf16 at G = 1, D <= 64 (decode_g1_kernel, 4 warps, redesigned for
//    Hopper; minicpm-2b's MHA): each K/V row serves one query head, so
//    nothing is reused and the kernel is pure streaming; what costs is
//    every wait that leaves no bytes in flight. The work items are the
//    (row, KV head, split)s; the grid is one wave (as many blocks as the
//    card holds, the items spread evenly over them), and a block walks its
//    items x, x + grid, ..., staging each in shared memory by cp.async (16
//    bytes a copy, no registers held; zeros outside [lo, length)) as soon
//    as its warps have read the last. One item a block in shared memory
//    (33 KB) lets six blocks share an SM, whose copies keep its bytes in
//    flight during the others' math, merge and partial writes; two
//    (DEC_G1_STAGES=2, three blocks an SM) streamed a little faster and
//    had a longer tail, 1.5-2 us more in all (tools/decode_tail.py
//    --define). Each warp scores 32 of the split's positions from shared
//    memory as decode_kernel does (8 lanes a row of 64); the warps' (m, l,
//    P V) meet by one barrier and warp 0
//    merges them in warp order. The tickets are the other wait: an atomic
//    round trip to L2 under the streaming load takes microseconds, and
//    drawn after each item it stalled the block (its warps wait on warp 0
//    at the next item's barrier). So warp 0 notes each item's row and
//    draws the block's tickets together (one a lane, all in flight at
//    once) when it has no item left, then combines the rows whose last
//    ticket it drew, in split order as decode_kernel's combine. (One
//    block a whole row, combining its own partials with no ticket at all,
//    streamed slower at minicpm's 144 rows: not kept.) The split is
//    split_len(D), as for every G, so a B = 1 lane and K3 over in-order
//    pages give a batched row's and K2's bits.
//  * A split wholly outside [lo, length) writes the empty partial
//    (m = -1e30, l = 0, o = 0) without reading the cache; the combine weighs
//    it by exp2(-1e30 - m) = 0, so it adds exactly nothing and no NaN. The
//    splits cover the same logical positions whatever the addressing, so a
//    paged pool whose pages lie in order gives the contiguous kernel's
//    result bit for bit.
//  * The counters (int32, one per (row, KV head)) belong to the caller,
//    zeroed once when allocated; every launch leaves them at zero, so a
//    CUDA graph that captured a launch replays correctly. Two launches that
//    may run at once (on two streams) must not share a counter buffer.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace decode_split {

using bf16 = __nv_bfloat16;

constexpr float NEG_INF = -1e30f;
constexpr int GMAX = 16;      // query heads per KV head a launch takes
constexpr int WARPS = 4;      // warps per decode_kernel block
constexpr int MIN_BLOCKS = 3;  // resident blocks per SM the registers allow
// Logical cache positions a split block takes: it depends on the head dim
// alone, so the contiguous, ring and paged decodes cut a row alike and a
// B = 1 lane gives a batched row's bits
__host__ __device__ constexpr int split_len(int D) { return D > 64 ? 64 : 128; }
// K (and V) loads a lane of decode_kernel keeps in flight at most: at
// D = 128 (float32 there: a row is the whole warp) eight, so that a lane's
// 16 loads do not spill
template <int D>
__host__ __device__ constexpr int batch() {
  return D > 64 ? 8 : 16;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// atomicAdd(counter, 1) with acquire-release semantics at device scope.
__device__ __forceinline__ int ticket(int* counter) {
  int old;
  asm volatile("atom.acq_rel.gpu.add.s32 %0, [%1], 1;\n" : "=r"(old) : "l"(counter) : "memory");
  return old;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16(x); }

// The dense decode cache [B, S, K, D], one length for every row.
struct ContigKV {
  int S, K, D, len;
  __device__ __forceinline__ int length(int) const { return len; }
  __device__ __forceinline__ long long row(int b, int j, int kh) const {
    return (((long long)b * S + j) * K + kh) * D;
  }
};

// A page pool [n_pool_pages, page_size, K, D] given by its element strides
// (a layer's strided view of a stacked store), a [B, n_tab] int32 page table
// and [B] int32 lengths. Only the table entries below a row's length are
// read; a length is clamped to the table's n_tab * page_size positions.
struct PagedKV {
  const int* table;
  const int* lengths;
  int n_tab, page_size;
  long long page_stride, row_stride, head_stride;
  __device__ __forceinline__ int length(int b) const {
    return min(max(lengths[b], 0), n_tab * page_size);
  }
  __device__ __forceinline__ long long row(int b, int j, int kh) const {
    const long long page = table[(long long)b * n_tab + j / page_size];
    return page * page_stride + (long long)(j % page_size) * row_stride +
           (long long)kh * head_stride;
  }
};

// A ring-buffer window cache [B, W, K, D] (contiguous): position p lies in
// slot p % W, and the decode at position pos attends to [lo, pos + 1) with
// lo = pos + 1 - n, n = min(window, W, pos + 1): the positions the ring
// still holds and the window admits. The kernel's index j reads position
// lo + j, so its splits cover exactly that range (the caller passes window
// 0 and n_splits = ceil(n / split_len(D))) and none lies wholly below it.
struct RingKV {
  int W, K, D, n, lo;
  __device__ __forceinline__ int length(int) const { return n; }
  __device__ __forceinline__ long long row(int b, int j, int kh) const {
    return (((long long)b * W + (lo + j) % W) * K + kh) * D;
  }
};

// Grid (n_splits, K, B); WARPS * 32 threads. G <= GMAX. Partials: part_o
// [B,K,n_splits,G,D]; part_m, part_l [B,K,n_splits,G] (unused with one
// split); counters [B*K], zero between launches. Dynamic shared memory:
// smem_bytes<D>(G).
template <typename T, int D, typename KV>
__global__ void __launch_bounds__(WARPS * 32, MIN_BLOCKS) decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, float* __restrict__ part_o, float* __restrict__ part_m,
    float* __restrict__ part_l, int* __restrict__ counters, KV kv, int H, int K,
    int window, float scale) {
  constexpr int SPLIT = split_len(D);
  constexpr int WARP_POS = SPLIT / WARPS;  // positions per warp
  constexpr int E = 16 / sizeof(T);        // elements per 16-byte load
  constexpr int LPR = D / E;               // lanes per K or V row
  constexpr int RPW = 32 / LPR;            // rows one warp load covers
  constexpr int NIT = WARP_POS / RPW;      // K (and V) loads per lane
  constexpr int NB = NIT > batch<D>() ? NIT / batch<D>() : 1;  // batches of them
  constexpr int NI = NIT / NB;             // loads a batch
  constexpr int THREADS = WARPS * 32;
  extern __shared__ __align__(16) float sm[];
  __shared__ int last;
  __shared__ float mg_s[GMAX];
  const int G = H / K;
  const int split = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int n_splits = gridDim.x;
  const int start = split * SPLIT;
  const int length = kv.length(b);
  const int lo = window > 0 ? max(length - window, 0) : 0;
  const int j0 = max(start, lo), j1 = min(start + SPLIT, length);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rg = lane / LPR, cl = lane % LPR;  // row group, slice of the row
  const long long pidx = ((long long)(b * K + kh) * n_splits + split) * G;
  T* o = out + ((long long)b * H + kh * G) * D;

  float* q_s = sm;                       // [G][D], scaled
  float* red_o = q_s + G * D;            // [WARPS][G][D]: each warp's P V
  float* red_m = red_o + WARPS * G * D;  // [WARPS][G]
  float* red_l = red_m + WARPS * G;      // [WARPS][G]

  // this lane's positions: start + warp * WARP_POS + it * RPW + rg, batch
  // bt holding it = bt NI .. (bt + 1) NI - 1
  const bool empty = j0 >= j1;
  uint4 kr[NI], vr[NI];
  bool live[NI];
  auto load = [&](int bt) {
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int j = start + warp * WARP_POS + (bt * NI + i) * RPW + rg;
      live[i] = j >= j0 && j < j1;
      kr[i] = vr[i] = make_uint4(0, 0, 0, 0);
      if (live[i]) {
        const long long row = kv.row(b, j, kh) + cl * E;
        kr[i] = __ldg(reinterpret_cast<const uint4*>(k + row));
        vr[i] = __ldg(reinterpret_cast<const uint4*>(v + row));
      }
    }
  };
  if (!empty) load(0);
  const T* qb = q + ((long long)b * H + kh * G) * D;
  // scores in the log2 domain: q scaled by log2(e) / sqrt(D), exp2 below
  for (int i = threadIdx.x; i < G * D; i += THREADS) q_s[i] = to_f(qb[i]) * scale;
  __syncthreads();

  if (!empty) {
#pragma unroll
    for (int bt = 0; bt < NB; ++bt) {
      if (bt > 0) load(bt);
      for (int g = 0; g < G; ++g) {
        float qv[E];
#pragma unroll
        for (int e = 0; e < E; e += 4) {
          const float4 f = *reinterpret_cast<const float4*>(q_s + g * D + cl * E + e);
          qv[e] = f.x;
          qv[e + 1] = f.y;
          qv[e + 2] = f.z;
          qv[e + 3] = f.w;
        }
        float s[NI];
        float mx = NEG_INF;
#pragma unroll
        for (int it = 0; it < NI; ++it) {
          const T* kt = reinterpret_cast<const T*>(&kr[it]);
          float dot = 0.f;
#pragma unroll
          for (int e = 0; e < E; ++e) dot += qv[e] * to_f(kt[e]);
#pragma unroll
          for (int off = LPR / 2; off > 0; off /= 2)
            dot += __shfl_xor_sync(0xffffffffu, dot, off);
          s[it] = live[it] ? dot : NEG_INF;
          mx = fmaxf(mx, s[it]);
        }
#pragma unroll
        for (int off = 16; off >= LPR; off /= 2)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        float sum = 0.f, acc[E];
#pragma unroll
        for (int e = 0; e < E; ++e) acc[e] = 0.f;
#pragma unroll
        for (int it = 0; it < NI; ++it) {
          const float p = live[it] ? ex2(s[it] - mx) : 0.f;
          const T* vt = reinterpret_cast<const T*>(&vr[it]);
          sum += p;
#pragma unroll
          for (int e = 0; e < E; ++e) acc[e] += p * to_f(vt[e]);
        }
#pragma unroll
        for (int off = 16; off >= LPR; off /= 2) {
          sum += __shfl_xor_sync(0xffffffffu, sum, off);
#pragma unroll
          for (int e = 0; e < E; ++e) acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], off);
        }
        float* ro = red_o + (warp * G + g) * D + cl * E;
        if (bt == 0) {
          if (rg == 0) {
#pragma unroll
            for (int e = 0; e < E; e += 4)
              *reinterpret_cast<float4*>(ro + e) = make_float4(acc[e], acc[e + 1], acc[e + 2], acc[e + 3]);
          }
          if (lane == 0) {
            red_m[warp * G + g] = mx;
            red_l[warp * G + g] = sum;
          }
        } else {
          // merge into the earlier batches' partial (mx and sum are the
          // same in every lane, and so are the stored m and l)
          const float mo = red_m[warp * G + g], lo_ = red_l[warp * G + g];
          const float mn = fmaxf(mo, mx);
          const float wo = ex2(mo - mn), wn = ex2(mx - mn);
          if (rg == 0) {
#pragma unroll
            for (int e = 0; e < E; ++e) ro[e] = wo * ro[e] + wn * acc[e];
          }
          __syncwarp();  // every lane has read m and l
          if (lane == 0) {
            red_m[warp * G + g] = mn;
            red_l[warp * G + g] = wo * lo_ + wn * sum;
          }
        }
      }
      __syncwarp();  // the batch's m and l are written before the next reads them
    }
  }
  __syncthreads();

  // this split's partial: the warps' sums merged in warp order
  for (int e = threadIdx.x; e < G * D; e += THREADS) {
    const int g = e / D;
    float m = NEG_INF, l = 0.f, acc = 0.f;
    if (!empty) {
#pragma unroll
      for (int w = 0; w < WARPS; ++w) m = fmaxf(m, red_m[w * G + g]);
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        const float wt = ex2(red_m[w * G + g] - m);
        l += wt * red_l[w * G + g];
        acc += wt * red_o[w * G * D + e];
      }
    }
    if (n_splits == 1) {
      o[e] = from_f<T>(acc / fmaxf(l, 1e-30f));
    } else {
      part_o[pidx * D + e] = acc;
      if (e % D == 0) {
        part_m[pidx + g] = m;
        part_l[pidx + g] = l;
      }
    }
  }
  if (n_splits == 1) return;

  // the last of the (row, KV head)'s splits to finish combines them: the
  // ticket is drawn with release (the block's partial, ordered before it by
  // the barrier, is visible device-wide first) and acquire (the last block
  // then sees every other block's partial)
  __syncthreads();
  if (threadIdx.x == 0) last = ticket(&counters[b * K + kh]) == n_splits - 1;
  __syncthreads();
  if (!last) return;
  const long long base = (long long)(b * K + kh) * n_splits * G;
  constexpr int U = 16;  // splits whose loads are in flight at once
  if (n_splits > U) {
    // each head's largest m over the splits: warp w takes heads w,
    // w + WARPS, ..., its lanes the splits
    for (int g = warp; g < G; g += WARPS) {
      float mx = NEG_INF;
      for (int sp = lane; sp < n_splits; sp += 32)
        mx = fmaxf(mx, __ldcg(part_m + base + (long long)sp * G + g));
#pragma unroll
      for (int off = 16; off > 0; off /= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      if (lane == 0) mg_s[g] = mx;
    }
    __syncthreads();
  }
  for (int e = threadIdx.x; e < G * D; e += THREADS) {
    const int g = e / D;
    const float* pm = part_m + base + g;
    const float* pl = part_l + base + g;
    const float* po = part_o + base * D + e;
    float mg = n_splits > U ? mg_s[g] : NEG_INF;
    float num = 0.f, den = 0.f;
    for (int s0 = 0; s0 < n_splits; s0 += U) {
      float mm[U], ll[U], oo[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const long long i = (long long)(s0 + u) * G;
        const bool in = s0 + u < n_splits;
        mm[u] = in ? __ldcg(pm + i) : NEG_INF;
        ll[u] = in ? __ldcg(pl + i) : 0.f;
        oo[u] = in ? __ldcg(po + i * D) : 0.f;
      }
      if (n_splits <= U) {  // one batch: the largest m from the registers
#pragma unroll
        for (int u = 0; u < U; ++u) mg = fmaxf(mg, mm[u]);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {  // in split order
        const float w = ex2(mm[u] - mg);
        den += w * ll[u];
        num += w * oo[u];
      }
    }
    o[e] = from_f<T>(num / fmaxf(den, 1e-30f));
  }
  if (threadIdx.x == 0) counters[b * K + kh] = 0;
}

// ---------------------------------------------------------------------------
// bf16 at G > 1 (D = 64) and at D = 128: a KV head's query heads on the
// tensor cores
// ---------------------------------------------------------------------------
// The bf16 route: which (D, G) run decode_mma_kernel. The rule rests on
// (D, G) alone, never on B, the length or the addressing, so that K2, K2
// over a ring and K3 take one kernel at a model's shape
// (kernels/decode_attention.kernel mirrors it).
__host__ __device__ constexpr bool mma_route(int D, int G) {
  return D == 128 || (D == 64 && G > 1);
}

namespace tc {
constexpr int NWARP = 4;  // each a quarter of the block's positions: S, P and its P V
constexpr int THREADS = NWARP * 32;
constexpr int CMAX = 32;     // partials a round of the global combine stages at most
constexpr int WMAX = 32;     // partials whose weights the global combine keeps
template <int D>
struct L {
  // positions a block takes: one split of split_len(D) at D = 64, two at
  // 128, so that a row of 1056 positions leaves 9 partials at either
  static constexpr int SPAN = 128;
  static constexpr int PER = SPAN / split_len(D);  // splits a block takes
  // blocks an SM holds: shared memory (and at D = 64 the registers, <= 128)
  // allow it, so that granite-3-2b's, granite-moe-3b-a800m's,
  // qwen2.5-14b's and llava-next-34b's 288 blocks at B = 4 (9 a row, 8
  // KV heads) run in one wave on 132 SMs
  static constexpr int RESIDENT = D > 64 ? 3 : 4;
  static constexpr int ROW = D * 2 + 16;  // bytes of a staged row: +16, so that the
                                          // 8 rows an ldmatrix reads lie in distinct banks
  static constexpr int CH = D * 2 / 16;   // 16-byte pieces of a row
  static constexpr int RPP = THREADS / CH;  // rows one pass of the block's copies covers
  static constexpr int WPOS = SPAN / NWARP;  // positions a warp takes
  static constexpr int K_S = 0;                // byte offsets: K rows, V rows, q rows
  static constexpr int V_S = K_S + SPAN * ROW;
  static constexpr int Q_S = V_S + SPAN * ROW;
  static constexpr int BYTES = Q_S + GMAX * ROW;  // 39,168 at D = 64, 73,984 at 128
  static_assert(GMAX * CH % THREADS == 0 && SPAN % RPP == 0, "the copies split evenly");
  static_assert(WPOS % 16 == 0, "a warp's S tiles pair up into k16 steps");
  static_assert(NWARP * GMAX * D * 4 <= SPAN * ROW,
                "the warps' partials fit where the K rows were");
};
}  // namespace tc

// 16 bytes from global to shared by cp.async, or zeros (no read) when !full
__device__ __forceinline__ void cp16(uint32_t dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(full ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void ldsm(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
// d += a . b for one m16n8k16 tile: a row-major 16 x 16, b 16 x 8, bf16
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// (x0, x1) = hi + lo to about 16 bits, each a bf16 pair (x0 in the low half)
__device__ __forceinline__ void split_hi_lo(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// Grid (n_blocks, K, B): each block tc::L<D>::SPAN positions (PER
// splits), n_blocks = ceil(n_splits / PER). tc::THREADS threads;
// tc::L<D>::BYTES of dynamic shared memory. Partials, one a block: part_o
// [B,K,n_blocks,G,D]; part_m, part_l [B,K,n_blocks,G], unused when
// n_blocks = 1. Other arguments as decode_kernel's.
template <int D, typename KV>
__global__ void __launch_bounds__(tc::THREADS, tc::L<D>::RESIDENT) decode_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    bf16* __restrict__ out, float* __restrict__ part_o, float* __restrict__ part_m,
    float* __restrict__ part_l, int* __restrict__ counters, KV kv, int H, int K,
    int window, float scale) {
  using namespace tc;
  using Ly = L<D>;
  constexpr int SPAN = Ly::SPAN, ROW = Ly::ROW, CH = Ly::CH, RPP = Ly::RPP;
  constexpr int WPOS = Ly::WPOS;
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int last;
  // each warp's (m, l) and weight per head; the block's l; the global
  // combine's largest m and weighted l
  __shared__ float wm_s[NWARP][GMAX], wl_s[NWARP][GMAX], ww_s[NWARP][GMAX];
  __shared__ float l_s[GMAX];
  __shared__ float mg_s[GMAX], den_s[GMAX];
  const int G = H / K, n_pc = G * D / 4;  // float4 pieces of the G x D output
  const int blk = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int n_p = gridDim.x;  // the row's partials, one a block
  const int start = blk * SPAN;
  const int length = kv.length(b);
  const int lo = window > 0 ? max(length - window, 0) : 0;
  const int j0 = max(start, lo), j1 = min(start + SPAN, length);
  const bool empty = j0 >= j1;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  bf16* o = out + ((long long)b * H + kh * G) * D;
  const long long pb = (long long)(b * K + kh) * n_p * G;  // the row's first partial
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(smem));

  if (!empty) {
    // stage q's G rows (zeros to 16) and the block's K rows as one group,
    // then its V rows: piece ch of rows r0, r0 + RPP, ... (zeros outside
    // [j0, j1)); every row's address first, then every copy
    const int ch = tid % CH, r0 = tid / CH;
    const bf16* qb = q + ((long long)b * H + kh * G) * D;
#pragma unroll
    for (int i = 0; i < GMAX / RPP; ++i) {
      const int r = r0 + i * RPP;
      cp16(base + Ly::Q_S + r * ROW + ch * 16, qb + (r < G ? r : 0) * D + ch * 8, r < G);
    }
    long long off[SPAN / RPP];
    bool in[SPAN / RPP];
#pragma unroll
    for (int i = 0; i < SPAN / RPP; ++i) {
      const int j = start + r0 + i * RPP;
      in[i] = j >= j0 && j < j1;
      off[i] = in[i] ? kv.row(b, j, kh) + ch * 8 : 0;
    }
#pragma unroll
    for (int i = 0; i < SPAN / RPP; ++i)
      cp16(base + Ly::K_S + (r0 + i * RPP) * ROW + ch * 16, k + off[i], in[i]);
    cp_commit();
#pragma unroll
    for (int i = 0; i < SPAN / RPP; ++i)
      cp16(base + Ly::V_S + (r0 + i * RPP) * ROW + ch * 16, v + off[i], in[i]);
    cp_commit();
    cp_wait<1>();
    __syncthreads();

    // S = q K^T for the warp's WPOS positions (NT n8 tiles), two k16 steps
    // a pass, kept in registers: scaled to the log2 domain and masked
    constexpr int NT = WPOS / 8;
    const int pos0 = warp * WPOS;
    float sc[NT][4];
#pragma unroll
    for (int t = 0; t < NT; ++t) sc[t][0] = sc[t][1] = sc[t][2] = sc[t][3] = 0.f;
#pragma unroll
    for (int kp = 0; kp < D / 32; ++kp) {
      uint32_t kf[NT][4], qa[4];
#pragma unroll
      for (int t = 0; t < NT; ++t)
        ldsm(kf[t], base + Ly::K_S + (pos0 + 8 * t + lane % 8) * ROW + (4 * kp + lane / 8) * 16);
      ldsm(qa, base + Ly::Q_S + (lane % 16) * ROW + (4 * kp + lane / 16) * 16);
#pragma unroll
      for (int t = 0; t < NT; ++t) mma(sc[t], qa, kf[t][0], kf[t][1]);
      ldsm(qa, base + Ly::Q_S + (lane % 16) * ROW + (4 * kp + 2 + lane / 16) * 16);
#pragma unroll
      for (int t = 0; t < NT; ++t) mma(sc[t], qa, kf[t][2], kf[t][3]);
    }
    const int r = lane / 4, cq = 2 * (lane % 4);
    float m0 = NEG_INF, m1 = NEG_INF;
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const int jc = start + pos0 + 8 * t + cq;
      const bool ok0 = jc >= j0 && jc < j1, ok1 = jc + 1 >= j0 && jc + 1 < j1;
      sc[t][0] = ok0 ? sc[t][0] * scale : NEG_INF;
      sc[t][1] = ok1 ? sc[t][1] * scale : NEG_INF;
      sc[t][2] = ok0 ? sc[t][2] * scale : NEG_INF;
      sc[t][3] = ok1 ? sc[t][3] * scale : NEG_INF;
      m0 = fmaxf(m0, fmaxf(sc[t][0], sc[t][1]));
      m1 = fmaxf(m1, fmaxf(sc[t][2], sc[t][3]));
    }
    // the rows' max over the warp's positions (a quad of shuffles); a warp
    // whose positions all lie outside [j0, j1) subtracts 0, so its P is 0
#pragma unroll
    for (int off = 1; off < 4; off *= 2) {
      m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, off));
      m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, off));
    }
    const float e0 = m0 == NEG_INF ? 0.f : m0, e1 = m1 == NEG_INF ? 0.f : m1;
    cp_wait<0>();
    __syncthreads();  // everyone's V rows are in, and every warp has read the K rows

    // P = ex2(s - m) in registers as the A fragments of the warp's k16
    // steps (the C fragments of S tiles 2 kk and 2 kk + 1, as
    // FlashAttention-2 reuses them on Ampere), split into a bf16 high and
    // low part so that P V keeps about 16 bits of P; its P V for all D
    // columns (NV n8 tiles), V through ldmatrix.trans
    constexpr int NV = D / 8;
    float l0 = 0.f, l1 = 0.f;
    float acc[NV][4];
#pragma unroll
    for (int t = 0; t < NV; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < WPOS / 16; ++kk) {
      float p[8] = {sc[2 * kk][0],     sc[2 * kk][1],     sc[2 * kk][2],     sc[2 * kk][3],
                    sc[2 * kk + 1][0], sc[2 * kk + 1][1], sc[2 * kk + 1][2], sc[2 * kk + 1][3]};
#pragma unroll
      for (int e = 0; e < 8; ++e) p[e] = ex2(p[e] - ((e & 2) ? e1 : e0));
      l0 += (p[0] + p[1]) + (p[4] + p[5]);
      l1 += (p[2] + p[3]) + (p[6] + p[7]);
      uint32_t ph[4], pl[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) split_hi_lo(p[2 * i], p[2 * i + 1], ph[i], pl[i]);
#pragma unroll
      for (int t2 = 0; t2 < NV / 2; ++t2) {  // n8 tiles 2 t2 and 2 t2 + 1
        uint32_t vb[4];
        ldsm_t(vb, base + Ly::V_S + (pos0 + 16 * kk + lane % 16) * ROW + (2 * t2 + lane / 16) * 16);
        mma(acc[2 * t2], ph, vb[0], vb[1]);
        mma(acc[2 * t2], pl, vb[0], vb[1]);
        mma(acc[2 * t2 + 1], ph, vb[2], vb[3]);
        mma(acc[2 * t2 + 1], pl, vb[2], vb[3]);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off *= 2) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    // the warps' (m, l, P V) merged in warp order through shared memory
    // where the K rows were: each head's max over the warps, each warp's
    // weight ex2(m - max) and the weighted l by one thread a head, then the
    // block's partial output a float4 piece a thread
    float* red = reinterpret_cast<float*>(smem + Ly::K_S);  // [NWARP][G][D]
#pragma unroll
    for (int t = 0; t < NV; ++t) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int g = r + 8 * h;
        if (g < G)
          *reinterpret_cast<float2*>(red + (warp * G + g) * D + 8 * t + cq) =
              make_float2(acc[t][2 * h], acc[t][2 * h + 1]);
      }
    }
    if (cq == 0) {
      if (r < G) {
        wm_s[warp][r] = m0;
        wl_s[warp][r] = l0;
      }
      if (r + 8 < G) {
        wm_s[warp][r + 8] = m1;
        wl_s[warp][r + 8] = l1;
      }
    }
    __syncthreads();
    if (tid < G) {
      float mx = NEG_INF, l = 0.f;
#pragma unroll
      for (int w = 0; w < NWARP; ++w) mx = fmaxf(mx, wm_s[w][tid]);
#pragma unroll
      for (int w = 0; w < NWARP; ++w) {
        const float wt = ex2(wm_s[w][tid] - mx);
        ww_s[w][tid] = wt;
        l += wt * wl_s[w][tid];
      }
      l_s[tid] = l;
      if (n_p > 1) {
        part_m[pb + (long long)blk * G + tid] = mx;
        part_l[pb + (long long)blk * G + tid] = l;
      }
    }
    __syncthreads();
    // the block's partial into its slot (alone, the output)
    for (int pc = tid; pc < n_pc; pc += THREADS) {
      const int g = pc * 4 / D;
      float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int w = 0; w < NWARP; ++w) {
        const float wt = ww_s[w][g];
        const float4 y = *reinterpret_cast<const float4*>(red + w * G * D + pc * 4);
        sum.x += wt * y.x;
        sum.y += wt * y.y;
        sum.z += wt * y.z;
        sum.w += wt * y.w;
      }
      if (n_p == 1) {
        const float den = fmaxf(l_s[g], 1e-30f);
        __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(o + pc * 4);
        dst[0] = __floats2bfloat162_rn(sum.x / den, sum.y / den);
        dst[1] = __floats2bfloat162_rn(sum.z / den, sum.w / den);
      } else {
        *reinterpret_cast<float4*>(part_o + (pb + (long long)blk * G) * D + pc * 4) = sum;
      }
    }
  } else {
    // the empty partial in its slot (alone, a zero output row)
    for (int e = tid; e < G * D; e += THREADS) {
      if (n_p == 1)
        o[e] = __float2bfloat16(0.f);
      else
        part_o[(pb + (long long)blk * G) * D + e] = 0.f;
    }
    if (n_p > 1 && tid < G) {
      part_m[pb + (long long)blk * G + tid] = NEG_INF;
      part_l[pb + (long long)blk * G + tid] = 0.f;
    }
  }
  if (n_p == 1) return;

  // the last of the (row, KV head)'s blocks to finish combines the
  // partials (the ticket as decode_kernel's, one a block)
  __syncthreads();
  if (tid == 0) last = ticket(&counters[b * K + kh]) == (int)gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  // The partials' outputs come into shared memory (free now) by cp.async,
  // CS a round (at 1056 positions every G <= 8 takes one round), while one
  // warp a head takes the head's largest m and weighted l over the
  // partials (lanes the partials) and, up to WMAX partials, each one's
  // weight ex2(m - max) into shared memory (past WMAX, each round loads its
  // partials' weights beside its copies); then each thread sums its float4
  // pieces of the G x D output over the round's partials in order.
  const int GD = G * D;
  const bool kept = n_p <= WMAX;  // the weights in shared memory
  const int CS = min(CMAX, (Ly::BYTES - WMAX * G * 4) / (GD * 4));  // partials a round stages
  float* st_s = reinterpret_cast<float*>(smem);                        // [CS][G][D]
  float* w_s = reinterpret_cast<float*>(smem + Ly::BYTES) - WMAX * G;  // [WMAX][G]
  auto stage = [&](int s0, int nc) {
    const float* src = part_o + (pb + (long long)s0 * G) * D;
    for (int i = tid; i < nc * n_pc; i += THREADS) cp16(base + i * 16, src + i * 4, true);
    cp_commit();
  };
  int nc = min(CS, n_p);
  stage(0, nc);
  if (kept) {
    // every head's m and l loads issued before any is used: warp w takes
    // heads w, w + NWARP, ..., a partial a lane
    constexpr int HPW = GMAX / NWARP;
    float ma[HPW], la[HPW];
    const bool i0 = lane < n_p;
#pragma unroll
    for (int j = 0; j < HPW; ++j) {
      const int g = warp + j * NWARP;
      const bool h = g < G && i0;
      ma[j] = h ? __ldcg(part_m + pb + (long long)lane * G + g) : NEG_INF;
      la[j] = h ? __ldcg(part_l + pb + (long long)lane * G + g) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < HPW; ++j) {
      const int g = warp + j * NWARP;
      if (g >= G) break;
      float mx = ma[j];
#pragma unroll
      for (int off = 16; off > 0; off /= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float wa = ex2(ma[j] - mx);
      float den = wa * la[j];
#pragma unroll
      for (int off = 16; off > 0; off /= 2) den += __shfl_xor_sync(0xffffffffu, den, off);
      if (i0) w_s[lane * G + g] = wa;
      if (lane == 0) {
        mg_s[g] = mx;
        den_s[g] = den;
      }
    }
  } else {
    for (int g = warp; g < G; g += NWARP) {
      float mx = NEG_INF, den = 0.f;
      for (int sp = lane; sp < n_p; sp += 32)
        mx = fmaxf(mx, __ldcg(part_m + pb + (long long)sp * G + g));
#pragma unroll
      for (int off = 16; off > 0; off /= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      for (int sp = lane; sp < n_p; sp += 32)
        den += ex2(__ldcg(part_m + pb + (long long)sp * G + g) - mx) *
               __ldcg(part_l + pb + (long long)sp * G + g);
#pragma unroll
      for (int off = 16; off > 0; off /= 2) den += __shfl_xor_sync(0xffffffffu, den, off);
      if (lane == 0) {
        mg_s[g] = mx;
        den_s[g] = den;
      }
    }
    __syncthreads();  // the heads' largest m, for the rounds' weights
  }
  constexpr int NP = GMAX * D / 4 / THREADS;  // pieces a thread sums at most
  float4 sum[NP];
#pragma unroll
  for (int i = 0; i < NP; ++i) sum[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  // each thread's pieces summed over n staged partials, in order, their
  // weights from w (the first partial's, head 0)
  auto add = [&](int n, const float* w) {
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      const int pc = tid + i * THREADS;
      if (pc >= n_pc) break;
      const int g = pc * 4 / D;
#pragma unroll 4
      for (int u = 0; u < n; ++u) {
        const float wu = w[u * G + g];
        const float4 y = *reinterpret_cast<const float4*>(st_s + u * GD + pc * 4);
        sum[i].x += wu * y.x;
        sum[i].y += wu * y.y;
        sum[i].z += wu * y.z;
        sum[i].w += wu * y.w;
      }
    }
  };
  for (int s0 = 0;;) {
    if (!kept)  // the round's weights, loaded beside its copies
      for (int i = tid; i < nc * G; i += THREADS)
        w_s[i] = ex2(__ldcg(part_m + pb + (long long)s0 * G + i) - mg_s[i % G]);
    cp_wait<0>();
    __syncthreads();  // the round's pieces and weights (first: the heads' m and l)
    add(nc, w_s + (kept ? s0 * G : 0));
    s0 += nc;
    if (s0 >= n_p) break;
    nc = min(CS, n_p - s0);
    __syncthreads();  // the last round's pieces and weights are read
    stage(s0, nc);
  }
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const int pc = tid + i * THREADS;
    if (pc >= n_pc) break;
    const float den = fmaxf(den_s[pc * 4 / D], 1e-30f);
    __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(o + pc * 4);
    dst[0] = __floats2bfloat162_rn(sum[i].x / den, sum[i].y / den);
    dst[1] = __floats2bfloat162_rn(sum[i].z / den, sum[i].w / den);
  }
  if (tid == 0) counters[b * K + kh] = 0;
}

// ---------------------------------------------------------------------------
// bf16 at G = 1 and D <= 64: a KV head serves one query head
// ---------------------------------------------------------------------------
namespace g1 {
constexpr int NWARP = 4;      // each 32 positions of a split
constexpr int THREADS = NWARP * 32;
constexpr int U = 16;         // splits whose loads the combine has in flight at once
#ifndef DEC_G1_STAGES
#define DEC_G1_STAGES 1
#endif
constexpr int STAGES = DEC_G1_STAGES;  // items a block has staged or in flight
template <int D>
struct L {
  static constexpr int SPLIT = split_len(D);           // positions an item takes
  static constexpr int ROW = D * 2;                    // bytes of a K or V row
  static constexpr int CH = ROW / 16;                  // 16-byte pieces of a row
  static constexpr int RPP = THREADS / CH;             // rows one pass of the copies covers
  static constexpr int TILE = SPLIT * ROW;             // bytes of a split's K (or V) rows
  static constexpr int STAGE = 2 * TILE + ROW;         // K rows, V rows, q
  static constexpr int RED = STAGES * STAGE;           // the stages, then the warps'
  static constexpr int BYTES = RED + NWARP * (D + 2) * 4;  // o [NWARP][D], m and l [NWARP]
  static_assert(SPLIT % RPP == 0 && SPLIT == 32 * NWARP, "a split's rows split evenly");
};
}  // namespace g1

// Grid: as many blocks as the card holds at once, at most one per item;
// g1::THREADS threads; g1::L<D>::BYTES of dynamic shared memory. The work
// items are the (row, KV head, split)s, item (b K + kh) n_splits + split;
// block x takes items x, x + gridDim.x, ... Other arguments as
// decode_kernel's; H == K.
template <int D, typename KV>
__global__ void __launch_bounds__(g1::THREADS) decode_g1_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    bf16* __restrict__ out, float* __restrict__ part_o, float* __restrict__ part_m,
    float* __restrict__ part_l, int* __restrict__ counters, KV kv, int B, int K, int n_splits,
    int window, float scale) {
  using namespace g1;
  using Ly = L<D>;
  constexpr int SPLIT = Ly::SPLIT;
  constexpr int E = 8;                      // bf16 elements of a 16-byte piece
  constexpr int LPR = D / E;                // lanes a row takes when read
  constexpr int RPW = 32 / LPR;             // rows one warp read covers
  constexpr int NIT = SPLIT / NWARP / RPW;  // rows a lane reads
  constexpr int C = D / 32;                 // columns a lane of warp 0 merges
  extern __shared__ __align__(16) uint8_t smem[];
  const uint32_t sbase = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  float* red_o = reinterpret_cast<float*>(smem + Ly::RED);  // [NWARP][D]
  float* red_m = red_o + NWARP * D;                          // [NWARP]
  float* red_l = red_m + NWARP;                              // [NWARP]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n_items = B * K * n_splits;

  // an item's split: its first position and the positions [j0, j1) of it
  // below the row's length and inside the window (none: an empty split)
  struct Item {
    int b, kh, split, start, j0, j1;
  };
  auto item_at = [&](int it) {
    Item r;
    r.split = it % n_splits;
    r.kh = (it / n_splits) % K;
    r.b = it / (n_splits * K);
    r.start = r.split * SPLIT;
    const int length = kv.length(r.b);
    const int lo = window > 0 ? max(length - window, 0) : 0;
    r.j0 = max(r.start, lo);
    r.j1 = min(r.start + SPLIT, length);
    return r;
  };
  // stage an item's K and V rows (zeros outside [j0, j1)) and its q row
  // into stage buf by cp.async, every row's address first; an empty split
  // or a block past the last item copies nothing. Commits one group
  // either way, so that a thread's groups stay one per item.
  auto stage = [&](int it, int buf) {
    if (it < n_items) {
      const Item r = item_at(it);
      if (r.j0 < r.j1) {
        const uint32_t dst = sbase + buf * Ly::STAGE;
        const int ch = tid % Ly::CH, r0 = tid / Ly::CH;
        long long off[SPLIT / Ly::RPP];
        bool in[SPLIT / Ly::RPP];
#pragma unroll
        for (int i = 0; i < SPLIT / Ly::RPP; ++i) {
          const int j = r.start + r0 + i * Ly::RPP;
          in[i] = j >= r.j0 && j < r.j1;
          off[i] = in[i] ? kv.row(r.b, j, r.kh) + ch * E : 0;
        }
#pragma unroll
        for (int i = 0; i < SPLIT / Ly::RPP; ++i)
          cp16(dst + (r0 + i * Ly::RPP) * Ly::ROW + ch * 16, k + off[i], in[i]);
#pragma unroll
        for (int i = 0; i < SPLIT / Ly::RPP; ++i)
          cp16(dst + Ly::TILE + (r0 + i * Ly::RPP) * Ly::ROW + ch * 16, v + off[i], in[i]);
        if (tid < Ly::CH)
          cp16(dst + 2 * Ly::TILE + tid * 16, q + ((long long)r.b * K + r.kh) * D + tid * E, true);
      }
    }
    cp_commit();
  };

  // the combine of row `row` (b K + kh) by warp 0, in split order: U
  // splits' (m, l, o) loads in flight at once, the largest m from the
  // registers when one batch holds every split; the row's counter back to 0
  auto combine = [&](int row) {
    const long long base = (long long)row * n_splits;
    const float* pm = part_m + base;
    const float* pl = part_l + base;
    const float* po = part_o + base * D + lane;
    float mg = NEG_INF;
    if (n_splits > U) {
      for (int sp = lane; sp < n_splits; sp += 32) mg = fmaxf(mg, __ldcg(pm + sp));
#pragma unroll
      for (int off = 16; off > 0; off /= 2) mg = fmaxf(mg, __shfl_xor_sync(0xffffffffu, mg, off));
    }
    float num[C], den = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) num[c] = 0.f;
    for (int s0 = 0; s0 < n_splits; s0 += U) {
      float mm[U], ll[U], oo[U][C];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const bool in = s0 + u < n_splits;
        mm[u] = in ? __ldcg(pm + s0 + u) : NEG_INF;
        ll[u] = in ? __ldcg(pl + s0 + u) : 0.f;
#pragma unroll
        for (int c = 0; c < C; ++c) oo[u][c] = in ? __ldcg(po + (long long)(s0 + u) * D + 32 * c) : 0.f;
      }
      if (n_splits <= U) {
#pragma unroll
        for (int u = 0; u < U; ++u) mg = fmaxf(mg, mm[u]);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float w = ex2(mm[u] - mg);
        den += w * ll[u];
#pragma unroll
        for (int c = 0; c < C; ++c) num[c] += w * oo[u][c];
      }
    }
#pragma unroll
    for (int c = 0; c < C; ++c)
      out[(long long)row * D + lane + 32 * c] = __float2bfloat16(num[c] / fmaxf(den, 1e-30f));
    if (lane == 0) counters[row] = 0;
  };
  // The tickets of warp 0's pending splits (lane i holds the row of the
  // i-th), drawn together when the block has no item left (or 32 are
  // pending), off the items' critical path: after __syncwarp (the lanes'
  // partial stores ordered before it), one ticket a pending split, all in
  // flight at once, with release (those stores visible device-wide first)
  // and acquire (the row's last ticket sees every split's partial); the
  // block combines the rows whose last ticket it drew.
  int pending = 0, n_pending = 0;
  auto flush = [&]() {
    __syncwarp();
    const bool last = lane < n_pending && ticket(&counters[pending]) == n_splits - 1;
    unsigned todo = __ballot_sync(0xffffffffu, last);
    __syncwarp();
    while (todo) {
      const int row = __shfl_sync(0xffffffffu, pending, __ffs(todo) - 1);
      todo &= todo - 1;
      combine(row);
    }
    n_pending = 0;
  };

  int it = blockIdx.x;
#pragma unroll
  for (int j = 0; j < STAGES; ++j) stage(it + j * gridDim.x, j);
  for (int i = 0; it < n_items; ++i, it += gridDim.x) {
    const int buf = i % STAGES;
    const Item r = item_at(it);
    const bool empty = r.j0 >= r.j1;
    cp_wait<STAGES - 1>();  // this thread's copies of the item are in
    __syncthreads();  // everyone's; and warp 0 is done with the last item's partials

    // this warp's positions start + 32 warp + RPW i + rg: scores (q scaled
    // to the log2 domain against a lane's piece of each K row, summed over
    // the row's lanes), their max and sum over the warp, and P V
    if (!empty) {
      const uint8_t* st = smem + buf * Ly::STAGE;
      const int rg = lane / LPR, cl = lane % LPR;
      float qv[E];
      {
        const uint4 qr = *reinterpret_cast<const uint4*>(st + 2 * Ly::TILE + cl * 16);
        const bf16* qe = reinterpret_cast<const bf16*>(&qr);
#pragma unroll
        for (int e = 0; e < E; ++e) qv[e] = __bfloat162float(qe[e]) * scale;
      }
      float s[NIT];
      float mx = NEG_INF;
#pragma unroll
      for (int n = 0; n < NIT; ++n) {
        const int row = warp * 32 + n * RPW + rg, j = r.start + row;
        const uint4 kr = *reinterpret_cast<const uint4*>(st + row * Ly::ROW + cl * 16);
        const bf16* kt = reinterpret_cast<const bf16*>(&kr);
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) dot += qv[e] * __bfloat162float(kt[e]);
#pragma unroll
        for (int off = LPR / 2; off > 0; off /= 2) dot += __shfl_xor_sync(0xffffffffu, dot, off);
        s[n] = j >= r.j0 && j < r.j1 ? dot : NEG_INF;
        mx = fmaxf(mx, s[n]);
      }
#pragma unroll
      for (int off = 16; off >= LPR; off /= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      float sum = 0.f, acc[E];
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] = 0.f;
#pragma unroll
      for (int n = 0; n < NIT; ++n) {
        const int row = warp * 32 + n * RPW + rg;
        const float pr = s[n] > NEG_INF ? ex2(s[n] - mx) : 0.f;
        const uint4 vr = *reinterpret_cast<const uint4*>(st + Ly::TILE + row * Ly::ROW + cl * 16);
        const bf16* vt = reinterpret_cast<const bf16*>(&vr);
        sum += pr;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[e] += pr * __bfloat162float(vt[e]);
      }
#pragma unroll
      for (int off = 16; off >= LPR; off /= 2) {
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
#pragma unroll
        for (int e = 0; e < E; ++e) acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], off);
      }
      if (rg == 0) {
        float* ro = red_o + warp * D + cl * E;
#pragma unroll
        for (int e = 0; e < E; e += 4)
          *reinterpret_cast<float4*>(ro + e) = make_float4(acc[e], acc[e + 1], acc[e + 2], acc[e + 3]);
      }
      if (lane == 0) {
        red_m[warp] = mx;
        red_l[warp] = sum;
      }
    }
    __syncthreads();  // the warps' partials are in; the stage is read
    stage(it + STAGES * gridDim.x, buf);
    if (warp != 0) continue;

    // warp 0: the split's partial, the warps' merged in warp order (lane
    // takes columns lane + 32c); its ticket waits for the flush
    float m = NEG_INF, l = 0.f, acc[C];
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] = 0.f;
    if (!empty) {
#pragma unroll
      for (int w = 0; w < NWARP; ++w) m = fmaxf(m, red_m[w]);
#pragma unroll
      for (int w = 0; w < NWARP; ++w) {
        const float wt = ex2(red_m[w] - m);
        l += wt * red_l[w];
#pragma unroll
        for (int c = 0; c < C; ++c) acc[c] += wt * red_o[w * D + lane + 32 * c];
      }
    }
    const int row = r.b * K + r.kh;
    if (n_splits == 1) {
#pragma unroll
      for (int c = 0; c < C; ++c)
        out[(long long)row * D + lane + 32 * c] = __float2bfloat16(acc[c] / fmaxf(l, 1e-30f));
      continue;
    }
    const long long base = (long long)row * n_splits;
#pragma unroll
    for (int c = 0; c < C; ++c) part_o[(base + r.split) * D + lane + 32 * c] = acc[c];
    if (lane == 0) {
      part_m[base + r.split] = m;
      part_l[base + r.split] = l;
    }
    if (lane == n_pending) pending = row;
    if (++n_pending == 32) flush();
  }
  if (warp == 0 && n_pending > 0) flush();
}

// Bytes of dynamic shared memory decode_kernel<T, D> needs: q, then each
// warp's P V sums and (m, l).
template <int D>
size_t smem_bytes(int G) {
  return (size_t)(G * D + WARPS * G * D + 2 * WARPS * G) * sizeof(float);
}

// Launches the kernel on the caller's stream; returns a cudaError_t.
// part_o: [B,K,n_splits,G,D] float32; part_ml: [2,B,K,n_splits,G] float32
// (m then l); counters: [B*K] int32, zero.
template <typename T, int D, typename KV>
int launch(const void* q, const void* k, const void* v, void* o, float* part_o,
           float* part_ml, int* counters, const KV& kv, int B, int H, int K,
           int n_splits, int window, cudaStream_t st) {
  const int G = H / K;
  const long long n_part = (long long)B * K * n_splits * G;
  if (G > GMAX) return (int)cudaErrorInvalidValue;
  decode_kernel<T, D, KV><<<dim3(n_splits, K, B), WARPS * 32, smem_bytes<D>(G), st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), part_o, part_ml, part_ml + n_part, counters, kv, H, K,
      window, 1.4426950408889634f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

namespace {
// Whether decode_mma_kernel<D, KV> may take its dynamic shared memory on a
// device (above 48 KB it must be allowed once). In an unnamed namespace,
// as g1_fit below.
template <int D, typename KV>
bool* tc_ready() {
  static bool ready[64];
  return ready;
}
}  // namespace

// The same for decode_mma_kernel<D> (bf16): tc::L<D>::PER splits a block.
// part_o: [B,K,n_blk,G,D]; part_ml: [2,B,K,n_blk,G], n_blk the blocks a
// row takes.
template <int D, typename KV>
int launch_mma(const void* q, const void* k, const void* v, void* o, float* part_o,
               float* part_ml, int* counters, const KV& kv, int B, int H, int K,
               int n_splits, int window, cudaStream_t st) {
  using Ly = tc::L<D>;
  const int G = H / K;
  const int n_blk = (n_splits + Ly::PER - 1) / Ly::PER;  // blocks a row takes
  const long long n_part = (long long)B * K * n_blk * G;
  if (G > GMAX) return (int)cudaErrorInvalidValue;
  auto kernel = decode_mma_kernel<D, KV>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  bool* ready = tc_ready<D, KV>();
  if (dev >= 64 || !ready[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Ly::BYTES);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) ready[dev] = true;
  }
  kernel<<<dim3(n_blk, K, B), tc::THREADS, Ly::BYTES, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), part_o, part_ml, part_ml + n_part, counters, kv, H, K, window,
      1.4426950408889634f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

namespace {
// Blocks of decode_g1_kernel<D, KV> the card holds at once, per device (0:
// not read yet). In an unnamed namespace: a static of a template of the
// named one would be one object across every loaded build of this header.
template <int D, typename KV>
int* g1_fit() {
  static int fit[64];
  return fit;
}
}  // namespace

// The same for decode_g1_kernel (bf16, G = 1, D <= 64): as many blocks as
// fit the card at once (the occupancy and the SM count, read once per
// device), at most one per item.
template <int D, typename KV>
int launch_g1(const void* q, const void* k, const void* v, void* o, float* part_o,
              float* part_ml, int* counters, const KV& kv, int B, int K, int n_splits,
              int window, cudaStream_t st) {
  constexpr int BYTES = g1::L<D>::BYTES;
  int* fit = g1_fit<D, KV>();
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  int blocks = dev < 64 ? fit[dev] : 0;
  if (blocks == 0) {
    auto kernel = decode_g1_kernel<D, KV>;
    int per_sm = 0, sms = 0;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, BYTES);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, g1::THREADS, BYTES);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    blocks = per_sm * sms;
    if (blocks < 1) return (int)cudaErrorInvalidConfiguration;
    if (dev < 64) fit[dev] = blocks;
  }
  const long long n_items = (long long)B * K * n_splits;
  const long long n_part = n_items;
  // as many items a block as the card's blocks need, spread evenly
  const long long per_block = (n_items + blocks - 1) / blocks;
  const int grid = (int)((n_items + per_block - 1) / per_block);
  decode_g1_kernel<D, KV><<<grid, g1::THREADS, BYTES, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), part_o, part_ml, part_ml + n_part, counters, kv, B, K, n_splits,
      window, 1.4426950408889634f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

// The built instantiations: dtype 0 = float32, 1 = bfloat16; D 32, 64, 128
// (bf16 by mma_route on decode_mma_kernel: at D = 128, and at D = 64 for
// G > 1; bf16 at G = 1 and D <= 64 on decode_g1_kernel). `split` must be
// split_len(D); the callers size the partials by it, one a split, or one a
// tc::L<D>::SPAN positions on decode_mma_kernel.
template <typename KV>
int dispatch(int dtype, int D, const void* q, const void* k, const void* v,
             void* o, void* part_o, void* part_ml, void* counters, const KV& kv,
             int B, int H, int K, int n_splits, int window, int split,
             void* stream) {
  if (B < 1 || K < 1 || H % K != 0 || n_splits < 1 || split != split_len(D))
    return (int)cudaErrorInvalidValue;
  float* po = static_cast<float*>(part_o);
  float* pml = static_cast<float*>(part_ml);
  int* cnt = static_cast<int*>(counters);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool tc = dtype == 1 && mma_route(D, H / K);
  if (tc && D == 128)
    return launch_mma<128>(q, k, v, o, po, pml, cnt, kv, B, H, K, n_splits, window, st);
  if (tc && D == 64)
    return launch_mma<64>(q, k, v, o, po, pml, cnt, kv, B, H, K, n_splits, window, st);
  if (dtype == 1 && D == 64 && H == K)
    return launch_g1<64>(q, k, v, o, po, pml, cnt, kv, B, K, n_splits, window, st);
  if (dtype == 1 && D == 32 && H == K)
    return launch_g1<32>(q, k, v, o, po, pml, cnt, kv, B, K, n_splits, window, st);
  if (dtype == 1 && D == 32)
    return launch<bf16, 32>(q, k, v, o, po, pml, cnt, kv, B, H, K, n_splits, window, st);
  if (dtype == 0 && D == 128)
    return launch<float, 128>(q, k, v, o, po, pml, cnt, kv, B, H, K, n_splits, window, st);
  if (dtype == 0 && D == 64)
    return launch<float, 64>(q, k, v, o, po, pml, cnt, kv, B, H, K, n_splits, window, st);
  if (dtype == 0 && D == 32)
    return launch<float, 32>(q, k, v, o, po, pml, cnt, kv, B, H, K, n_splits, window, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace decode_split
