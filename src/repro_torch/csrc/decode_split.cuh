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
//  * One launch. The splits are parallel blocks: one block of 4 warps per
//    (row, KV head, split of SPLIT = 128 logical positions). Each block
//    writes an unnormalised partial (m, l, o) for the KV head's G query
//    heads, then takes a ticket from a per-(row, KV head) counter (after
//    __syncthreads, one atomicAdd with release and acquire semantics, which
//    also does a __threadfence's work); the block that draws the last
//    ticket combines the splits in split-index order, as a separate
//    combine kernel did, and sets the counter back to 0. The atomic only
//    elects the block: every sum runs in a fixed order, so the result is
//    deterministic and the same whichever block combines. The combine's
//    loads are batched (up to 16 splits' (m, l, o) per batch, the largest
//    m taken from the registers when one batch holds every split), so the
//    tail after the last ticket is one or two round trips to L2. With a
//    single split the block writes the output.
//  * Streaming. Each warp takes 32 positions; D * sizeof(T) / 16 lanes read
//    one K or V row (8 lanes for a bf16 row of 64), 16 bytes each, so a
//    warp's load covers one or more whole rows. Every K and V load of a
//    thread is issued before any is used (up to batch<D>() of each at once), and
//    nothing waits on another warp before the merge, so one warp's math
//    overlaps the other warps' (and blocks') loads. 128-position splits
//    rather than 64 halve the partials the combine reads, while each warp
//    keeps twice the loads in flight, so the card holds as many bytes in
//    flight. At D = 128 (added later; not redesigned) a bf16 row takes 16
//    lanes and a float32 row the whole warp, 16 or 32 loads of K and of V a
//    lane: the warp takes its positions in batches of 8 loads, each later
//    batch's (m, l, P V) merged into the earlier ones' in shared memory, so
//    the loads stay in registers.
//  * Per query head of the KV head, a warp computes its positions' scores
//    (a lane's slice of q from shared memory against its slice of the K
//    row, summed over the row's lanes by shuffles), its online-softmax
//    (m, l) by shuffles across the row groups, and its P V sum in
//    registers; the 4 warps' partials are merged through shared memory in
//    warp order. Scores are in the log2 domain (q scaled by
//    log2(e) / sqrt(D)) and exponentiated with ex2.approx.
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
constexpr int WARPS = 4;      // warps per split block
constexpr int WARP_POS = 32;  // positions per warp
constexpr int SPLIT = WARPS * WARP_POS;
constexpr int MIN_BLOCKS = 3;  // resident blocks per SM the registers allow
// K (and V) loads a lane keeps in flight at most: at D = 128 eight, so
// that a bf16 row's 16 loads do not spill (ptxas: 830 bytes at 16)
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
// 0 and n_splits = ceil(n / SPLIT)) and none lies wholly below it.
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

// The six built instantiations: dtype 0 = float32, 1 = bfloat16; D 32, 64, 128.
// `split` must be SPLIT (the callers size the partials by it).
template <typename KV>
int dispatch(int dtype, int D, const void* q, const void* k, const void* v,
             void* o, void* part_o, void* part_ml, void* counters, const KV& kv,
             int B, int H, int K, int n_splits, int window, int split,
             void* stream) {
  if (B < 1 || K < 1 || H % K != 0 || n_splits < 1 || split != SPLIT)
    return (int)cudaErrorInvalidValue;
  float* po = static_cast<float*>(part_o);
  float* pml = static_cast<float*>(part_ml);
  int* cnt = static_cast<int*>(counters);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && D == 128)
    return launch<bf16, 128>(q, k, v, o, po, pml, cnt, kv, B, H, K, n_splits, window, st);
  if (dtype == 1 && D == 64)
    return launch<bf16, 64>(q, k, v, o, po, pml, cnt, kv, B, H, K, n_splits, window, st);
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
