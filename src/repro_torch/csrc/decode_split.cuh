// Split-KV flash-decoding kernels shared by the contiguous-cache decode
// (decode_attention.cu, kernel 2, also over a ring-buffer window cache) and
// the paged-pool decode (paged_decode_attention.cu, kernel 3). Included by
// both; not compiled on its own.
//
// Computes, for each row b and query head h, softmax(q k^T / sqrt(D)) v over
// cache positions [max(length_b - window, 0), length_b), with query head h
// reading KV head h / (H / K). q: [B,H,D]; out: [B,H,D]. Where the K/V row of
// (row b, position j, KV head kh) lies is the one thing the two callers
// differ in: an addressing functor (ContigKV, RingKV, PagedKV) gives its
// element offset and each row's length. Scores, softmax and sums are
// float32; the output is cast to the input type.
//
// Bound: each cache position's K and V rows (2*D elements) serve the G = H/K
// query heads of their KV head at 4*D FLOP per head, so the work is G FLOP
// per cache byte in bf16 (4 for granite-3-2b), far below the H100's ~295
// FLOP/byte ridge: device-memory bytes bound it, the 2*length*K*D cache
// elements below each row's length at 3.35 TB/s.
// Design against that bound:
//  * The TPU kernels carry (m, l, acc) across a sequential split (or page)
//    axis. On Hopper the splits are parallel blocks: one block per (row, KV
//    head, split of SPLIT logical positions), enough blocks to keep the SMs'
//    loads in flight. A block reads each of its K and V rows from device
//    memory once for all G query heads of its KV head: one thread per
//    position issues all the 16-byte loads of its K row (kept in registers
//    for the scores) and its V row (staged in shared memory) at once, so the
//    block waits on device memory once. For P.V one warp takes a position at
//    a time and adds its V row into all G heads' accumulators, kept in
//    registers.
//  * Each block writes an unnormalised partial (m, l, o) to scratch; a second
//    small kernel combines the splits in a fixed order. No atomics, so the
//    result is deterministic.
//  * A split wholly outside [lo, length) writes the empty partial
//    (m = -1e30, l = 0, o = 0) without reading the cache; the combine weighs
//    it by exp(-1e30 - m) = 0, so it adds exactly nothing and no NaN. The
//    splits cover the same logical positions whatever the addressing, so a
//    paged pool whose pages lie in order gives the contiguous kernel's
//    result bit for bit.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace decode_split {

using bf16 = __nv_bfloat16;

constexpr float NEG_INF = -1e30f;
constexpr int GMAX = 16;  // query heads per KV head the accumulators hold

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16(x); }

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o /= 2) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o /= 2) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

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
// 0 and n_splits = ceil(n / split)) and none lies wholly below it.
struct RingKV {
  int W, K, D, n, lo;
  __device__ __forceinline__ int length(int) const { return n; }
  __device__ __forceinline__ long long row(int b, int j, int kh) const {
    return (((long long)b * W + (lo + j) % W) * K + kh) * D;
  }
};

// Grid (n_splits, K, B); blockDim.x = split positions, one per thread.
// G <= GMAX. Partials: part_o [B,K,n_splits,G,D]; part_m, part_l
// [B,K,n_splits,G]. Dynamic shared memory: see smem_bytes().
template <typename T, int D, typename KV>
__global__ void __launch_bounds__(256) decode_split_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    float* __restrict__ part_o, float* __restrict__ part_m,
    float* __restrict__ part_l, KV kv, int H, int K, int window, float scale) {
  constexpr int L16 = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int VP = D + L16;          // v_s row pitch (16-byte pad: no bank conflicts)
  constexpr int VEC = D / 32;          // elements of a V row per lane in P.V
  extern __shared__ __align__(16) float sm[];
  const int G = H / K;
  const int split = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int n_splits = gridDim.x, span = blockDim.x;
  const int start = split * span;
  const int length = kv.length(b);
  const int lo = window > 0 ? max(length - window, 0) : 0;
  const int j0 = max(start, lo), j1 = min(start + span, length);
  const long long pidx = ((long long)(b * K + kh) * n_splits + split) * G;
  float* o_out = part_o + pidx * D;

  if (j0 >= j1) {  // nothing of [lo, length) in this split: empty partial
    for (int i = threadIdx.x; i < G * D; i += blockDim.x) o_out[i] = 0.f;
    for (int g = threadIdx.x; g < G; g += blockDim.x) {
      part_m[pidx + g] = NEG_INF;
      part_l[pidx + g] = 0.f;
    }
    return;
  }

  float* q_s = sm;                                    // [G][D], scaled
  float* p_s = q_s + G * D;                           // [G][span]: scores, then p
  T* v_s = reinterpret_cast<T*>(p_s + G * span);      // [span][VP]: the V rows
  const T* qb = q + ((long long)b * H + kh * G) * D;
  for (int i = threadIdx.x; i < G * D; i += blockDim.x) q_s[i] = to_f(qb[i]) * scale;

  // Thread jl reads cache position start + jl: its K row into registers and
  // its V row into v_s, every 16-byte load of the block issued before any
  // is used, so the block waits on device memory once.
  const int jl = threadIdx.x, j = start + jl;
  const bool live = j >= j0 && j < j1;
  float kf[D];
  if (live) {
    const long long row = kv.row(b, j, kh);
    const uint4* kr = reinterpret_cast<const uint4*>(k + row);
    const uint4* vr = reinterpret_cast<const uint4*>(v + row);
    uint4 ku[D / L16], vu[D / L16];
#pragma unroll
    for (int c = 0; c < D / L16; ++c) {
      ku[c] = kr[c];
      vu[c] = vr[c];
    }
#pragma unroll
    for (int c = 0; c < D / L16; ++c) {
      *reinterpret_cast<uint4*>(v_s + jl * VP + c * L16) = vu[c];
      const T* e = reinterpret_cast<const T*>(&ku[c]);
#pragma unroll
      for (int t = 0; t < L16; ++t) kf[c * L16 + t] = to_f(e[t]);
    }
  }
  __syncthreads();  // q_s and v_s are filled

  if (live) {
    for (int g = 0; g < G; ++g) {
      float sc = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) sc += q_s[g * D + d] * kf[d];
      p_s[g * span + jl] = sc;
    }
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_warps = blockDim.x / 32;
  for (int g = warp; g < G; g += n_warps) {
    float* ps = p_s + g * span;
    float mx = NEG_INF;
    for (int i = j0 - start + lane; i < j1 - start; i += 32) mx = fmaxf(mx, ps[i]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int i = j0 - start + lane; i < j1 - start; i += 32) {
      const float pr = expf(ps[i] - mx);
      ps[i] = pr;
      sum += pr;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      part_m[pidx + g] = mx;
      part_l[pidx + g] = sum;
    }
  }
  __syncthreads();

  // P.V from shared memory: warp w takes positions j0 + w, j0 + w + n_warps,
  // ...; the lane adds its VEC elements of each V row into all G heads'
  // accumulators, kept in registers
  float acc[GMAX][VEC];
#pragma unroll
  for (int g = 0; g < GMAX; ++g)
#pragma unroll
    for (int t = 0; t < VEC; ++t) acc[g][t] = 0.f;
  for (int i = j0 - start + warp; i < j1 - start; i += n_warps) {
    float vf[VEC];
#pragma unroll
    for (int t = 0; t < VEC; ++t) vf[t] = to_f(v_s[i * VP + lane * VEC + t]);
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g < G) {
        const float pr = p_s[g * span + i];
#pragma unroll
        for (int t = 0; t < VEC; ++t) acc[g][t] += pr * vf[t];
      }
    }
  }
  __syncthreads();  // every warp is done with v_s, which now takes the sums

  // sum the warps' accumulators in warp order (deterministic)
  float* red = reinterpret_cast<float*>(v_s);  // [n_warps][G][D]
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    if (g < G) {
#pragma unroll
      for (int t = 0; t < VEC; ++t) red[(warp * G + g) * D + lane * VEC + t] = acc[g][t];
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < G * D; e += blockDim.x) {
    float sum = 0.f;
    for (int w = 0; w < n_warps; ++w) sum += red[w * G * D + e];
    o_out[e] = sum;
  }
}

// Bytes of dynamic shared memory decode_split_kernel<T, D> needs: q and the
// scores, then the V rows, whose space later holds the per-warp P.V sums.
template <typename T, int D>
size_t smem_bytes(int G, int split) {
  const size_t v_rows = (size_t)split * (D + 16 / sizeof(T)) * sizeof(T);
  const size_t sums = (size_t)(split / 32) * G * D * sizeof(float);
  return (size_t)(G * D + G * split) * sizeof(float) + (v_rows > sums ? v_rows : sums);
}

// Grid (H, B); blockDim.x = D. Combines the splits in index order.
template <typename T>
__global__ void decode_combine_kernel(const float* __restrict__ part_o,
                                      const float* __restrict__ part_m,
                                      const float* __restrict__ part_l,
                                      T* __restrict__ out, int H, int K,
                                      int n_splits) {
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x, D = blockDim.x;
  const int G = H / K, kh = h / G, g = h % G;
  const long long base = (long long)(b * K + kh) * n_splits * G + g;
  float mg = NEG_INF;
  for (int s = 0; s < n_splits; ++s) mg = fmaxf(mg, part_m[base + (long long)s * G]);
  float num = 0.f, den = 0.f;
  for (int s = 0; s < n_splits; ++s) {
    const long long i = base + (long long)s * G;
    const float w = expf(part_m[i] - mg);
    den += w * part_l[i];
    num += w * part_o[i * D + d];
  }
  out[((long long)b * H + h) * D + d] = from_f<T>(num / fmaxf(den, 1e-30f));
}

// Launches the split kernel and the combine on the caller's stream; returns
// a cudaError_t. part_o: [B,K,n_splits,G,D] float32; part_ml:
// [2,B,K,n_splits,G] float32 (m then l).
template <typename T, int D, typename KV>
int launch(const void* q, const void* k, const void* v, void* o, float* part_o,
           float* part_ml, const KV& kv, int B, int H, int K, int n_splits,
           int window, int split, cudaStream_t st) {
  const int G = H / K;
  const long long n_part = (long long)B * K * n_splits * G;
  const size_t smem = smem_bytes<T, D>(G, split);
  if (G > GMAX || smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  decode_split_kernel<T, D, KV><<<dim3(n_splits, K, B), split, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), part_o, part_ml, part_ml + n_part, kv, H, K,
      window, 1.0f / sqrtf((float)D));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_combine_kernel<T><<<dim3(H, B), D, 0, st>>>(
      part_o, part_ml, part_ml + n_part, static_cast<T*>(o), H, K, n_splits);
  return (int)cudaGetLastError();
}

// The four built instantiations: dtype 0 = float32, 1 = bfloat16; D 32, 64.
template <typename KV>
int dispatch(int dtype, int D, const void* q, const void* k, const void* v,
             void* o, void* part_o, void* part_ml, const KV& kv, int B, int H,
             int K, int n_splits, int window, int split, void* stream) {
  if (B < 1 || K < 1 || H % K != 0 || n_splits < 1 || split < 32 ||
      split > 256 || split % 32 != 0)
    return (int)cudaErrorInvalidValue;
  float* po = static_cast<float*>(part_o);
  float* pml = static_cast<float*>(part_ml);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && D == 64)
    return launch<bf16, 64>(q, k, v, o, po, pml, kv, B, H, K, n_splits, window, split, st);
  if (dtype == 1 && D == 32)
    return launch<bf16, 32>(q, k, v, o, po, pml, kv, B, H, K, n_splits, window, split, st);
  if (dtype == 0 && D == 64)
    return launch<float, 64>(q, k, v, o, po, pml, kv, B, H, K, n_splits, window, split, st);
  if (dtype == 0 && D == 32)
    return launch<float, 32>(q, k, v, o, po, pml, kv, B, H, K, n_splits, window, split, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace decode_split
