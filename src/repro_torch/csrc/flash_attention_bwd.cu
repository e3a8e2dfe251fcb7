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
// Deterministic: no atomics. Each output row is owned by one block, which
// sums its terms in a fixed order, so two runs on the same inputs agree bit
// for bit. Three kernels:
//  * preprocess: Dr = rowsum(dO o) in float32, one thread a row (16-byte
//    loads);
//  * dK/dV: one block owns (b, KV head, 64 KV rows); it keeps K and V in
//    shared memory and walks the G query heads, and for each the causal
//    query tiles (the window's too), in a fixed order, recomputing P from
//    q, k and lse; dK and dV stay in registers and are written once;
//  * dQ: one block owns (b, query head, 64 query rows) and walks the KV
//    tiles from the window's edge to the diagonal in order; dQ is written
//    once.
//
// Bound: five products of K1's size (S, dP in both kernels, dV, dK, dQ:
// 2.5x the forward's work, 10 B H S^2 D / 2 FLOP causal) against reading
// q, k, v, o, dO and writing dq, dk, dv once: operations, at the tensor
// cores' rate. This first version is simple: bf16 runs mma.sync m16n8k16
// (bf16 in, float32 sums; P and dS rounded to bf16 for their products, as
// K1 rounds P), tiles staged by plain 16-byte loads into padded shared rows
// (a row of D + 8 elements, so each 8-row ldmatrix hits distinct banks),
// four warps of 16 rows each; float32 takes scalar kernels (one thread a
// row, the other side's rows read from shared memory as broadcasts), since
// float32 has no exact tensor-core path. wgmma, TMA and one kernel for dQ
// and dK/dV are later work.
//
// Layout: every tensor is addressed by (batch, head, seq) strides with a
// contiguous head dim; lse and Dr are float32 [B,H,S] contiguous. Two C
// entries, the preprocess's and the dK/dV and dQ kernels' (one launch a
// call); each returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr float LOG2E = 1.4426950408889634f;
constexpr int BT = 64;       // rows of a tile, both sides (bf16 kernels)
constexpr int THREADS = 128;  // four warps of 16 rows (bf16 kernels)
constexpr int FT = 64;       // rows a block owns (float32 kernels: a thread each)
constexpr int FB = 16;       // rows of the other side's broadcast tile (float32)

struct Strides {
  long long b, h, s;
};

struct Args {
  const void *q, *k, *v, *o, *dout;
  const float* lse;  // [B,H,S]
  float* delta;      // [B,H,S]
  void *dq, *dk, *dv;
  int H, K, S;
  Strides qs, ks, vs, os, dos, dqs, dks, dvs;
  int window;  // 0: no window
  float scale;
};

__device__ __forceinline__ bool valid_pair(int qp, int kp, int S, int window) {
  return qp < S && kp <= qp && (window <= 0 || qp - kp < window);
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ const T* row_ptr(const void* base, const Strides& st, int b, int h,
                                            int s) {
  return static_cast<const T*>(base) + b * st.b + h * st.h + s * st.s;
}

// ---------------------------------------------------------------------------
// preprocess: Dr = rowsum(dO o), float32, one thread a row
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(128) preprocess_kernel(Args a) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x, h = blockIdx.y, b = blockIdx.z;
  if (s >= a.S) return;
  const T* o = row_ptr<T>(a.o, a.os, b, h, s);
  const T* g = row_ptr<T>(a.dout, a.dos, b, h, s);
  constexpr int V = 16 / sizeof(T);  // elements a 16-byte load
  float acc = 0.f;
#pragma unroll
  for (int d = 0; d < D; d += V) {
    const uint4 x = *reinterpret_cast<const uint4*>(o + d);
    const uint4 y = *reinterpret_cast<const uint4*>(g + d);
    const T* xs = reinterpret_cast<const T*>(&x);
    const T* ys = reinterpret_cast<const T*>(&y);
#pragma unroll
    for (int j = 0; j < V; ++j) acc += to_f(xs[j]) * to_f(ys[j]);
  }
  a.delta[((long long)b * a.H + h) * a.S + s] = acc;
}

// ---------------------------------------------------------------------------
// bf16: mma.sync m16n8k16 (bf16 in, float32 sums)
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a . b for one m16n8k16 tile: a row-major 16x16, b 16x8, both bf16
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (lo, hi) -> one register, lo in the low half (the lower column)
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// A fragment of a 16x16 tile from two neighbouring n8 accumulator tiles:
// rows as they are, columns 0-7 from c0 and 8-15 from c1, rounded to bf16
__device__ __forceinline__ void acc_to_a(uint32_t (&r)[4], const float (&c0)[4],
                                         const float (&c1)[4]) {
  r[0] = pack(c0[0], c0[1]);
  r[1] = pack(c0[2], c0[3]);
  r[2] = pack(c1[0], c1[1]);
  r[3] = pack(c1[2], c1[3]);
}

// Rows [r0, r0 + BT) of (b, h) into a padded shared tile; rows at or past S
// are zeros. 16-byte loads (the wrapper checks the rows' alignment).
template <int D>
__device__ __forceinline__ void load_tile(bf16 (*dst)[D + 8], const void* src,
                                          const Strides& st, int b, int h, int r0, int S) {
  const bf16* base = static_cast<const bf16*>(src) + b * st.b + h * st.h;
  for (int i = threadIdx.x; i < BT * D / 8; i += THREADS) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < S) x = *reinterpret_cast<const uint4*>(base + (r0 + r) * st.s + c);
    *reinterpret_cast<uint4*>(&dst[r][c]) = x;
  }
}

// The lane's ldmatrix row and column within a 16x16 block: as an A operand
// (row-major [m][k]) and as a B operand stored [n][k] (non-transposed) or
// [k][n] (transposed), x4 loading two n8 tiles of B at once.
struct Lanes {
  int ar, ac, br, bc, tr, tc;
  __device__ __forceinline__ Lanes() {
    const int lane = threadIdx.x & 31, m = lane >> 3, r = lane & 7;
    ar = (m & 1) * 8 + r;
    ac = (m >> 1) * 8;
    br = (m >> 1) * 8 + r;
    bc = (m & 1) * 8;
    tr = (m & 1) * 8 + r;
    tc = (m >> 1) * 8;
  }
};

// Write a warp's 16 x D float32 accumulator (times `mul`) as bf16 rows
// r0, r0 + 8 of the thread's quad, below S.
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 8][4], float mul, void* dst,
                                           const Strides& st, int b, int h, int r0, int S) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  bf16* base = static_cast<bf16*>(dst) + b * st.b + h * st.h;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    if (r0 + g < S)
      *reinterpret_cast<uint32_t*>(base + (r0 + g) * st.s + 8 * n + 2 * t) =
          pack(acc[n][0] * mul, acc[n][1] * mul);
    if (r0 + g + 8 < S)
      *reinterpret_cast<uint32_t*>(base + (r0 + g + 8) * st.s + 8 * n + 2 * t) =
          pack(acc[n][2] * mul, acc[n][3] * mul);
  }
}

// dK, dV for 64 KV rows of one (b, KV head); warp w owns rows 16w..16w+15.
template <int D>
__global__ void __launch_bounds__(THREADS) dkdv_bf16_kernel(Args a) {
  constexpr int LD = D + 8;
  __shared__ __align__(16) bf16 k_s[BT][LD];
  __shared__ __align__(16) bf16 v_s[BT][LD];
  __shared__ __align__(16) bf16 q_s[BT][LD];
  __shared__ __align__(16) bf16 do_s[BT][LD];
  __shared__ float lse_s[BT], dr_s[BT];

  const int kt = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int G = a.H / a.K;
  const int k0 = kt * BT;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int t = lane & 3;
  const int kv0 = k0 + warp * 16 + (lane >> 2), kv1 = kv0 + 8;  // the thread's rows
  const float scale_log2 = a.scale * LOG2E;
  const Lanes L;

  load_tile<D>(k_s, a.k, a.ks, b, kh, k0, a.S);
  load_tile<D>(v_s, a.v, a.vs, b, kh, k0, a.S);
  __syncthreads();
  uint32_t ka[D / 16][4], va[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    ldsm(ka[kk], &k_s[warp * 16 + L.ar][kk * 16 + L.ac]);
    ldsm(va[kk], &v_s[warp * 16 + L.ar][kk * 16 + L.ac]);
  }
  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  // the query rows that see these keys: from the tile's first key to the
  // last key's window edge
  const int q_hi = a.window > 0 ? min(a.S, k0 + BT - 1 + a.window) : a.S;
  const int qt_lo = k0 / BT, qt_hi = (q_hi + BT - 1) / BT;
  for (int gi = 0; gi < G; ++gi) {
    const int h = kh * G + gi;
    const float* lse = a.lse + ((long long)b * a.H + h) * a.S;
    const float* dr = a.delta + ((long long)b * a.H + h) * a.S;
    for (int qt = qt_lo; qt < qt_hi; ++qt) {
      const int q0 = qt * BT;
      __syncthreads();  // the last tile's reads are done
      load_tile<D>(q_s, a.q, a.qs, b, h, q0, a.S);
      load_tile<D>(do_s, a.dout, a.dos, b, h, q0, a.S);
      if (threadIdx.x < BT) {
        const int qp = q0 + threadIdx.x;
        lse_s[threadIdx.x] = qp < a.S ? lse[qp] * LOG2E : 0.f;
        dr_s[threadIdx.x] = qp < a.S ? dr[qp] : 0.f;
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T: the warp's 16 keys x 64 queries
      float st[BT / 8][4], dpt[BT / 8][4];
#pragma unroll
      for (int n = 0; n < BT / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
#pragma unroll
      for (int np = 0; np < BT / 16; ++np)
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          uint32_t qb[4], ob[4];
          ldsm(qb, &q_s[np * 16 + L.br][kk * 16 + L.bc]);
          ldsm(ob, &do_s[np * 16 + L.br][kk * 16 + L.bc]);
          mma(st[2 * np], ka[kk], qb[0], qb[1]);
          mma(st[2 * np + 1], ka[kk], qb[2], qb[3]);
          mma(dpt[2 * np], va[kk], ob[0], ob[1]);
          mma(dpt[2 * np + 1], va[kk], ob[2], ob[3]);
        }
      // P^T under K1's mask, then dS^T = P^T (dP^T - Dr)
#pragma unroll
      for (int n = 0; n < BT / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ql = 8 * n + 2 * t + (e & 1);
          const bool ok = valid_pair(q0 + ql, e < 2 ? kv0 : kv1, a.S, a.window);
          const float p = ok ? ex2(st[n][e] * scale_log2 - lse_s[ql]) : 0.f;
          st[n][e] = p;
          dpt[n][e] = p * (dpt[n][e] - dr_s[ql]);
        }
      // dV += P^T dO, dK += dS^T Q: 16 queries a step
#pragma unroll
      for (int kk = 0; kk < BT / 16; ++kk) {
        uint32_t pa[4], sa[4];
        acc_to_a(pa, st[2 * kk], st[2 * kk + 1]);
        acc_to_a(sa, dpt[2 * kk], dpt[2 * kk + 1]);
#pragma unroll
        for (int cp = 0; cp < D / 16; ++cp) {
          uint32_t ob[4], qb[4];
          ldsm_t(ob, &do_s[kk * 16 + L.tr][cp * 16 + L.tc]);
          ldsm_t(qb, &q_s[kk * 16 + L.tr][cp * 16 + L.tc]);
          mma(dv[2 * cp], pa, ob[0], ob[1]);
          mma(dv[2 * cp + 1], pa, ob[2], ob[3]);
          mma(dk[2 * cp], sa, qb[0], qb[1]);
          mma(dk[2 * cp + 1], sa, qb[2], qb[3]);
        }
      }
    }
  }
  store_rows<D>(dk, a.scale, a.dk, a.dks, b, kh, k0 + warp * 16, a.S);
  store_rows<D>(dv, 1.f, a.dv, a.dvs, b, kh, k0 + warp * 16, a.S);
}

// dQ for 64 query rows of one (b, query head); warp w owns rows 16w..16w+15.
template <int D>
__global__ void __launch_bounds__(THREADS) dq_bf16_kernel(Args a) {
  constexpr int LD = D + 8;
  __shared__ __align__(16) bf16 q_s[BT][LD];
  __shared__ __align__(16) bf16 do_s[BT][LD];
  __shared__ __align__(16) bf16 k_s[BT][LD];
  __shared__ __align__(16) bf16 v_s[BT][LD];

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (a.H / a.K);
  const int q0 = qt * BT;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int t = lane & 3;
  const int qp0 = q0 + warp * 16 + (lane >> 2), qp1 = qp0 + 8;  // the thread's rows
  const float scale_log2 = a.scale * LOG2E;
  const Lanes L;

  load_tile<D>(q_s, a.q, a.qs, b, h, q0, a.S);
  load_tile<D>(do_s, a.dout, a.dos, b, h, q0, a.S);
  __syncthreads();
  uint32_t qa[D / 16][4], oa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    ldsm(qa[kk], &q_s[warp * 16 + L.ar][kk * 16 + L.ac]);
    ldsm(oa[kk], &do_s[warp * 16 + L.ar][kk * 16 + L.ac]);
  }
  const float* lse = a.lse + ((long long)b * a.H + h) * a.S;
  const float* dr = a.delta + ((long long)b * a.H + h) * a.S;
  const float l0 = qp0 < a.S ? lse[qp0] * LOG2E : 0.f, l1 = qp1 < a.S ? lse[qp1] * LOG2E : 0.f;
  const float r0 = qp0 < a.S ? dr[qp0] : 0.f, r1 = qp1 < a.S ? dr[qp1] : 0.f;
  float dq[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;

  // the keys these queries see: from the first row's window edge to the
  // diagonal
  const int k_lo = a.window > 0 ? max(q0 - a.window + 1, 0) : 0;
  const int kt_lo = k_lo / BT, kt_hi = (min(q0 + BT, a.S) + BT - 1) / BT;
  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * BT;
    __syncthreads();  // the last tile's reads are done
    load_tile<D>(k_s, a.k, a.ks, b, kh, k0, a.S);
    load_tile<D>(v_s, a.v, a.vs, b, kh, k0, a.S);
    __syncthreads();

    // S = Q K^T and dP = dO V^T: the warp's 16 queries x 64 keys
    float s[BT / 8][4], dp[BT / 8][4];
#pragma unroll
    for (int n = 0; n < BT / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int np = 0; np < BT / 16; ++np)
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t kb[4], vb[4];
        ldsm(kb, &k_s[np * 16 + L.br][kk * 16 + L.bc]);
        ldsm(vb, &v_s[np * 16 + L.br][kk * 16 + L.bc]);
        mma(s[2 * np], qa[kk], kb[0], kb[1]);
        mma(s[2 * np + 1], qa[kk], kb[2], kb[3]);
        mma(dp[2 * np], oa[kk], vb[0], vb[1]);
        mma(dp[2 * np + 1], oa[kk], vb[2], vb[3]);
      }
    // P under K1's mask, then dS = P (dP - Dr), in place of dp
#pragma unroll
    for (int n = 0; n < BT / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = k0 + 8 * n + 2 * t + (e & 1);
        const bool ok = valid_pair(e < 2 ? qp0 : qp1, kp, a.S, a.window);
        const float p = ok ? ex2(s[n][e] * scale_log2 - (e < 2 ? l0 : l1)) : 0.f;
        dp[n][e] = p * (dp[n][e] - (e < 2 ? r0 : r1));
      }
    // dQ += dS K: 16 keys a step
#pragma unroll
    for (int kk = 0; kk < BT / 16; ++kk) {
      uint32_t sa[4];
      acc_to_a(sa, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int cp = 0; cp < D / 16; ++cp) {
        uint32_t kb[4];
        ldsm_t(kb, &k_s[kk * 16 + L.tr][cp * 16 + L.tc]);
        mma(dq[2 * cp], sa, kb[0], kb[1]);
        mma(dq[2 * cp + 1], sa, kb[2], kb[3]);
      }
    }
  }
  store_rows<D>(dq, a.scale, a.dq, a.dqs, b, h, q0 + warp * 16, a.S);
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
  const long long row = ((long long)b * a.H + h) * a.S + qp;
  const float lse = qp < a.S ? a.lse[row] : 0.f, dr = qp < a.S ? a.delta[row] : 0.f;
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

template <int D>
int launch(int kernel, const Args& a, int B, int dtype, cudaStream_t st) {
  if (kernel == 0) {
    const dim3 grid((a.S + 127) / 128, a.H, B);
    if (dtype == 1)
      preprocess_kernel<bf16, D><<<grid, 128, 0, st>>>(a);
    else
      preprocess_kernel<float, D><<<grid, 128, 0, st>>>(a);
  } else if (dtype == 1) {
    if (kernel == 1)
      dkdv_bf16_kernel<D><<<dim3((a.S + BT - 1) / BT, a.K, B), THREADS, 0, st>>>(a);
    else
      dq_bf16_kernel<D><<<dim3((a.S + BT - 1) / BT, a.H, B), THREADS, 0, st>>>(a);
  } else {
    if (kernel == 1)
      dkdv_f32_kernel<D><<<dim3((a.S + FT - 1) / FT, a.K, B), FT, 0, st>>>(a);
    else
      dq_f32_kernel<D><<<dim3((a.S + FT - 1) / FT, a.H, B), FT, 0, st>>>(a);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// The preprocess: delta = rowsum(dO o), float32 [B,H,S] contiguous. strides:
// the (batch, head, seq) element strides of o and dO (6 values). dtype: 0 =
// float32, 1 = bfloat16. Returns a cudaError_t.
extern "C" int repro_flash_attention_bwd_delta(const void* o, const void* dout, float* delta,
                                               int B, int H, int S, int D,
                                               const long long* strides, int dtype,
                                               void* stream) {
  if (B < 1 || S < 1 || H < 1 || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  Args a = {};
  a.o = o; a.dout = dout; a.delta = delta;
  a.H = H; a.K = H; a.S = S;
  a.os = {strides[0], strides[1], strides[2]};
  a.dos = {strides[3], strides[4], strides[5]};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64) return launch<64>(0, a, B, dtype, st);
  if (D == 32) return launch<32>(0, a, B, dtype, st);
  return (int)cudaErrorInvalidValue;
}

// kernel: 1 = dK/dV, 2 = dQ. strides: the (batch, head, seq) element strides
// of q, k, v, dO, dq, dk, dv in that order (21 values). lse and delta (the
// preprocess's): float32 [B,H,S] contiguous. dtype: 0 = float32, 1 =
// bfloat16. Returns a cudaError_t.
extern "C" int repro_flash_attention_bwd(int kernel, const void* q, const void* k,
                                         const void* v, const void* dout, const float* lse,
                                         const float* delta, void* dq, void* dk, void* dv,
                                         int B, int H, int K, int S, int D,
                                         const long long* strides, int window, int dtype,
                                         void* stream) {
  if (B < 1 || S < 1 || K < 1 || H % K != 0 || kernel < 1 || kernel > 2 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  Args a = {};
  a.q = q; a.k = k; a.v = v; a.dout = dout;
  a.lse = lse; a.delta = const_cast<float*>(delta);
  a.dq = dq; a.dk = dk; a.dv = dv;
  a.H = H; a.K = K; a.S = S;
  Strides* all[7] = {&a.qs, &a.ks, &a.vs, &a.dos, &a.dqs, &a.dks, &a.dvs};
  for (int i = 0; i < 7; ++i) *all[i] = {strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  a.window = window;
  a.scale = 1.0f / sqrtf((float)D);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64) return launch<64>(kernel, a, B, dtype, st);
  if (D == 32) return launch<32>(kernel, a, B, dtype, st);
  return (int)cudaErrorInvalidValue;
}
