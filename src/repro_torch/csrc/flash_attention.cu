// Causal GQA flash attention (prefill) for NVIDIA Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention.py::_kernel, the Pallas TPU
// kernel behind flash_attention() (the twin of models/layers.py
// chunked_attention, which the JAX package runs on this path).
//
// Computes o = softmax(q k^T / sqrt(D) + mask) v per (row, query head) with
// the causal mask and an optional sliding window (qpos - kpos < window).
// Query head h reads KV head h / (H / K); the KV heads are never repeated.
// Scores, the online-softmax state (m, l) and the accumulator are float32;
// the output is cast to the input type.
//
// Bound: at prefill shapes (B = 4, H = 32, K = 8, S = 1024, D = 64, bf16)
// the work is 4*B*H*S^2*D/2 FLOP against 2*B*(2H+2K)*S*D bytes (q, k, v read,
// o written): about 410 FLOP per byte, above the H100's ~295 FLOP/byte
// ridge, so the tensor cores bound it.
// Design against that bound:
//  * bf16: the two products run on the tensor cores through WMMA
//    (mma.sync, 16x16x16 bf16 -> f32). One block of 4 warps owns 64 query
//    rows; each warp owns 16 of them and keeps its Q fragments in registers
//    for the whole pass, so Q is read from device memory once. K/V tiles of
//    64 rows are staged in shared memory and shared by the 4 warps.
//  * float32 inputs have no exact tensor-core path (TF32 would round
//    them), so they take a scalar kernel: one thread per query row, K/V
//    tiles in shared memory read as broadcasts.
//  * The loop over KV tiles stops at the diagonal (and starts at the
//    window's edge): the TPU kernel's skip of dead tiles, as loop bounds.
//    Only tiles that straddle the diagonal or the window edge evaluate
//    the mask; interior tiles run the pure product + softmax update.
//  * Blocks are launched heaviest-first (the last query tile has the most
//    KV tiles), so the short tiles fill the tail of the grid.
// wgmma/TMA pipelines are left for a later change.
//
// Layout: every tensor is addressed by (batch, head, seq) strides with a
// contiguous head dim, so [B,S,H,D] projections are taken as they are.
// Each entry point returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr float NEG_INF = -1e30f;
constexpr int BQ = 64;    // query rows per block
constexpr int BK = 64;    // KV rows per tile (tensor-core kernel)
constexpr int BKS = 32;   // KV rows per tile (scalar kernel)

struct Strides {
  long long b, h, s;
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int H, K, S;
  Strides qs, ks, vs, os;
  int window;  // 0: no window
  float scale;
};

__device__ __forceinline__ bool valid_pair(int qp, int kp, int window) {
  return kp <= qp && (window <= 0 || qp - kp < window);
}

// Every (q, k) pair of the tile [q0, q0+BQ) x [k0, k0+bk) is valid.
__device__ __forceinline__ bool tile_full(int q0, int k0, int bk, int window) {
  bool full = k0 + bk - 1 <= q0;
  if (window > 0) full = full && (q0 + BQ - 1) - k0 < window;
  return full;
}

// KV rows [lo, hi) the query tile starting at q0 needs; lo tile-aligned.
__device__ __forceinline__ void kv_range(int q0, int S, int window, int bk,
                                         int* lo, int* hi) {
  *hi = min(q0 + BQ, S);
  int l = window > 0 ? max(q0 - window + 1, 0) : 0;
  *lo = (l / bk) * bk;
}

// ---------------------------------------------------------------------------
// bf16: tensor cores through WMMA. 128 threads = 4 warps x 16 query rows.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(128) flash_bf16_kernel(Args a) {
  constexpr int LDQ = D + 8;   // bf16 pitch of Q/K/V tiles (16 B pad)
  constexpr int LDP = BK + 8;  // bf16 pitch of the P tile
  constexpr int LDS = (BK > D ? BK : D) + 4;  // f32 pitch of S / PV tiles
  constexpr int QP = (LDQ > LDP ? LDQ : LDP) * BQ;
  constexpr int CH = D / 8;    // 16-byte chunks per row
  constexpr int NO = 16 * D / 32;  // accumulator elements per lane

  // Q tile, then (once every warp holds its Q fragments) each warp's P rows
  __shared__ __align__(128) bf16 qp_s[QP];
  __shared__ __align__(128) bf16 k_s[BK * LDQ];
  __shared__ __align__(128) bf16 v_s[BK * LDQ];
  // scores, then the P.V product of the tile (each warp its own 16 rows)
  __shared__ __align__(128) float s_s[BQ * LDS];
  __shared__ float alpha_s[BQ];
  __shared__ float l_s[BQ];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (a.H / a.K);
  const int q0 = qt * BQ;
  const bf16* q = static_cast<const bf16*>(a.q) + b * a.qs.b + h * a.qs.h;
  const bf16* k = static_cast<const bf16*>(a.k) + b * a.ks.b + kh * a.ks.h;
  const bf16* v = static_cast<const bf16*>(a.v) + b * a.vs.b + kh * a.vs.h;
  bf16* o = static_cast<bf16*>(a.o) + b * a.os.b + h * a.os.h;

  for (int i = threadIdx.x; i < BQ * CH; i += blockDim.x) {
    const int r = i / CH, c = i % CH;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (q0 + r < a.S)
      val = *reinterpret_cast<const uint4*>(q + (q0 + r) * a.qs.s + c * 8);
    *reinterpret_cast<uint4*>(qp_s + r * LDQ + c * 8) = val;
  }
  __syncthreads();
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qf[D / 16];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wmma::load_matrix_sync(qf[kk], qp_s + warp * 16 * LDQ + kk * 16, LDQ);

  // softmax ownership: lanes 2r and 2r+1 hold row warp*16 + r, one half each
  const int srow = warp * 16 + lane / 2;
  const int scol = (lane % 2) * (BK / 2);
  const int qpos = q0 + srow;
  float m_run = NEG_INF, l_run = 0.f;
  float acc[NO];  // lane owns element e = lane + 32*i of the warp's 16 x D rows
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = 0.f;

  int lo, hi;
  kv_range(q0, a.S, a.window, BK, &lo, &hi);
  for (int k0 = lo; k0 < hi; k0 += BK) {
    __syncthreads();  // every warp is done with the previous K/V tile
    for (int i = threadIdx.x; i < BK * CH; i += blockDim.x) {
      const int r = i / CH, c = i % CH;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (k0 + r < a.S) {
        kv = *reinterpret_cast<const uint4*>(k + (k0 + r) * a.ks.s + c * 8);
        vv = *reinterpret_cast<const uint4*>(v + (k0 + r) * a.vs.s + c * 8);
      }
      *reinterpret_cast<uint4*>(k_s + r * LDQ + c * 8) = kv;
      *reinterpret_cast<uint4*>(v_s + r * LDQ + c * 8) = vv;
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows
#pragma unroll
    for (int nb = 0; nb < BK / 16; ++nb) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sf;
      wmma::fill_fragment(sf, 0.f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kf;
        wmma::load_matrix_sync(kf, k_s + nb * 16 * LDQ + kk * 16, LDQ);
        wmma::mma_sync(sf, qf[kk], kf, sf);
      }
      wmma::store_matrix_sync(s_s + warp * 16 * LDS + nb * 16, sf, LDS,
                              wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax over this lane's half row
    const bool full = tile_full(q0, k0, BK, a.window);
    float* srow_p = s_s + srow * LDS + scol;
    float tmax = NEG_INF;
    for (int j = 0; j < BK / 2; ++j) {
      const float s = srow_p[j] * a.scale;
      srow_p[j] = s;
      if (full || valid_pair(qpos, k0 + scol + j, a.window)) tmax = fmaxf(tmax, s);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    const float m_new = fmaxf(m_run, tmax);
    const float alpha = expf(m_run - m_new);
    bf16* prow = qp_s + srow * LDP + scol;
    float psum = 0.f;
    for (int j = 0; j < BK / 2; ++j) {
      const bool ok = full || valid_pair(qpos, k0 + scol + j, a.window);
      const float p = ok ? expf(srow_p[j] - m_new) : 0.f;
      psum += p;
      prow[j] = __float2bfloat16(p);
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    l_run = l_run * alpha + psum;
    m_run = m_new;
    if (lane % 2 == 0) alpha_s[srow] = alpha;
    __syncwarp();

    // this tile's P.V for the warp's rows, staged in its rows of s_s
#pragma unroll
    for (int nd = 0; nd < D / 16; ++nd) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> of;
      wmma::fill_fragment(of, 0.f);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pf;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vf;
        wmma::load_matrix_sync(pf, qp_s + warp * 16 * LDP + kk * 16, LDP);
        wmma::load_matrix_sync(vf, v_s + kk * 16 * LDQ + nd * 16, LDQ);
        wmma::mma_sync(of, pf, vf, of);
      }
      wmma::store_matrix_sync(s_s + warp * 16 * LDS + nd * 16, of, LDS,
                              wmma::mem_row_major);
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < NO; ++i) {
      const int e = lane + 32 * i, r = warp * 16 + e / D, c = e % D;
      acc[i] = acc[i] * alpha_s[r] + s_s[r * LDS + c];
    }
  }

  if (lane % 2 == 0) l_s[srow] = l_run;
  __syncwarp();
#pragma unroll
  for (int i = 0; i < NO; ++i) {
    const int e = lane + 32 * i, r = warp * 16 + e / D, c = e % D;
    if (q0 + r < a.S)
      o[(q0 + r) * a.os.s + c] = __float2bfloat16(acc[i] / fmaxf(l_s[r], 1e-30f));
  }
}

// ---------------------------------------------------------------------------
// float32: scalar FMA, one thread per query row, 64 threads per block.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(BQ) flash_f32_kernel(Args a) {
  __shared__ __align__(16) float k_s[BKS][D];
  __shared__ __align__(16) float v_s[BKS][D];

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (a.H / a.K);
  const int q0 = qt * BQ;
  const int qpos = q0 + threadIdx.x;
  const bool active = qpos < a.S;
  const float* q = static_cast<const float*>(a.q) + b * a.qs.b + h * a.qs.h;
  const float* k = static_cast<const float*>(a.k) + b * a.ks.b + kh * a.ks.h;
  const float* v = static_cast<const float*>(a.v) + b * a.vs.b + kh * a.vs.h;
  float* o = static_cast<float*>(a.o) + b * a.os.b + h * a.os.h;

  float qr[D], acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = active ? q[qpos * a.qs.s + d] * a.scale : 0.f;
    acc[d] = 0.f;
  }
  float m_run = NEG_INF, l_run = 0.f;

  int lo, hi;
  kv_range(q0, a.S, a.window, BKS, &lo, &hi);
  for (int k0 = lo; k0 < hi; k0 += BKS) {
    __syncthreads();
    for (int i = threadIdx.x; i < BKS * D / 4; i += blockDim.x) {
      const int r = i / (D / 4), c = (i % (D / 4)) * 4;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (k0 + r < a.S) {
        kv = *reinterpret_cast<const float4*>(k + (k0 + r) * a.ks.s + c);
        vv = *reinterpret_cast<const float4*>(v + (k0 + r) * a.vs.s + c);
      }
      *reinterpret_cast<float4*>(&k_s[r][c]) = kv;
      *reinterpret_cast<float4*>(&v_s[r][c]) = vv;
    }
    __syncthreads();
    if (!active) continue;

    const bool full = tile_full(q0, k0, BKS, a.window);
    float s[BKS];
    float tmax = NEG_INF;
#pragma unroll
    for (int j = 0; j < BKS; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; d += 4) {
        const float4 kk = *reinterpret_cast<const float4*>(&k_s[j][d]);
        dot += qr[d] * kk.x + qr[d + 1] * kk.y + qr[d + 2] * kk.z + qr[d + 3] * kk.w;
      }
      s[j] = dot;
      if (full || valid_pair(qpos, k0 + j, a.window)) tmax = fmaxf(tmax, dot);
    }
    const float m_new = fmaxf(m_run, tmax);
    const float alpha = expf(m_run - m_new);
    l_run *= alpha;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] *= alpha;
#pragma unroll
    for (int j = 0; j < BKS; ++j) {
      const bool ok = full || valid_pair(qpos, k0 + j, a.window);
      const float p = ok ? expf(s[j] - m_new) : 0.f;
      l_run += p;
#pragma unroll
      for (int d = 0; d < D; d += 4) {
        const float4 vv = *reinterpret_cast<const float4*>(&v_s[j][d]);
        acc[d] += p * vv.x;
        acc[d + 1] += p * vv.y;
        acc[d + 2] += p * vv.z;
        acc[d + 3] += p * vv.w;
      }
    }
    m_run = m_new;
  }
  if (active) {
    const float inv = 1.f / fmaxf(l_run, 1e-30f);
#pragma unroll
    for (int d = 0; d < D; ++d) o[qpos * a.os.s + d] = acc[d] * inv;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t.
extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, void* o,
    int B, int H, int K, int S, int D,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss,
    int window, int dtype, void* stream) {
  if (B < 1 || S < 1 || K < 1 || H % K != 0) return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q; a.k = k; a.v = v; a.o = o;
  a.H = H; a.K = K; a.S = S;
  a.qs = {q_sb, q_sh, q_ss};
  a.ks = {k_sb, k_sh, k_ss};
  a.vs = {v_sb, v_sh, v_ss};
  a.os = {o_sb, o_sh, o_ss};
  a.window = window;
  a.scale = 1.0f / sqrtf((float)D);
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && D == 64) {
    flash_bf16_kernel<64><<<grid, 128, 0, st>>>(a);
  } else if (dtype == 1 && D == 32) {
    flash_bf16_kernel<32><<<grid, 128, 0, st>>>(a);
  } else if (dtype == 0 && D == 64) {
    flash_f32_kernel<64><<<grid, BQ, 0, st>>>(a);
  } else if (dtype == 0 && D == 32) {
    flash_f32_kernel<32><<<grid, BQ, 0, st>>>(a);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
