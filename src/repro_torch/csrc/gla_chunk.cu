// Chunked gated linear attention (GLA) for NVIDIA Hopper (sm_90a): both
// schedules of the JAX package's Pallas kernels, and the backward.
//
// Replaces: src/repro/kernels/mlstm_chunk.py::_kernel (gla_chunk: K4 here,
// repro_gla_chunk; for training repro_gla_chunk_starts, which also writes
// the state entering each chunk) and ::_phase_a_kernel / ::_phase_b_kernel
// (gla_chunk_parallel: K5 here, repro_gla_phase_a / repro_gla_phase_b).
// The backward (K4b, repro_gla_chunk_bwd, after the forward kernels)
// replaces no Pallas kernel: the JAX package differentiates the plain-XLA
// models/ssm.py chunked_gla; its design note opens its section below.
//
// For each row b and head h, the recurrence
//   h_t = exp(lg_t) h_{t-1} + k_t v_t^T,    y_t = q_t . h_t
// is computed over chunks of c positions, as the Pallas kernels do:
//   intra:  y_i  = sum_{j <= i in the chunk} (q_i . k_j) exp(cum_i - cum_j) v_j
//   inter:  y_i += (q_i exp(cum_i)) . state
//   state:  state = exp(total) state + sum_j (k_j exp(total - cum_j)) v_j^T
// with cum the inclusive cumsum of lg within the chunk and total its last
// value. q, k: [B,S,H,N]; v: [B,S,H,P]; lg: [B,S,H] float32 (<= 0); each
// taken by its element strides (last dim contiguous), so the model's
// head-broadcast q and k (head stride 0) are read in place. Outputs are
// contiguous: y [B,S,H,P] in v's type, the final state [B,H,N,P] float32
// (K4; the Pallas kernel drops it, the model's prefill cache needs it),
// phase A's per-chunk g = exp(total) [B,H,nc] and state delta [B,H,nc,N,P]
// float32. All sums are float32.
//
// Bound: at hymba's serving shape (B4 S1536 H25 N16 P64, c 256, bf16) the
// work is about 3.8 GFLOP, mostly the intra-chunk products (c^2 (N+P) per
// chunk), against about 41 MB moved (v and y dominate; q and k are one
// [B,S,N] row each per position): 12.2 us of device memory at 3.35 TB/s
// (K4; phase A 12.8, phase B 12.7 us), 4 us of bf16 tensor-core time.
// Device-memory bytes bound it.
//
// bf16 design (tensor cores), one per-chunk core in three kernels:
//  * The TPU runs the chunk axis as a sequential grid dimension with the
//    [N,P] state in VMEM. Here y[:, p] and state[:, p] depend only on
//    v[:, p], so a block owns a PW = 32 column slice of P: K4 is one block
//    per (b, h, slice), 2B*H at P 64, walking the chunks in order with its
//    [16,PW] state slice in shared memory. The phases are persistent: as
//    many blocks as fit walk the (b, h, chunk, slice) items.
//  * Two stages: the next chunk's (item's) rows load by cp.async while this
//    one computes, its lg first, so that its cum and decays are computed in
//    this one's tail between the barriers the state partials need anyway.
//  * A chunk's q and k rows (N bf16, zero-padded to 16), its v slice (phase
//    B: y_intra's) and its lg are staged in XOR-swizzled shared rows, so
//    every ldmatrix is free of bank conflicts. The 8 warps own 16-row query
//    tiles, tile t paired with T-1-t so the causal triangle is balanced; a
//    warp's two tiles share each key tile's loads and give each step two
//    independent chains.
//  * For each key tile J <= I: S = Q_I K_J^T by mma.sync m16n8k16 (bf16 in,
//    float32 sums; N = 8 runs as 16 with zero columns), the decay applied to
//    the S fragment in registers, rounded to bf16 as P.V's A fragment (as
//    K1 rounds its probabilities), and O_I += P V_J with V_J through
//    ldmatrix.trans. Off the diagonal the decay takes no per-element
//    exponential: exp(cum_i - cum_j) = al_i g_IJ bk_j with al_i =
//    exp(cum_i - cum_{16I-1}), g_IJ = exp(cum_{16I-1} - cum_{16J+15}) (one
//    number for the tile pair) and bk_j = exp(cum_{16J+15} - cum_j), each
//    <= 1 as cum does not increase, so none overflows. A step multiplies S
//    by g bk_j; the tile's sum of such steps takes al_i once, before its
//    diagonal step, which takes one exp2 per element under the causal mask.
//  * Inter term and state update stay float32 on the tensor cores by a bf16
//    hi/lo split of the float32 operand: y_I += diag(exp(cum_I)) (Q_I .
//    (state_hi + state_lo)) with Q_I exact in bf16, and the delta (K
//    diag(w))^T V with K diag(w) split likewise and V exact. Each warp sums
//    its key tiles; the 8 warps' partials are added in warp order by one
//    thread per element: no atomics, deterministic.
//  * y leaves through a per-warp staging tile in shared memory as 16-byte
//    stores, a row's 64-byte slice in 4 of them.
//  * The cumsum is 32-wide warp scans plus the segments' totals added in
//    order, one fixed order, so phase B recomputes exactly phase A's cum.
// On an H100 80GB HBM3 at 700 W (PERF.md) this takes K4 from 665 to
// 51 us, phase A from 467 to 40 us and phase B from 226 to 23 us: 4.2x,
// 3.1x and 1.8x the bound. Loads alone take 15, 14 and 12 us
// (tools/gla_breakdown.py), and the compute adds to them: a K4 chunk's
// intra rows, about 45% of its cycles, are split between instruction issue
// and the mma.sync pipe at 16 warps an SM, and K4's 200 chains leave 64 of
// the 132 SMs with one block. 16-column slices (GLA_PW=16) are slower
// (K4 88, phase A 60, phase B 29 us): each slice still computes all of
// S = Q K^T, and at 3 blocks an SM ptxas spills.
// float32 keeps exact scalar products (no TF32): one block per (b, h) for
// K4 and per (b, h, chunk) for the phases, one thread per query row over
// the chunk staged as float32 (the slice-1 design).
//
// Each entry point launches one kernel on the caller's stream and returns
// cudaGetLastError().
//
// Diagnostic builds (tools/gla_breakdown.py passes these with -D; the
// shipped build defines none): GLA_PW=16 builds the bf16 kernels on 16-column
// slices; GLA_LOADONLY stops each bf16 chunk (item) after its loads and the
// barrier that waits for them; GLA_NOEXP makes every ex2 return its
// argument; GLA_CLOCK prints one K4 block's phases at chunk 3 in clock64
// cycles. Their outputs are wrong by design except GLA_PW's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#ifdef GLA_CLOCK
#include <cstdio>
#define GLA_STAMP(k) stamp[k] = clock64()
#define GLA_STAMP_DECL(n) long long stamp[n]
#else
#define GLA_STAMP(k)
#define GLA_STAMP_DECL(n)
#endif

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr size_t MAX_SMEM = 232448;  // a block's shared memory on sm_90
constexpr float LOG2E = 1.4426950408889634f;
#ifndef GLA_PW
#define GLA_PW 32
#endif
constexpr int PW = GLA_PW;           // the bf16 kernels' P slice, columns
// K4's and phase A's blocks an SM, for ptxas's register budget
constexpr int MIN_BLOCKS = PW == 16 ? 3 : 2;

// BWD: K4b as a whole (its largest block); BWD_STATE: its state pass's layout
enum Which { CHUNK = 0, PHASE_A = 1, PHASE_B = 2, BWD = 3, BWD_STATE = 4 };

// Element strides of a [B,S,H,*] operand.
struct Strides {
  long long b, s, h;
  __device__ __forceinline__ long long at(int bi, int t, int h_) const {
    return bi * b + t * s + h_ * this->h;
  }
};

template <typename T>
struct GlaIn {
  const T* q;
  const T* k;
  const T* v;
  const float* lg;
  Strides sq, sk, sv, sl;
  int S, H, c, B;
};

// The backward's other operands: dy [B,S,H,P] by its strides, K4's chunk
// start states [B,H,nc,N,P] float32, and the gradients, contiguous: dq, dk
// [B,S,H,N] float32 per head, dv [B,S,H,P] in v's type, dlg [B,S,H] float32.
template <typename T>
struct BwdIO {
  const T* dy;
  Strides sdy;
  const float* starts;
  float* dq;
  float* dk;
  T* dv;
  float* dlg;
};

// ===========================================================================
// float32: exact scalar products
// ===========================================================================

// Shared memory of a float32 block: the chunk's K rows [c][N], V rows
// [c][P], cum [c], exp(total - cum) [c] and the state [N][P], all float32;
// phase B: cum [c] and the start state [N][P].
__host__ __device__ size_t smem_f32(Which which, int c, int N, int P) {
  return sizeof(float) * (which == PHASE_B ? (size_t)c + N * P : (size_t)c * (N + P + 2) + N * P);
}

// x[0..n) scanned in place into its inclusive cumsum by warp 0, 32-wide
// shuffle steps with a carry: one fixed order. Not synchronised.
__device__ void scan_rows(float* x, int n) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  float carry = 0.f;
  for (int base = 0; base < n; base += 32) {
    const int i = base + lane;
    float v = i < n ? x[i] : 0.f;
#pragma unroll
    for (int o = 1; o < 32; o *= 2) {
      const float y = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += y;
    }
    v += carry;
    if (i < n) x[i] = v;
    carry = __shfl_sync(0xffffffffu, v, 31);
  }
}

// Stage the chunk's lg and scan it in place into its inclusive cumsum.
// Ends synchronised.
__device__ void stage_cum(const GlaIn<float>& in, int b, int h, int t0, float* cum_s) {
  for (int j = threadIdx.x; j < in.c; j += blockDim.x)
    cum_s[j] = in.lg[in.sl.at(b, t0 + j, h)];
  __syncthreads();
  scan_rows(cum_s, in.c);
  __syncthreads();
}

template <int N, int P>
__device__ void stage_kv(const GlaIn<float>& in, int b, int h, int t0, float* k_s, float* v_s) {
  for (int e = threadIdx.x; e < in.c * N; e += blockDim.x)
    k_s[e] = in.k[in.sk.at(b, t0 + e / N, h) + e % N];
  for (int e = threadIdx.x; e < in.c * P; e += blockDim.x)
    v_s[e] = in.v[in.sv.at(b, t0 + e / P, h) + e % P];
}

template <int N>
__device__ __forceinline__ void load_q(const GlaIn<float>& in, int b, int h, int t, float* qi) {
  const float* qr = in.q + in.sq.at(b, t, h);
#pragma unroll
  for (int n = 0; n < N; ++n) qi[n] = qr[n];
}

// acc += row i's intra-chunk output: sum_{j<=i} (q_i.k_j) exp(cum_i - cum_j) v_j.
template <int N, int P>
__device__ __forceinline__ void intra_row(const float* qi, int i, const float* k_s,
                                          const float* v_s, const float* cum_s, float* acc) {
  const float ci = cum_s[i];
  for (int j = 0; j <= i; ++j) {
    float s = 0.f;
#pragma unroll
    for (int n = 0; n < N; ++n) s += qi[n] * k_s[j * N + n];
    s *= expf(ci - cum_s[j]);
#pragma unroll
    for (int p = 0; p < P; ++p) acc[p] += s * v_s[j * P + p];
  }
}

// acc += (q_i exp(cum_i)) . state
template <int N, int P>
__device__ __forceinline__ void inter_row(const float* qi, float ci, const float* state_s,
                                          float* acc) {
  const float e = expf(ci);
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const float qn = qi[n] * e;
#pragma unroll
    for (int p = 0; p < P; ++p) acc[p] += qn * state_s[n * P + p];
  }
}

// Element e = n*P + p of the chunk's state delta, sum_j k_j[n] w_j v_j[p]
// with w_j = exp(total - cum_j), j in order.
template <int N, int P>
__device__ __forceinline__ float delta_elem(int e, int c, const float* k_s, const float* v_s,
                                            const float* w_s) {
  const int n = e / P, p = e % P;
  float d = 0.f;
  for (int j = 0; j < c; ++j) d += k_s[j * N + n] * w_s[j] * v_s[j * P + p];
  return d;
}

// K4, float32. Grid (B*H); one block per (b, h) walks the chunks in order.
template <int N, int P>
__global__ void __launch_bounds__(THREADS)
    gla_chunk_f32_kernel(GlaIn<float> in, float* __restrict__ y, float* __restrict__ state_out,
                         float* __restrict__ starts) {
  extern __shared__ __align__(16) float smf[];
  const int c = in.c, nc = in.S / c, H = in.H;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  float* k_s = smf;
  float* v_s = k_s + c * N;
  float* cum_s = v_s + c * P;
  float* w_s = cum_s + c;
  float* state_s = w_s + c;
  for (int e = threadIdx.x; e < N * P; e += blockDim.x) state_s[e] = 0.f;

  for (int ci = 0; ci < nc; ++ci) {
    const int t0 = ci * c;
    __syncthreads();  // the previous chunk is done with k_s, v_s, cum_s, w_s
    if (starts != nullptr) {  // the state entering this chunk, for the backward
      float* so = starts + ((long long)blockIdx.x * nc + ci) * N * P;
      for (int e = threadIdx.x; e < N * P; e += blockDim.x) so[e] = state_s[e];
    }
    stage_kv<N, P>(in, b, h, t0, k_s, v_s);
    stage_cum(in, b, h, t0, cum_s);
    for (int i = threadIdx.x; i < c; i += blockDim.x) {
      float qi[N], acc[P];
      load_q<N>(in, b, h, t0 + i, qi);
#pragma unroll
      for (int p = 0; p < P; ++p) acc[p] = 0.f;
      intra_row<N, P>(qi, i, k_s, v_s, cum_s, acc);
      inter_row<N, P>(qi, cum_s[i], state_s, acc);
      float* out = y + (((long long)b * in.S + t0 + i) * H + h) * P;
#pragma unroll
      for (int p = 0; p < P; ++p) out[p] = acc[p];
    }
    const float total = cum_s[c - 1];
    for (int j = threadIdx.x; j < c; j += blockDim.x) w_s[j] = expf(total - cum_s[j]);
    __syncthreads();  // every row has read the state; w_s is filled
    const float g = expf(total);
    for (int e = threadIdx.x; e < N * P; e += blockDim.x)
      state_s[e] = state_s[e] * g + delta_elem<N, P>(e, c, k_s, v_s, w_s);
  }
  float* so = state_out + ((long long)b * H + h) * N * P;
  for (int e = threadIdx.x; e < N * P; e += blockDim.x) so[e] = state_s[e];
}

// K5 phase A, float32. Grid (nc, B*H): the intra-chunk output, g and the
// state delta of one (b, h, chunk).
template <int N, int P>
__global__ void __launch_bounds__(THREADS)
    gla_phase_a_f32_kernel(GlaIn<float> in, float* __restrict__ y_intra,
                           float* __restrict__ g_out, float* __restrict__ d_out) {
  extern __shared__ __align__(16) float smf[];
  const int c = in.c, H = in.H, ci = blockIdx.x, nc = gridDim.x;
  const int b = blockIdx.y / H, h = blockIdx.y % H, t0 = ci * c;
  float* k_s = smf;
  float* v_s = k_s + c * N;
  float* cum_s = v_s + c * P;
  float* w_s = cum_s + c;
  stage_kv<N, P>(in, b, h, t0, k_s, v_s);
  stage_cum(in, b, h, t0, cum_s);
  for (int i = threadIdx.x; i < c; i += blockDim.x) {
    float qi[N], acc[P];
    load_q<N>(in, b, h, t0 + i, qi);
#pragma unroll
    for (int p = 0; p < P; ++p) acc[p] = 0.f;
    intra_row<N, P>(qi, i, k_s, v_s, cum_s, acc);
    float* out = y_intra + (((long long)b * in.S + t0 + i) * H + h) * P;
#pragma unroll
    for (int p = 0; p < P; ++p) out[p] = acc[p];
  }
  const float total = cum_s[c - 1];
  for (int j = threadIdx.x; j < c; j += blockDim.x) w_s[j] = expf(total - cum_s[j]);
  __syncthreads();
  const long long chunk = (long long)blockIdx.y * nc + ci;
  float* d = d_out + chunk * N * P;
  for (int e = threadIdx.x; e < N * P; e += blockDim.x)
    d[e] = delta_elem<N, P>(e, c, k_s, v_s, w_s);
  if (threadIdx.x == 0) g_out[chunk] = expf(total);
}

// K5 phase B, float32. Grid (nc, B*H): y = y_intra + (q exp(cum)) . start.
template <int N, int P>
__global__ void __launch_bounds__(THREADS)
    gla_phase_b_f32_kernel(GlaIn<float> in, const float* __restrict__ start,
                           const float* __restrict__ y_intra, float* __restrict__ y) {
  extern __shared__ __align__(16) float smf[];
  const int c = in.c, H = in.H, ci = blockIdx.x, nc = gridDim.x;
  const int b = blockIdx.y / H, h = blockIdx.y % H, t0 = ci * c;
  float* cum_s = smf;
  float* state_s = cum_s + c;
  const float* st = start + ((long long)blockIdx.y * nc + ci) * N * P;
  for (int e = threadIdx.x; e < N * P; e += blockDim.x) state_s[e] = st[e];
  stage_cum(in, b, h, t0, cum_s);  // its barriers also cover state_s
  for (int i = threadIdx.x; i < c; i += blockDim.x) {
    float qi[N], acc[P];
    load_q<N>(in, b, h, t0 + i, qi);
    const long long row = (((long long)b * in.S + t0 + i) * H + h) * P;
#pragma unroll
    for (int p = 0; p < P; ++p) acc[p] = y_intra[row + p];
    inter_row<N, P>(qi, cum_s[i], state_s, acc);
#pragma unroll
    for (int p = 0; p < P; ++p) y[row + p] = acc[p];
  }
}

// ===========================================================================
// bf16: tensor cores (mma.sync m16n8k16, bf16 in, float32 sums)
// ===========================================================================

// 16 bytes (8: cp8; 4: cp4) from global to shared, or zeros when !full
__device__ __forceinline__ void cp16(uint32_t dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(full ? 16 : 0));
}
__device__ __forceinline__ void cp8(uint32_t dst, const void* src, bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(src),
               "r"(full ? 8 : 0));
}
__device__ __forceinline__ void cp4(uint32_t dst, const void* src, bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(full ? 4 : 0));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int n>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
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

// d += a . b for one m16n8k16 tile: a row-major 16x16, b 16x8, both bf16
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}
// (lo, hi) -> one register, lo in the low half (the lower column)
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  return bits(__floats2bfloat162_rn(lo, hi));
}
__device__ __forceinline__ float2 unpack(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u));
}
// 2^x in one SFU op (denormals flush to 0, where every use is below
// float32's range anyway)
__device__ __forceinline__ float ex2(float x) {
#ifdef GLA_NOEXP
  return x;
#else
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
#endif
}
// x = hi + lo to about 16 bits, each a bf16 pair
__device__ __forceinline__ void split(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = pack(x0 - hf.x, x1 - hf.y);
}

// Byte offset of 16-byte piece ch of row r, in rows of CH pieces, XOR-swizzled
// so that the eight rows of one ldmatrix 8x8 load hit distinct bank groups.
template <int CH>
__device__ __forceinline__ uint32_t swz(int r, int ch) {
  return (uint32_t)(r * CH + (ch ^ ((r / (8 / CH)) % CH))) * 16u;
}

// Dynamic shared memory of a bf16 block, byte offsets; rows padded to tc,
// the chunk rounded up to 16. Two stages, one chunk's (K4) or one item's
// (the phases) while the other computes: q rows and (not phase B or K4b's
// state pass) k rows [tc][16] bf16, the PW-column slice of v (phase B: of
// y_intra; the state pass: of dy) [tc][PW]
// bf16, lg [tc] float32 (scanned in place), and in phase B the item's start
// state slice [16][PW] float32. Two sets of the decays, one a stage, from
// dset, dsz bytes each: cl = cum log2(e), bk, al, w, e [tc] float32 and the
// scan's segment totals (K4b's state pass: one stage and one set). K4's
// state slice [16][PW] float32. The warps'
// scratch, wsz bytes each: state partials [16][PW + 4] float32 (K4, phase
// A), also the staged output rows [16][PW] bf16.
struct Layout {
  int stage, q, k, v, lg, st0, dset, dsz, cl, bk, al, w, e, tot, state, scratch, wsz, total;
  __host__ __device__ Layout(Which which, int c) {
    const int tc = (c + 15) & ~15;
    q = 0;
    k = q + tc * 32;
    v = k + (which == PHASE_B || which == BWD_STATE ? 0 : tc * 32);
    lg = v + tc * PW * 2;
    st0 = lg + tc * 4;
    stage = st0 + (which == PHASE_B ? 16 * PW * 4 : 0);
    const int sets = which == BWD_STATE ? 1 : 2;  // K4b's state pass: one chunk a block
    dset = sets * stage;
    cl = 0;
    bk = cl + tc * 4;
    al = bk + tc * 4;
    w = al + tc * 4;
    e = w + tc * 4;
    tot = e + tc * 4;
    dsz = tot + (((tc + 31) / 32 * 4 + 15) & ~15);
    state = dset + sets * dsz;
    scratch = state + (which == CHUNK ? 16 * PW * 4 : 0);
    wsz = which == PHASE_B ? 16 * PW * 2 : 16 * (PW + 4) * 4;
    total = scratch + WARPS * wsz;
  }
};

// Work item it of (b, h, chunk, slice): slice fastest, then chunk, then
// (b, h). K4's blocks walk one (b, h, slice)'s chunks; the phases' blocks
// walk every gridDim-th item.
struct Item {
  int slice, ci, bh;
  __device__ __forceinline__ Item(int it, int ns, int nc)
      : slice(it % ns), ci(it / ns % nc), bh(it / (ns * nc)) {}
};

// Stage rows [t0, t0 + c) of (b, h) by cp.async (not committed): q and, when
// K, k rows (N bf16, zero-padded to 16 columns), v's columns [p0, p0 + PW).
// Rows c..tc-1 are zeros.
template <int N, bool K>
__device__ void stage_rows(const GlaIn<bf16>& in, int b, int h, int t0, int p0, int tc,
                           unsigned char* st, const Layout& L) {
  constexpr int VCH = PW / 8;
  const int c = in.c;
  const uint32_t qa = smem_addr(st + L.q), ka = smem_addr(st + L.k), va = smem_addr(st + L.v);
  for (int idx = threadIdx.x; idx < tc * 2; idx += THREADS) {
    const int j = idx >> 1, ch = idx & 1;
    const bool ok = j < c && ch * 8 < N;
    cp16(qa + swz<2>(j, ch), in.q + (ok ? in.sq.at(b, t0 + j, h) + ch * 8 : 0), ok);
    if (K) cp16(ka + swz<2>(j, ch), in.k + (ok ? in.sk.at(b, t0 + j, h) + ch * 8 : 0), ok);
  }
  for (int idx = threadIdx.x; idx < tc * VCH; idx += THREADS) {
    const int j = idx / VCH, ch = idx % VCH;
    const bool ok = j < c;
    cp16(va + swz<VCH>(j, ch), in.v + (ok ? in.sv.at(b, t0 + j, h) + p0 + ch * 8 : 0), ok);
  }
}

// Stage the chunk's lg by cp.async (not committed); rows c..tc-1 are zeros.
__device__ void stage_lg(const GlaIn<bf16>& in, int b, int h, int t0, int tc,
                         unsigned char* st, const Layout& L) {
  const uint32_t la = smem_addr(st + L.lg);
  for (int j = threadIdx.x; j < tc; j += THREADS) {
    const bool ok = j < in.c;
    cp4(la + 4 * j, in.lg + (ok ? in.sl.at(b, t0 + j, h) : 0), ok);
  }
}

// Stage phase B's start state slice [16][PW] float32 by cp.async (not
// committed): rows n < N of src (row stride P), zeros below.
template <int N, int P>
__device__ void stage_start(const float* src, unsigned char* st, const Layout& L) {
  constexpr int PCH = PW / 4;   // 16-byte pieces a row
  const uint32_t sa = smem_addr(st + L.st0);
  for (int idx = threadIdx.x; idx < 16 * PCH; idx += THREADS) {
    const int n = idx / PCH, ch = idx % PCH;
    cp16(sa + 16 * idx, src + (n < N ? n * P + ch * 4 : 0), n < N);
  }
}

// The chunk's cum in two passes, one fixed order, so that phase B
// recomputes exactly phase A's: scan_segments runs 32-wide warp scans of
// the staged lg in place and writes the segments' totals; after a barrier,
// chunk_decays adds to each row the totals of the segments before it, in
// order, and writes, for each row j < tc: e = exp(cum_j); and unless phase
// B (!INTRA): cl = cum log2(e); bk = exp(cum_end - cum_j), end the last row
// of j's 16-row tile; al = exp(cum_j - cum_{s-1}), s the first row of j's
// tile (1 in tile 0); w = exp(total - cum_j) (K4b's state pass, CL: cl and
// e only). It returns total = cum_{c-1}.
// Neither synchronises.
__device__ void scan_segments(int tc, unsigned char* st, unsigned char* ds, const Layout& L) {
  float* x_s = reinterpret_cast<float*>(st + L.lg);
  float* tot_s = reinterpret_cast<float*>(ds + L.tot);
  const int lane = threadIdx.x & 31, nseg = (tc + 31) / 32;
  for (int seg = threadIdx.x >> 5; seg < nseg; seg += WARPS) {
    const int i = seg * 32 + lane;
    float x = i < tc ? x_s[i] : 0.f;
#pragma unroll
    for (int o = 1; o < 32; o *= 2) {
      const float y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    if (i < tc) x_s[i] = x;
    if (lane == 31) tot_s[seg] = x;
  }
}
template <bool INTRA, bool CL = INTRA>
__device__ float chunk_decays(int c, int tc, const unsigned char* st, unsigned char* ds,
                              const Layout& L) {
  const float* x_s = reinterpret_cast<const float*>(st + L.lg);
  const float* tot_s = reinterpret_cast<const float*>(ds + L.tot);
  float carry = 0.f;
  for (int s = 0; s < (c - 1) / 32; ++s) carry += tot_s[s];
  const float total = x_s[c - 1] + carry, cl_tot = total * LOG2E;
  float* cl_s = reinterpret_cast<float*>(ds + L.cl);
  float* bk_s = reinterpret_cast<float*>(ds + L.bk);
  float* al_s = reinterpret_cast<float*>(ds + L.al);
  float* w_s = reinterpret_cast<float*>(ds + L.w);
  float* e_s = reinterpret_cast<float*>(ds + L.e);
  for (int j = threadIdx.x; j < tc; j += THREADS) {
    // cj: the carry into j's segment; cp: into the one before (row s - 1 of
    // a tile at the start of a segment lies there)
    float cj = 0.f, cp = 0.f;
    for (int s = 0; s < j / 32; ++s) {
      cp = cj;
      cj += tot_s[s];
    }
    const float cl = (x_s[j] + cj) * LOG2E;
    e_s[j] = ex2(cl);
    if (CL) cl_s[j] = cl;
    if (INTRA) {
      bk_s[j] = ex2((x_s[j | 15] + cj) * LOG2E - cl);
      al_s[j] = j < 16 ? 1.f : ex2(cl - (x_s[(j & ~15) - 1] + (j & 16 ? cj : cp)) * LOG2E);
      w_s[j] = ex2(cl_tot - cl);
    }
  }
  return total;
}

// Q_I's A fragment: rows 16I.., the 16 (padded) columns of q
__device__ __forceinline__ void load_qa(uint32_t (&qa)[4], uint32_t q_a, int I) {
  const int lane = threadIdx.x & 31, m = lane >> 3, r = lane & 7;
  ldsm(qa, q_a + swz<2>(16 * I + (m & 1) * 8 + r, m >> 1));
}

// A lane's ldmatrix addresses for key tile 0; tile J is KT * J (k) or
// VT * J (v) bytes further (the swizzles repeat every 16 rows). kl: K_J as
// S's B operand (also, transposed, the delta's A operand); vl[cp]: V_J's
// column tiles 2cp and 2cp + 1 as P.V's B operand, transposed.
constexpr uint32_t KT = 16 * 32, VT = 16 * PW * 2;
struct KvLanes {
  uint32_t kl, vl[PW / 16];
  __device__ __forceinline__ KvLanes(uint32_t k_a, uint32_t v_a) {
    const int lane = threadIdx.x & 31, m = lane >> 3, r = lane & 7;
    kl = k_a + swz<2>((m >> 1) * 8 + r, m & 1);
#pragma unroll
    for (int cp = 0; cp < PW / 16; ++cp) vl[cp] = v_a + swz<PW / 8>((m & 1) * 8 + r, 2 * cp + (m >> 1));
  }
  __device__ __forceinline__ void v(int J, uint32_t (&vb)[PW / 16][4]) const {
#pragma unroll
    for (int cp = 0; cp < PW / 16; ++cp) ldsm_t(vb[cp], vl[cp] + VT * J);
  }
  __device__ __forceinline__ void kv(int J, uint32_t (&kb)[4], uint32_t (&vb)[PW / 16][4]) const {
    ldsm(kb, kl + KT * J);
    v(J, vb);
  }
};

// S = Q_I K_J^T for one query tile against one key tile
__device__ __forceinline__ void scores(const uint32_t (&qa)[4], const uint32_t (&kb)[4],
                                       float (&s)[2][4]) {
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int x = 0; x < 4; ++x) s[nt][x] = 0.f;
  mma(s[0], qa, kb[0], kb[1]);
  mma(s[1], qa, kb[2], kb[3]);
}

// o += P V_J, P = s rounded to bf16 pairs as the A fragment (as K1 rounds
// its probabilities)
__device__ __forceinline__ void pv(const float (&s)[2][4], const uint32_t (&vb)[PW / 16][4],
                                   float (&o)[PW / 8][4]) {
  const uint32_t pa[4] = {pack(s[0][0], s[0][1]), pack(s[0][2], s[0][3]),
                          pack(s[1][0], s[1][1]), pack(s[1][2], s[1][3])};
#pragma unroll
  for (int cp = 0; cp < PW / 16; ++cp) {
    mma(o[2 * cp], pa, vb[cp][0], vb[cp][1]);
    mma(o[2 * cp + 1], pa, vb[cp][2], vb[cp][3]);
  }
}

// Query tile I against key tile J < I. The decay exp(cum_i - cum_j) factors
// as al_i * g * bk_j with g = exp(cum_{16I-1} - cum_{16J+15}), one number
// for the tile pair, and every factor <= 1 (cum does not increase), so none
// overflows: this step multiplies S by g bk_j only, and the caller scales
// the tile's sum of these steps by al_i once, before its diagonal step.
// ce: cl of row 16I - 1.
__device__ __forceinline__ void off_step(int J, float ce, const uint32_t (&qa)[4],
                                         const uint32_t (&kb)[4],
                                         const uint32_t (&vb)[PW / 16][4], const float* cl_s,
                                         const float* bk_s, float (&o)[PW / 8][4]) {
  const int t = threadIdx.x & 3;
  float s[2][4];
  scores(qa, kb, s);
  const float g = ex2(ce - cl_s[16 * J + 15]);
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    const float2 bb = *reinterpret_cast<const float2*>(bk_s + 16 * J + 8 * nt + 2 * t);
    const float b0 = g * bb.x, b1 = g * bb.y;
    s[nt][0] *= b0;
    s[nt][1] *= b1;
    s[nt][2] *= b0;
    s[nt][3] *= b1;
  }
  pv(s, vb, o);
}

// Query tile I's diagonal step: o *= al (the off-diagonal sum's row factor),
// then o += its own key tile, one exp2 per element under the causal mask.
__device__ __forceinline__ void diag_step(int I, const uint32_t (&qa)[4],
                                          const uint32_t (&kb)[4],
                                          const uint32_t (&vb)[PW / 16][4], const float* cl_s,
                                          const float* al_s, float (&o)[PW / 8][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3, i0 = 16 * I + g;
  const float c0 = cl_s[i0], c1 = cl_s[i0 + 8], a0 = al_s[i0], a1 = al_s[i0 + 8];
  float s[2][4];
  scores(qa, kb, s);
#pragma unroll
  for (int nt = 0; nt < PW / 8; ++nt) {
    o[nt][0] *= a0;
    o[nt][1] *= a0;
    o[nt][2] *= a1;
    o[nt][3] *= a1;
  }
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int di = (x < 2 ? 0 : 8) - (8 * nt + 2 * t + (x & 1));  // i - j
      const float dec = ex2((x < 2 ? c0 : c1) - cl_s[16 * I + 8 * nt + 2 * t + (x & 1)]);
      s[nt][x] = g + di >= 0 ? s[nt][x] * dec : 0.f;
    }
  }
  pv(s, vb, o);
}

// A warp's pair of query tiles I0 < I1 (I0 < 0: tile I1 alone): o0, o1 +=
// their decayed intra products over key tiles 0..I. The two share each key
// tile's fragments, and their steps are two independent chains.
__device__ __forceinline__ void intra_pair(int I0, int I1, const uint32_t (&q0)[4],
                                           const uint32_t (&q1)[4], const KvLanes& ln,
                                           const float* cl_s, const float* bk_s,
                                           const float* al_s, float (&o0)[PW / 8][4],
                                           float (&o1)[PW / 8][4]) {
  const float e1 = I1 > 0 ? cl_s[16 * I1 - 1] : 0.f, e0 = I0 > 0 ? cl_s[16 * I0 - 1] : 0.f;
  uint32_t kb[4], vb[PW / 16][4];
  int J = 0;
  for (; J < I0; ++J) {
    ln.kv(J, kb, vb);
    off_step(J, e1, q1, kb, vb, cl_s, bk_s, o1);
    off_step(J, e0, q0, kb, vb, cl_s, bk_s, o0);
  }
  if (I0 >= 0) {
    ln.kv(I0, kb, vb);
    off_step(I0, e1, q1, kb, vb, cl_s, bk_s, o1);
    diag_step(I0, q0, kb, vb, cl_s, al_s, o0);
    ++J;
  }
  for (; J < I1; ++J) {
    ln.kv(J, kb, vb);
    off_step(J, e1, q1, kb, vb, cl_s, bk_s, o1);
  }
  ln.kv(I1, kb, vb);
  diag_step(I1, q1, kb, vb, cl_s, al_s, o1);
}

// A state [16][PW] float32 (rows n, columns p) as B fragments of the PW/8
// column tiles, hi and lo: sb[nt] = {hi b0, hi b1, lo b0, lo b1}.
__device__ __forceinline__ void state_frags(const float* st, uint32_t (&sb)[PW / 8][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < PW / 8; ++nt) {
    const int p = 8 * nt + g;
    split(st[2 * t * PW + p], st[(2 * t + 1) * PW + p], sb[nt][0], sb[nt][2]);
    split(st[(2 * t + 8) * PW + p], st[(2 * t + 9) * PW + p], sb[nt][1], sb[nt][3]);
  }
}

// o += diag(exp(cum_I)) (Q_I . state), float32 through the hi/lo split;
// e_s = exp(cum)
__device__ __forceinline__ void inter_tile(int I, const uint32_t (&qa)[4],
                                           const uint32_t (&sb)[PW / 8][4], const float* e_s,
                                           float (&o)[PW / 8][4]) {
  const int g = (threadIdx.x & 31) >> 2;
  const float e0 = e_s[16 * I + g], e1 = e_s[16 * I + g + 8];
#pragma unroll
  for (int nt = 0; nt < PW / 8; ++nt) {
    float x[4] = {};
    mma(x, qa, sb[nt][0], sb[nt][1]);
    mma(x, qa, sb[nt][2], sb[nt][3]);
    o[nt][0] += e0 * x[0];
    o[nt][1] += e0 * x[1];
    o[nt][2] += e1 * x[2];
    o[nt][3] += e1 * x[3];
  }
}

// d += this warp's share of the chunk's state delta over its slice,
// sum_{J = warp, warp + 8, ...} (K_J diag(w_J))^T V_J: rows n, columns p.
__device__ __forceinline__ void delta_part(int T, uint32_t k_a, uint32_t v_a, const float* w_s,
                                           float (&d)[PW / 8][4]) {
  const int t = threadIdx.x & 3;
  const KvLanes ln(k_a, v_a);
  for (int J = threadIdx.x >> 5; J < T; J += WARPS) {
    uint32_t ka[4], hi[4], lo[4], vb[PW / 16][4];
    ldsm_t(ka, ln.kl + KT * J);
    ln.v(J, vb);
    const float2 w0 = *reinterpret_cast<const float2*>(w_s + 16 * J + 2 * t);
    const float2 w1 = *reinterpret_cast<const float2*>(w_s + 16 * J + 8 + 2 * t);
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const float2 f = unpack(ka[x]), w = x < 2 ? w0 : w1;
      split(f.x * w.x, f.y * w.y, hi[x], lo[x]);
    }
#pragma unroll
    for (int cp = 0; cp < PW / 16; ++cp) {
      mma(d[2 * cp], hi, vb[cp][0], vb[cp][1]);
      mma(d[2 * cp], lo, vb[cp][0], vb[cp][1]);
      mma(d[2 * cp + 1], hi, vb[cp][2], vb[cp][3]);
      mma(d[2 * cp + 1], lo, vb[cp][2], vb[cp][3]);
    }
  }
}

// The warps' partial deltas, added in warp order: element e of [16][PW].
// The partials sit in the scratch, [8][16][PW + 4] float32.
__device__ __forceinline__ void write_part(const float (&d)[PW / 8][4], float* scr) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float* mine = scr + (threadIdx.x >> 5) * 16 * (PW + 4);
#pragma unroll
  for (int nt = 0; nt < PW / 8; ++nt) {
    *reinterpret_cast<float2*>(mine + g * (PW + 4) + 8 * nt + 2 * t) =
        make_float2(d[nt][0], d[nt][1]);
    *reinterpret_cast<float2*>(mine + (g + 8) * (PW + 4) + 8 * nt + 2 * t) =
        make_float2(d[nt][2], d[nt][3]);
  }
}
__device__ __forceinline__ float sum_parts(const float* scr, int e) {
  const int n = e / PW, p = e % PW;
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) s += scr[(w * 16 + n) * (PW + 4) + p];
  return s;
}

// Store tile I's slice rows (i < c) as bf16 through this warp's staging
// rows: row i goes to out + i * rs, 16 bytes a lane.
__device__ __forceinline__ void store_tile(const float (&o)[PW / 8][4], int I, int c,
                                           unsigned char* stg, bf16* out, long long rs) {
  constexpr int VCH = PW / 8;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < PW / 8; ++nt) {
    *reinterpret_cast<uint32_t*>(stg + swz<VCH>(g, nt) + 4 * t) = pack(o[nt][0], o[nt][1]);
    *reinterpret_cast<uint32_t*>(stg + swz<VCH>(g + 8, nt) + 4 * t) = pack(o[nt][2], o[nt][3]);
  }
  __syncwarp();
#pragma unroll
  for (int idx = lane; idx < 16 * VCH; idx += 32) {
    const int rr = idx / VCH, ch = idx % VCH, i = 16 * I + rr;
    if (i < c)
      *reinterpret_cast<uint4*>(out + i * rs + ch * 8) =
          *reinterpret_cast<const uint4*>(stg + swz<VCH>(rr, ch));
  }
  __syncwarp();
}

// The per-chunk core of K4 and phase A: each warp's pairs of query tiles
// (t, T-1-t), their intra products, (K4) the inter term, stored as bf16.
// ds: the chunk's decays.
template <bool INTER>
__device__ __forceinline__ void chunk_rows(int T, int c, const unsigned char* st,
                                           const unsigned char* ds, const Layout& L,
                                           const uint32_t (&sb)[PW / 8][4], unsigned char* stg,
                                           bf16* out, long long rs) {
  const float* cl_s = reinterpret_cast<const float*>(ds + L.cl);
  const float* bk_s = reinterpret_cast<const float*>(ds + L.bk);
  const float* al_s = reinterpret_cast<const float*>(ds + L.al);
  const float* e_s = reinterpret_cast<const float*>(ds + L.e);
  const uint32_t q_a = smem_addr(st + L.q);
  const KvLanes ln(smem_addr(st + L.k), smem_addr(st + L.v));
  for (int pr = threadIdx.x >> 5; pr < (T + 1) / 2; pr += WARPS) {
    const int I1 = T - 1 - pr, I0 = pr < I1 ? pr : -1;
    uint32_t q0[4] = {}, q1[4];
    load_qa(q1, q_a, I1);
    if (I0 >= 0) load_qa(q0, q_a, I0);
    float o0[PW / 8][4] = {}, o1[PW / 8][4] = {};
    intra_pair(I0, I1, q0, q1, ln, cl_s, bk_s, al_s, o0, o1);
    if (INTER) inter_tile(I1, q1, sb, e_s, o1);
    store_tile(o1, I1, c, stg, out, rs);
    if (I0 >= 0) {
      if (INTER) inter_tile(I0, q0, sb, e_s, o0);
      store_tile(o0, I0, c, stg, out, rs);
    }
  }
}

// The pipeline of K4 and phase A, one block: its units (K4: the chunks of
// one (b, h, slice) in order; phase A: the items x, x + grid, ...) go
// through two stages, the next unit's lg and then its rows loading by
// cp.async while this one computes; the next unit's cum and decays are
// computed in this one's tail, between the barriers the state partials
// need anyway. K4 (CHAIN) carries the state slice from chunk to chunk and,
// given o2, writes the slice entering each chunk there ([B,H,nc,N,P]).
template <int N, int P, bool CHAIN>
__device__ __forceinline__ void pipeline(const GlaIn<bf16>& in, bf16* __restrict__ y,
                                         float* __restrict__ o1, float* __restrict__ o2) {
  extern __shared__ __align__(128) unsigned char sm[];
  constexpr int NS = P / PW;
  const int c = in.c, nc = in.S / c, H = in.H, tc = (c + 15) & ~15, T = tc / 16;
  const int warp = threadIdx.x >> 5;
  // K4: the chunks of block x's (b, h, slice); phase A: the items
  const int first = CHAIN ? 0 : blockIdx.x, step = CHAIN ? 1 : gridDim.x;
  const int end = CHAIN ? nc : NS * nc * in.B * H;
  // K4's block x is (b, h) = x / NS, slice x % NS; an item number runs
  // slice fastest, then chunk, then (b, h)
  auto unit = [&](int u) {
    return Item(CHAIN ? (int)(blockIdx.x % NS + NS * (u + nc * (blockIdx.x / NS))) : u, NS, nc);
  };
  const Layout L(CHAIN ? CHUNK : PHASE_A, c);
  float* st_s = reinterpret_cast<float*>(sm + L.state);
  float* scr = reinterpret_cast<float*>(sm + L.scratch);
  unsigned char* stg = sm + L.scratch + warp * L.wsz;
  if (first >= end) return;
  if (CHAIN)
    for (int e = threadIdx.x; e < 16 * PW; e += THREADS) st_s[e] = 0.f;
  {
    const Item x = unit(first);
    stage_lg(in, x.bh / H, x.bh % H, x.ci * c, tc, sm, L);
    cp_commit();
    stage_rows<N, true>(in, x.bh / H, x.bh % H, x.ci * c, x.slice * PW, tc, sm, L);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    scan_segments(tc, sm, sm + L.dset, L);
    __syncthreads();
  }
  float total = chunk_decays<true>(c, tc, sm, sm + L.dset, L);
#ifdef GLA_CLOCK
  long long stamp[6];
#endif
  for (int n = 0, u = first; u < end; ++n, u += step) {
    unsigned char* st = sm + (n & 1) * L.stage;
    unsigned char* ds = sm + L.dset + (n & 1) * L.dsz;
    unsigned char* nst = sm + ((n + 1) & 1) * L.stage;
    unsigned char* nds = sm + L.dset + ((n + 1) & 1) * L.dsz;
    const bool more = u + step < end;
    GLA_STAMP(0);
    if (more) {
      const Item x = unit(u + step);
      stage_lg(in, x.bh / H, x.bh % H, x.ci * c, tc, nst, L);
      cp_commit();
      stage_rows<N, true>(in, x.bh / H, x.bh % H, x.ci * c, x.slice * PW, tc, nst, L);
      cp_commit();
      cp_wait<2>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();  // this unit's rows, its decays and (K4) the state are in
#ifdef GLA_LOADONLY
    if (c > 0) continue;
#endif
    GLA_STAMP(1);
    const Item x = unit(u);
    const int b = x.bh / H, h = x.bh % H, p0 = x.slice * PW;
    if (CHAIN && o2 != nullptr) {  // K4's state slice entering this chunk
      float* so = o2 + ((long long)x.bh * nc + x.ci) * N * P + p0;
      for (int e = threadIdx.x; e < N * PW; e += THREADS) so[(e / PW) * P + e % PW] = st_s[e];
    }
    uint32_t sb[PW / 8][4] = {};
    if (CHAIN) state_frags(st_s, sb);
    chunk_rows<CHAIN>(T, c, st, ds, L, sb, stg,
                      y + (((long long)b * in.S + x.ci * c) * H + h) * P + p0, (long long)H * P);
    GLA_STAMP(2);
    float d[PW / 8][4] = {};
    delta_part(T, smem_addr(st + L.k), smem_addr(st + L.v),
               reinterpret_cast<const float*>(ds + L.w), d);
    GLA_STAMP(3);
    if (more) cp_wait<1>();  // the next unit's lg is in
    __syncthreads();  // the staging rows (and the state) are read
    write_part(d, scr);
    if (more) scan_segments(tc, nst, nds, L);
    __syncthreads();
    GLA_STAMP(4);
    if (CHAIN) {
      const float gc = expf(total);
      for (int e = threadIdx.x; e < 16 * PW; e += THREADS)
        st_s[e] = st_s[e] * gc + sum_parts(scr, e);
    } else {
      const long long chunk = (long long)x.bh * nc + x.ci;
      float* dd = o2 + chunk * N * P + p0;
      for (int e = threadIdx.x; e < N * PW; e += THREADS)
        dd[(e / PW) * P + e % PW] = sum_parts(scr, e);
      if (x.slice == 0 && threadIdx.x == 0) o1[chunk] = expf(total);
    }
    if (more) total = chunk_decays<true>(c, tc, nst, nds, L);
    GLA_STAMP(5);
#ifdef GLA_CLOCK
    if (CHAIN && blockIdx.x == 0 && n == 3 && (threadIdx.x & 31) == 0)
      printf("[clock] K4 block 0 chunk 3 warp %d: next loads + barrier %lld, rows %lld, "
             "delta %lld, partials + next scan %lld, state + next decays %lld, total %lld "
             "cycles\n", warp, stamp[1] - stamp[0], stamp[2] - stamp[1], stamp[3] - stamp[2],
             stamp[4] - stamp[3], stamp[5] - stamp[4], stamp[5] - stamp[0]);
#endif
  }
  if (CHAIN) {
    float* so = o1 + (long long)(blockIdx.x / NS) * N * P + (blockIdx.x % NS) * PW;
    for (int e = threadIdx.x; e < N * PW; e += THREADS) so[(e / PW) * P + e % PW] = st_s[e];
  }
}

// K4, bf16. Grid (B*H*P/PW): one block per (b, h, slice) walks the chunks
// in order with its [16][PW] state slice in shared memory. y: [B,S,H,P];
// state_out: [B,H,N,P]; starts (or null): [B,H,nc,N,P].
template <int N, int P>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    gla_chunk_kernel(GlaIn<bf16> in, bf16* __restrict__ y, float* __restrict__ state_out,
                     float* __restrict__ starts) {
  pipeline<N, P, true>(in, y, state_out, starts);
}

// K5 phase A, bf16. Persistent: block x walks the items (b, h, chunk,
// slice) x, x + grid, ...: the intra-chunk output (rounded to bf16, as the
// Pallas phase A), the delta slice and, from slice 0, g. y_intra:
// [B,S,H,P]; g: [B,H,nc]; d: [B,H,nc,N,P].
template <int N, int P>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    gla_phase_a_kernel(GlaIn<bf16> in, bf16* __restrict__ y_intra, float* __restrict__ g_out,
                       float* __restrict__ d_out) {
  pipeline<N, P, false>(in, y_intra, g_out, d_out);
}

// K5 phase B, bf16. Persistent over the items (b, h, chunk, slice) as phase
// A, two stages: y = y_intra + diag(exp(cum)) (q . start), the product on
// the tensor cores through the hi/lo split of start. y_intra's slice is
// staged in v's place (in.v = y_intra), so its rows come in and y's leave
// 16 bytes a lane. start: [B,H,nc,N,P] float32; y_intra, y: [B,S,H,P].
template <int N, int P>
__global__ void __launch_bounds__(THREADS, 3)
    gla_phase_b_kernel(GlaIn<bf16> in, const float* __restrict__ start, bf16* __restrict__ y) {
  extern __shared__ __align__(128) unsigned char sm[];
  constexpr int NS = P / PW, VCH = PW / 8;
  const int c = in.c, nc = in.S / c, H = in.H, tc = (c + 15) & ~15, T = tc / 16;
  const int items = NS * nc * in.B * H, warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const Layout L(PHASE_B, c);
  unsigned char* stg = sm + L.scratch + warp * L.wsz;
  auto stage = [&](int it, unsigned char* dst) {
    const Item x(it, NS, nc);
    stage_lg(in, x.bh / H, x.bh % H, x.ci * c, tc, dst, L);
    stage_rows<N, false>(in, x.bh / H, x.bh % H, x.ci * c, x.slice * PW, tc, dst, L);
    stage_start<N, P>(start + ((long long)x.bh * nc + x.ci) * N * P + x.slice * PW, dst, L);
    cp_commit();
  };
  int it = blockIdx.x;
  if (it >= items) return;
  stage(it, sm);
  for (int n = 0; it < items; ++n, it += gridDim.x) {
    unsigned char* st = sm + (n & 1) * L.stage;
    unsigned char* ds = sm + L.dset + (n & 1) * L.dsz;
    // the next item's copies overwrite the last item's stage: every warp
    // must be done reading it
    if (n > 0) __syncthreads();
    if (it + (int)gridDim.x < items) {
      stage(it + gridDim.x, sm + ((n + 1) & 1) * L.stage);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();  // this item's rows are in
#ifdef GLA_LOADONLY
    if (c > 0) continue;
#endif
    scan_segments(tc, st, ds, L);
    __syncthreads();
    chunk_decays<false>(c, tc, st, ds, L);
    __syncthreads();
    const Item x(it, NS, nc);
    const int b = x.bh / H, h = x.bh % H;
    const float* e_s = reinterpret_cast<const float*>(ds + L.e);
    uint32_t sb[PW / 8][4];
    state_frags(reinterpret_cast<const float*>(st + L.st0), sb);
    const uint32_t q_a = smem_addr(st + L.q);
    const unsigned char* yi = st + L.v;
    bf16* out = y + (((long long)b * in.S + x.ci * c) * H + h) * P + x.slice * PW;
    for (int I = warp; I < T; I += WARPS) {
      uint32_t qa[4];
      load_qa(qa, q_a, I);
      float o[PW / 8][4];
#pragma unroll
      for (int nt = 0; nt < PW / 8; ++nt) {
        const float2 lo = unpack(*reinterpret_cast<const uint32_t*>(
                             yi + swz<VCH>(16 * I + g, nt) + 4 * t)),
                     hi = unpack(*reinterpret_cast<const uint32_t*>(
                             yi + swz<VCH>(16 * I + g + 8, nt) + 4 * t));
        o[nt][0] = lo.x;
        o[nt][1] = lo.y;
        o[nt][2] = hi.x;
        o[nt][3] = hi.y;
      }
      inter_tile(I, qa, sb, e_s, o);
      store_tile(o, I, c, stg, out, (long long)H * P);
    }
  }
}


// ===========================================================================
// the backward (K4b): dq, dk, dv and dlg of K4's function
// ===========================================================================
//
// With cum the chunk's inclusive cumsum of lg, tot its last value, S_z
// K4's state entering chunk z, dS_z the gradient of the state leaving it
// (zero after the last chunk) and W_ij = exp(cum_i - cum_j) for j <= i:
//   dq_i = sum_{j<=i} W_ij (dy_i . v_j) k_j + exp(cum_i) S_z dy_i
//   dk_j = sum_{i>=j} W_ij (dy_i . v_j) q_i + exp(tot - cum_j) dS_z v_j
//   dv_j = sum_{i>=j} W_ij (q_i . k_j) dy_i + exp(tot - cum_j) dS_z^T k_j
//   dS_{z-1} = exp(tot) dS_z + sum_i exp(cum_i) q_i dy_i^T
// and dlg_t = sum_{s>=t} (q_s . dq_s - k_s . dk_s), the scalar decay's
// identity (the final state takes no gradient), with each head's own dots.
// The plain versions are kernels/ref.py gla_bwd and gla_bwd_states. In the
// model q and k are one row shared by the heads (head stride 0): the bf16
// route takes them so and returns dq and dk as the shared rows, the heads'
// sum, in bf16; float32 and per-head q and k get per-head rows.
//
// Bound: at hymba's training shape (B4 S1536 H25 N16 P64, c 256, bf16) the
// function moves ~63.5 MB (v, dy, dv in bf16, q, k and their gradients as
// the shared rows, lg and dlg, K4's states): 18.9 us at 3.35 TB/s, against
// ~8 GFLOP of products (c^2 (3N + 2P) multiply-adds under the causal half
// and four c N P state products a chunk), 8 us of tensor-core time.
// Device-memory bytes bound it.
//
// Design (bf16), four launches, each deterministic (no atomics; the port's
// recovery is held byte for byte), so that the chunks and heads no longer
// wait on each other and the tensor work runs on wgmma:
//  (a) The reversed state pass: dS_z for every chunk into [B,H,nc,N,P]
//      float32 (K4's `starts` layout). Its own launch (gla_bwd_state_kernel)
//      computes every chunk's increment sum_i exp(cum_i) q_i dy_i^T at once,
//      one block per (b, h, chunk, 32-column slice), on K4's state-delta
//      machinery with q in k's place and dy in v's, and each chunk's cum
//      log2(e) and 64-row tiles' factors fwd and bwd, [B,H,S]; the walk
//      from the last chunk, dS_{z-1} = exp(tot_z) dS_z + increment_z, a few
//      multiply-adds an element, runs in the first blocks of the dq launch,
//      which reads no dS. (One block per (b, h, slice) walking the chunks in
//      series took 22 us; each tile's increment taken in the dq launch from
//      its dY tile, so that dy is read once, cost dq more than it saved.)
//  (b) dq (gla_bwd_dq_kernel): a block owns a query tile of 64 rows of one
//      (b, chunk) and a group of heads, walked in order. Per head: the
//      inter term dY_I (exp(cum_I0) S_z)^T first (S_z split hi/lo into
//      bf16 tiles); per key tile J < I, dP = dY_I V_J^T by wgmma from the
//      TMA tiles; the decay as K4 factors it, exp(cum_i - cum_j) = fwd_i
//      g_IJ bwd_j with every factor <= 1, so an off-diagonal tile takes a
//      column factor and the sum fwd_i once, and only the diagonal tile an
//      ex2 an element; dq_h += (.) K_J by wgmma, A from registers split
//      hi/lo (dlg is a difference of per-row dots) and B = K_J^T staged as a
//      128-byte-swizzled tile. q . dq_h goes to a [B,H,S] row, and dq_h
//      into the group's sum in registers, head by head.
//  (c) dk and dv (gla_bwd_dkdv_kernel): a block owns a key tile J of one
//      (b, chunk) and a group of heads. Per head: the inter terms V_J dS'^T
//      and K_J dS' (dS' = exp(tot - cum_J1) dS_z, hi/lo), then the query
//      tiles I >= J from the last: dP^T = V_J dY_I^T (wgmma), the scores
//      K_J Q_I^T on mma.sync (their K index is N = 16, read from q rows as
//      K4 stages them; recomputed per head, a fifth of a tile's tensor
//      work, rather than held in 16 KB a tile), both times the column
//      factor, dv_h += P^T dY_I (P rounded to bf16, as K4 rounds its
//      probabilities; dY read MN-major from the same TMA tile) and dk_h +=
//      dP^T Q_I (hi/lo); the row factor bwd_j, then the diagonal. k . dk_h
//      to a row, dk_h into the group's sum, dv_h out in bf16 through a
//      staging tile, 16 bytes a thread.
//  (d) The finish (gla_bwd_finish_kernel): dq and dk, the head groups'
//      partials added in group order, out as the shared rows in bf16; dlg's
//      suffix sums over all S positions per (b, h), one block each: runs of
//      rows a thread, the runs' totals across the block, one fixed order.
//  Blocks of (b) and (c) are one consumer warpgroup and a producer warp
//  (dk/dv: a producer warpgroup, whose registers go to the consumers by
//  setmaxnreg, 232 a thread, so dk/dv's accumulators do not spill); its
//  lane 0 issues the TMA loads into a 3-slot ring and a double buffer
//  (mbarriers full and empty); one tile of look-ahead: a group holds this
//  tile's second products and the next tile's first. A head's decays and
//  state rows arrive by cp.async into a second buffer while the head
//  before computes, one barrier a head. Heads come in equal groups (5 at
//  hymba's shape: 480 blocks a launch; groups sized by the tile's weight,
//  and groups of 1-3 or 8, were slower), the heaviest tiles first (dq: the
//  last query tile; dk/dv: the first key tile).
// On an H100 80GB HBM3 at 700 W (PERF.md) it takes 127.6 us (the earlier
// design, one block per (b, h) on mma.sync, took 139.5), 6.7x the bound:
// the state pass 17.3, dq 47.3, dk/dv 54.9, the finish 7.7 us. Each
// warpgroup's tile is a chain (its group, the wait, then the decays and
// hi/lo splits with the tensor cores idle: ~1.8K cycles a dq tile pair at
// three blocks an SM against ~190 of tensor work), a head adds ~2.5K
// cycles, the state pass reads dy again, and the finish is a few
// dependent round trips to memory a block.
// float32 runs one scalar kernel (exact products, no TF32), one block per
// (b, h) walking the chunks in reverse carrying dS, one thread a row for
// dq and one a column for dk and dv.
// Diagnostic builds: GLA_LOADONLY stops each launch's compute after its
// loads (dq's and dk/dv's consumers wait and release the tiles), GLA_NOEXP
// as above, GLA_CLOCK prints one block's phases of each launch in clock64
// cycles.

// dlg over the chunk's c rows: the suffix sums of r = rq - rk (q_t . dq_t -
// k_t . dk_t), plus carry, the later chunks' sum, which it updates. Warp 0
// in 32-row segments from the last, one fixed order; the other warps return
// at once. dlg row i is dlg[row0 + i * rs].
__device__ void dlg_rows(const float* rq, const float* rk, int c, float& carry, float* dlg,
                         long long row0, long long rs) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  for (int seg = (c - 1) / 32; seg >= 0; --seg) {
    const int i = seg * 32 + lane;
    float x = i < c ? rq[i] - rk[i] : 0.f;
#pragma unroll
    for (int o = 1; o < 32; o *= 2) {
      const float y = __shfl_down_sync(0xffffffffu, x, o);
      if (lane + o < 32) x += y;
    }
    x += carry;
    if (i < c) dlg[row0 + i * rs] = x;
    carry = __shfl_sync(0xffffffffu, x, 0);
  }
}

// Shared memory of a float32 backward block: the chunk's q, k [c][N], v, dy
// [c][P], cum, q.dq and k.dk [c], the entering state S_z and the carried
// dS [N][P], all float32.
__host__ __device__ size_t smem_bwd_f32(int c, int N, int P) {
  return sizeof(float) * ((size_t)c * (2 * N + 2 * P + 3) + 2 * N * P);
}

// K4b, float32: exact scalar products. Grid (B*H); one block per (b, h)
// walks the chunks in reverse carrying dS, one thread a row for dq and one
// a column j for dk and dv.
template <int N, int P>
__global__ void __launch_bounds__(THREADS)
    gla_bwd_f32_kernel(GlaIn<float> in, BwdIO<float> io) {
  extern __shared__ __align__(16) float smf[];
  const int c = in.c, nc = in.S / c, H = in.H;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  float* q_s = smf;
  float* k_s = q_s + c * N;
  float* v_s = k_s + c * N;
  float* dy_s = v_s + c * P;
  float* cum_s = dy_s + c * P;
  float* rq_s = cum_s + c;
  float* rk_s = rq_s + c;
  float* sz_s = rk_s + c;
  float* ds_s = sz_s + N * P;
  for (int e = threadIdx.x; e < N * P; e += blockDim.x) ds_s[e] = 0.f;
  float carry = 0.f;
  for (int z = nc - 1; z >= 0; --z) {
    const int t0 = z * c;
    __syncthreads();  // the later chunk is done with every array; dS is updated
    for (int e = threadIdx.x; e < c * N; e += blockDim.x)
      q_s[e] = in.q[in.sq.at(b, t0 + e / N, h) + e % N];
    for (int e = threadIdx.x; e < c * P; e += blockDim.x)
      dy_s[e] = io.dy[io.sdy.at(b, t0 + e / P, h) + e % P];
    stage_kv<N, P>(in, b, h, t0, k_s, v_s);
    const float* sz = io.starts + ((long long)blockIdx.x * nc + z) * N * P;
    for (int e = threadIdx.x; e < N * P; e += blockDim.x) sz_s[e] = sz[e];
    stage_cum(in, b, h, t0, cum_s);  // its barriers also cover the rows above
    const float tot = cum_s[c - 1];
    const long long row0 = (long long)b * in.S + t0;
    // dq_i = sum_{j<=i} exp(cum_i - cum_j) (dy_i . v_j) k_j + exp(cum_i) S_z dy_i
    for (int i = threadIdx.x; i < c; i += blockDim.x) {
      const float* dyi = dy_s + i * P;
      const float ci = cum_s[i];
      float acc[N];
#pragma unroll
      for (int n = 0; n < N; ++n) acc[n] = 0.f;
      for (int j = 0; j <= i; ++j) {
        float d = 0.f;
#pragma unroll
        for (int p = 0; p < P; ++p) d += dyi[p] * v_s[j * P + p];
        d *= expf(ci - cum_s[j]);
#pragma unroll
        for (int n = 0; n < N; ++n) acc[n] += d * k_s[j * N + n];
      }
      const float e = expf(ci);
      float r = 0.f;
      float* out = io.dq + ((row0 + i) * H + h) * N;
#pragma unroll
      for (int n = 0; n < N; ++n) {
        float x = 0.f;
#pragma unroll
        for (int p = 0; p < P; ++p) x += sz_s[n * P + p] * dyi[p];
        acc[n] += e * x;
        r += q_s[i * N + n] * acc[n];
        out[n] = acc[n];
      }
      rq_s[i] = r;
    }
    // dk_j = sum_{i>=j} w_ij (dy_i . v_j) q_i + exp(tot - cum_j) dS v_j
    // dv_j = sum_{i>=j} w_ij (q_i . k_j) dy_i + exp(tot - cum_j) dS^T k_j
    for (int j = threadIdx.x; j < c; j += blockDim.x) {
      const float* vj = v_s + j * P;
      const float* kj = k_s + j * N;
      const float cj = cum_s[j];
      float dk[N], dv[P];
#pragma unroll
      for (int n = 0; n < N; ++n) dk[n] = 0.f;
#pragma unroll
      for (int p = 0; p < P; ++p) dv[p] = 0.f;
      for (int i = j; i < c; ++i) {
        const float w = expf(cum_s[i] - cj);
        float d = 0.f, a = 0.f;
#pragma unroll
        for (int p = 0; p < P; ++p) d += dy_s[i * P + p] * vj[p];
#pragma unroll
        for (int n = 0; n < N; ++n) a += q_s[i * N + n] * kj[n];
        d *= w;
        a *= w;
#pragma unroll
        for (int n = 0; n < N; ++n) dk[n] += d * q_s[i * N + n];
#pragma unroll
        for (int p = 0; p < P; ++p) dv[p] += a * dy_s[i * P + p];
      }
      const float e = expf(tot - cj);
      float r = 0.f;
      float* ko = io.dk + ((row0 + j) * H + h) * N;
#pragma unroll
      for (int n = 0; n < N; ++n) {
        float x = 0.f;
#pragma unroll
        for (int p = 0; p < P; ++p) x += ds_s[n * P + p] * vj[p];
        dk[n] += e * x;
        r += kj[n] * dk[n];
        ko[n] = dk[n];
      }
      float* vo = io.dv + ((row0 + j) * H + h) * P;
#pragma unroll
      for (int p = 0; p < P; ++p) {
        float x = 0.f;
#pragma unroll
        for (int n = 0; n < N; ++n) x += ds_s[n * P + p] * kj[n];
        vo[p] = dv[p] + e * x;
      }
      rk_s[j] = r;
    }
    __syncthreads();  // every row has read dS and written its q.dq, k.dk
    // dS <- exp(tot) dS + sum_i exp(cum_i) q_i dy_i^T, i in order
    const float g = expf(tot);
    for (int e = threadIdx.x; e < N * P; e += blockDim.x) {
      const int n = e / P, p = e % P;
      float x = 0.f;
      for (int i = 0; i < c; ++i) x += expf(cum_s[i]) * q_s[i * N + n] * dy_s[i * P + p];
      ds_s[e] = ds_s[e] * g + x;
    }
    dlg_rows(rq_s, rk_s, c, carry, io.dlg, row0 * H + h, H);
  }
}

// ---------------------------------------------------------------------------
// K4b, bf16: the state pass, dq (with the state pass's walk), dk/dv and the
// finish (design note above)
// ---------------------------------------------------------------------------

constexpr int BT = 64;             // rows of a dq or dk/dv tile: one wgmma M
constexpr int BSTAGES = 3;         // slots of the streamed tiles' ring
constexpr int BWD_THREADS = 160;   // dq: one consumer warpgroup, then a producer warp
// dk/dv: one consumer warpgroup, then a producer warpgroup that gives its
// registers up (setmaxnreg) to the consumers: two blocks an SM hold 128 a
// thread at launch, the producer keeps 24 and the consumers rise to 232
constexpr int DKDV_THREADS = 256, DKDV_AT_LAUNCH = 128, PRODUCER_REGS = 24,
              CONSUMER_REGS = 232;
constexpr int FIN_ROWS = 2048;     // rows of q.dq and k.dk the finish stages at once

// The bf16 backward's operands besides GlaIn's: dy by its strides, K4's
// chunk start states, the scratch one launch hands the next (float32,
// contiguous) and the outputs.
struct Bwd16 {
  const bf16* dy;
  Strides sdy;
  const float* starts;  // [B,H,nc,N,P]
  float* cl;            // [B,H,S]: cum log2(e) within each chunk (the state pass)
  float* fwd;           // [B,H,S]: exp(cum_x - cum_x0), x0 the first row of x's 64-row tile
  float* bwd;           // [B,H,S]: exp(cum_x1 - cum_x), x1 its last (at most c - 1)
  float* dstate;        // [B,H,nc,N,P]: the gradient of the state leaving chunk z
  float* rq;            // [B,H,S]: each head's q . dq (dq kernel)
  float* rk;            // [B,H,S]: each head's k . dk (dk/dv kernel)
  float* dqp;           // [ng,B,S,N]: each head group's dq (dq kernel)
  float* dkp;           // [ng,B,S,N]: each head group's dk (dk/dv kernel)
  bf16* dq;             // [B,S,N] (shared rows) or [B,S,H,N] (per head)
  bf16* dk;
  bf16* dv;             // [B,S,H,P]
  float* dlg;           // [B,S,H]
  int hg;               // heads a block of dq and dk/dv walks; 0: per-head q and k
  int ng;               // head groups: head_groups(H, hg)
};

// The groups of hg heads that a dq or dk/dv launch's blocks walk (one head
// a group when q and k are per head, hg = 0).
__host__ __device__ inline int head_groups(int H, int hg) {
  return hg > 0 ? (H + hg - 1) / hg : H;
}

// The reversed state pass, first half (K4b's first launch): every chunk's
// increment of dS at once. Grid (B*H*nc*P/PW): one block per (b, h, chunk,
// slice) stages the chunk's q rows, its dy slice and lg, scans lg into cum,
// and writes the increment sum_i exp(cum_i) q_i dy_i^T of its [N][PW] slice
// of dS into dstate (K4's state-delta machinery with q in k's place and dy
// in v's: each warp's tiles, the 8 partials added in warp order); slice 0
// also writes the chunk's cum log2(e) and its 64-row tiles' decays fwd and
// bwd (the dq and dk/dv launches' factors of exp(cum_i - cum_j)). The walk
// over the chunks that turns the increments into dS_z runs in the first
// blocks of the dq launch (walk_states).
template <int N, int P>
__global__ void __launch_bounds__(THREADS, 4)
    gla_bwd_state_kernel(GlaIn<bf16> in, Bwd16 w) {
  extern __shared__ __align__(128) unsigned char sm[];
  constexpr int NS = P / PW;
  const int c = in.c, nc = in.S / c, tc = (c + 15) & ~15, T = tc / 16;
  const int slice = blockIdx.x % NS, z = blockIdx.x / NS % nc, bh = blockIdx.x / NS / nc;
  const int b = bh / in.H, h = bh % in.H, p0 = slice * PW;
  const Layout L(BWD_STATE, c);
  float* scr = reinterpret_cast<float*>(sm + L.scratch);
  unsigned char* ds = sm + L.dset;
  GLA_STAMP_DECL(4);
  GLA_STAMP(0);
  stage_lg(in, b, h, z * c, tc, sm, L);
  stage_rows<N, false>(in, b, h, z * c, p0, tc, sm, L);
  cp_commit();
  cp_wait<0>();
  __syncthreads();
#ifdef GLA_LOADONLY
  if (c > 0) return;
#endif
  GLA_STAMP(1);
  scan_segments(tc, sm, ds, L);
  __syncthreads();
  chunk_decays<false, true>(c, tc, sm, ds, L);
  __syncthreads();
  if (slice == 0) {  // cl, and the 64-row tiles' decays the dq and dk/dv launches take
    const float* cl_s = reinterpret_cast<const float*>(ds + L.cl);
    const long long row = (long long)bh * in.S + z * c;
    for (int j = threadIdx.x; j < c; j += THREADS) {
      const int j0 = j & ~(BT - 1), j1 = min(j0 + BT - 1, c - 1);
      w.cl[row + j] = cl_s[j];
      w.fwd[row + j] = ex2(cl_s[j] - cl_s[j0]);
      w.bwd[row + j] = ex2(cl_s[j1] - cl_s[j]);
    }
  }
  GLA_STAMP(2);
  float d[PW / 8][4] = {};
  delta_part(T, smem_addr(sm + L.q), smem_addr(sm + L.v),
             reinterpret_cast<const float*>(ds + L.e), d);
  write_part(d, scr);
  __syncthreads();
  float* out = w.dstate + ((long long)bh * nc + z) * N * P + p0;
  for (int e = threadIdx.x; e < N * PW; e += THREADS) out[(e / PW) * P + e % PW] = sum_parts(scr, e);
  GLA_STAMP(3);
#ifdef GLA_CLOCK
  if (blockIdx.x == 0 && (threadIdx.x & 31) == 0)
    printf("[clock] K4b state pass block 0 warp %d: loads %lld, cumsum + decays %lld, "
           "increment + partial sum %lld cycles\n", threadIdx.x >> 5, stamp[1] - stamp[0],
           stamp[2] - stamp[1], stamp[3] - stamp[2]);
#endif
}

// The reversed state pass, second half, by the first blocks of the dq
// launch (which reads no dS): turn each chunk's increment in dstate into
// dS_z, the gradient of the state leaving chunk z, in place: dS_{nc-1} = 0
// and dS_{z-1} = exp(tot_z) dS_z + increment_z, from the last chunk, the
// increments of eight chunks loaded at once. Thread x of the walk owns
// four elements of one (b, h)'s [N][P].
template <int N, int P>
__device__ void walk_states(const GlaIn<bf16>& in, const Bwd16& w, int x) {
  constexpr int NP = N * P, U = 8;
  const int c = in.c, nc = in.S / c;
  if (x >= in.B * in.H * NP / 4) return;
  const int bh = x / (NP / 4), e = x % (NP / 4);
  float4* ds = reinterpret_cast<float4*>(w.dstate + (long long)bh * nc * NP) + e;
  const float* cl = w.cl + (long long)bh * in.S + c - 1;  // each chunk's cum log2(e) at its end
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int z1 = nc; z1 > 0; z1 -= U) {
    float4 inc[U];
    float g[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (z1 - 1 - u >= 0) {
        inc[u] = ds[(long long)(z1 - 1 - u) * (NP / 4)];
        g[u] = ex2(cl[(long long)(z1 - 1 - u) * c]);
      }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (z1 - 1 - u >= 0) {
        ds[(long long)(z1 - 1 - u) * (NP / 4)] = acc;
        acc.x = acc.x * g[u] + inc[u].x;
        acc.y = acc.y * g[u] + inc[u].y;
        acc.z = acc.z * g[u] + inc[u].z;
        acc.w = acc.w * g[u] + inc[u].w;
      }
  }
}

// Byte offset of bf16 element (r, x) in a tile of rows of RB bytes (64 or
// 128) swizzled as the TMA writes it (the tile on 1024 bytes): 16-byte
// chunk x / 8 of row r lies at chunk (x / 8) ^ (address bits 7-9 or 7-8).
template <int RB>
__device__ __forceinline__ uint32_t sw_off(int r, int x) {
  const int sw = RB == 128 ? (r & 7) : ((r >> 1) & 3);
  return (uint32_t)(r * RB + (((x >> 3) ^ sw) << 4) + (x & 7) * 2);
}

// Shared memory of a dq or dk/dv block, byte offsets from a 1024-byte
// aligned base, for P columns and the chunk's nt = ceil(c / 64) tiles: two
// buffers of the per-head tile (dq: dY_I; dk/dv: V_J) and the ring of
// streamed tiles (dq: V_J; dk/dv: dY_I), 64 x P bf16 each as the TMA writes
// them; the chunk's q or k tiles transposed, [16][64] bf16 swizzled by 128
// bytes (dq: K_J^T; dk/dv: Q_I^T); for dk/dv the chunk's q rows and the key
// tile's k rows [.][16] as K4 stages them. Then two of each per-head
// buffer, one head's in use while the next head's fills: its state
// operand hi and lo [16][P] bf16 swizzled as a P-column tile, the state
// rows it is made from [16][P] float32, the cl, fwd and bwd rows of the
// chunk [64 nt] float32 and two scalars a consumer thread (the operand's
// scale), all by cp.async; for dk/dv two staging tiles of dv [64][P] bf16
// (a head's rows leave 16 bytes a thread); the barriers.
struct TileSmem {
  int one, ring, tr, qrows, krow, sth, stl, sts, rst, cl, fwd, bwd, slot, dvs, rows, bar, total;
  __host__ __device__ TileSmem(int c, int P, bool dkdv) {
    const int nt = (c + BT - 1) / BT, tile = BT * P * 2;
    rows = nt * BT;
    sts = (16 * P * 2 + 1023) & ~1023;
    one = 0;
    ring = one + 2 * tile;
    tr = ring + BSTAGES * tile;
    qrows = tr + nt * 2048;
    krow = qrows + (dkdv ? nt * BT * 32 : 0);
    sth = (krow + (dkdv ? BT * 32 : 0) + 1023) & ~1023;
    stl = sth + 2 * sts;
    rst = stl + 2 * sts;
    cl = rst + 2 * 16 * P * 4;
    fwd = cl + 2 * rows * 4;
    bwd = fwd + 2 * rows * 4;
    slot = bwd + 2 * rows * 4;
    dvs = slot + 2 * 128 * 2 * 4;
    bar = dvs + (dkdv ? 2 * tile : 0);
    total = bar + (2 * BSTAGES + 4) * 8 + 1024;  // + the base's alignment slack
  }
};

// A barrier of the 128 consumer threads (id 1; 0 is __syncthreads's)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
}

// Keeps A fragments written before the wgmma.fence that precedes the wgmma
// reading them (not sunk past it).
__device__ __forceinline__ void pin_frag(uint32_t (&r)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// A 64 x 64 accumulator as four k16 A fragments: rounded to bf16 (p), or
// split hi/lo (float32 to about 16 bits).
__device__ __forceinline__ void acc_round(const float* a, uint32_t (&p)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int x = 0; x < 4; ++x) p[kk][x] = pack(a[8 * kk + 2 * x], a[8 * kk + 2 * x + 1]);
}
__device__ __forceinline__ void acc_split(const float* a, uint32_t (&hi)[4][4],
                                          uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int x = 0; x < 4; ++x) split(a[8 * kk + 2 * x], a[8 * kk + 2 * x + 1], hi[kk][x], lo[kk][x]);
}

// Start the copies of head h's rows into buffer d, by the consumer
// threads (committed by the caller): its cl, fwd and bwd rows of the chunk
// (rows from c on zero), its state [N][P] float32 (st_g; rows from N on
// zero), each thread its own pairs, and to each thread's slot the cl
// values at rows s0 and s1 of the chunk (its operand's scale).
template <int N, int P>
__device__ void prefetch_head(const Bwd16& w, long long row, const float* st_g, int c, int s0,
                              int s1, int d, unsigned char* sm, const TileSmem& L) {
  const uint32_t cl = smem_addr(sm + L.cl) + d * L.rows * 4;
  const uint32_t fw = smem_addr(sm + L.fwd) + d * L.rows * 4;
  const uint32_t bw = smem_addr(sm + L.bwd) + d * L.rows * 4;
  for (int x = threadIdx.x; x < L.rows; x += 128) {
    const bool ok = x < c;
    const long long at = row + (ok ? x : 0);
    cp4(cl + 4 * x, w.cl + at, ok);
    cp4(fw + 4 * x, w.fwd + at, ok);
    cp4(bw + 4 * x, w.bwd + at, ok);
  }
  const uint32_t rst = smem_addr(sm + L.rst) + d * 16 * P * 4;
  for (int e = 2 * threadIdx.x; e < 16 * P; e += 256) {
    const bool ok = e / P < N;
    cp8(rst + 4 * e, st_g + (ok ? e : 0), ok);
  }
  const uint32_t slot = smem_addr(sm + L.slot) + (d * 128 + threadIdx.x) * 8;
  cp4(slot, w.cl + row + s0, true);
  cp4(slot + 4, w.cl + row + s1, true);
}

// Head h's state operand in buffer d from the rows its thread copied there
// (the caller waits for them): scale * X as the bf16 hi and lo tiles
// [16][P], scale = exp(cl_s0 (- cl_s1 when SUB)) from its slot.
template <int P, bool SUB>
__device__ void head_operand(int d, unsigned char* sm, const TileSmem& L) {
  const float* rst = reinterpret_cast<const float*>(sm + L.rst) + d * 16 * P;
  const float* slot = reinterpret_cast<const float*>(sm + L.slot) + (d * 128 + threadIdx.x) * 2;
  const float sc = ex2(SUB ? slot[0] - slot[1] : slot[0]);
  unsigned char* hi = sm + L.sth + d * L.sts;
  unsigned char* lo = sm + L.stl + d * L.sts;
  for (int e = 2 * threadIdx.x; e < 16 * P; e += 256) {
    const int n = e / P, p = e % P;
    const float2 v = *reinterpret_cast<const float2*>(rst + e);
    uint32_t h, l;
    split(v.x * sc, v.y * sc, h, l);
    *reinterpret_cast<uint32_t*>(hi + sw_off<P * 2>(n, p)) = h;
    *reinterpret_cast<uint32_t*>(lo + sw_off<P * 2>(n, p)) = l;
  }
}

// Rows [r0, r0 + 64) of the chunk's q or k (head h; zeros from row c and
// column N on) transposed into a [16][64] bf16 tile swizzled by 128 bytes:
// the K-major B operand of a product over those rows. Consumer threads.
template <int N>
__device__ void stage_transposed(const bf16* x, const Strides& sx, int b, int h, int t0, int r0,
                                 int c, unsigned char* tile) {
  const int j = threadIdx.x & (BT - 1), hf = threadIdx.x >> 6;
  uint4 u = make_uint4(0u, 0u, 0u, 0u);
  if (hf * 8 < N && r0 + j < c)
    u = *reinterpret_cast<const uint4*>(x + sx.at(b, t0 + r0 + j, h) + hf * 8);
  const bf16* e8 = reinterpret_cast<const bf16*>(&u);
#pragma unroll
  for (int e = 0; e < 8; ++e) *reinterpret_cast<bf16*>(tile + sw_off<128>(hf * 8 + e, j)) = e8[e];
}

// Rows [r0, r0 + n) of q or k (head h; zeros from row c and column N on) as
// K4 stages them, [n][16] bf16 swizzled (swz<2>). Consumer threads.
template <int N>
__device__ void stage_rows16(const bf16* x, const Strides& sx, int b, int h, int t0, int r0,
                             int n, int c, unsigned char* dst) {
  for (int idx = threadIdx.x; idx < 2 * n; idx += 128) {
    const int j = idx >> 1, ch = idx & 1;
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    if (ch * 8 < N && r0 + j < c)
      u = *reinterpret_cast<const uint4*>(x + sx.at(b, t0 + r0 + j, h) + ch * 8);
    *reinterpret_cast<uint4*>(dst + swz<2>(j, ch)) = u;
  }
}

// A consumer thread's two rows of q or k (rows r and r + 8 of the chunk, head
// h; zeros past c), columns 2t, 2t + 1, 8 + 2t, 9 + 2t: the columns of its
// n16 accumulator, for the rows' dots.
template <int N>
__device__ __forceinline__ void row_pair(const bf16* x, const Strides& sx, int b, int h, int t0,
                                         int r, int c, float (&v)[2][4]) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr)
#pragma unroll
    for (int nb = 0; nb < 2; ++nb) {
      const int i = r + 8 * rr, n = 8 * nb + 2 * t;
      float2 f = make_float2(0.f, 0.f);
      if (i < c && n < N) f = unpack(*reinterpret_cast<const uint32_t*>(x + sx.at(b, t0 + i, h) + n));
      v[rr][2 * nb] = f.x;
      v[rr][2 * nb + 1] = f.y;
    }
}

// The dots of a thread's two rows (v, row_pair's) with an n16 accumulator,
// summed over the four lanes that share the rows.
__device__ __forceinline__ float2 row_dots(const float (&v)[2][4], const float* a) {
  float d0 = v[0][0] * a[0] + v[0][1] * a[1] + v[0][2] * a[4] + v[0][3] * a[5];
  float d1 = v[1][0] * a[2] + v[1][1] * a[3] + v[1][2] * a[6] + v[1][3] * a[7];
#pragma unroll
  for (int o = 1; o < 4; o *= 2) {
    d0 += __shfl_xor_sync(0xffffffffu, d0, o);
    d1 += __shfl_xor_sync(0xffffffffu, d1, o);
  }
  return make_float2(d0, d1);
}

// Write an n16 accumulator's columns n < N of the thread's rows r, r + 8 (<
// c): row i at out + i * N, float32.
template <int N>
__device__ __forceinline__ void put_n16(const float* a, int r, int c, float* out) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr)
#pragma unroll
    for (int nb = 0; nb < 2; ++nb) {
      const int i = r + 8 * rr, n = 8 * nb + 2 * t;
      if (i < c && n < N)
        *reinterpret_cast<float2*>(out + (long long)i * N + n) =
            make_float2(a[4 * nb + 2 * rr], a[4 * nb + 2 * rr + 1]);
    }
}

// sc = K_J Q_I^T for a warp's 16 key rows (ka, their A fragment) and the 64
// query rows of tile I (q_a: the chunk's q rows as K4 stages them) on
// mma.sync, as eight 16 x 8 C fragments: the layout of a warp's share of a
// 64 x 64 wgmma accumulator.
__device__ __forceinline__ void scores64(const uint32_t (&ka)[4], uint32_t q_a, int I,
                                         float (&sc)[8][4]) {
  const int lane = threadIdx.x & 31, m = lane >> 3, r = lane & 7;
  const uint32_t base = q_a + swz<2>((m >> 1) * 8 + r, m & 1);
#pragma unroll
  for (int q4 = 0; q4 < 4; ++q4) {
    uint32_t qb[4];
    ldsm(qb, base + KT * (4 * I + q4));
#pragma unroll
    for (int x = 0; x < 4; ++x) sc[2 * q4][x] = sc[2 * q4 + 1][x] = 0.f;
    mma(sc[2 * q4], ka, qb[0], qb[1]);
    mma(sc[2 * q4 + 1], ka, qb[2], qb[3]);
  }
}

// dq. Grid (nt x B x nc x ng), the query tiles with the most key tiles
// first: a block owns query tile I (64 rows) of one (b, chunk) and walks its
// head group's heads in order. The consumer warpgroup, per head: dq_h =
// dY_I (exp(cum_I0) S_z)^T (the inter term, hi and lo); for each key tile J
// < I, dP = dY_I V_J^T, times g_IJ bwd_j by column, split hi/lo, dq_h +=
// (.) K_J (the next tile's dP in the same wgmma group); dq_h *= fwd_i; the
// diagonal tile with one ex2 an element under the mask; then q . dq_h into
// rq and dq_h into the group's sum, in head order. The producer warp's lane
// 0 streams dY_I (two buffers) and the V_J (a ring) by TMA.
template <int N, int P>
__global__ void __launch_bounds__(BWD_THREADS, 3)
    gla_bwd_dq_kernel(const __grid_constant__ CUtensorMap tdy,
                      const __grid_constant__ CUtensorMap tv, GlaIn<bf16> in, Bwd16 w,
                      int dy_slots, int v_slots, int walk_blocks) {
  if ((int)blockIdx.x < walk_blocks) {  // the state pass's walk (they run first)
    walk_states<N, P>(in, w, blockIdx.x * BWD_THREADS + threadIdx.x);
    return;
  }
  constexpr int TILE = BT * P * 2, KS = P / 16;
  constexpr uint64_t TILE_D = TILE >> 4, TR_D = 2048 >> 4;
  extern __shared__ uint8_t smem_raw[];
  unsigned char* sm = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const int c = in.c, nc = in.S / c, H = in.H, nt = (c + BT - 1) / BT;
  const TileSmem L(c, P, false);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L.bar);
  uint64_t* empty = full + BSTAGES;
  uint64_t* ofull = empty + BSTAGES;
  uint64_t* oempty = ofull + 2;
  // block -> (I, b, z, head group): the query tiles with the most key tiles
  // first
  const int per = in.B * nc * w.ng, blk = (int)blockIdx.x - walk_blocks;
  const int I = nt - 1 - blk / per, rest = blk % per;
  const int g = rest % w.ng, z = rest / w.ng % nc, b = rest / w.ng / nc;
  const int hg = w.hg > 0 ? w.hg : 1;
  const int h0 = g * hg, h1 = min(h0 + hg, H);
  const int t0 = z * c, I0 = I * BT;
  const int warp = warp_index();
  if (threadIdx.x == 0) {
    for (int i = 0; i < BSTAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 128);
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(&ofull[i], 1);
      mbar_init(&oempty[i], 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (warp == 4) {  // the producer: lane 0 issues the loads
    if (threadIdx.x != 128) return;
    for (int h = h0, hc = 0, it = 0; h < h1; ++h, ++hc) {
      const int o = hc & 1;
      if (hc >= 2) mbar_wait(&oempty[o], ((hc >> 1) - 1) & 1);
      mbar_expect_tx(&ofull[o], TILE);
      tma_load(sm + L.one + o * TILE, &tdy, &ofull[o], dy_slots, t0 + I0, h, b);
      for (int J = 0; J <= I; ++J, ++it) {
        const int s = it % BSTAGES;
        if (it >= BSTAGES) mbar_wait(&empty[s], ((it / BSTAGES) - 1) & 1);
        mbar_expect_tx(&full[s], TILE);
        tma_load(sm + L.ring + s * TILE, &tv, &full[s], v_slots, t0 + J * BT, h, b);
      }
    }
    return;
  }
  const int lane = threadIdx.x & 31, tq = lane & 3, r0 = warp * 16 + (lane >> 2);
  // K_J^T for J <= I, from head h0's k (the group's shared row)
  for (int J = 0; J <= I; ++J)
    stage_transposed<N>(in.k, in.sk, b, h0, t0, J * BT, c, sm + L.tr + J * 2048);
  float qv[2][4];
  row_pair<N>(in.q, in.sq, b, h0, t0, I0 + r0, c, qv);
  const uint64_t d_one = smem_desc<P>(sm + L.one), d_ring = smem_desc<P>(sm + L.ring);
  const uint64_t d_sth0 = smem_desc<P>(sm + L.sth), d_stl0 = smem_desc<P>(sm + L.stl);
  const uint64_t d_tr = smem_desc<64>(sm + L.tr);
  float dq_tot[8] = {};
#ifdef GLA_CLOCK
  long long stamp[4];
#endif
  auto prefetch = [&](int h, int d) {  // head h's decays and S_z into buffer d
    const long long bhh = (long long)b * H + h;
    prefetch_head<N, P>(w, bhh * in.S + t0, w.starts + (bhh * nc + z) * N * P, c, I0, I0, d,
                        sm, L);
    cp_commit();
  };
  // the operand exp(cum_I0) S_z of the head whose rows buffer d holds
  auto operand = [&](int d) {
    cp_wait<0>();
    head_operand<P, false>(d, sm, L);
    fence_proxy_async();
    consumer_sync();  // the buffer is in for every thread (the first: the tiles above too)
  };
  prefetch(h0, 0);
  operand(0);
  for (int h = h0, hc = 0, it = 0; h < h1; ++h, ++hc) {
    const int o = hc & 1, d = hc & 1;
    const long long bhh = (long long)b * H + h;
    GLA_STAMP(0);
    if (h + 1 < h1) prefetch(h + 1, d ^ 1);  // lands while this head computes
    const float* cl_s = reinterpret_cast<const float*>(sm + L.cl) + d * L.rows;
    const float* fwd_s = reinterpret_cast<const float*>(sm + L.fwd) + d * L.rows;
    const float* bwd_s = reinterpret_cast<const float*>(sm + L.bwd) + d * L.rows;
    const uint64_t d_sth = d_sth0 + (L.sts >> 4) * d, d_stl = d_stl0 + (L.sts >> 4) * d;
#ifdef GLA_LOADONLY
    mbar_wait(&ofull[o], (hc >> 1) & 1);
    for (int J = 0; J <= I; ++J, ++it) {
      mbar_wait(&full[it % BSTAGES], (it / BSTAGES) & 1);
      mbar_arrive(&empty[it % BSTAGES]);
    }
    mbar_arrive(&oempty[o]);
    if (h + 1 < h1) operand(d ^ 1);
    continue;
#endif
    const float f0 = fwd_s[I0 + r0], f1 = fwd_s[I0 + r0 + 8];
    const float c0 = cl_s[I0 + r0], c1 = cl_s[I0 + r0 + 8];
    float dq[8] = {}, dp[32] = {};
    mbar_wait(&ofull[o], (hc >> 1) & 1);
    const uint64_t d_y = d_one + TILE_D * o;
    mbar_wait(&full[it % BSTAGES], (it / BSTAGES) & 1);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) wgmma_ss_n16(dq, d_y + 2 * kk, d_sth + 2 * kk, kk > 0);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) wgmma_ss_n16(dq, d_y + 2 * kk, d_stl + 2 * kk, 1);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wgmma_ss_n64(dp, d_y + 2 * kk, d_ring + TILE_D * (it % BSTAGES) + 2 * kk, kk > 0);
    wg_commit();
    GLA_STAMP(1);
    for (int J = 0; J <= I; ++J, ++it) {
      wg_wait<0>();
      fence_regs<32>(dp);
      fence_regs<8>(dq);
      mbar_arrive(&empty[it % BSTAGES]);  // V_J is read
      if (J < I) {  // exp(cum_i - cum_j) = fwd_i g bwd_j, fwd_i applied after the sum
        const float gj = ex2(cl_s[I0] - cl_s[J * BT + BT - 1]);
#pragma unroll
        for (int nb = 0; nb < 8; ++nb) {
          const float2 bb = *reinterpret_cast<const float2*>(bwd_s + J * BT + 8 * nb + 2 * tq);
          dp[4 * nb] *= gj * bb.x;
          dp[4 * nb + 1] *= gj * bb.y;
          dp[4 * nb + 2] *= gj * bb.x;
          dp[4 * nb + 3] *= gj * bb.y;
        }
      } else {  // the diagonal, after the off-diagonal sum takes its row factor
#pragma unroll
        for (int x = 0; x < 8; ++x) dq[x] *= x & 2 ? f1 : f0;
#pragma unroll
        for (int nb = 0; nb < 8; ++nb)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = I0 + r0 + (e & 2 ? 8 : 0), j = I0 + 8 * nb + 2 * tq + (e & 1);
            dp[4 * nb + e] =
                j <= i && i < c ? dp[4 * nb + e] * ex2((e & 2 ? c1 : c0) - cl_s[j]) : 0.f;
          }
      }
      uint32_t hi[4][4], lo[4][4];
      acc_split(dp, hi, lo);
      pin_frag(hi);
      pin_frag(lo);
      fence_regs<32>(dp);
      wg_fence();
      if (J < I) {  // the next key tile's dP
        const int s = (it + 1) % BSTAGES;
        mbar_wait(&full[s], ((it + 1) / BSTAGES) & 1);
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)
          wgmma_ss_n64(dp, d_y + 2 * kk, d_ring + TILE_D * s + 2 * kk, kk > 0);
      }
      const uint64_t d_k = d_tr + TR_D * J;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_rs_n16(dq, hi[kk], d_k + 2 * kk);
        wgmma_rs_n16(dq, lo[kk], d_k + 2 * kk);
      }
      wg_commit();
    }
    wg_wait<0>();
    fence_regs<8>(dq);
    mbar_arrive(&oempty[o]);  // dY_I is read
    GLA_STAMP(2);
    const float2 r = row_dots(qv, dq);
    if (tq == 0) {
      if (I0 + r0 < c) w.rq[bhh * in.S + t0 + I0 + r0] = r.x;
      if (I0 + r0 + 8 < c) w.rq[bhh * in.S + t0 + I0 + r0 + 8] = r.y;
    }
#pragma unroll
    for (int x = 0; x < 8; ++x) dq_tot[x] += dq[x];
    if (h + 1 < h1) operand(d ^ 1);
    GLA_STAMP(3);
#ifdef GLA_CLOCK
    if (blk == 0 && hc < 2 && lane == 0)
      printf("[clock] K4b dq block 0 (query tile %d) head %d warp %d: first group %lld, %d "
             "tiles %lld, epilogue + the next head's operand %lld cycles\n", I, h, warp,
             stamp[1] - stamp[0], I + 1, stamp[2] - stamp[1], stamp[3] - stamp[2]);
#endif
  }
  put_n16<N>(dq_tot, I0 + r0, c, w.dqp + ((long long)g * in.B + b) * in.S * N + (long long)t0 * N);
}

// dk and dv. Grid (nt x B x nc x ng), the key tiles with the most query
// tiles first: a block owns key tile J of one (b, chunk) and walks its head
// group's heads in order. The consumer warpgroup, per head: the inter terms
// dk_h = V_J dS'^T and dv_h = K_J dS' (dS' = exp(tot - cum_J1) dS_z, hi
// and lo); for each query tile I > J from the last, dP^T = V_J dY_I^T and
// the scores K_J Q_I^T (on mma.sync: the K index is N = 16; no head in
// them), both times g_JI fwd_i by column, dv_h += P^T dY_I (P rounded to
// bf16) and dk_h += dP^T Q_I (split hi/lo); dk_h, dv_h *= bwd_j; the
// diagonal tile; then k . dk_h into rk, dk_h into the group's sum in head
// order and dv_h out in bf16. The producer warp streams V_J (two buffers)
// and the dY_I (a ring) by TMA.
template <int N, int P>
__global__ void __launch_bounds__(DKDV_THREADS, 2)
    gla_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap tv,
                        const __grid_constant__ CUtensorMap tdy, GlaIn<bf16> in, Bwd16 w,
                        int v_slots, int dy_slots) {
  constexpr int TILE = BT * P * 2, KS = P / 16, NV = P / 2;
  constexpr uint64_t TILE_D = TILE >> 4, TR_D = 2048 >> 4;
  extern __shared__ uint8_t smem_raw[];
  unsigned char* sm = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const int c = in.c, nc = in.S / c, H = in.H, nt = (c + BT - 1) / BT;
  const TileSmem L(c, P, true);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L.bar);
  uint64_t* empty = full + BSTAGES;
  uint64_t* ofull = empty + BSTAGES;
  uint64_t* oempty = ofull + 2;
  // block -> (J, b, z, head group): the key tiles with the most query tiles
  // first
  const int per = in.B * nc * w.ng;
  const int J = (int)blockIdx.x / per, rest = (int)blockIdx.x % per;
  const int g = rest % w.ng, z = rest / w.ng % nc, b = rest / w.ng / nc;
  const int hg = w.hg > 0 ? w.hg : 1;
  const int h0 = g * hg, h1 = min(h0 + hg, H);
  const int t0 = z * c, J0 = J * BT;
  const int warp = warp_index();
  if (threadIdx.x == 0) {
    for (int i = 0; i < BSTAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 128);
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(&ofull[i], 1);
      mbar_init(&oempty[i], 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (warp >= 4) {  // the producer warpgroup: its registers go to the consumers, lane 0 loads
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x != 128) return;
    for (int h = h0, hc = 0, it = 0; h < h1; ++h, ++hc) {
      const int o = hc & 1;
      if (hc >= 2) mbar_wait(&oempty[o], ((hc >> 1) - 1) & 1);
      mbar_expect_tx(&ofull[o], TILE);
      tma_load(sm + L.one + o * TILE, &tv, &ofull[o], v_slots, t0 + J0, h, b);
      for (int I = nt - 1; I >= J; --I, ++it) {
        const int s = it % BSTAGES;
        if (it >= BSTAGES) mbar_wait(&empty[s], ((it / BSTAGES) - 1) & 1);
        mbar_expect_tx(&full[s], TILE);
        tma_load(sm + L.ring + s * TILE, &tdy, &full[s], dy_slots, t0 + I * BT, h, b);
      }
    }
    return;
  }
  setmaxnreg_inc<CONSUMER_REGS>();
  const int lane = threadIdx.x & 31, tq = lane & 3, r0 = warp * 16 + (lane >> 2);
  // Q_I^T for I >= J, the chunk's q rows and tile J's k rows (head h0's)
  for (int I = J; I < nt; ++I)
    stage_transposed<N>(in.q, in.sq, b, h0, t0, I * BT, c, sm + L.tr + I * 2048);
  stage_rows16<N>(in.q, in.sq, b, h0, t0, 0, nt * BT, c, sm + L.qrows);
  stage_rows16<N>(in.k, in.sk, b, h0, t0, J0, BT, c, sm + L.krow);
  const uint32_t q_a = smem_addr(sm + L.qrows);
  const uint64_t d_one = smem_desc<P>(sm + L.one), d_ring = smem_desc<P>(sm + L.ring);
  const uint64_t d_sth0 = smem_desc<P>(sm + L.sth), d_stl0 = smem_desc<P>(sm + L.stl);
  const uint64_t d_tr = smem_desc<64>(sm + L.tr);
  float dk_tot[8] = {};
  uint32_t ka[4];
  consumer_sync();  // the rows are staged
  load_qa(ka, smem_addr(sm + L.krow), warp);  // K_J's A fragment: the warp's 16 key rows
#ifdef GLA_CLOCK
  long long stamp[4];
#endif
  const int j1 = min(J0 + BT - 1, c - 1);
  auto prefetch = [&](int h, int d) {  // head h's decays and dS_z into buffer d
    const long long bhh = (long long)b * H + h;
    prefetch_head<N, P>(w, bhh * in.S + t0, w.dstate + (bhh * nc + z) * N * P, c, c - 1, j1,
                        d, sm, L);
    cp_commit();
  };
  // the operand exp(tot - cum_J1) dS_z of the head whose rows buffer d holds
  auto operand = [&](int d) {
    cp_wait<0>();
    head_operand<P, true>(d, sm, L);
    fence_proxy_async();
    consumer_sync();  // the buffer is in for every thread
  };
  prefetch(h0, 0);
  operand(0);
  for (int h = h0, hc = 0, it = 0; h < h1; ++h, ++hc) {
    const int o = hc & 1, d = hc & 1;
    const long long bhh = (long long)b * H + h;
    GLA_STAMP(0);
    if (h + 1 < h1) prefetch(h + 1, d ^ 1);  // lands while this head computes
    const float* cl_s = reinterpret_cast<const float*>(sm + L.cl) + d * L.rows;
    const float* fwd_s = reinterpret_cast<const float*>(sm + L.fwd) + d * L.rows;
    const float* bwd_s = reinterpret_cast<const float*>(sm + L.bwd) + d * L.rows;
    const uint64_t d_sth = d_sth0 + (L.sts >> 4) * d, d_stl = d_stl0 + (L.sts >> 4) * d;
#ifdef GLA_LOADONLY
    mbar_wait(&ofull[o], (hc >> 1) & 1);
    for (int I = nt - 1; I >= J; --I, ++it) {
      mbar_wait(&full[it % BSTAGES], (it / BSTAGES) & 1);
      mbar_arrive(&empty[it % BSTAGES]);
    }
    mbar_arrive(&oempty[o]);
    if (h + 1 < h1) operand(d ^ 1);
    continue;
#endif
    const float b0 = bwd_s[J0 + r0], b1 = bwd_s[J0 + r0 + 8];
    const float c0 = cl_s[J0 + r0], c1 = cl_s[J0 + r0 + 8];
    float dk[8] = {}, dv[NV] = {}, dp[32] = {}, sc[8][4];
    uint32_t pa[4][4] = {}, hi[4][4] = {}, lo[4][4] = {};
    mbar_wait(&ofull[o], (hc >> 1) & 1);
    const uint64_t d_v = d_one + TILE_D * o;
    mbar_wait(&full[it % BSTAGES], (it / BSTAGES) & 1);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) wgmma_ss_n16(dk, d_v + 2 * kk, d_sth + 2 * kk, kk > 0);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) wgmma_ss_n16(dk, d_v + 2 * kk, d_stl + 2 * kk, 1);
    mma_rs<P>(dv, ka, d_sth);  // the state tile read MN-major: its 16 rows are the K index
    mma_rs<P>(dv, ka, d_stl);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wgmma_ss_n64(dp, d_v + 2 * kk, d_ring + TILE_D * (it % BSTAGES) + 2 * kk, kk > 0);
    wg_commit();
    GLA_STAMP(1);
    for (int I = nt - 1; I >= J; --I, ++it) {
      scores64(ka, q_a, I, sc);  // no head in them; on mma.sync while the group runs
      // the fragments the products in flight read stay where they are
      pin_frag(pa);
      pin_frag(hi);
      pin_frag(lo);
      wg_wait<0>();
      fence_regs<32>(dp);
      fence_regs<8>(dk);
      fence_regs<NV>(dv);
      if (I < nt - 1) mbar_arrive(&empty[(it - 1) % BSTAGES]);  // the last tile's dY is read
      if (I > J) {  // exp(cum_i - cum_j) = bwd_j g fwd_i, bwd_j applied after the sum
        const float gi = ex2(cl_s[I * BT] - cl_s[J0 + BT - 1]);
#pragma unroll
        for (int nb = 0; nb < 8; ++nb) {
          const float2 ff = *reinterpret_cast<const float2*>(fwd_s + I * BT + 8 * nb + 2 * tq);
          const float x0 = gi * ff.x, x1 = gi * ff.y;
          sc[nb][0] *= x0;
          sc[nb][1] *= x1;
          sc[nb][2] *= x0;
          sc[nb][3] *= x1;
          dp[4 * nb] *= x0;
          dp[4 * nb + 1] *= x1;
          dp[4 * nb + 2] *= x0;
          dp[4 * nb + 3] *= x1;
        }
      } else {  // the diagonal, after the off-diagonal sum takes its row factor
#pragma unroll
        for (int x = 0; x < 8; ++x) dk[x] *= x & 2 ? b1 : b0;
#pragma unroll
        for (int x = 0; x < NV; ++x) dv[x] *= x & 2 ? b1 : b0;
#pragma unroll
        for (int nb = 0; nb < 8; ++nb)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = J0 + r0 + (e & 2 ? 8 : 0), i = J0 + 8 * nb + 2 * tq + (e & 1);
            const float wt = i >= j && i < c ? ex2(cl_s[i] - (e & 2 ? c1 : c0)) : 0.f;
            sc[nb][e] *= wt;
            dp[4 * nb + e] *= wt;
          }
      }
      acc_round(&sc[0][0], pa);
      acc_split(dp, hi, lo);
      pin_frag(pa);
      pin_frag(hi);
      pin_frag(lo);
      fence_regs<32>(dp);
      wg_fence();
      if (I > J) {  // the next query tile's dP^T
        const int s = (it + 1) % BSTAGES;
        mbar_wait(&full[s], ((it + 1) / BSTAGES) & 1);
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)
          wgmma_ss_n64(dp, d_v + 2 * kk, d_ring + TILE_D * s + 2 * kk, kk > 0);
      }
      const uint64_t d_y = d_ring + TILE_D * (it % BSTAGES);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) mma_rs<P>(dv, pa[kk], d_y + mn_step<P>() * kk);
      const uint64_t d_q = d_tr + TR_D * I;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_rs_n16(dk, hi[kk], d_q + 2 * kk);
        wgmma_rs_n16(dk, lo[kk], d_q + 2 * kk);
      }
      wg_commit();
    }
    wg_wait<0>();
    fence_regs<8>(dk);
    fence_regs<NV>(dv);
    mbar_arrive(&empty[(it - 1) % BSTAGES]);
    mbar_arrive(&oempty[o]);  // V_J is read
    GLA_STAMP(2);
    float kv[2][4];  // k of the thread's two rows, from the staged k rows
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
#pragma unroll
      for (int nb = 0; nb < 2; ++nb) {
        const float2 f = unpack(*reinterpret_cast<const uint32_t*>(
            sm + L.krow + swz<2>(r0 + 8 * rr, nb) + 4 * tq));
        kv[rr][2 * nb] = f.x;
        kv[rr][2 * nb + 1] = f.y;
      }
    const float2 r = row_dots(kv, dk);
    if (tq == 0) {
      if (J0 + r0 < c) w.rk[bhh * in.S + t0 + J0 + r0] = r.x;
      if (J0 + r0 + 8 < c) w.rk[bhh * in.S + t0 + J0 + r0 + 8] = r.y;
    }
#pragma unroll
    for (int x = 0; x < 8; ++x) dk_tot[x] += dk[x];
    // dv through staging tile d: its rows leave 16 bytes a thread after the
    // barrier that the next head's operand (or the last head) takes anyway
    unsigned char* stg = sm + L.dvs + d * BT * P * 2;
#pragma unroll
    for (int nb = 0; nb < P / 8; ++nb)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr)
        *reinterpret_cast<uint32_t*>(stg + sw_off<P * 2>(r0 + 8 * rr, 8 * nb + 2 * tq)) =
            pack(dv[4 * nb + 2 * rr], dv[4 * nb + 2 * rr + 1]);
    if (h + 1 < h1)
      operand(d ^ 1);
    else
      consumer_sync();
    for (int idx = threadIdx.x; idx < BT * P / 8; idx += 128) {
      const int r = idx / (P / 8), ch = idx % (P / 8);
      if (J0 + r < c)
        *reinterpret_cast<uint4*>(w.dv + (((long long)b * in.S + t0 + J0 + r) * H + h) * P +
                                  8 * ch) = *reinterpret_cast<const uint4*>(stg + sw_off<P * 2>(r, 8 * ch));
    }
    GLA_STAMP(3);
#ifdef GLA_CLOCK
    if (blockIdx.x == 0 && hc < 2 && lane == 0)
      printf("[clock] K4b dk/dv block 0 (key tile %d) head %d warp %d: first group %lld, %d "
             "tiles %lld, epilogue + the next head's operand %lld cycles\n", J, h, warp,
             stamp[1] - stamp[0], nt - J, stamp[2] - stamp[1], stamp[3] - stamp[2]);
#endif
  }
  put_n16<N>(dk_tot, J0 + r0, c, w.dkp + ((long long)g * in.B + b) * in.S * N + (long long)t0 * N);
}

// The finish. Blocks 0 .. B*H-1: dlg of one (b, h), the suffix sums of r =
// rq - rk from the last row, FIN_ROWS rows staged at a time; one fixed
// order: each thread sums a run of consecutive rows from its top, the runs'
// totals are summed across the block by warp shuffles and the warps' totals
// in warp order, and the later pieces' sum is carried. The other blocks: dq
// and dk out in bf16, the head groups' partials added in group order
// (shared rows) or each head's row moved to [B,S,H,N] (per head).
template <int N, int P>
__global__ void __launch_bounds__(THREADS)
    gla_bwd_finish_kernel(GlaIn<bf16> in, Bwd16 w) {
  __shared__ float x_s[FIN_ROWS];
  __shared__ float wt_s[WARPS];
  const int S = in.S, H = in.H, nbh = in.B * H;
  if ((int)blockIdx.x < nbh) {
    const int b = blockIdx.x / H, h = blockIdx.x % H;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const float* rq = w.rq + (long long)blockIdx.x * S;
    const float* rk = w.rk + (long long)blockIdx.x * S;
    float carry = 0.f;
    GLA_STAMP_DECL(2);
    GLA_STAMP(0);
    for (int hi = S; hi > 0; hi -= FIN_ROWS) {
      const int lo = max(hi - FIN_ROWS, 0), n = hi - lo, run = (n + THREADS - 1) / THREADS;
      __syncthreads();  // the last piece's rows and warp totals are read
      for (int i0 = 0; i0 < n; i0 += 8 * THREADS) {  // eight rows' loads in flight a thread
        float a[8], b[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int i = i0 + u * THREADS + threadIdx.x;
          if (i < n) {
            a[u] = rq[lo + i];
            b[u] = rk[lo + i];
          }
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int i = i0 + u * THREADS + threadIdx.x;
          if (i < n) x_s[i] = a[u] - b[u];
        }
      }
      __syncthreads();
      const int r0 = threadIdx.x * run, r1 = min(r0 + run, n);
      float acc = 0.f;
      for (int i = r1 - 1; i >= r0; --i) {
        acc += x_s[i];
        x_s[i] = acc;
      }
      float suf = acc;  // this thread's run and the later runs of its warp
#pragma unroll
      for (int o = 1; o < 32; o *= 2) {
        const float y = __shfl_down_sync(0xffffffffu, suf, o);
        if (lane + o < 32) suf += y;
      }
      if (lane == 0) wt_s[warp] = suf;
      __syncthreads();
      float later = carry;  // the later warps' runs and the later pieces
      for (int v = WARPS - 1; v > warp; --v) later += wt_s[v];
      float excl = __shfl_down_sync(0xffffffffu, suf, 1);  // the later lanes' runs
      if (lane == 31) excl = 0.f;
      later += excl;
      for (int i = r0; i < r1; ++i)
        w.dlg[((long long)b * S + lo + i) * H + h] = x_s[i] + later;
      for (int v = WARPS - 1; v >= 0; --v) carry += wt_s[v];
    }
    GLA_STAMP(1);
#ifdef GLA_CLOCK
    if (blockIdx.x == 0 && threadIdx.x == 0)
      printf("[clock] K4b finish block 0 (dlg of one (b, h)): %lld cycles\n", stamp[1] - stamp[0]);
#endif
    return;
  }
  GLA_STAMP_DECL(2);
  GLA_STAMP(0);
  const bool shared = w.hg > 0;
  const long long bs = (long long)in.B * S, E = shared ? bs * N : bs * H * N;
  const long long step = (long long)(gridDim.x - nbh) * THREADS;
  for (long long e = (long long)(blockIdx.x - nbh) * THREADS + threadIdx.x; e < E; e += step) {
    long long src = e;  // shared: e = (b S + s) N + n; per head: ((b S + s) H + h) N + n
    if (!shared) {
      const long long n = e % N, hh = e / N % H, row = e / N / H;
      src = (hh * bs + row) * N + n;
    }
    const int ng = shared ? w.ng : 1;
    float x = 0.f, y = 0.f;
    for (int g0 = 0; g0 < ng; g0 += 8) {  // the loads first, then the sums in group order
      float a[8], b[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (g0 + u < ng) {
          a[u] = w.dqp[(g0 + u) * bs * N + src];
          b[u] = w.dkp[(g0 + u) * bs * N + src];
        }
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (g0 + u < ng) {
          x += a[u];
          y += b[u];
        }
    }
    w.dq[e] = __float2bfloat16(x);
    w.dk[e] = __float2bfloat16(y);
  }
  GLA_STAMP(1);
#ifdef GLA_CLOCK
  if ((int)blockIdx.x == nbh && threadIdx.x == 0)
    printf("[clock] K4b finish block %d (dq and dk rows): %lld cycles\n", nbh, stamp[1] - stamp[0]);
#endif
}

// ===========================================================================
// launch
// ===========================================================================

template <typename K>
cudaError_t set_smem(K kern, size_t smem) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// A persistent kernel's grid: as many blocks as fit on the device at once,
// no more than the items.
template <typename K>
cudaError_t persistent_grid(K kern, size_t smem, int items, int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, THREADS, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *grid = items < sms * per_sm ? items : sms * per_sm;
  return cudaSuccess;
}

size_t smem_bytes(Which which, int c, int N, int P, int dtype) {
  if (which == BWD) {  // the largest block of the backward's launches
    if (dtype != 1) return smem_bwd_f32(c, N, P);
    const size_t a = Layout(BWD_STATE, c).total, t = TileSmem(c, P, true).total;
    return a > t ? a : t;
  }
  return dtype == 1 ? (size_t)Layout(which, c).total : smem_f32(which, c, N, P);
}

template <int N, int P>
int launch_bwd_f32(const GlaIn<float>& in, const BwdIO<float>& io, cudaStream_t st) {
  const size_t smem = smem_bwd_f32(in.c, N, P);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  auto kern = gla_bwd_f32_kernel<N, P>;
  const cudaError_t err = set_smem(kern, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<in.B * in.H, THREADS, smem, st>>>(in, io);
  return (int)cudaGetLastError();
}

// K4b in bf16: the state pass, dq (its first blocks the walk), dk/dv and the finish, in that order on
// the caller's stream. The TMA maps of v and dy are encoded per call and
// passed by value (a CUDA graph keeps them).
template <int N, int P>
int launch_bwd(const GlaIn<bf16>& in, const Bwd16& w, cudaStream_t st) {
  static_assert(P % PW == 0 && N <= 16 && N % 8 == 0, "slices of PW columns; N in {8, 16}");
  const int c = in.c, nc = in.S / c, nt = (c + BT - 1) / BT;
  const size_t s_a = Layout(BWD_STATE, c).total, s_q = TileSmem(c, P, false).total,
               s_k = TileSmem(c, P, true).total, smem = s_a > s_k ? s_a : s_k;
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  // Encoding a tensor map needs a current context, and a host thread that
  // has made no CUDA call yet (the autograd engine's worker) has none: bind
  // the device's primary context.
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaSetDevice(dev);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap tdy, tv;
  int dy_slots = 0, v_slots = 0;
  int rc = encode(&tdy, w.dy, P, in.S, in.H, in.B, w.sdy.s, w.sdy.h, w.sdy.b, BT, &dy_slots);
  if (!rc) rc = encode(&tv, in.v, P, in.S, in.H, in.B, in.sv.s, in.sv.h, in.sv.b, BT, &v_slots);
  if (rc) return rc;
  GlaIn<bf16> iy = in;  // the state pass stages dy in v's place
  iy.v = w.dy;
  iy.sv = w.sdy;
  auto ka = gla_bwd_state_kernel<N, P>;
  if ((err = set_smem(ka, s_a)) != cudaSuccess) return (int)err;
  ka<<<in.B * in.H * nc * (P / PW), THREADS, s_a, st>>>(iy, w);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int blocks = in.B * nc * nt * w.ng;  // of dq, and of dk/dv
  const int walk = (in.B * in.H * N * P / 4 + BWD_THREADS - 1) / BWD_THREADS;
  auto kq = gla_bwd_dq_kernel<N, P>;
  if ((err = set_smem(kq, s_q)) != cudaSuccess) return (int)err;
  kq<<<walk + blocks, BWD_THREADS, s_q, st>>>(tdy, tv, in, w, dy_slots, v_slots, walk);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  auto kk = gla_bwd_dkdv_kernel<N, P>;
  if ((err = set_smem(kk, s_k)) != cudaSuccess) return (int)err;
  // the consumers' setmaxnreg.inc must find its registers in the pool the
  // producer gives up (an increase it cannot serve would never return)
  cudaFuncAttributes attr;
  if ((err = cudaFuncGetAttributes(&attr, kk)) != cudaSuccess) return (int)err;
  if (attr.numRegs > DKDV_AT_LAUNCH || attr.numRegs < PRODUCER_REGS)
    return (int)cudaErrorInvalidConfiguration;
  kk<<<blocks, DKDV_THREADS, s_k, st>>>(tv, tdy, in, w, v_slots, dy_slots);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const long long E = (long long)in.B * in.S * N * (w.hg > 0 ? 1 : in.H);
  const long long fill = (E + THREADS - 1) / THREADS;
  gla_bwd_finish_kernel<N, P><<<in.B * in.H + (int)(fill < 1024 ? fill : 1024), THREADS, 0, st>>>(
      in, w);
  return (int)cudaGetLastError();
}

// K4b's dispatch: dtype and (N, P) as dispatch's; strides: q, k, v, lg, dy.
// float32 writes dq and dk per head [B,S,H,N] float32 and takes no scratch;
// bf16 reads and writes the scratch of Bwd16 (scr: cl, fwd, bwd, dstate, rq,
// rk, dqp, dkp) and writes dq and dk in bf16, as the shared rows
// [B,S,N] when hg > 0 (a block walks hg heads; q's and k's head strides are
// then 0) and per head [B,S,H,N] when hg = 0.
int dispatch_bwd(const void* q, const void* k, const void* v, const void* lg, const void* dy,
                 const float* starts, void* dq, void* dk, void* dv, float* dlg,
                 float* const* scr, int B, int S, int H, int N, int P, int c, int hg,
                 const long long* strides, int dtype, void* stream) {
  if (B < 1 || H < 1 || c < 1 || S < c || S % c != 0 || starts == nullptr || hg < 0)
    return (int)cudaErrorInvalidValue;
  const Strides sq{strides[0], strides[1], strides[2]}, sk{strides[3], strides[4], strides[5]},
      sv{strides[6], strides[7], strides[8]}, sl{strides[9], strides[10], strides[11]},
      sd{strides[12], strides[13], strides[14]};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* lgf = static_cast<const float*>(lg);
  if (dtype == 0) {
#define GLA_BWD_F32(NN, PP)                                                                   \
  if (N == NN && P == PP) {                                                                  \
    const GlaIn<float> in{static_cast<const float*>(q), static_cast<const float*>(k),        \
                          static_cast<const float*>(v), lgf, sq, sk, sv, sl, S, H, c, B};    \
    const BwdIO<float> io{static_cast<const float*>(dy), sd, starts, static_cast<float*>(dq), \
                          static_cast<float*>(dk), static_cast<float*>(dv), dlg};            \
    return launch_bwd_f32<NN, PP>(in, io, st);                                               \
  }
    GLA_BWD_F32(16, 64)
    GLA_BWD_F32(8, 32)
#undef GLA_BWD_F32
  } else if (dtype == 1) {
    if (scr == nullptr || (hg > 0 && (sq.h != 0 || sk.h != 0))) return (int)cudaErrorInvalidValue;
    const Bwd16 w{static_cast<const bf16*>(dy), sd, starts, scr[0], scr[1], scr[2], scr[3],
                  scr[4], scr[5], scr[6], scr[7], static_cast<bf16*>(dq),
                  static_cast<bf16*>(dk), static_cast<bf16*>(dv), dlg, hg,
                  head_groups(H, hg)};
#define GLA_BWD_BF16(NN, PP)                                                                  \
  if (N == NN && P == PP) {                                                                  \
    const GlaIn<bf16> in{static_cast<const bf16*>(q), static_cast<const bf16*>(k),           \
                         static_cast<const bf16*>(v), lgf, sq, sk, sv, sl, S, H, c, B};      \
    return launch_bwd<NN, PP>(in, w, st);                                               \
  }
    GLA_BWD_BF16(16, 64)
    GLA_BWD_BF16(8, 32)
#undef GLA_BWD_BF16
  }
  return (int)cudaErrorInvalidValue;
}

template <int N, int P>
int launch_f32(Which which, const GlaIn<float>& in, int B, void* o0, void* o1, void* o2,
               cudaStream_t st) {
  const int nc = in.S / in.c;
  const size_t smem = smem_f32(which, in.c, N, P);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (which == CHUNK) {
    auto kern = gla_chunk_f32_kernel<N, P>;
    if ((err = set_smem(kern, smem)) != cudaSuccess) return (int)err;
    kern<<<B * in.H, THREADS, smem, st>>>(in, static_cast<float*>(o0), static_cast<float*>(o1),
                                          static_cast<float*>(o2));
  } else if (which == PHASE_A) {
    auto kern = gla_phase_a_f32_kernel<N, P>;
    if ((err = set_smem(kern, smem)) != cudaSuccess) return (int)err;
    kern<<<dim3(nc, B * in.H), THREADS, smem, st>>>(
        in, static_cast<float*>(o0), static_cast<float*>(o1), static_cast<float*>(o2));
  } else {
    auto kern = gla_phase_b_f32_kernel<N, P>;
    if ((err = set_smem(kern, smem)) != cudaSuccess) return (int)err;
    kern<<<dim3(nc, B * in.H), THREADS, smem, st>>>(
        in, static_cast<const float*>(o1), static_cast<const float*>(o2), static_cast<float*>(o0));
  }
  return (int)cudaGetLastError();
}

template <int N, int P>
int launch_bf16(Which which, const GlaIn<bf16>& in, int B, void* o0, void* o1, void* o2,
                cudaStream_t st) {
  static_assert(P % PW == 0 && N <= 16 && N % 8 == 0, "slices of PW columns; N in {8, 16}");
  constexpr int NS = P / PW;
  const int nc = in.S / in.c;
  const size_t smem = Layout(which, in.c).total;
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (which == CHUNK) {
    auto kern = gla_chunk_kernel<N, P>;
    if ((err = set_smem(kern, smem)) != cudaSuccess) return (int)err;
    kern<<<B * in.H * NS, THREADS, smem, st>>>(in, static_cast<bf16*>(o0),
                                               static_cast<float*>(o1), static_cast<float*>(o2));
  } else if (which == PHASE_A) {
    auto kern = gla_phase_a_kernel<N, P>;
    int grid = 0;
    if ((err = set_smem(kern, smem)) != cudaSuccess ||
        (err = persistent_grid(kern, smem, nc * NS * B * in.H, &grid)) != cudaSuccess)
      return (int)err;
    kern<<<grid, THREADS, smem, st>>>(in, static_cast<bf16*>(o0), static_cast<float*>(o1),
                                      static_cast<float*>(o2));
  } else {
    // y_intra ([B,S,H,P], contiguous) is staged in v's place
    GlaIn<bf16> iy = in;
    iy.v = static_cast<const bf16*>(o2);
    iy.sv = Strides{(long long)in.S * in.H * P, (long long)in.H * P, P};
    auto kern = gla_phase_b_kernel<N, P>;
    int grid = 0;
    if ((err = set_smem(kern, smem)) != cudaSuccess ||
        (err = persistent_grid(kern, smem, nc * NS * B * in.H, &grid)) != cudaSuccess)
      return (int)err;
    kern<<<grid, THREADS, smem, st>>>(iy, static_cast<const float*>(o1),
                                      static_cast<bf16*>(o0));
  }
  return (int)cudaGetLastError();
}

// dtype 0 = float32, 1 = bfloat16; (N, P) in {(16, 64), (8, 32)}: the
// SSD heads of hymba-1.5b at full width and at the smoke config.
int dispatch(Which which, const void* q, const void* k, const void* v, const void* lg,
             void* o0, void* o1, void* o2, int B, int S, int H, int N, int P, int c,
             const long long* strides, int dtype, void* stream) {
  if (B < 1 || H < 1 || c < 1 || S < c || S % c != 0) return (int)cudaErrorInvalidValue;
  const Strides sq{strides[0], strides[1], strides[2]}, sk{strides[3], strides[4], strides[5]},
      sv{strides[6], strides[7], strides[8]}, sl{strides[9], strides[10], strides[11]};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* lgf = static_cast<const float*>(lg);
#define GLA_CASE(T, NN, PP, LAUNCH)                                                          \
  if (N == NN && P == PP) {                                                                  \
    const GlaIn<T> in{static_cast<const T*>(q), static_cast<const T*>(k),                    \
                      static_cast<const T*>(v), lgf, sq, sk, sv, sl, S, H, c, B};            \
    return LAUNCH<NN, PP>(which, in, B, o0, o1, o2, st);                                     \
  }
  if (dtype == 1) {
    GLA_CASE(bf16, 16, 64, launch_bf16)
    GLA_CASE(bf16, 8, 32, launch_bf16)
  } else if (dtype == 0) {
    GLA_CASE(float, 16, 64, launch_f32)
    GLA_CASE(float, 8, 32, launch_f32)
  }
#undef GLA_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// K4. y: [B,S,H,P] contiguous in q's type; state: [B,H,N,P] float32.
// strides: q, k, v, lg, three each (batch, position, head), in elements.
extern "C" int repro_gla_chunk(const void* q, const void* k, const void* v, const void* lg,
                               void* y, void* state, int B, int S, int H, int N, int P,
                               int c, const long long* strides, int dtype, void* stream) {
  return dispatch(CHUNK, q, k, v, lg, y, state, nullptr, B, S, H, N, P, c, strides, dtype,
                  stream);
}

// K4 for training: repro_gla_chunk, and the state entering each chunk into
// starts, [B,H,nc,N,P] float32 contiguous (zeros for chunk 0), which the
// backward reads. y and state are the same bits as repro_gla_chunk's.
extern "C" int repro_gla_chunk_starts(const void* q, const void* k, const void* v,
                                      const void* lg, void* y, void* state, void* starts, int B,
                                      int S, int H, int N, int P, int c,
                                      const long long* strides, int dtype, void* stream) {
  if (starts == nullptr) return (int)cudaErrorInvalidValue;
  return dispatch(CHUNK, q, k, v, lg, y, state, starts, B, S, H, N, P, c, strides, dtype,
                  stream);
}

// K5 phase A. y_intra: [B,S,H,P] contiguous; g: [B,H,nc]; d: [B,H,nc,N,P].
extern "C" int repro_gla_phase_a(const void* q, const void* k, const void* v, const void* lg,
                                 void* y_intra, void* g, void* d, int B, int S, int H, int N,
                                 int P, int c, const long long* strides, int dtype,
                                 void* stream) {
  return dispatch(PHASE_A, q, k, v, lg, y_intra, g, d, B, S, H, N, P, c, strides, dtype,
                  stream);
}

// K5 phase B. start: [B,H,nc,N,P] float32; y_intra, y: [B,S,H,P]
// contiguous. Only the q and lg strides are read.
extern "C" int repro_gla_phase_b(const void* q, const void* lg, const void* start,
                                 const void* y_intra, void* y, int B, int S, int H, int N,
                                 int P, int c, const long long* strides, int dtype,
                                 void* stream) {
  return dispatch(PHASE_B, q, nullptr, nullptr, lg, y, const_cast<void*>(start),
                  const_cast<void*>(y_intra), B, S, H, N, P, c, strides, dtype, stream);
}

// K4b, the backward of K4's function, from q, k, v, lg, dy and K4's chunk
// start states starts [B,H,nc,N,P] float32: dv [B,S,H,P] in v's type and
// dlg [B,S,H] float32, contiguous, and dq, dk: float32 per head [B,S,H,N]
// (dtype 0); bf16 (dtype 1) as the shared rows [B,S,N] (hg > 0: q's and k's
// head strides 0, a block of the dq and dk/dv launches walks hg heads) or
// per head [B,S,H,N] (hg = 0). The bf16 launches' scratch, float32 contiguous (null
// for float32): cl, fwd, bwd, rq, rk [B,H,S], dstate [B,H,nc,N,P] (the
// gradient of the state leaving each chunk) and dqp, dkp [ng,B,S,N] with ng
// = ceil(H / hg) (H when hg = 0). strides: q, k, v,
// lg, dy, three each (batch, position, head), in elements.
extern "C" int repro_gla_chunk_bwd(const void* q, const void* k, const void* v, const void* lg,
                                   const void* dy, const void* starts, void* dq, void* dk,
                                   void* dv, void* dlg, void* cl, void* fwd, void* bwd,
                                   void* dstate, void* rq, void* rk, void* dqp, void* dkp,
                                   int B, int S, int H, int N, int P, int c, int hg,
                                   const long long* strides, int dtype, void* stream) {
  float* const scr[8] = {static_cast<float*>(cl),     static_cast<float*>(fwd),
                         static_cast<float*>(bwd),    static_cast<float*>(dstate),
                         static_cast<float*>(rq),     static_cast<float*>(rk),
                         static_cast<float*>(dqp),    static_cast<float*>(dkp)};
  return dispatch_bwd(q, k, v, lg, dy, static_cast<const float*>(starts), dq, dk, dv,
                      static_cast<float*>(dlg), dtype == 1 ? scr : nullptr, B, S, H, N, P, c,
                      hg, strides, dtype, stream);
}

// Dynamic shared memory of one block of kernel `which` (0 K4, 1 phase A, 2
// phase B, 3 K4b) at chunk c, in bytes; the launch refuses more than a block
// has.
extern "C" long long repro_gla_smem_bytes(int which, int c, int N, int P, int dtype) {
  return (long long)smem_bytes(static_cast<Which>(which), c, N, P, dtype);
}
