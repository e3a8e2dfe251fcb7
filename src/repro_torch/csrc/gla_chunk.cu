// Chunked gated linear attention (GLA) for NVIDIA Hopper (sm_90a): both
// schedules of the JAX package's Pallas kernels, and the backward.
//
// Replaces: src/repro/kernels/mlstm_chunk.py::_kernel (gla_chunk: K4 here,
// repro_gla_chunk; for training repro_gla_chunk_starts, which also writes
// the state entering each chunk) and ::_phase_a_kernel / ::_phase_b_kernel
// (gla_chunk_parallel: K5 here, repro_gla_phase_a / repro_gla_phase_b).
// The backward (K4b, repro_gla_chunk_bwd, after the forward kernels)
// replaces no Pallas kernel: the JAX package differentiates the plain-XLA
// models/ssm.py chunked_gla; its design note is at gla_bwd_kernel.
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
#ifdef GLA_CLOCK
#include <cstdio>
#define GLA_STAMP(k) stamp[k] = clock64()
#else
#define GLA_STAMP(k)
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

enum Which { CHUNK = 0, PHASE_A = 1, PHASE_B = 2, BWD = 3 };

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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes (4: cp4) from global to shared, or zeros when !full
__device__ __forceinline__ void cp16(uint32_t dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(full ? 16 : 0));
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
// (the phases) while the other computes: q rows and (not phase B) k rows
// [tc][16] bf16, the PW-column slice of v (phase B: of y_intra) [tc][PW]
// bf16, lg [tc] float32 (scanned in place), and in phase B the item's start
// state slice [16][PW] float32. Two sets of the decays, one a stage, from
// dset, dsz bytes each: cl = cum log2(e), bk, al, w, e [tc] float32 and the
// scan's segment totals. K4's state slice [16][PW] float32. The warps'
// scratch, wsz bytes each: state partials [16][PW + 4] float32 (K4, phase
// A), also the staged output rows [16][PW] bf16.
struct Layout {
  int stage, q, k, v, lg, st0, dset, dsz, cl, bk, al, w, e, tot, state, scratch, wsz, total;
  __host__ __device__ Layout(Which which, int c) {
    const int tc = (c + 15) & ~15;
    q = 0;
    k = q + tc * 32;
    v = k + (which == PHASE_B ? 0 : tc * 32);
    lg = v + tc * PW * 2;
    st0 = lg + tc * 4;
    stage = st0 + (which == PHASE_B ? 16 * PW * 4 : 0);
    dset = 2 * stage;
    cl = 0;
    bk = cl + tc * 4;
    al = bk + tc * 4;
    w = al + tc * 4;
    e = w + tc * 4;
    tot = e + tc * 4;
    dsz = tot + (((tc + 31) / 32 * 4 + 15) & ~15);
    state = dset + 2 * dsz;
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
// tile (1 in tile 0); w = exp(total - cum_j). It returns total = cum_{c-1}.
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
template <bool INTRA>
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
    if (INTRA) {
      cl_s[j] = cl;
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
// Per (b, h), the chunks in reverse, carrying dS (the gradient of the state
// leaving the chunk; zero after the last), with cum the chunk's inclusive
// cumsum of lg, tot its last value, S_z K4's state entering it and
// W_ij = exp(cum_i - cum_j) for j <= i:
//   dq_i = sum_{j<=i} W_ij (dy_i . v_j) k_j + exp(cum_i) S_z dy_i
//   dk_j = sum_{i>=j} W_ij (dy_i . v_j) q_i + exp(tot - cum_j) dS v_j
//   dv_j = sum_{i>=j} W_ij (q_i . k_j) dy_i + exp(tot - cum_j) dS^T k_j
//   dS  <- exp(tot) dS + sum_i exp(cum_i) q_i dy_i^T
// and dlg_t = sum_{s>=t} (q_s . dq_s - k_s . dk_s), the scalar decay's
// identity (the final state takes no gradient). The plain version is
// kernels/ref.py gla_bwd. dq and dk leave per head in float32: the model's
// q and k are one row shared by the heads (head stride 0), and dlg needs
// each head's own dots, so the sum over heads is the caller's.
//
// Bound: at hymba's training shape (B4 S1536 H25 N16 P64, c 256, bf16)
// about 83 MB move (v, dy, dv in bf16, dq and dk per head in float32, the
// states, lg and dlg): 24.7 us at 3.35 TB/s, against ~8 GFLOP of products
// (c^2 (3N + 2P) multiply-adds under the causal half and four c N P state
// products a chunk), 8 us of bf16 tensor-core time. Device-memory bytes
// bound it.
//
// Design, deterministic with no atomics (the port's recovery is held
// byte for byte): one block per (b, h) owns all P columns, because dq, dk
// and dlg's dots sum over them (100 blocks at hymba's shape, one wave of
// the 132 SMs). Two stages: chunk z - 1's rows load by cp.async while z
// computes. Each warp takes query tiles t and T-1-t for dq and key tiles
// t and T-1-t for dk and dv (T + 1 tile steps each), on mma.sync with K4's
// swizzled staging and fragments: dq's pass computes dY_I V_J^T, dk/dv's
// the transposed tiles V_J dY_I^T and K_J Q_I^T, so each product's
// accumulator is the next one's A fragment. dlg is a difference of
// per-row dots, so the decayed dY.V^T is split hi/lo into bf16 pairs for
// the dq and dk products (float32 to about 16 bits), as are S_z and dS;
// the decayed q.k for dv is rounded to bf16, as K4 rounds its
// probabilities. Each element's decay is one ex2 under the causal mask.
// dS's increment is summed per warp and the 8 partials added in warp
// order; warp 0 runs dlg's suffix sums in 32-row segments with the later
// chunks' carry. float32 runs a scalar kernel (exact products, no TF32),
// one thread a row for dq and one a column for dk and dv.
// On an H100 80GB HBM3 at 700 W (PERF.md) it takes 139.7 us, 5.7x the
// bound: every tile's dY_I V_J^T is computed in both passes, each element
// takes an ex2, and 100 blocks of 8 warps leave the tensor pipes idle on
// each chain's latency; more blocks (a column split whose partials are
// added in order) and K4's factored decays are the next steps.

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

// Dynamic shared memory of a bf16 backward block, byte offsets; rows padded
// to tc (the chunk rounded up to 16), q and k rows to 16 columns. Two
// stages, one chunk's while the one before it loads: q and k rows [tc][16]
// and v and dy rows [tc][P] bf16 (XOR-swizzled), lg [tc] float32 (scanned in
// place into cum) and the entering state S_z [16][P] float32 (rows n >= N
// zero). Then the carried dS [16][P] float32, the decays cl = cum log2(e),
// eq = exp(cum) and ek = exp(tot - cum) [tc], the rows' q.dq and k.dk [tc],
// float32, and the warps' dS partials [WARPS][16][P + 4] float32.
struct BwdLayout {
  int q, k, v, dy, lg, sz, stage, ds, cl, eq, ek, rq, rk, scratch, total;
  __host__ __device__ BwdLayout(int c, int P) {
    const int tc = (c + 15) & ~15;
    q = 0;
    k = q + tc * 32;
    v = k + tc * 32;
    dy = v + tc * P * 2;
    lg = dy + tc * P * 2;
    sz = lg + tc * 4;
    stage = sz + 16 * P * 4;
    ds = 2 * stage;
    cl = ds + 16 * P * 4;
    eq = cl + tc * 4;
    ek = eq + tc * 4;
    rq = ek + tc * 4;
    rk = rq + tc * 4;
    scratch = rk + tc * 4;
    total = scratch + WARPS * 16 * (P + 4) * 4;
  }
};

// Stage chunk z of (b, h) by cp.async (not committed): rows c..tc-1 and the
// q/k columns from N to 16 are zeros, and so are S_z's rows from N.
template <int N, int P>
__device__ void bwd_stage(const GlaIn<bf16>& in, const BwdIO<bf16>& io, int b, int h, int z,
                          unsigned char* st, const BwdLayout& L) {
  constexpr int VCH = P / 8, PCH = P / 4;
  const int c = in.c, tc = (c + 15) & ~15, t0 = z * c;
  const uint32_t qa = smem_addr(st + L.q), ka = smem_addr(st + L.k);
  for (int idx = threadIdx.x; idx < tc * 2; idx += THREADS) {
    const int j = idx >> 1, ch = idx & 1;
    const bool ok = j < c && ch * 8 < N;
    cp16(qa + swz<2>(j, ch), in.q + (ok ? in.sq.at(b, t0 + j, h) + ch * 8 : 0), ok);
    cp16(ka + swz<2>(j, ch), in.k + (ok ? in.sk.at(b, t0 + j, h) + ch * 8 : 0), ok);
  }
  const uint32_t va = smem_addr(st + L.v), da = smem_addr(st + L.dy);
  for (int idx = threadIdx.x; idx < tc * VCH; idx += THREADS) {
    const int j = idx / VCH, ch = idx % VCH;
    const bool ok = j < c;
    cp16(va + swz<VCH>(j, ch), in.v + (ok ? in.sv.at(b, t0 + j, h) + ch * 8 : 0), ok);
    cp16(da + swz<VCH>(j, ch), io.dy + (ok ? io.sdy.at(b, t0 + j, h) + ch * 8 : 0), ok);
  }
  const uint32_t la = smem_addr(st + L.lg);
  for (int j = threadIdx.x; j < tc; j += THREADS) {
    const bool ok = j < c;
    cp4(la + 4 * j, in.lg + (ok ? in.sl.at(b, t0 + j, h) : 0), ok);
  }
  const float* src = io.starts + ((long long)(b * in.H + h) * (in.S / c) + z) * N * P;
  const uint32_t sa = smem_addr(st + L.sz);
  for (int idx = threadIdx.x; idx < 16 * PCH; idx += THREADS) {
    const int n = idx / PCH, ch = idx % PCH;
    cp16(sa + 16 * idx, src + (n < N ? n * P + ch * 4 : 0), n < N);
  }
}

// ldmatrix lane addresses of the 16 x 16 bf16 block at rows r0.. and
// column group kc (16-byte pieces 2kc, 2kc + 1) of rows of CH pieces.
// lane_a: with ldsm the block as an A fragment (rows the M index); with
// ldsm_t the B fragments of column tiles 2kc and 2kc + 1 of the block read
// as [K][N] (rows the K index): {b0, b1} of each. lane_b: with ldsm the B
// fragments of row tiles 0 and 1 of the block read as [N][K] (the product
// with its transpose); with ldsm_t the A fragment of its transpose.
template <int CH>
__device__ __forceinline__ uint32_t lane_a(uint32_t base, int r0, int kc) {
  const int lane = threadIdx.x & 31, m = lane >> 3, r = lane & 7;
  return base + swz<CH>(r0 + (m & 1) * 8 + r, 2 * kc + (m >> 1));
}
template <int CH>
__device__ __forceinline__ uint32_t lane_b(uint32_t base, int r0, int kc) {
  const int lane = threadIdx.x & 31, m = lane >> 3, r = lane & 7;
  return base + swz<CH>(r0 + (m >> 1) * 8 + r, 2 * kc + (m & 1));
}

// A C fragment pair (two 16x8 tiles, rows m, columns 0-15) as the A
// fragment of the next product, hi and lo: float32 to about 16 bits
__device__ __forceinline__ void split_a(const float (&s)[2][4], uint32_t (&hi)[4],
                                        uint32_t (&lo)[4]) {
  split(s[0][0], s[0][1], hi[0], lo[0]);
  split(s[0][2], s[0][3], hi[1], lo[1]);
  split(s[1][0], s[1][1], hi[2], lo[2]);
  split(s[1][2], s[1][3], hi[3], lo[3]);
}

// x[nt] += A . X^T over P for a float32 X [16][P] in shared memory (rows n,
// split hi/lo as B fragments): A's fragments a[kc] for k = p in 16kc..
template <int P>
__device__ __forceinline__ void times_xt(const uint32_t (&a)[P / 16][4], const float* x,
                                         float (&out)[2][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kc = 0; kc < P / 16; ++kc)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const float* r = x + (8 * nt + g) * P + 16 * kc + 2 * t;
      uint32_t h0, l0, h1, l1;
      split(r[0], r[1], h0, l0);
      split(r[8], r[9], h1, l1);
      mma(out[nt], a[kc], h0, h1);
      mma(out[nt], a[kc], l0, l1);
    }
}

// Write a 16 x 16 float32 tile's columns n < N of rows i < c (row i at out +
// i * rs, rows r0..) and return each row's dot with the bf16 rows x (q or
// k, in shared memory at xa): lane (g, t) gets rows r0 + g and r0 + g + 8.
template <int N>
__device__ __forceinline__ float2 put_nrows(const float (&o)[2][4], int r0, int c,
                                            const unsigned char* xa, float* out, long long rs) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3, i0 = r0 + g;
  float d0 = 0.f, d1 = 0.f;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    const int n = 8 * nt + 2 * t;
    if (n < N) {
      const float2 x0 = unpack(*reinterpret_cast<const uint32_t*>(xa + swz<2>(i0, nt) + 4 * t));
      const float2 x1 =
          unpack(*reinterpret_cast<const uint32_t*>(xa + swz<2>(i0 + 8, nt) + 4 * t));
      d0 += x0.x * o[nt][0] + x0.y * o[nt][1];
      d1 += x1.x * o[nt][2] + x1.y * o[nt][3];
      if (i0 < c) *reinterpret_cast<float2*>(out + i0 * rs + n) = make_float2(o[nt][0], o[nt][1]);
      if (i0 + 8 < c)
        *reinterpret_cast<float2*>(out + (i0 + 8) * rs + n) = make_float2(o[nt][2], o[nt][3]);
    }
  }
#pragma unroll
  for (int o_ = 1; o_ < 4; o_ *= 2) {
    d0 += __shfl_xor_sync(0xffffffffu, d0, o_);
    d1 += __shfl_xor_sync(0xffffffffu, d1, o_);
  }
  return make_float2(d0, d1);
}

// dq of query tile I: sum over key tiles J <= I of (W o dY_I V_J^T) K_J,
// then diag(exp(cum)) dY_I S_z^T; rows and q.dq out. The first product's
// A (dY) and B (V) are bf16 as given; W o (dY V^T) is split hi/lo for the
// second, so dq is float32 to about 16 bits (dlg is a difference of such
// dots).
template <int N, int P>
__device__ __forceinline__ void bwd_dq_tile(int I, int c, const unsigned char* st,
                                            const BwdLayout& L, const float* cl_s,
                                            const float* eq_s, float* rq_s, float* dq,
                                            long long rs) {
  constexpr int VCH = P / 8, KS = P / 16;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3, i0 = 16 * I + g;
  const uint32_t k_a = smem_addr(st + L.k), v_a = smem_addr(st + L.v),
                 d_a = smem_addr(st + L.dy);
  uint32_t dya[KS][4];
#pragma unroll
  for (int kc = 0; kc < KS; ++kc) ldsm(dya[kc], lane_a<VCH>(d_a, 16 * I, kc));
  const float c0 = cl_s[i0], c1 = cl_s[i0 + 8];
  float acc[2][4] = {};
  for (int J = 0; J <= I; ++J) {
    float s[2][4] = {};
#pragma unroll
    for (int kc = 0; kc < KS; ++kc) {
      uint32_t vb[4];
      ldsm(vb, lane_b<VCH>(v_a, 16 * J, kc));
      mma(s[0], dya[kc], vb[0], vb[1]);
      mma(s[1], dya[kc], vb[2], vb[3]);
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int j = 16 * J + 8 * nt + 2 * t + (x & 1), i = i0 + (x < 2 ? 0 : 8);
        s[nt][x] = (J < I || i >= j) ? s[nt][x] * ex2((x < 2 ? c0 : c1) - cl_s[j]) : 0.f;
      }
    uint32_t hi[4], lo[4], kb[4];
    split_a(s, hi, lo);
    ldsm_t(kb, lane_a<2>(k_a, 16 * J, 0));
    mma(acc[0], hi, kb[0], kb[1]);
    mma(acc[0], lo, kb[0], kb[1]);
    mma(acc[1], hi, kb[2], kb[3]);
    mma(acc[1], lo, kb[2], kb[3]);
  }
  float x[2][4] = {};
  times_xt<P>(dya, reinterpret_cast<const float*>(st + L.sz), x);
  const float e0 = eq_s[i0], e1 = eq_s[i0 + 8];
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    acc[nt][0] += e0 * x[nt][0];
    acc[nt][1] += e0 * x[nt][1];
    acc[nt][2] += e1 * x[nt][2];
    acc[nt][3] += e1 * x[nt][3];
  }
  const float2 r = put_nrows<N>(acc, 16 * I, c, st + L.q, dq, rs);
  if (t == 0) {
    rq_s[i0] = r.x;
    rq_s[i0 + 8] = r.y;
  }
}

// dk and dv of key tile J: over query tiles I >= J, with the tiles
// transposed (rows j): dk += (W o V_J dY_I^T) Q_I (A split hi/lo, as dq's)
// and dv += (W o K_J Q_I^T) dY_I (A rounded to bf16, as K4 rounds its
// probabilities); then diag(exp(tot - cum)) times V_J dS^T and K_J dS (dS
// split hi/lo). Rows, k.dk and dv out.
template <int N, int P>
__device__ __forceinline__ void bwd_dkdv_tile(int J, int T, int c, const unsigned char* st,
                                              const BwdLayout& L, const float* cl_s,
                                              const float* ek_s, const float* ds_s,
                                              float* rk_s, float* dk_out, long long rsk,
                                              bf16* dv_out, long long rsv) {
  constexpr int VCH = P / 8, KS = P / 16, NT = P / 8;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3, j0 = 16 * J + g;
  const uint32_t q_a = smem_addr(st + L.q), k_a = smem_addr(st + L.k),
                 v_a = smem_addr(st + L.v), d_a = smem_addr(st + L.dy);
  uint32_t ka[4], va[KS][4];
  ldsm(ka, lane_a<2>(k_a, 16 * J, 0));
#pragma unroll
  for (int kc = 0; kc < KS; ++kc) ldsm(va[kc], lane_a<VCH>(v_a, 16 * J, kc));
  const float c0 = cl_s[j0], c1 = cl_s[j0 + 8];
  float dk[2][4] = {}, dv[NT][4] = {};
  for (int I = J; I < T; ++I) {
    float at[2][4] = {}, pt[2][4] = {};
    uint32_t qb[4];
    ldsm(qb, lane_b<2>(q_a, 16 * I, 0));
    mma(at[0], ka, qb[0], qb[1]);
    mma(at[1], ka, qb[2], qb[3]);
#pragma unroll
    for (int kc = 0; kc < KS; ++kc) {
      uint32_t db[4];
      ldsm(db, lane_b<VCH>(d_a, 16 * I, kc));
      mma(pt[0], va[kc], db[0], db[1]);
      mma(pt[1], va[kc], db[2], db[3]);
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int i = 16 * I + 8 * nt + 2 * t + (x & 1), j = j0 + (x < 2 ? 0 : 8);
        const float w = (I > J || i >= j) ? ex2(cl_s[i] - (x < 2 ? c0 : c1)) : 0.f;
        at[nt][x] *= w;
        pt[nt][x] *= w;
      }
    uint32_t hi[4], lo[4], qt[4];
    split_a(pt, hi, lo);
    ldsm_t(qt, lane_a<2>(q_a, 16 * I, 0));
    mma(dk[0], hi, qt[0], qt[1]);
    mma(dk[0], lo, qt[0], qt[1]);
    mma(dk[1], hi, qt[2], qt[3]);
    mma(dk[1], lo, qt[2], qt[3]);
    const uint32_t pa[4] = {pack(at[0][0], at[0][1]), pack(at[0][2], at[0][3]),
                            pack(at[1][0], at[1][1]), pack(at[1][2], at[1][3])};
#pragma unroll
    for (int kc = 0; kc < KS; ++kc) {
      uint32_t db[4];
      ldsm_t(db, lane_a<VCH>(d_a, 16 * I, kc));
      mma(dv[2 * kc], pa, db[0], db[1]);
      mma(dv[2 * kc + 1], pa, db[2], db[3]);
    }
  }
  const float e0 = ek_s[j0], e1 = ek_s[j0 + 8];
  float x[2][4] = {};
  times_xt<P>(va, ds_s, x);
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    dk[nt][0] += e0 * x[nt][0];
    dk[nt][1] += e0 * x[nt][1];
    dk[nt][2] += e1 * x[nt][2];
    dk[nt][3] += e1 * x[nt][3];
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int p = 8 * nt + g;
    uint32_t h0, l0, h1, l1;
    split(ds_s[2 * t * P + p], ds_s[(2 * t + 1) * P + p], h0, l0);
    split(ds_s[(2 * t + 8) * P + p], ds_s[(2 * t + 9) * P + p], h1, l1);
    float y[4] = {};
    mma(y, ka, h0, h1);
    mma(y, ka, l0, l1);
    dv[nt][0] += e0 * y[0];
    dv[nt][1] += e0 * y[1];
    dv[nt][2] += e1 * y[2];
    dv[nt][3] += e1 * y[3];
  }
  const float2 r = put_nrows<N>(dk, 16 * J, c, st + L.k, dk_out, rsk);
  if (t == 0) {
    rk_s[j0] = r.x;
    rk_s[j0 + 8] = r.y;
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int p = 8 * nt + 2 * t;
    if (j0 < c) *reinterpret_cast<uint32_t*>(dv_out + j0 * rsv + p) = pack(dv[nt][0], dv[nt][1]);
    if (j0 + 8 < c)
      *reinterpret_cast<uint32_t*>(dv_out + (j0 + 8) * rsv + p) = pack(dv[nt][2], dv[nt][3]);
  }
}

// This warp's share of the chunk's dS increment, sum over its query tiles
// I = warp, warp + 8, ... of (Q_I diag(exp(cum)))^T dY_I: rows n, columns
// p; the scaled q split hi/lo (as K4's state delta).
template <int P>
__device__ __forceinline__ void bwd_ds_part(int T, const unsigned char* st, const BwdLayout& L,
                                            const float* eq_s, float (&d)[P / 8][4]) {
  constexpr int VCH = P / 8, KS = P / 16;
  const int t = threadIdx.x & 3;
  const uint32_t q_a = smem_addr(st + L.q), d_a = smem_addr(st + L.dy);
  for (int I = threadIdx.x >> 5; I < T; I += WARPS) {
    uint32_t qa[4], hi[4], lo[4];
    ldsm_t(qa, lane_b<2>(q_a, 16 * I, 0));
    const float2 w0 = *reinterpret_cast<const float2*>(eq_s + 16 * I + 2 * t);
    const float2 w1 = *reinterpret_cast<const float2*>(eq_s + 16 * I + 8 + 2 * t);
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const float2 f = unpack(qa[x]), w = x < 2 ? w0 : w1;
      split(f.x * w.x, f.y * w.y, hi[x], lo[x]);
    }
#pragma unroll
    for (int kc = 0; kc < KS; ++kc) {
      uint32_t db[4];
      ldsm_t(db, lane_a<VCH>(d_a, 16 * I, kc));
      mma(d[2 * kc], hi, db[0], db[1]);
      mma(d[2 * kc], lo, db[0], db[1]);
      mma(d[2 * kc + 1], hi, db[2], db[3]);
      mma(d[2 * kc + 1], lo, db[2], db[3]);
    }
  }
}

// K4b, bf16. Grid (B*H): one block per (b, h) walks the chunks in reverse
// with dS [16][P] in shared memory, two stages (chunk z - 1 loads while z
// computes). Each warp takes query tiles t and T-1-t for dq and key tiles t
// and T-1-t for dk and dv (T + 1 tile steps each), then its share of the
// dS increment; the 8 partials are added in warp order by one thread per
// element, and warp 0 runs dlg's suffix sums: no atomics, one fixed order.
template <int N, int P>
__global__ void __launch_bounds__(THREADS, 1)
    gla_bwd_kernel(GlaIn<bf16> in, BwdIO<bf16> io) {
  extern __shared__ __align__(128) unsigned char sm[];
  const int c = in.c, nc = in.S / c, H = in.H, tc = (c + 15) & ~15, T = tc / 16;
  const int b = blockIdx.x / H, h = blockIdx.x % H, warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const BwdLayout L(c, P);
  float* ds_s = reinterpret_cast<float*>(sm + L.ds);
  float* cl_s = reinterpret_cast<float*>(sm + L.cl);
  float* eq_s = reinterpret_cast<float*>(sm + L.eq);
  float* ek_s = reinterpret_cast<float*>(sm + L.ek);
  float* rq_s = reinterpret_cast<float*>(sm + L.rq);
  float* rk_s = reinterpret_cast<float*>(sm + L.rk);
  float* scr = reinterpret_cast<float*>(sm + L.scratch);
  for (int e = threadIdx.x; e < 16 * P; e += THREADS) ds_s[e] = 0.f;
  float carry = 0.f;
  bwd_stage<N, P>(in, io, b, h, nc - 1, sm, L);
  cp_commit();
  for (int n = 0; n < nc; ++n) {
    const int z = nc - 1 - n;
    unsigned char* st = sm + (n & 1) * L.stage;
    if (z > 0) {
      bwd_stage<N, P>(in, io, b, h, z - 1, sm + ((n + 1) & 1) * L.stage, L);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();  // chunk z's rows are in; the later chunk's dS and dlg are done
    float* cum = reinterpret_cast<float*>(st + L.lg);
    scan_rows(cum, tc);
    __syncthreads();
    const float tot = cum[c - 1], cl_tot = tot * LOG2E;
    for (int j = threadIdx.x; j < tc; j += THREADS) {
      const float cl = cum[j] * LOG2E;
      cl_s[j] = cl;
      eq_s[j] = ex2(cl);
      ek_s[j] = ex2(cl_tot - cl);
    }
    __syncthreads();
    const long long row0 = (long long)b * in.S + z * c;
    float* dq = io.dq + (row0 * H + h) * N;
    float* dk = io.dk + (row0 * H + h) * N;
    bf16* dv = io.dv + (row0 * H + h) * P;
    for (int pr = warp; pr < (T + 1) / 2; pr += WARPS) {
      const int I1 = T - 1 - pr;
      bwd_dq_tile<N, P>(I1, c, st, L, cl_s, eq_s, rq_s, dq, (long long)H * N);
      if (pr < I1) bwd_dq_tile<N, P>(pr, c, st, L, cl_s, eq_s, rq_s, dq, (long long)H * N);
      bwd_dkdv_tile<N, P>(pr, T, c, st, L, cl_s, ek_s, ds_s, rk_s, dk, (long long)H * N, dv,
                          (long long)H * P);
      if (pr < I1)
        bwd_dkdv_tile<N, P>(I1, T, c, st, L, cl_s, ek_s, ds_s, rk_s, dk, (long long)H * N,
                            dv, (long long)H * P);
    }
    float d[P / 8][4] = {};
    bwd_ds_part<P>(T, st, L, eq_s, d);
    float* mine = scr + warp * 16 * (P + 4);
#pragma unroll
    for (int nt = 0; nt < P / 8; ++nt) {
      *reinterpret_cast<float2*>(mine + g * (P + 4) + 8 * nt + 2 * t) =
          make_float2(d[nt][0], d[nt][1]);
      *reinterpret_cast<float2*>(mine + (g + 8) * (P + 4) + 8 * nt + 2 * t) =
          make_float2(d[nt][2], d[nt][3]);
    }
    __syncthreads();  // every tile has read dS; the partials, q.dq and k.dk are in
    const float gc = expf(tot);
    for (int e = threadIdx.x; e < 16 * P; e += THREADS) {
      const int nn = e / P, p = e % P;
      float x = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) x += scr[(w * 16 + nn) * (P + 4) + p];
      ds_s[e] = ds_s[e] * gc + x;
    }
    dlg_rows(rq_s, rk_s, c, carry, io.dlg, row0 * H + h, H);
  }
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
  if (which == BWD)
    return dtype == 1 ? (size_t)BwdLayout(c, P).total : smem_bwd_f32(c, N, P);
  return dtype == 1 ? (size_t)Layout(which, c).total : smem_f32(which, c, N, P);
}

template <int N, int P, typename T, typename K>
int launch_bwd(K kern, const GlaIn<T>& in, const BwdIO<T>& io, size_t smem, cudaStream_t st) {
  static_assert(P % 16 == 0 && N <= 16 && N % 8 == 0, "N in {8, 16}; P a multiple of 16");
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  const cudaError_t err = set_smem(kern, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<in.B * in.H, THREADS, smem, st>>>(in, io);
  return (int)cudaGetLastError();
}

// K4b's dispatch: dtype and (N, P) as dispatch's; strides: q, k, v, lg, dy.
int dispatch_bwd(const void* q, const void* k, const void* v, const void* lg, const void* dy,
                 const float* starts, float* dq, float* dk, void* dv, float* dlg, int B, int S,
                 int H, int N, int P, int c, const long long* strides, int dtype, void* stream) {
  if (B < 1 || H < 1 || c < 1 || S < c || S % c != 0 || starts == nullptr)
    return (int)cudaErrorInvalidValue;
  const Strides sq{strides[0], strides[1], strides[2]}, sk{strides[3], strides[4], strides[5]},
      sv{strides[6], strides[7], strides[8]}, sl{strides[9], strides[10], strides[11]},
      sd{strides[12], strides[13], strides[14]};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* lgf = static_cast<const float*>(lg);
#define GLA_BWD_CASE(T, NN, PP, KERN, SMEM)                                                  \
  if (N == NN && P == PP) {                                                                  \
    const GlaIn<T> in{static_cast<const T*>(q), static_cast<const T*>(k),                    \
                      static_cast<const T*>(v), lgf, sq, sk, sv, sl, S, H, c, B};            \
    const BwdIO<T> io{static_cast<const T*>(dy), sd, starts, dq, dk, static_cast<T*>(dv),    \
                      dlg};                                                                  \
    return launch_bwd<NN, PP>(KERN<NN, PP>, in, io, SMEM, st);                               \
  }
  if (dtype == 1) {
    GLA_BWD_CASE(bf16, 16, 64, gla_bwd_kernel, (size_t)BwdLayout(c, 64).total)
    GLA_BWD_CASE(bf16, 8, 32, gla_bwd_kernel, (size_t)BwdLayout(c, 32).total)
  } else if (dtype == 0) {
    GLA_BWD_CASE(float, 16, 64, gla_bwd_f32_kernel, smem_bwd_f32(c, 16, 64))
    GLA_BWD_CASE(float, 8, 32, gla_bwd_f32_kernel, smem_bwd_f32(c, 8, 32))
  }
#undef GLA_BWD_CASE
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

// K4b, the backward of K4's function: dq, dk [B,S,H,N] float32 (per head),
// dv [B,S,H,P] in v's type and dlg [B,S,H] float32, all contiguous, from q,
// k, v, lg, dy and K4's chunk start states starts [B,H,nc,N,P] float32.
// strides: q, k, v, lg, dy, three each (batch, position, head), in elements.
extern "C" int repro_gla_chunk_bwd(const void* q, const void* k, const void* v, const void* lg,
                                   const void* dy, const void* starts, void* dq, void* dk,
                                   void* dv, void* dlg, int B, int S, int H, int N, int P,
                                   int c, const long long* strides, int dtype, void* stream) {
  return dispatch_bwd(q, k, v, lg, dy, static_cast<const float*>(starts),
                      static_cast<float*>(dq), static_cast<float*>(dk), dv,
                      static_cast<float*>(dlg), B, S, H, N, P, c, strides, dtype, stream);
}

// Dynamic shared memory of one block of kernel `which` (0 K4, 1 phase A, 2
// phase B, 3 K4b) at chunk c, in bytes; the launch refuses more than a block
// has.
extern "C" long long repro_gla_smem_bytes(int which, int c, int N, int P, int dtype) {
  return (long long)smem_bytes(static_cast<Which>(which), c, N, P, dtype);
}
