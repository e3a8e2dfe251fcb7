// Chunked gated linear attention (GLA) for NVIDIA Hopper (sm_90a): both
// schedules of the JAX package's Pallas kernels.
//
// Replaces: src/repro/kernels/mlstm_chunk.py::_kernel (gla_chunk: K4 here,
// repro_gla_chunk) and ::_phase_a_kernel / ::_phase_b_kernel
// (gla_chunk_parallel: K5 here, repro_gla_phase_a / repro_gla_phase_b).
//
// For each row b and head h, the recurrence
//   h_t = exp(lg_t) h_{t-1} + k_t v_t^T,    y_t = q_t . h_t
// is computed over chunks of c positions, as the Pallas kernels do:
//   intra:  y_i  = sum_{j <= i in the chunk} (q_i . k_j) exp(cum_i - cum_j) v_j
//   inter:  y_i += (q_i exp(cum_i)) . state
//   state:  state = exp(total) state + sum_j (k_j exp(total - cum_j)) v_j^T
// with cum the inclusive cumsum of lg within the chunk and total its last
// value. q, k: [B,S,H,N]; v: [B,S,H,P]; lg: [B,S,H] float32; each taken by
// its element strides (last dim contiguous), so the model's head-broadcast
// q and k (head stride 0) are read in place. Outputs are contiguous: y
// [B,S,H,P] in v's type, the final state [B,H,N,P] float32 (K4; the Pallas
// kernel drops it, the model's prefill cache needs it), phase A's per-chunk
// g = exp(total) [B,H,nc] and state delta [B,H,nc,N,P] float32. All sums
// are float32.
//
// Bound: at the serving shape (B4 S1536 H25 N16 P64, c 256, bf16) the work
// is about 3.8 GFLOP, mostly the intra-chunk products (c^2 (N+P) per
// chunk), against about 41 MB moved (v and y dominate; q and k are one
// [B,S,N] row each per position): 12 us of device memory at 3.35 TB/s,
// 4 us of bf16 tensor-core time. Device-memory bytes bound it.
// Design, a simple one that is right first:
//  * The TPU runs the chunk axis as a sequential grid dimension with the
//    [N,P] state in VMEM. Here K4 is one block per (b, h) that loops over
//    the chunks with the state in shared memory; K5 is one block per
//    (b, h, chunk) in each phase, and the scan between them is plain torch
//    in chunk order (kernels/gla_chunk.py).
//  * A chunk's 256x256 score matrix does not fit a block, so none is made:
//    the chunk's K and V rows and its cumsum are staged in dynamic shared
//    memory as float32 (86 KB at c 256), and each thread takes one query
//    row, walking j <= i with every K and V row read as a warp-wide
//    broadcast. The state update gives each thread its own [N,P] elements
//    and sums the chunk's rows in order: no atomics, deterministic.
//  * The cumsum runs in warp 0 in 32-wide shuffle steps, a fixed order, so
//    phase B recomputes exactly the cum phase A used.
//  * Speed is later work: the products are scalar float32 FMAs, and K4's
//    B*H blocks (100 at the serving shape) leave SMs idle.
//
// Each entry point launches one kernel on the caller's stream and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;
constexpr size_t MAX_SMEM = 232448;  // a block's shared memory on sm_90

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16(x); }

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
  int S, H, c;
};

// Shared memory of a block: the chunk's K rows [c][N], V rows [c][P], cum
// [c], exp(total - cum) [c] and the state [N][P], all float32.
template <int N, int P>
__host__ __device__ constexpr size_t smem_floats(int c) {
  return (size_t)c * (N + P + 2) + N * P;
}

// Stage the chunk's lg and scan it in place into its inclusive cumsum:
// warp 0 in 32-wide shuffle steps, a fixed order. Ends synchronised.
template <typename T>
__device__ void stage_cum(const GlaIn<T>& in, int b, int h, int t0, float* cum_s) {
  for (int j = threadIdx.x; j < in.c; j += blockDim.x)
    cum_s[j] = in.lg[in.sl.at(b, t0 + j, h)];
  __syncthreads();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    float carry = 0.f;
    for (int base = 0; base < in.c; base += 32) {
      const int i = base + lane;
      float x = i < in.c ? cum_s[i] : 0.f;
#pragma unroll
      for (int o = 1; o < 32; o *= 2) {
        const float y = __shfl_up_sync(0xffffffffu, x, o);
        if (lane >= o) x += y;
      }
      x += carry;
      if (i < in.c) cum_s[i] = x;
      carry = __shfl_sync(0xffffffffu, x, 31);
    }
  }
  __syncthreads();
}

// Stage the chunk's K and V rows as float32 (no synchronisation).
template <typename T, int N, int P>
__device__ void stage_kv(const GlaIn<T>& in, int b, int h, int t0, float* k_s, float* v_s) {
  for (int e = threadIdx.x; e < in.c * N; e += blockDim.x)
    k_s[e] = to_f(in.k[in.sk.at(b, t0 + e / N, h) + e % N]);
  for (int e = threadIdx.x; e < in.c * P; e += blockDim.x)
    v_s[e] = to_f(in.v[in.sv.at(b, t0 + e / P, h) + e % P]);
}

template <typename T, int N>
__device__ __forceinline__ void load_q(const GlaIn<T>& in, int b, int h, int t, float* qi) {
  const T* qr = in.q + in.sq.at(b, t, h);
#pragma unroll
  for (int n = 0; n < N; ++n) qi[n] = to_f(qr[n]);
}

// acc += row i's intra-chunk output: sum_{j<=i} (q_i.k_j) exp(cum_i - cum_j) v_j.
// Every lane of a warp reads the same K and V row at each j (a broadcast).
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

template <typename T, int P>
__device__ __forceinline__ void store_row(T* out, const float* acc) {
#pragma unroll
  for (int p = 0; p < P; ++p) out[p] = from_f<T>(acc[p]);
}

// K4. Grid (B*H); one block per (b, h) walks the chunks in order, the state
// in shared memory. y: [B,S,H,P]; state_out: [B,H,N,P].
template <typename T, int N, int P>
__global__ void __launch_bounds__(THREADS)
    gla_chunk_kernel(GlaIn<T> in, T* __restrict__ y, float* __restrict__ state_out) {
  extern __shared__ __align__(16) float sm[];
  const int c = in.c, nc = in.S / c, H = in.H;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  float* k_s = sm;
  float* v_s = k_s + c * N;
  float* cum_s = v_s + c * P;
  float* w_s = cum_s + c;
  float* state_s = w_s + c;
  for (int e = threadIdx.x; e < N * P; e += blockDim.x) state_s[e] = 0.f;

  for (int ci = 0; ci < nc; ++ci) {
    const int t0 = ci * c;
    __syncthreads();  // the previous chunk is done with k_s, v_s, cum_s, w_s
    stage_kv<T, N, P>(in, b, h, t0, k_s, v_s);
    stage_cum(in, b, h, t0, cum_s);
    for (int i = threadIdx.x; i < c; i += blockDim.x) {
      float qi[N], acc[P];
      load_q<T, N>(in, b, h, t0 + i, qi);
#pragma unroll
      for (int p = 0; p < P; ++p) acc[p] = 0.f;
      intra_row<N, P>(qi, i, k_s, v_s, cum_s, acc);
      inter_row<N, P>(qi, cum_s[i], state_s, acc);
      store_row<T, P>(y + (((long long)b * in.S + t0 + i) * H + h) * P, acc);
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

// K5 phase A. Grid (nc, B*H); one block per (b, h, chunk): the intra-chunk
// output, g = exp(total) and the state delta, with no data from other
// chunks. y_intra: [B,S,H,P] in T; g: [B,H,nc]; d: [B,H,nc,N,P].
template <typename T, int N, int P>
__global__ void __launch_bounds__(THREADS)
    gla_phase_a_kernel(GlaIn<T> in, T* __restrict__ y_intra, float* __restrict__ g_out,
                       float* __restrict__ d_out) {
  extern __shared__ __align__(16) float sm[];
  const int c = in.c, H = in.H, ci = blockIdx.x, nc = gridDim.x;
  const int b = blockIdx.y / H, h = blockIdx.y % H, t0 = ci * c;
  float* k_s = sm;
  float* v_s = k_s + c * N;
  float* cum_s = v_s + c * P;
  float* w_s = cum_s + c;
  stage_kv<T, N, P>(in, b, h, t0, k_s, v_s);
  stage_cum(in, b, h, t0, cum_s);
  for (int i = threadIdx.x; i < c; i += blockDim.x) {
    float qi[N], acc[P];
    load_q<T, N>(in, b, h, t0 + i, qi);
#pragma unroll
    for (int p = 0; p < P; ++p) acc[p] = 0.f;
    intra_row<N, P>(qi, i, k_s, v_s, cum_s, acc);
    store_row<T, P>(y_intra + (((long long)b * in.S + t0 + i) * H + h) * P, acc);
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

// K5 phase B. Grid (nc, B*H); one block per (b, h, chunk): y = y_intra +
// (q exp(cum)) . start, with start [B,H,nc,N,P] the chunk's scanned start
// state. y_intra and y: [B,S,H,P] contiguous in T.
template <typename T, int N, int P>
__global__ void __launch_bounds__(THREADS)
    gla_phase_b_kernel(GlaIn<T> in, const float* __restrict__ start,
                       const T* __restrict__ y_intra, T* __restrict__ y) {
  extern __shared__ __align__(16) float sm[];
  const int c = in.c, H = in.H, ci = blockIdx.x, nc = gridDim.x;
  const int b = blockIdx.y / H, h = blockIdx.y % H, t0 = ci * c;
  float* cum_s = sm;
  float* state_s = cum_s + c;
  const float* st = start + ((long long)blockIdx.y * nc + ci) * N * P;
  for (int e = threadIdx.x; e < N * P; e += blockDim.x) state_s[e] = st[e];
  stage_cum(in, b, h, t0, cum_s);  // its barriers also cover state_s
  for (int i = threadIdx.x; i < c; i += blockDim.x) {
    float qi[N], acc[P];
    load_q<T, N>(in, b, h, t0 + i, qi);
    const long long row = (((long long)b * in.S + t0 + i) * H + h) * P;
#pragma unroll
    for (int p = 0; p < P; ++p) acc[p] = to_f(y_intra[row + p]);
    inter_row<N, P>(qi, cum_s[i], state_s, acc);
    store_row<T, P>(y + row, acc);
  }
}

enum Which { CHUNK = 0, PHASE_A = 1, PHASE_B = 2 };

template <typename T, int N, int P>
int launch(Which which, const GlaIn<T>& in, int B, void* o0, void* o1, void* o2,
           cudaStream_t st) {
  const int nc = in.S / in.c;
  const size_t smem = (which == PHASE_B ? (size_t)in.c + N * P : smem_floats<N, P>(in.c)) *
                      sizeof(float);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (which == CHUNK) {
    auto kern = gla_chunk_kernel<T, N, P>;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kern<<<B * in.H, THREADS, smem, st>>>(in, static_cast<T*>(o0), static_cast<float*>(o1));
  } else if (which == PHASE_A) {
    auto kern = gla_phase_a_kernel<T, N, P>;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kern<<<dim3(nc, B * in.H), THREADS, smem, st>>>(
        in, static_cast<T*>(o0), static_cast<float*>(o1), static_cast<float*>(o2));
  } else {
    auto kern = gla_phase_b_kernel<T, N, P>;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kern<<<dim3(nc, B * in.H), THREADS, smem, st>>>(
        in, static_cast<const float*>(o1), static_cast<const T*>(o2), static_cast<T*>(o0));
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
#define GLA_CASE(T, NN, PP)                                                                  \
  if (N == NN && P == PP) {                                                                  \
    const GlaIn<T> in{static_cast<const T*>(q), static_cast<const T*>(k),                    \
                      static_cast<const T*>(v), lgf, sq, sk, sv, sl, S, H, c};               \
    return launch<T, NN, PP>(which, in, B, o0, o1, o2, st);                                  \
  }
  if (dtype == 1) {
    GLA_CASE(bf16, 16, 64)
    GLA_CASE(bf16, 8, 32)
  } else if (dtype == 0) {
    GLA_CASE(float, 16, 64)
    GLA_CASE(float, 8, 32)
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
