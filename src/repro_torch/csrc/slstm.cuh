// The sLSTM recurrence's device helpers, shared by its forward
// (slstm_scan.cu) and its backward (slstm_scan_bwd.cu): the grid's
// constants, bf16 conversions, the cell's exponentials, mma.sync, and the
// DSMEM exchange (cp.async, mbarriers, st.async). Each source includes it
// once; everything is in namespace slstm, compiled into each library.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace slstm {

constexpr int CLUSTER = 8;  // blocks a (head, row group)
constexpr int ROWS = 8;     // rows a group at most
constexpr int KS = 2;       // the product's dh split in KS ranges a column
constexpr int MAX_DH = 256; // shared memory: R's slice is dh x dh / 2 elements

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T and back: the value a T tensor holds
template <typename T>
__device__ __forceinline__ float round_t(float x) {
  return to_f<T>(from_f<T>(x));
}

// log(sigmoid(x)) = min(x, 0) - log1p(exp(-|x|)), the reference's
// jax.nn.log_sigmoid (= -softplus(-x))
__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// d += a b: m16n8k16, bf16 in, float32 out
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// one (row, unit) cell: gates in T's rounding (rh = T(sum), gate = T(wx +
// rh)), the state in float32; returns h, and the gates it took in `gate`
// (what the training forward saves for the backward). FAST (the bf16 kernel, whose gates
// carry 8 bits): the exponentials, the logarithm and the divisions by the
// SFU's approximations (ex2.approx, lg2.approx, rcp; a relative 1e-6 or so,
// tanh as 1 - 2 / (1 + e^{2z})), which shorten the step's chain; else the
// accurate library functions (the float32 kernel, exact to its sums).
template <typename T, bool FAST>
__device__ __forceinline__ float cell_step(const float (&wg)[4], const float (&sum)[4], float& c,
                                           float& n, float& m, float (&gate)[4]) {
#pragma unroll
  for (int g = 0; g < 4; ++g) gate[g] = round_t<T>(wg[g] + round_t<T>(sum[g]));
  const float li = gate[0];
  float lf, fs, is, z, o;
  if constexpr (FAST) {
    lf = fminf(gate[1], 0.f) - __logf(1.f + __expf(-fabsf(gate[1])));
    const float m_new = fmaxf(lf + m, li);
    fs = __expf(lf + m - m_new);
    is = __expf(li - m_new);
    z = 1.f - __fdividef(2.f, 1.f + __expf(2.f * gate[2]));
    o = __fdividef(1.f, 1.f + __expf(-gate[3]));
    m = m_new;
  } else {
    lf = log_sigmoid(gate[1]);
    const float m_new = fmaxf(lf + m, li);
    fs = expf(lf + m - m_new);
    is = expf(li - m_new);
    z = tanhf(gate[2]);
    o = 1.f / (1.f + expf(-gate[3]));
    m = m_new;
  }
  c = fs * c + is * z;
  n = fs * n + is;
  return FAST ? __fdividef(o * c, fmaxf(n, 1e-6f)) : o * c / fmaxf(n, 1e-6f);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// a copy of BYTES (8 or 16) from global to shared memory by the copy engine
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_u32(dst)), "l"(src)
                 : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}

// the thread's arrival on `bar`, expecting `bytes` more of its phase
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// spin until the phase of parity `parity` has completed; acquire at cluster
// scope, so that the peers' stores it counted are seen
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// the shared::cluster address of `local` (this block's shared memory) in
// block `rank` of the cluster
__device__ __forceinline__ uint32_t map_rank(const void* local, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(smem_u32(local)), "r"(rank));
  return out;
}

// 4 bytes into a peer's shared memory, counted on its mbarrier `bar`
__device__ __forceinline__ void st_async(uint32_t addr, uint32_t v, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n" ::"r"(
                   addr),
               "r"(v), "r"(bar)
               : "memory");
}

// the group's rows of the float32 kernels: the fewest of 1, 2, 4, 8 that
// hold min(B, ROWS)
inline int group_rows(int B) {
  const int rows = B < ROWS ? B : ROWS;
  return rows <= 1 ? 1 : rows <= 2 ? 2 : rows <= 4 ? 4 : 8;
}

// 8 bytes (two 32-bit words) into a peer's shared memory, counted on its
// mbarrier `bar`; `addr` 8-byte aligned
__device__ __forceinline__ void st_async_v2(uint32_t addr, uint32_t v0, uint32_t v1, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.b32 [%0], {%1, %2}, [%3];\n" ::"r"(
          addr),
      "r"(v0), "r"(v1), "r"(bar)
      : "memory");
}

// one (row, unit) cell's backward at one position, the stabilizer m held
// constant (h does not depend on the m trajectory: c and n are the
// unstabilized values times e^{-m}). gate: the position's gates as the
// cell took them (i, f, z, o raw); cp, np_, mp: the state before it; c, n,
// m: after it; dh: h's gradient at the position. dc and dn carry the
// gradients of c and n after the position in, and before it out; dg gets
// the gates' gradients. The float32 kernel's form, with the accurate
// library functions.
__device__ __forceinline__ void cell_bwd(const float (&gate)[4], float cp, float np_, float mp,
                                         float c, float n, float m, float dh, float& dc,
                                         float& dn, float (&dg)[4]) {
  const float fs = expf(log_sigmoid(gate[1]) + mp - m);
  const float is = expf(gate[0] - m);
  const float z = tanhf(gate[2]);
  const float o = 1.f / (1.f + expf(-gate[3]));
  const float sf = 1.f / (1.f + expf(gate[1]));  // sigmoid(-f_raw) = d log_sigmoid / d f_raw
  const float nn = fmaxf(n, 1e-6f);
  const float rn = 1.f / nn;
  const float hc = c * rn;  // c / n
  dg[3] = dh * hc * o * (1.f - o);
  dc += dh * o * rn;
  if (n > 1e-6f) dn -= dh * o * hc * rn;
  dg[2] = dc * is * (1.f - z * z);
  dg[0] = (dc * z + dn) * is;
  dg[1] = (dc * cp + dn * np_) * fs * sf;
  dc *= fs;
  dn *= fs;
}

// cell_bwd split in two for the bf16 kernel, whose chain then holds only
// what needs dh: the position's backward is linear in (dh, dc, dn), and
// its coefficients depend on the saved gates and states alone.
// cell_bwd_coef computes them (on the SFU's approximations, as cell_step's
// FAST path), off the chain; cell_bwd_apply is the map itself, a few FMAs.
struct BwdCoef {
  float o_dh;  // d o_raw / dh = (c / n) o (1 - o)
  float c_dh;  // dc += dh o / n
  float n_dh;  // dn -= dh o c / n^2 (0 where n <= 1e-6: the clamp passes no gradient)
  float z_dc;  // d z_raw = dc is (1 - z^2)
  float i_dc;  // d i_raw = dc z is + dn is
  float i_dn;
  float f_dc;  // d f_raw = dc c_prev fs sigmoid(-f_raw) + dn n_prev fs sigmoid(-f_raw)
  float f_dn;
  float fs;    // dc and dn carry to the position before times fs
};

__device__ __forceinline__ BwdCoef cell_bwd_coef(const float (&gate)[4], float cp, float np_,
                                                 float mp, float c, float n, float m) {
  const float lf = fminf(gate[1], 0.f) - __logf(1.f + __expf(-fabsf(gate[1])));
  const float fs = __expf(lf + mp - m);
  const float is = __expf(gate[0] - m);
  const float z = 1.f - __fdividef(2.f, 1.f + __expf(2.f * gate[2]));
  const float o = __fdividef(1.f, 1.f + __expf(-gate[3]));
  const float fsf = __fdividef(fs, 1.f + __expf(gate[1]));  // fs sigmoid(-f_raw)
  const float rn = __fdividef(1.f, fmaxf(n, 1e-6f));
  const float hc = c * rn;
  BwdCoef k;
  k.o_dh = hc * o * (1.f - o);
  k.c_dh = o * rn;
  k.n_dh = n > 1e-6f ? o * hc * rn : 0.f;
  k.z_dc = is * (1.f - z * z);
  k.i_dc = z * is;
  k.i_dn = is;
  k.f_dc = cp * fsf;
  k.f_dn = np_ * fsf;
  k.fs = fs;
  return k;
}

__device__ __forceinline__ void cell_bwd_apply(const BwdCoef& k, float dh, float& dc, float& dn,
                                               float (&dg)[4]) {
  const float c_ = fmaf(dh, k.c_dh, dc);
  const float n_ = fmaf(-dh, k.n_dh, dn);
  dg[0] = fmaf(c_, k.i_dc, n_ * k.i_dn);
  dg[1] = fmaf(c_, k.f_dc, n_ * k.f_dn);
  dg[2] = c_ * k.z_dc;
  dg[3] = dh * k.o_dh;
  dc = c_ * k.fs;
  dn = n_ * k.fs;
}

}  // namespace slstm
