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
// bytes in device memory bound it (2 DK length bytes a row).
//
// Design (a first kernel, simple and right; its times are in PERF.md):
//  * One block per (row, SPAN = 64 positions), whatever B, the length or the
//    addressing (ContigKV, PagedKV of decode_split.cuh): the paged form over
//    pages in order gives the contiguous form's bits, and a B = 1 lane a
//    batched row's. A block wholly past the length writes the empty partial
//    (m = -1e30, l = 0, o = 0) and reads nothing.
//  * bf16 (latent_mma_kernel, eight warps): the block stages its 64 latent
//    rows and the row's query rows (zeros to HMAX = 48) in shared memory by
//    cp.async (16 bytes a copy, one group; rows past the length as zeros,
//    not read), rows padded by 16 bytes so that an ldmatrix's 8 rows lie in
//    distinct banks. Warp w < 3 takes query heads 16 w .. 16 w + 15, one
//    m16 tile, and all 64 positions, so no merge across warps: S = q L^T by
//    mma.sync m16n8k16 over DK / 16 = 18 k16 steps (q the A operand through
//    ldmatrix, the latent rows as they lie the B operand), scaled to the
//    log2 domain and masked in registers; each head's max and sum by quad
//    shuffles; P = ex2(s - m) as the A fragments of P L straight from S's C
//    fragments, split into a bf16 high and low part (about 16 bits of P, as
//    decode_mma_kernel); O = P L[:, :DV] from the same staged rows through
//    ldmatrix.trans, 64 columns at a time, each chunk written to the block's
//    partial from the registers.
//  * float32 (latent_f32_kernel, eight warps): the latent rows staged as
//    floats with a 289-float stride (32 rows read by 32 lanes hit 32 banks),
//    q scaled into shared memory; a warp a head at a time: each lane scores
//    two positions, the max and sum by shuffles, then each lane sums eight of
//    the DV columns over the 64 positions, P broadcast by shuffles. Exact
//    scalar products, no TF32.
//  * Partials: (m, l) [B, n_p, H] and o [B, n_p, H, DV] float32, one a block.
//    A ticket per row (decode_split's counters, left at zero) elects the last
//    block to finish, which combines them in block order: each head's largest
//    m and weighted l, then each float4 of the output summed over the
//    partials in order, eight partials' loads in flight a thread. The atomic
//    only elects: every sum runs in a fixed order, so the result is
//    deterministic. A row of one block writes its output directly. (The
//    combine is what a redesign should take first: one block a row reads
//    the row's 17 partials of 40 KB at minicpm3-4b's decode.)
//
// Each entry point launches one kernel on the caller's stream and returns
// cudaGetLastError().

#include "decode_split.cuh"

// A named namespace, not an unnamed one: the header's own unnamed namespace
// inside decode_split would make the kernels' registration ambiguous.
namespace latent {

using namespace decode_split;

constexpr int DK = 288;   // latent row: kv_lora_rank 256 + qk_rope_dim 32
constexpr int DV = 256;   // its value columns: kv_lora_rank
constexpr int HMAX = 48;  // query heads a launch takes: three m16 tiles
constexpr int SPAN = 64;  // positions a block takes

namespace lt {  // the bf16 kernel
constexpr int NWARP = HMAX / 16;  // warps that compute, one m16 tile of heads each
// threads a block: eight warps stage the rows and combine the partials, the
// first NWARP also compute (the combine's loads in flight scale with them)
constexpr int THREADS = 256;
constexpr int ROW = DK * 2 + 16;  // bytes of a staged row: 37 16-byte pieces, an odd count
constexpr int CH = DK * 2 / 16;   // 16-byte pieces of a row
constexpr int L_S = 0;
constexpr int Q_S = L_S + SPAN * ROW;
constexpr int BYTES = Q_S + HMAX * ROW;  // 66,304
static_assert(DK % 32 == 0 && DV % 64 == 0 && SPAN % 16 == 0, "the mma tiles divide the shape");
}  // namespace lt

namespace lf {  // the float32 kernel
constexpr int NWARP = 8;
constexpr int THREADS = NWARP * 32;
constexpr int ROWF = DK + 1;  // floats of a staged row
constexpr int Q_S = SPAN * ROWF;
constexpr int BYTES = (Q_S + HMAX * DK) * 4;  // 129,280
static_assert(SPAN == 64 && DV % 32 == 0, "a lane scores two positions and sums DV / 32 columns");
}  // namespace lf

// The last block of row b combines the row's n_p partials in block order
// into out[b] (H x DV); m_s and den_s are HMAX floats of shared memory each.
template <typename T>
__device__ __forceinline__ void combine(T* __restrict__ out, const float* __restrict__ part_o,
                                        const float* __restrict__ part_m,
                                        const float* __restrict__ part_l, int b, int H, int n_p,
                                        float* m_s, float* den_s) {
  const long long pm = (long long)b * n_p * H;  // the row's first (m, l)
  for (int g = threadIdx.x; g < H; g += blockDim.x) {
    float mx = NEG_INF, den = 0.f;
    for (int p = 0; p < n_p; ++p) mx = fmaxf(mx, __ldcg(part_m + pm + (long long)p * H + g));
    for (int p = 0; p < n_p; ++p)
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
    for (int p = 0; p < n_p; ++p) {
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

// Grid (n_p, B): block blk takes positions [blk SPAN, + SPAN) of row b.
// lt::THREADS threads, lt::BYTES of dynamic shared memory. scale: the
// scores' scale times log2(e).
template <typename KV>
__global__ void __launch_bounds__(lt::THREADS) latent_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ lat, bf16* __restrict__ out,
    float* __restrict__ part_o, float* __restrict__ part_m, float* __restrict__ part_l,
    int* __restrict__ counters, KV kv, int H, float scale) {
  using namespace lt;
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int last;
  __shared__ float m_s[HMAX], den_s[HMAX];
  const int blk = blockIdx.x, b = blockIdx.y, n_p = gridDim.x;
  const int start = blk * SPAN;
  const int j1 = min(start + SPAN, kv.length(b));
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long long pm = ((long long)b * n_p + blk) * H;  // this block's first (m, l)
  bf16* o = out + (long long)b * H * DV;
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(smem));

  if (start < j1) {
    const bf16* qb = q + (long long)b * H * DK;
    for (int i = tid; i < HMAX * CH; i += THREADS) {
      const int r = i / CH, ch = i % CH;
      cp16(base + Q_S + r * ROW + ch * 16, qb + (r < H ? r : 0) * DK + ch * 8, r < H);
    }
    for (int i = tid; i < SPAN * CH; i += THREADS) {
      const int r = i / CH, ch = i % CH;
      const bool in = start + r < j1;
      cp16(base + L_S + r * ROW + ch * 16, lat + (in ? kv.row(b, start + r, 0) : 0) + ch * 8, in);
    }
    cp_commit();
    cp_wait<0>();
    __syncthreads();

    const int h0 = warp * 16;
    if (warp < NWARP && h0 < H) {
      // S = q L^T for the warp's 16 heads and the block's SPAN positions
      // (NT n8 tiles), two k16 steps a pass
      constexpr int NT = SPAN / 8;
      float sc[NT][4];
#pragma unroll
      for (int t = 0; t < NT; ++t) sc[t][0] = sc[t][1] = sc[t][2] = sc[t][3] = 0.f;
#pragma unroll
      for (int kp = 0; kp < DK / 32; ++kp) {
        uint32_t kf[NT][4], qa[4];
#pragma unroll
        for (int t = 0; t < NT; ++t)
          ldsm(kf[t], base + L_S + (8 * t + lane % 8) * ROW + (4 * kp + lane / 8) * 16);
        ldsm(qa, base + Q_S + (h0 + lane % 16) * ROW + (4 * kp + lane / 16) * 16);
#pragma unroll
        for (int t = 0; t < NT; ++t) mma(sc[t], qa, kf[t][0], kf[t][1]);
        ldsm(qa, base + Q_S + (h0 + lane % 16) * ROW + (4 * kp + 2 + lane / 16) * 16);
#pragma unroll
        for (int t = 0; t < NT; ++t) mma(sc[t], qa, kf[t][2], kf[t][3]);
      }
      // scaled to the log2 domain, masked past the length; each head's max
      // over the positions (a quad of shuffles; the block holds a valid
      // position, so it is finite)
      const int r = lane / 4, cq = 2 * (lane % 4);
      float m0 = NEG_INF, m1 = NEG_INF;
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const int jc = start + 8 * t + cq;
        const bool ok0 = jc < j1, ok1 = jc + 1 < j1;
        sc[t][0] = ok0 ? sc[t][0] * scale : NEG_INF;
        sc[t][1] = ok1 ? sc[t][1] * scale : NEG_INF;
        sc[t][2] = ok0 ? sc[t][2] * scale : NEG_INF;
        sc[t][3] = ok1 ? sc[t][3] * scale : NEG_INF;
        m0 = fmaxf(m0, fmaxf(sc[t][0], sc[t][1]));
        m1 = fmaxf(m1, fmaxf(sc[t][2], sc[t][3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off *= 2) {
        m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, off));
        m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, off));
      }
      // P = ex2(s - m) as the A fragments of the SPAN / 16 k16 steps of P L
      // (the C fragments of S tiles 2 kk and 2 kk + 1), high and low parts
      constexpr int KS = SPAN / 16;
      uint32_t ph[KS][4], pl[KS][4];
      float l0 = 0.f, l1 = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        float p[8] = {sc[2 * kk][0],     sc[2 * kk][1],     sc[2 * kk][2],     sc[2 * kk][3],
                      sc[2 * kk + 1][0], sc[2 * kk + 1][1], sc[2 * kk + 1][2], sc[2 * kk + 1][3]};
#pragma unroll
        for (int e = 0; e < 8; ++e) p[e] = ex2(p[e] - ((e & 2) ? m1 : m0));
        l0 += (p[0] + p[1]) + (p[4] + p[5]);
        l1 += (p[2] + p[3]) + (p[6] + p[7]);
#pragma unroll
        for (int i = 0; i < 4; ++i) split_hi_lo(p[2 * i], p[2 * i + 1], ph[kk][i], pl[kk][i]);
      }
#pragma unroll
      for (int off = 1; off < 4; off *= 2) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, off);
        l1 += __shfl_xor_sync(0xffffffffu, l1, off);
      }
      const int g0 = h0 + r, g1 = g0 + 8;
      if (n_p > 1 && cq == 0) {
        if (g0 < H) {
          part_m[pm + g0] = m0;
          part_l[pm + g0] = l0;
        }
        if (g1 < H) {
          part_m[pm + g1] = m1;
          part_l[pm + g1] = l1;
        }
      }
      const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
      // O = P L[:, :DV], 64 columns (8 n8 tiles) a chunk, L through
      // ldmatrix.trans; each chunk out from the registers
#pragma unroll 1
      for (int c = 0; c < DV / 64; ++c) {
        float acc[8][4];
#pragma unroll
        for (int t = 0; t < 8; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
          for (int t2 = 0; t2 < 4; ++t2) {  // n8 tiles 2 t2 and 2 t2 + 1
            uint32_t vb[4];
            ldsm_t(vb, base + L_S + (16 * kk + lane % 16) * ROW + (8 * c + 2 * t2 + lane / 16) * 16);
            mma(acc[2 * t2], ph[kk], vb[0], vb[1]);
            mma(acc[2 * t2], pl[kk], vb[0], vb[1]);
            mma(acc[2 * t2 + 1], ph[kk], vb[2], vb[3]);
            mma(acc[2 * t2 + 1], pl[kk], vb[2], vb[3]);
          }
        }
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          const int col = 64 * c + 8 * t + cq;
          if (n_p == 1) {
            if (g0 < H)
              *reinterpret_cast<__nv_bfloat162*>(o + (long long)g0 * DV + col) =
                  __floats2bfloat162_rn(acc[t][0] * inv0, acc[t][1] * inv0);
            if (g1 < H)
              *reinterpret_cast<__nv_bfloat162*>(o + (long long)g1 * DV + col) =
                  __floats2bfloat162_rn(acc[t][2] * inv1, acc[t][3] * inv1);
          } else {
            if (g0 < H)
              *reinterpret_cast<float2*>(part_o + (pm + g0) * DV + col) =
                  make_float2(acc[t][0], acc[t][1]);
            if (g1 < H)
              *reinterpret_cast<float2*>(part_o + (pm + g1) * DV + col) =
                  make_float2(acc[t][2], acc[t][3]);
          }
        }
      }
    }
  } else {
    // the empty partial (alone, a zero output row)
    for (int e = tid; e < H * DV; e += THREADS) {
      if (n_p == 1)
        o[e] = __float2bfloat16(0.f);
      else
        part_o[pm * DV + e] = 0.f;
    }
    if (n_p > 1)
      for (int g = tid; g < H; g += THREADS) {
        part_m[pm + g] = NEG_INF;
        part_l[pm + g] = 0.f;
      }
  }
  if (n_p == 1) return;

  // the last of the row's blocks to finish combines the partials
  __syncthreads();
  if (tid == 0) last = ticket(&counters[b]) == n_p - 1;
  __syncthreads();
  if (!last) return;
  combine<bf16>(out, part_o, part_m, part_l, b, H, n_p, m_s, den_s);
  if (tid == 0) counters[b] = 0;
}

// float32: grid as latent_mma_kernel's; lf::THREADS threads, lf::BYTES of
// dynamic shared memory.
template <typename KV>
__global__ void __launch_bounds__(lf::THREADS) latent_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ lat, float* __restrict__ out,
    float* __restrict__ part_o, float* __restrict__ part_m, float* __restrict__ part_l,
    int* __restrict__ counters, KV kv, int H, float scale) {
  using namespace lf;
  extern __shared__ __align__(16) float fs[];
  __shared__ int last;
  __shared__ float m_s[HMAX], den_s[HMAX];
  float* l_s = fs;          // [SPAN][ROWF]
  float* q_s = fs + Q_S;    // [H][DK], scaled
  const int blk = blockIdx.x, b = blockIdx.y, n_p = gridDim.x;
  const int start = blk * SPAN;
  const int j1 = min(start + SPAN, kv.length(b));
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long long pm = ((long long)b * n_p + blk) * H;
  float* o = out + (long long)b * H * DV;

  if (start < j1) {
    for (int i = tid; i < SPAN * DK; i += THREADS) {
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
      if (n_p == 1) {
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
  } else {
    for (int e = tid; e < H * DV; e += THREADS) {
      if (n_p == 1)
        o[e] = 0.f;
      else
        part_o[pm * DV + e] = 0.f;
    }
    if (n_p > 1)
      for (int g = tid; g < H; g += THREADS) {
        part_m[pm + g] = NEG_INF;
        part_l[pm + g] = 0.f;
      }
  }
  if (n_p == 1) return;
  __syncthreads();
  if (tid == 0) last = ticket(&counters[b]) == n_p - 1;
  __syncthreads();
  if (!last) return;
  combine<float>(out, part_o, part_m, part_l, b, H, n_p, m_s, den_s);
  if (tid == 0) counters[b] = 0;
}

// Whether a kernel may take its dynamic shared memory (above 48 KB) on a
// device: allowed once per kernel and device.
template <typename Kernel>
int allow(Kernel kernel, int bytes, bool* ready) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 64 && ready[dev]) return 0;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  if (dev < 64) ready[dev] = true;
  return 0;
}

template <typename KV>
bool* ready_mma() {
  static bool ready[64];
  return ready;
}
template <typename KV>
bool* ready_f32() {
  static bool ready[64];
  return ready;
}

// dtype 0 = float32, 1 = bfloat16. part_o: [B,n_p,H,DV] float32; part_ml:
// [2,B,n_p,H] float32 (m then l); counters: [B] int32, zero (left zero).
template <typename KV>
int launch_latent(int dtype, const void* q, const void* lat, void* o, void* part_o,
                  void* part_ml, void* counters, const KV& kv, int B, int H, int n_p, int dk,
                  int dv, float scale, void* stream) {
  if (B < 1 || H < 1 || H > HMAX || n_p < 1 || dk != DK || dv != DV)
    return (int)cudaErrorInvalidValue;
  float* pm = static_cast<float*>(part_ml);
  float* pl = pm + (long long)B * n_p * H;
  float* po = static_cast<float*>(part_o);
  int* cnt = static_cast<int*>(counters);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float s2 = scale * 1.4426950408889634f;  // the log2 domain
  const dim3 grid(n_p, B);
  int rc;
  if (dtype == 1) {
    if ((rc = allow(latent_mma_kernel<KV>, lt::BYTES, ready_mma<KV>()))) return rc;
    latent_mma_kernel<KV><<<grid, lt::THREADS, lt::BYTES, st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(lat), static_cast<bf16*>(o), po,
        pm, pl, cnt, kv, H, s2);
  } else if (dtype == 0) {
    if ((rc = allow(latent_f32_kernel<KV>, lf::BYTES, ready_f32<KV>()))) return rc;
    latent_f32_kernel<KV><<<grid, lf::THREADS, lf::BYTES, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(lat), static_cast<float*>(o), po,
        pm, pl, cnt, kv, H, s2);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace latent

using latent::launch_latent;

// The latent cache [B,S,DK] contiguous, one length for every row (1 <=
// length <= S); n_p = ceil(S / SPAN) blocks a row. Returns a cudaError_t.
extern "C" int repro_latent_decode_attention(const void* q, const void* lat, void* o,
                                             void* part_o, void* part_ml, void* counters, int B,
                                             int H, int S, int length, int dk, int dv,
                                             float scale, int dtype, void* stream) {
  if (S < 1 || length < 1 || length > S) return (int)cudaErrorInvalidValue;
  const decode_split::ContigKV kv{S, 1, latent::DK, length};
  return launch_latent(dtype, q, lat, o, part_o, part_ml, counters, kv, B, H,
                       (S + latent::SPAN - 1) / latent::SPAN, dk, dv, scale, stream);
}

// The latent pages [n_pool_pages, page_size, DK] by their element strides
// (a layer's strided view of the fleet's stacked store; rows contiguous), a
// [B, n_tab] int32 page table and [B] int32 lengths (clamped to the table's
// n_tab page_size positions); n_p = ceil(n_tab page_size / SPAN) blocks a
// row, as the contiguous form's over as many positions. Returns a
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
  const long long positions = (long long)n_tab * page_size;
  return launch_latent(dtype, q, lat, o, part_o, part_ml, counters, kv, B, H,
                       (int)((positions + latent::SPAN - 1) / latent::SPAN), dk, dv, scale,
                       stream);
}
