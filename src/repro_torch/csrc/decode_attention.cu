// Split-KV flash-decoding (one query token per row) over a contiguous cache,
// for NVIDIA Hopper (sm_90a).
//
// Replaces: src/repro/kernels/decode_attention.py::_kernel, the Pallas TPU
// kernel behind decode_attention() (the twin of models/layers.py
// decode_attention, which the JAX package runs on this path).
//
// q: [B,H,D]; k, v: [B,S,K,D] (the decode cache [B, S_max, K*D] as it lies);
// out: [B,H,D]; one length for every row. The kernel, the bound and the
// design notes are in decode_split.cuh, which the paged decode
// (paged_decode_attention.cu) shares: only the addressing (ContigKV here)
// differs. A second entry reads a sliding-window layer's ring-buffer cache
// (RingKV), where the reference runs layers.window_decode_attention in XLA.
//
// Each entry point launches one kernel on the caller's stream and returns
// cudaGetLastError().

#include "decode_split.cuh"

// dtype: 0 = float32, 1 = bfloat16. part_o: [B,K,n_p,G,D] float32;
// part_ml: [2,B,K,n_p,G] float32 (m then l), n_p = n_splits = ceil(S /
// split), or on decode_mma_kernel one a tc::L<D>::SPAN positions
// (kernels/decode_attention.slots); counters: [B*K] int32, zero (left
// zero). Returns a cudaError_t.
extern "C" int repro_decode_attention(const void* q, const void* k,
                                      const void* v, void* o, void* part_o,
                                      void* part_ml, void* counters, int B, int H,
                                      int K, int S, int D, int length, int window,
                                      int dtype, int split, void* stream) {
  if (length < 1 || length > S || split < 1) return (int)cudaErrorInvalidValue;
  const decode_split::ContigKV kv{S, K, D, length};
  return decode_split::dispatch(dtype, D, q, k, v, o, part_o, part_ml, counters, kv,
                                B, H, K, (S + split - 1) / split, window, split,
                                stream);
}

// The same kernel over a ring-buffer window cache k, v: [B,W,K,D], where
// position p lies in slot p % W (the layout of the reference's
// layers.window_decode_attention). The decode at position pos attends to
// the last n = min(window, W, pos + 1) positions; part_o and part_ml are
// sized as above for n_splits = ceil(n / split). Returns a cudaError_t.
extern "C" int repro_ring_decode_attention(const void* q, const void* k,
                                           const void* v, void* o, void* part_o,
                                           void* part_ml, void* counters, int B,
                                           int H, int K, int W, int D, int pos,
                                           int window, int dtype, int split,
                                           void* stream) {
  if (W < 1 || pos < 0 || window < 1 || split < 1) return (int)cudaErrorInvalidValue;
  const int n = min(min(window, W), pos + 1);
  const decode_split::RingKV kv{W, K, D, n, pos + 1 - n};
  return decode_split::dispatch(dtype, D, q, k, v, o, part_o, part_ml, counters, kv,
                                B, H, K, (n + split - 1) / split, 0, split, stream);
}
