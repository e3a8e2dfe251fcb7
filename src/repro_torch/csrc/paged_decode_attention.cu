// Split-KV flash-decoding (one query token per row) over a paged KV pool,
// for NVIDIA Hopper (sm_90a).
//
// Replaces: src/repro/kernels/decode_attention.py::_paged_kernel, the Pallas
// TPU kernel behind paged_decode_attention() and paged_attention_pool_view(),
// which read the serving pool's pages through a scalar-prefetched page table.
//
// q: [B,H,D] contiguous; k, v: a pool [n_pool_pages, page_size, K, D] given
// by its base pointers and element strides (page, row, head; D contiguous),
// so a layer's strided view of a stacked [n_pages, page_size, n_layers*K*D]
// store is read in place; page_table: [B, n_tab] int32; lengths: [B] int32,
// one per row; out: [B,H,D].
//
// On the TPU the table drives the BlockSpec index maps and the grid walks a
// row's pages in order, carrying (m, l, acc). Here a block loads its own
// page indices: the splits are the contiguous decode's (decode_split.cuh),
// each a parallel block over SPLIT logical positions, and each lane reads
// the page of its position from the table (table[b, pos / page_size]) and
// then its slice of the K/V row through the strides. Splits past a row's
// length read nothing, so the table entries past the length (0 by
// contract) are never read. Bound and design notes: decode_split.cuh.
//
// The entry point launches one kernel on the caller's stream and returns
// cudaGetLastError().

#include "decode_split.cuh"

// dtype: 0 = float32, 1 = bfloat16. part_o: [B,K,n_p,G,D] float32;
// part_ml: [2,B,K,n_p,G] float32 (m then l), n_p as decode_attention.cu's
// for n_splits = ceil(n_tab * page_size / split); counters: [B*K] int32,
// zero (left zero). Strides are in elements. Returns a cudaError_t.
extern "C" int repro_paged_decode_attention(
    const void* q, const void* k, const void* v, void* o, void* part_o,
    void* part_ml, void* counters, const void* page_table, const void* lengths,
    int B, int H, int K, int D, int n_tab, int page_size, long long page_stride,
    long long row_stride, long long head_stride, int window, int dtype,
    int split, void* stream) {
  if (n_tab < 1 || page_size < 1 || split < 1) return (int)cudaErrorInvalidValue;
  const decode_split::PagedKV kv{static_cast<const int*>(page_table),
                                 static_cast<const int*>(lengths),
                                 n_tab,
                                 page_size,
                                 page_stride,
                                 row_stride,
                                 head_stride};
  const long long positions = (long long)n_tab * page_size;
  return decode_split::dispatch(dtype, D, q, k, v, o, part_o, part_ml, counters, kv,
                                B, H, K, (int)((positions + split - 1) / split),
                                window, split, stream);
}
