// Per-row threshold-select over a packed-key pool, for Hopper (sm_90a).
//
// Replaces: xfmr_rec_tpu/ops/topk_pallas.py `_select_kernel` (body
// `_threshold_select_body`, launched by `select_topk_keys`). Plain
// PyTorch version beside it: xfmr_rec_torch/ops/topk.py
// `select_topk_keys_plain`.
//
// What it computes. For each row of a (B, W) pool of non-negative int32
// keys, the select of select_common.cuh: the k-th largest key at quantum
// granularity by a bit search, then every key above the tau quantum and
// tau-quantum ties in lane order up to `capacity`, compacted to their
// rank with meta = lane + 1. The final sort over `capacity` lanes stays
// in the wrapper.
//
// What bounds it on this card. Bytes: the pool is read once (B*W*4) and
// 2*B*capacity*4 written; the bit search re-reads the row ~23 times, but
// from shared memory. At W=3072 that is tens of MB, a few us at 3.35 TB/s;
// in practice the ~23 block-wide reductions (two barriers each) and
// one block per row set the time.
//
// What the design does about it. One block per row: the row (16 KB at
// W=4096) sits in shared memory, each bit's count is a warp reduction
// plus a 8-entry cross-warp sum. Ranks come from one block-wide exclusive
// scan of a packed two-class counter (above-quantum << 16 | tie), each
// thread owning a contiguous run of lanes so its local order is lane
// order. Each kept key scatters straight to its rank: the TPU kernel's
// butterfly compaction exists only because TPU lanes cannot gather, and
// is not needed here.

#include "select_common.cuh"

namespace {

using namespace xfmr;

__global__ void __launch_bounds__(kSelectThreads) threshold_select_kernel(
    const int* __restrict__ pool, int* __restrict__ out_keys,
    int* __restrict__ out_meta, int width, int k, int capacity,
    int quantum_bits, int shared_exponent) {
  extern __shared__ int smem[];
  int* row_s = smem;                // [width]
  int* keys_s = row_s + width;      // [capacity]
  int* meta_s = keys_s + capacity;  // [capacity]
  __shared__ SelectScratch scratch;

  const size_t row = blockIdx.x;
  const int* src = pool + row * width;
  int local_max = 0;
  for (int i = threadIdx.x; i < width; i += kSelectThreads) {
    const int v = src[i];
    row_s[i] = v;
    local_max = max(local_max, v);
  }
  select_row(row_s, local_max, width, k, capacity, quantum_bits,
             shared_exponent, keys_s, meta_s, &scratch,
             out_keys + row * capacity, out_meta + row * capacity);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int xfmr_threshold_select(const void* pool, void* keys,
                                     void* meta, int batch, int width, int k,
                                     int capacity, int quantum_bits,
                                     int shared_exponent, void* stream) {
  if (batch <= 0) return 0;
  const size_t smem = sizeof(int) * (static_cast<size_t>(width) +
                                     2 * static_cast<size_t>(capacity));
  cudaError_t err = cudaFuncSetAttribute(
      threshold_select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  threshold_select_kernel<<<batch, kSelectThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(pool), static_cast<int*>(keys),
      static_cast<int*>(meta), width, k, capacity, quantum_bits,
      shared_exponent);
  return static_cast<int>(cudaGetLastError());
}
