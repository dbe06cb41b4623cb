// Per-row threshold-select over a packed-key pool, for Hopper (sm_90a).
//
// Replaces: xfmr_rec_tpu/ops/topk_pallas.py `_select_kernel` (body
// `_threshold_select_body`, launched by `select_topk_keys`). Plain
// PyTorch version beside it: xfmr_rec_torch/ops/topk.py
// `select_topk_keys_plain`.
//
// What it computes. For each row of a (B, W) pool of non-negative int32
// keys: tau, the k-th largest key at quantum granularity, by a bit search
// (from bit 22 seeded with the row max's exponent bits, or from bit 30,
// down to quantum_bits: per bit, count keys >= tau | bit and keep the bit
// when at least k do). Then every key above the tau quantum is kept, and
// tau-quantum ties in lane order up to `capacity` in all. Kept keys are
// written at their rank (lane order) with meta = lane + 1; empty slots
// are 0. The final sort over `capacity` lanes stays in the wrapper.
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

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ int block_sum(int v, int* red) {
  v = __reduce_add_sync(0xffffffffu, v);
  const int warp = threadIdx.x >> 5;
  __syncthreads();  // red[] free from the previous call
  if ((threadIdx.x & 31) == 0) red[warp] = v;
  __syncthreads();
  int total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) total += red[w];
  return total;
}

__device__ __forceinline__ int block_max(int v, int* red) {
  v = __reduce_max_sync(0xffffffffu, v);
  const int warp = threadIdx.x >> 5;
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[warp] = v;
  __syncthreads();
  int total = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) total = max(total, red[w]);
  return total;
}

__global__ void __launch_bounds__(kThreads) threshold_select_kernel(
    const int* __restrict__ pool, int* __restrict__ out_keys,
    int* __restrict__ out_meta, int width, int k, int capacity,
    int quantum_bits, int shared_exponent) {
  extern __shared__ int smem[];
  int* row_s = smem;                // [width]
  int* keys_s = row_s + width;      // [capacity]
  int* meta_s = keys_s + capacity;  // [capacity]
  __shared__ int red[kWarps];
  __shared__ int scan_s[kWarps];

  const int tid = threadIdx.x;
  const size_t row = blockIdx.x;
  const int* src = pool + row * width;
  int local_max = 0;
  for (int i = tid; i < width; i += kThreads) {
    const int v = src[i];
    row_s[i] = v;
    local_max = max(local_max, v);
  }
  for (int i = tid; i < capacity; i += kThreads) {
    keys_s[i] = 0;
    meta_s[i] = 0;
  }
  __syncthreads();

  // 1. the k-th largest key, by bits
  int tau = 0;
  int high_bit = 30;
  if (shared_exponent) {
    tau = block_max(local_max, red) & ~((1 << 23) - 1);
    high_bit = 22;
  }
  for (int bit = high_bit; bit >= quantum_bits; --bit) {
    const int cand = tau | (1 << bit);
    int count = 0;
    for (int i = tid; i < width; i += kThreads) count += row_s[i] >= cand;
    if (block_sum(count, red) >= k) tau = cand;
  }

  // 2. two-class keep set; ranks from one exclusive scan over lanes
  const int floor_key = max(tau, 1);
  const int gt_key = static_cast<int>(static_cast<unsigned>(floor_key) +
                                      (1u << quantum_bits));
  const int per = (width + kThreads - 1) / kThreads;
  const int begin = min(tid * per, width);
  const int end = min(begin + per, width);
  int local = 0;
  for (int i = begin; i < end; ++i) {
    const int v = row_s[i];
    local += v >= gt_key ? (1 << 16) : (v >= floor_key ? 1 : 0);
  }
  // inclusive warp scan, then across warps
  int incl = local;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int n = __shfl_up_sync(0xffffffffu, incl, off);
    if ((tid & 31) >= off) incl += n;
  }
  if ((tid & 31) == 31) scan_s[tid >> 5] = incl;
  __syncthreads();
  int warp_base = 0;
  int total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    if (w < (tid >> 5)) warp_base += scan_s[w];
    total += scan_s[w];
  }
  int excl = warp_base + incl - local;
  const int budget = capacity - (total >> 16);
  for (int i = begin; i < end; ++i) {
    const int v = row_s[i];
    const int inc = v >= gt_key ? (1 << 16) : (v >= floor_key ? 1 : 0);
    const int tie_rank = excl & 0xFFFF;
    const int gt_rank = excl >> 16;
    const bool gt = v >= gt_key;
    const bool keep = gt || (v >= floor_key && tie_rank < budget);
    if (keep) {
      const int rank = gt_rank + min(tie_rank, budget);
      keys_s[rank] = v;
      meta_s[rank] = i + 1;
    }
    excl += inc;
  }
  __syncthreads();
  int* dst_keys = out_keys + row * capacity;
  int* dst_meta = out_meta + row * capacity;
  for (int i = tid; i < capacity; i += kThreads) {
    dst_keys[i] = keys_s[i];
    dst_meta[i] = meta_s[i];
  }
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
  threshold_select_kernel<<<batch, kThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(pool), static_cast<int*>(keys),
      static_cast<int*>(meta), width, k, capacity, quantum_bits,
      shared_exponent);
  return static_cast<int>(cudaGetLastError());
}
