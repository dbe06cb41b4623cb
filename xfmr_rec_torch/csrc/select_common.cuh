// The per-row threshold select, shared by threshold_select.cu (one
// block per pool row) and packed_scan_select.cu (the epilogue of the
// fused kernel), so both run the same code.
//
// For one row of `width` non-negative int32 keys in shared memory: tau,
// the k-th largest key at quantum granularity, by a bit search (from bit
// 22 seeded with the row max's exponent bits, or from bit 30, down to
// quantum_bits: per bit, count keys >= tau | bit and keep the bit when at
// least k do). Then every key above the tau quantum is kept, and
// tau-quantum ties in lane order up to `capacity` in all. Kept keys are
// written at their rank (lane order) with meta = lane + 1; empty slots
// are 0.

#pragma once

#include <cuda_runtime.h>

namespace xfmr {

constexpr int kSelectThreads = 256;
constexpr int kSelectWarps = kSelectThreads / 32;

// Scratch of one select: block-wide reduction and scan cells.
struct SelectScratch {
  int red[kSelectWarps];
  int scan[kSelectWarps];
};

__device__ __forceinline__ int block_sum(int v, int* red) {
  v = __reduce_add_sync(0xffffffffu, v);
  const int warp = threadIdx.x >> 5;
  __syncthreads();  // red[] free from the previous call
  if ((threadIdx.x & 31) == 0) red[warp] = v;
  __syncthreads();
  int total = 0;
#pragma unroll
  for (int w = 0; w < kSelectWarps; ++w) total += red[w];
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
  for (int w = 1; w < kSelectWarps; ++w) total = max(total, red[w]);
  return total;
}

// Called by all kSelectThreads threads of a block. `row_s` [width] holds
// the row, `local_max` this thread's share of the row max (any split),
// `keys_s` and `meta_s` [capacity] are shared scratch; the function
// zeroes them itself. Writes dst_keys and dst_meta [capacity] in global
// memory. Ends with the scratch still being read: put a __syncthreads()
// before reusing row_s, keys_s or meta_s.
__device__ __forceinline__ void select_row(
    const int* row_s, int local_max, int width, int k, int capacity,
    int quantum_bits, int shared_exponent, int* keys_s, int* meta_s,
    SelectScratch* scratch, int* __restrict__ dst_keys,
    int* __restrict__ dst_meta) {
  const int tid = threadIdx.x;
  for (int i = tid; i < capacity; i += kSelectThreads) {
    keys_s[i] = 0;
    meta_s[i] = 0;
  }
  __syncthreads();

  // 1. the k-th largest key, by bits
  int tau = 0;
  int high_bit = 30;
  if (shared_exponent) {
    tau = block_max(local_max, scratch->red) & ~((1 << 23) - 1);
    high_bit = 22;
  }
  for (int bit = high_bit; bit >= quantum_bits; --bit) {
    const int cand = tau | (1 << bit);
    int count = 0;
    for (int i = tid; i < width; i += kSelectThreads) {
      count += row_s[i] >= cand;
    }
    if (block_sum(count, scratch->red) >= k) tau = cand;
  }

  // 2. two-class keep set; ranks from one exclusive scan over lanes
  const int floor_key = max(tau, 1);
  const int gt_key = static_cast<int>(static_cast<unsigned>(floor_key) +
                                      (1u << quantum_bits));
  const int per = (width + kSelectThreads - 1) / kSelectThreads;
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
  __syncthreads();  // scan[] free from the previous row
  if ((tid & 31) == 31) scratch->scan[tid >> 5] = incl;
  __syncthreads();
  int warp_base = 0;
  int total = 0;
#pragma unroll
  for (int w = 0; w < kSelectWarps; ++w) {
    if (w < (tid >> 5)) warp_base += scratch->scan[w];
    total += scratch->scan[w];
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
  for (int i = tid; i < capacity; i += kSelectThreads) {
    dst_keys[i] = keys_s[i];
    dst_meta[i] = meta_s[i];
  }
}

}  // namespace xfmr
