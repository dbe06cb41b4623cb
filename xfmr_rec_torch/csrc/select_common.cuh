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

// Scratch of one select: reduction and scan cells of the group of kT
// threads that runs it, sized for the largest group (kT / 32 cells are
// used).
struct SelectScratch {
  int red[kSelectWarps];
  int scan[kSelectWarps];
};

// A select is run by a group of kT threads: a whole block of kT threads
// (kT a multiple of 32), or, with kT = 32, one warp of a larger block,
// each warp with a row and a scratch of its own.
template <int kT>
__device__ __forceinline__ void group_sync() {
  if (kT == 32) {
    __syncwarp();
  } else {
    __syncthreads();
  }
}

template <int kT = kSelectThreads>
__device__ __forceinline__ int block_sum(int v, int* red) {
  v = __reduce_add_sync(0xffffffffu, v);
  if (kT == 32) return v;
  const int warp = threadIdx.x >> 5;
  __syncthreads();  // red[] free from the previous call
  if ((threadIdx.x & 31) == 0) red[warp] = v;
  __syncthreads();
  int total = 0;
#pragma unroll
  for (int w = 0; w < kT / 32; ++w) total += red[w];
  return total;
}

template <int kT = kSelectThreads>
__device__ __forceinline__ int block_max(int v, int* red) {
  v = __reduce_max_sync(0xffffffffu, v);
  if (kT == 32) return v;
  const int warp = threadIdx.x >> 5;
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[warp] = v;
  __syncthreads();
  int total = red[0];
#pragma unroll
  for (int w = 1; w < kT / 32; ++w) total = max(total, red[w]);
  return total;
}

// Step 2 of the select for a single warp: the kept keys to their ranks.
// The warp takes 32 consecutive lanes at a time, so the shared-memory
// reads do not collide (a contiguous run per thread would put all 32 on
// one bank), and ballots count the kept keys of the lanes before.
__device__ __forceinline__ void place_kept_warp(
    const int* __restrict__ row_s, int width, int floor_key, int gt_key,
    int capacity, int* __restrict__ keys_s, int* __restrict__ meta_s) {
  const int lane = threadIdx.x & 31;
  const unsigned before = (1u << lane) - 1;
  int above = 0;
  for (int i = lane; i < width; i += 32) above += row_s[i] >= gt_key;
  const int budget = capacity - __reduce_add_sync(0xffffffffu, above);
  int gt_seen = 0;
  int tie_seen = 0;
#pragma unroll 4
  for (int base = 0; base < width; base += 32) {
    const int i = base + lane;
    const int v = i < width ? row_s[i] : 0;  // 0 is below every floor
    const bool gt = v >= gt_key;
    const bool tie = !gt && v >= floor_key;
    const unsigned gt_mask = __ballot_sync(0xffffffffu, gt);
    const unsigned tie_mask = __ballot_sync(0xffffffffu, tie);
    const int tie_rank = tie_seen + __popc(tie_mask & before);
    if (gt || (tie && tie_rank < budget)) {
      const int rank =
          gt_seen + __popc(gt_mask & before) + min(tie_rank, budget);
      keys_s[rank] = v;
      meta_s[rank] = i + 1;
    }
    gt_seen += __popc(gt_mask);
    tie_seen += __popc(tie_mask);
  }
}

// Called by all kT threads of a group (the result does not depend on
// kT). `row_s` [width] holds the row, `local_max` this thread's share of
// the row max (any split), `keys_s` and `meta_s` [capacity] are shared
// scratch; the function
// zeroes them itself. Writes dst_keys and dst_meta [capacity] in global
// memory; a single warp (kT = 32) needs no `scratch`. Ends with the
// scratch still being read: put a group_sync<kT>() before reusing row_s,
// keys_s or meta_s.
template <int kT = kSelectThreads>
__device__ __forceinline__ void select_row(
    const int* row_s, int local_max, int width, int k, int capacity,
    int quantum_bits, int shared_exponent, int* keys_s, int* meta_s,
    SelectScratch* scratch, int* __restrict__ dst_keys,
    int* __restrict__ dst_meta) {
  const int tid = threadIdx.x % kT;
  for (int i = tid; i < capacity; i += kT) {
    keys_s[i] = 0;
    meta_s[i] = 0;
  }
  group_sync<kT>();

  // 1. the k-th largest key, by bits
  int* red = nullptr;  // a single warp reduces in registers
  if constexpr (kT != 32) red = scratch->red;
  int tau = 0;
  int high_bit = 30;
  if (shared_exponent) {
    tau = block_max<kT>(local_max, red) & ~((1 << 23) - 1);
    high_bit = 22;
  }
  for (int bit = high_bit; bit >= quantum_bits; --bit) {
    const int cand = tau | (1 << bit);
    int count = 0;
    for (int i = tid; i < width; i += kT) {
      count += row_s[i] >= cand;
    }
    if (block_sum<kT>(count, red) >= k) tau = cand;
  }

  // 2. two-class keep set; ranks from one exclusive scan over lanes
  const int floor_key = max(tau, 1);
  const int gt_key = static_cast<int>(static_cast<unsigned>(floor_key) +
                                      (1u << quantum_bits));
  if constexpr (kT == 32) {
    place_kept_warp(row_s, width, floor_key, gt_key, capacity, keys_s, meta_s);
  } else {
    const int per = (width + kT - 1) / kT;
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
    group_sync<kT>();  // scan[] free from the previous row
    if ((tid & 31) == 31) scratch->scan[tid >> 5] = incl;
    group_sync<kT>();
    int warp_base = 0;
    int total = 0;
#pragma unroll
    for (int w = 0; w < kT / 32; ++w) {
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
  }
  group_sync<kT>();
  for (int i = tid; i < capacity; i += kT) {
    dst_keys[i] = keys_s[i];
    dst_meta[i] = meta_s[i];
  }
}

}  // namespace xfmr
