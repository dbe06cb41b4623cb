// The per-row threshold select, run by one warp over one row in shared
// memory: shared by threshold_select.cu (a warp per pool row) and the
// tail of packed_scan_select.cu (a warp per merged row), so both run the
// same code. No block barrier anywhere: reductions are warp votes and
// shuffles, the histogram is the warp's own.
//
// For one row of `width` non-negative int32 keys: tau, the k-th largest
// key at quantum granularity, seeded with the row max's exponent bits
// (shared_exponent) or 0. The searched bits run from 22 (or 30) down to
// quantum_bits; the search takes them in digits of at most kRadixBits,
// from the top (13 bits on the main path: two passes, not 13). Per digit,
// a histogram of the digit over the keys that carry tau's bits above it,
// then the highest bin whose suffix count reaches the keys still needed.
// That equals the bit search of the plain version (a bit is kept when at
// least k keys are >= tau | bit): both give max(seed, the k-th key with
// the bits below the quantum cleared), and
// tests/test_torch_select_radix.py holds the two equal. The suffix
// counts above the chosen bins add up to n_gt, the keys at or above the
// next quantum, so the compaction is one pass: every key above the tau
// quantum, then tau-quantum ties in lane order up to `capacity`, each
// written at its rank (lane order) with meta = lane + 1; empty slots 0.
//
// No pass branches per key: on an H100 a branch a key (in SASS, a
// BSSY/BSYNC region around each key's add or store) made the warp
// reconverge once a key, at about a hundred cycles each. The histogram
// add is an unconditional `atomicAdd(+1)`, which the card aggregates
// over the lanes that hit one address (keys outside the prefix all go to
// a spare bin); kept keys are written with predicated stores; a step's
// four 16-byte reads go out together.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace xfmr {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kRadixBits = 8;
constexpr int kRadixBins = 1 << kRadixBits;
// ints of a warp's histogram: the bins, then the spare bin (padded so a
// region that follows stays 16-byte aligned)
constexpr int kHistInts = kRadixBins + 4;
constexpr int kQuadKeys = 128;  // keys of one warp step: four a thread

// Steps of 128 keys in a row of `width` keys.
__host__ __device__ inline int row_steps(int width) {
  return (width + kQuadKeys - 1) / kQuadKeys;
}

// A row of `width` keys in lane order in shared memory, at a 16-byte
// aligned address, in a buffer of row_steps(width) * 128 ints: every
// thread reads every step, past the row's end too, so no read waits on a
// branch. `each(f)` calls f(v, i, n) for each step: v[0..3] the keys at
// lanes i..i+3 (i = step * 128 + 4 * thread), of which those with j < n
// are in the row (n may be negative or above 4); the same number of
// calls in every thread of the warp, so f may use warp collectives.
struct RowView {
  const int* keys;
  int width;

  template <typename F>
  __device__ __forceinline__ void each(F&& f) const {
    const int i0 = 4 * (threadIdx.x & 31);
    const int steps = row_steps(width);
    for (int s0 = 0; s0 < steps; s0 += 4) {
      int4 w[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int s = min(s0 + u, steps - 1);
        w[u] = *reinterpret_cast<const int4*>(keys + s * kQuadKeys + i0);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (s0 + u < steps) {  // the same in every thread
          const int i = (s0 + u) * kQuadKeys + i0;
          const int v[4] = {w[u].x, w[u].y, w[u].z, w[u].w};
          f(v, i, width - i);
        }
      }
    }
  }
};

// Stores v at *p where `pred` holds, predicated rather than branched.
__device__ __forceinline__ void store_if(bool pred, int* p, int v) {
  asm volatile(
      "{\n .reg .pred q;\n setp.ne.u32 q, %0, 0;\n @q st.global.u32 [%1], %2;\n}"
      ::"r"(static_cast<unsigned>(pred)), "l"(p), "r"(v)
      : "memory");
}

// One digit of the search: among the keys whose bits from `top` up equal
// `prefix`, the histogram of bits [shift, top) in the warp's `hist`
// (kHistInts ints). Returns the highest bin whose suffix count reaches
// `need`, with `above` the count of the bins over it; -1 when the keys
// with the prefix are fewer than `need`.
__device__ __forceinline__ int radix_digit(const RowView& row,
                                           unsigned prefix, int top,
                                           int shift, int need, int* hist,
                                           int& above) {
  const int lane = threadIdx.x & 31;
  const int bins = 1 << (top - shift);
  const unsigned mask = bins - 1;
  // lane l owns bins [first, last): it zeroes them and scans them
  const int per = (bins + 31) >> 5;
  const int first = min(lane * per, bins);
  const int last = min(first + per, bins);
  for (int b = first; b < last; ++b) hist[b] = 0;
  __syncwarp();
  row.each([&](const int (&v)[4], int, int n) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const unsigned u = static_cast<unsigned>(v[j]);
      const bool in = (j < n) & ((u >> top) == prefix);
      atomicAdd(hist + (in ? (u >> shift) & mask : kRadixBins), 1);
    }
  });
  __syncwarp();
  int mine = 0;
  for (int b = first; b < last; ++b) mine += hist[b];
  int suffix = mine;  // keys in the bins of this lane and the lanes above
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int n = __shfl_down_sync(kFullMask, suffix, off);
    if (lane + off < 32) suffix += n;
  }
  const unsigned reach = __ballot_sync(kFullMask, suffix >= need);
  if (reach == 0) return -1;
  const int owner = 31 - __clz(reach);
  int found = 0;
  int over = suffix - mine;
  if (lane == owner) {
    for (int b = last - 1; b >= first; --b) {
      if (over + hist[b] >= need) {
        found = b;
        break;
      }
      over += hist[b];
    }
  }
  above = __shfl_sync(kFullMask, over, owner);
  return __shfl_sync(kFullMask, found, owner);
}

// Called by all 32 threads of a warp with the same row; `hist`
// [kHistInts] is the warp's workspace in shared memory; writes dst_keys and
// dst_meta [capacity] in global memory. Ends with the row and `hist`
// still being read: put a __syncwarp() before reusing them.
__device__ __forceinline__ void select_row(const RowView& row, int k,
                                           int capacity, int quantum_bits,
                                           int shared_exponent, int* hist,
                                           int* __restrict__ dst_keys,
                                           int* __restrict__ dst_meta) {
  const int lane = threadIdx.x & 31;

  // 1. tau, by digits
  int tau = 0;
  int top = 31;  // one above the highest searched bit
  if (shared_exponent) {
    int row_max[2] = {0, 0};
    row.each([&](const int (&v)[4], int, int n) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        row_max[j & 1] = max(row_max[j & 1], j < n ? v[j] : 0);
      }
    });
    tau = __reduce_max_sync(kFullMask, max(row_max[0], row_max[1])) &
          ~((1 << 23) - 1);
    top = 23;
  }
  int need = k;
  int n_gt = -1;  // keys >= tau + quantum, when the digits tell it
  int above_all = 0;
  while (top > quantum_bits) {
    const int shift = max(top - kRadixBits, quantum_bits);
    int above = 0;
    const int bin = radix_digit(row, static_cast<unsigned>(tau) >> top, top,
                                shift, need, hist, above);
    if (bin < 0) break;  // first digit only: fewer than k keys >= seed
    tau |= bin << shift;
    need -= above;
    above_all += above;
    top = shift;
    if (top == quantum_bits) n_gt = above_all;
  }

  // 2. the keep set: above the tau quantum, then ties up to capacity
  const int floor_key = max(tau, 1);
  // int32 wrap-around, as the plain version's
  const int gt_key = static_cast<int>(static_cast<unsigned>(floor_key) +
                                      (1u << quantum_bits));
  if (tau < 1 || gt_key < floor_key || n_gt < 0) {
    // the digits counted from tau, not from floor_key, or stopped early
    int count = 0;
    row.each([&](const int (&v)[4], int, int n) {
#pragma unroll
      for (int j = 0; j < 4; ++j) count += (j < n) & (v[j] >= gt_key);
    });
    n_gt = __reduce_add_sync(kFullMask, count);
  }
  const int budget = capacity - n_gt;

  // 3. ranks in lane order from ballots: a step's keys before (lane, j)
  // are the four of every lower lane and this lane's own before j
  const unsigned lanes_before = (1u << lane) - 1;
  int gt_seen = 0;  // class counts of the steps before
  int tie_seen = 0;
  row.each([&](const int (&v)[4], int i, int n) {
    bool gt[4], tie[4];
    unsigned gt_mask[4], tie_mask[4];
    unsigned any = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      gt[j] = (j < n) & (v[j] >= gt_key);
      tie[j] = (j < n) & !gt[j] & (v[j] >= floor_key);
      gt_mask[j] = __ballot_sync(kFullMask, gt[j]);
      tie_mask[j] = __ballot_sync(kFullMask, tie[j]);
      any |= gt_mask[j] | tie_mask[j];
    }
    if (any == 0) return;  // the same in every thread
    int g = gt_seen;
    int t = tie_seen;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      g += __popc(gt_mask[j] & lanes_before);
      t += __popc(tie_mask[j] & lanes_before);
      gt_seen += __popc(gt_mask[j]);
      tie_seen += __popc(tie_mask[j]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int rank = g + min(t, budget);
      const bool keep =
          (gt[j] | (tie[j] & (t < budget))) &
          (static_cast<unsigned>(rank) < static_cast<unsigned>(capacity));
      store_if(keep, dst_keys + rank, v[j]);
      store_if(keep, dst_meta + rank, i + j + 1);
      g += gt[j];
      t += tie[j];
    }
  });
  const int kept = min(capacity, gt_seen + max(0, min(tie_seen, budget)));
  for (int s = kept + lane; s < capacity; s += 32) {
    dst_keys[s] = 0;
    dst_meta[s] = 0;
  }
}

}  // namespace xfmr
