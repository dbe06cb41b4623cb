// The packed-key slot contest over a range of corpus tiles, shared by
// packed_scan.cu (which writes the slots out) and packed_scan_select.cu
// (which goes on to merge and select them).
//
// Replaces the body of xfmr_rec_tpu/ops/topk_pallas.py
// `_packed_scan2_kernel` (and of `_packed_scan_select_kernel`'s sweep).
//
// For every query row r and lane l of a corpus tile of width ct, tile t
// contributes the corpus row t*ct + ((l - shift) mod ct), shift =
// (t * lane_shuffle) mod ct (the TPU kernel's roll, done here as index
// arithmetic). Its score s (f32 sum of the bf16/f32 query times the
// bf16/int8/f32 corpus row, times the int8 scale) becomes the key
//   (bits(s + 1.5) & ~low_mask) | t << reserve_bits
// (the +1.5 already inside s when the corpus carries the bias column), 0
// for padded rows. Each (row, lane) keeps its top-2 keys and each row of
// a thread the largest key its lanes evicted. The contest is elementwise
// per (row, lane), all integer max and min, and does not depend on tile
// order: so the tiles may be split over blocks, each block keeping the
// top-2 of its own range, and `merge_patch` below puts them together.
//
// What bounds it on this card. About seven integer operations per score
// for the key and the contest (0.9 ms at B=4096, N=2^20 at the CUDA
// cores' peak); the dot is 0.56 ms on the tensor cores and 8.2 ms on the
// f32 units, so it must not run there; the corpus is re-read from L2 by
// every 64-row tile, 128 bytes for 64 rows' worth of scores.
//
// What the design does about it. Two sweeps with one interface:
//   - `MmaSweep` (bf16 queries, bf16 or int8 corpus): one warpgroup owns
//     64 rows x kMmaLanes lanes. The scores of a tile come from wgmma
//     (`mma_sweep` of mma_sweep.cuh) and the contest runs on the
//     accumulator registers where they land, the slot state in the same
//     layout, so no score moves between threads. That is 64 slot and 32
//     accumulator registers a thread, 128 in all, so four blocks share an
//     SM: while one waits for its product or at a barrier, the others
//     contest. The corpus ring keeps two more tiles on their way. The
//     scale and the +1.5 stay two separately rounded f32 steps, as in the
//     reference.
//   - `FmaSweep` (f32 queries and corpus): the f32 `fmaf` chain of
//     scan_common.cuh (`fma_sweep`), 64 rows x 128 lanes on 256
//     threads. It stays on the CUDA cores because TF32 would drop
//     mantissa bits that the reference keeps.
// Each is a struct of static members: the block's shape (kThreads, kRows,
// kLanes), `Slots` (the registers of one thread), `run` (the sweep over
// tiles [tile_begin, tile_end)), `each_slot` and `each_row_discard`
// (which hand the registers out by their (row, lane) in the block).

#pragma once

#include <stdint.h>

#include "mma_sweep.cuh"
#include "scan_common.cuh"

namespace xfmr {

constexpr int kPackedRows = 8;  // rows per thread of the fmaf sweep
constexpr int kPackedBlockRows = 64;  // rows per block of either sweep
static_assert(kPackedBlockRows == kWarps * kPackedRows, "fmaf sweep rows");
static_assert(kPackedBlockRows == kMmaRows, "wgmma sweep rows");

struct PackedSweepArgs {
  int batch;
  int dim;
  int num_tiles;
  int corpus_tile;
  int true_num_items;  // < 0: no padding to mask
  int lane_shuffle;
  int low_mask;
  int reserve_bits;
  int add_bias;  // 0 when the corpus carries the 1.5 column
};

// One key enters a (row, lane)'s top-2; what falls out raises `disc`.
__device__ __forceinline__ void slot_contest(int key, int& best1, int& best2,
                                             int& disc) {
  const int contender = min(best1, key);
  disc = max(disc, min(best2, contender));
  best2 = max(best2, contender);
  best1 = max(best1, key);
}

// Merges the partial slots that the `splits` blocks of one (row tile,
// lane chunk) parked in `work` (`splits` buffers of (batch, 2*ct) keys)
// into `out` (batch, 2*ct), which may be the first of those buffers: a
// key carries its tile, so the top-2 of a (row, lane) over all tiles is
// the top-2 of its partial slots. What the merge drops raises `dmax`
// (unless null). Called by all threads of the block that arrived last;
// reads past L1, since other blocks wrote these.
template <typename Sweep>
__device__ __forceinline__ void merge_patch(const int* work, int splits,
                                            const PackedSweepArgs& a,
                                            int row0, int lane0, int* out,
                                            int* dmax) {
  const int ct = a.corpus_tile;
  const size_t stride = 2 * static_cast<size_t>(ct);
  const int rows = min(Sweep::kRows, a.batch - row0);
  for (int e = threadIdx.x; e < rows * Sweep::kLanes; e += Sweep::kThreads) {
    const size_t row = row0 + e / Sweep::kLanes;  // one row a warp and pass
    const int lane = lane0 + e % Sweep::kLanes;
    int dropped = 0;
    if (lane < ct) {
      int best1 = 0, best2 = 0;
      for (int s = 0; s < splits; ++s) {
        const int* src =
            work + (static_cast<size_t>(s) * a.batch + row) * stride + lane;
        slot_contest(__ldcg(src), best1, best2, dropped);
        slot_contest(__ldcg(src + ct), best1, best2, dropped);
      }
      out[row * stride + lane] = best1;
      out[row * stride + ct + lane] = best2;
    }
    if (dmax != nullptr) {
      dropped = __reduce_max_sync(0xffffffffu, dropped);
      if ((threadIdx.x & 31) == 0) atomicMax(&dmax[row], dropped);
    }
  }
}

struct FmaSweep {
  using Query = float;
  using Corpus = float;
  static constexpr int kThreads = xfmr::kThreads;
  static constexpr int kMinBlocks = 1;
  static constexpr int kRows = kPackedBlockRows;
  static constexpr int kLanes = kBlockLanes;

  struct Slots {
    int best1[kPackedRows][kLanesPerThread];
    int best2[kPackedRows][kLanesPerThread];
    int disc[kPackedRows];
  };

  static size_t smem_bytes(int dim) {
    return sizeof(float) * sweep_smem_floats<kPackedRows>(dim);
  }

  // Ends without a barrier: threads may still be reading `smem`.
  static __device__ __forceinline__ void run(
      unsigned char* smem, const float* __restrict__ queries,
      const float* __restrict__ corpus, const float* __restrict__ scales,
      const PackedSweepArgs& a, int row0, int lane0, int tile_begin,
      int tile_end, Slots& s) {
    const int tx = threadIdx.x & 31;
#pragma unroll
    for (int i = 0; i < kPackedRows; ++i) {
      s.disc[i] = 0;
#pragma unroll
      for (int j = 0; j < kLanesPerThread; ++j) {
        s.best1[i][j] = 0;
        s.best2[i][j] = 0;
      }
    }
    fma_sweep<kPackedRows>(
        reinterpret_cast<float*>(smem), queries, corpus, scales, a.batch,
        a.dim, a.corpus_tile, a.lane_shuffle, row0, lane0, tile_begin,
        tile_end,
        [&](const float (&acc)[kPackedRows][kLanesPerThread], int t,
            int shift, const float* scale_s) {
          const size_t tile_base = static_cast<size_t>(t) * a.corpus_tile;
          const int stamp = t << a.reserve_bits;
#pragma unroll
          for (int j = 0; j < kLanesPerThread; ++j) {
            const int ll = tx + 32 * j;
            const int lane = lane0 + ll;
            const long long item = static_cast<long long>(tile_base) +
                                   lane_column(lane, shift, a.corpus_tile);
            const bool live = lane < a.corpus_tile &&
                              (a.true_num_items < 0 || item < a.true_num_items);
            const float scale = scales != nullptr ? scale_s[ll] : 1.f;
#pragma unroll
            for (int i = 0; i < kPackedRows; ++i) {
              float v = acc[i][j];
              // separate roundings, never contracted into one FMA: the
              // reference multiplies by the scale, then adds the window bias
              if (scales != nullptr) v = __fmul_rn(v, scale);
              if (a.add_bias) v = __fadd_rn(v, 1.5f);
              int key = (__float_as_int(v) & ~a.low_mask) | stamp;
              key = live ? key : 0;
              slot_contest(key, s.best1[i][j], s.best2[i][j], s.disc[i]);
            }
          }
        });
  }

  // f(row in block, lane in block, best1, best2) for each of the thread's
  // slots.
  template <typename F>
  static __device__ __forceinline__ void each_slot(const Slots& s, F&& f) {
    const int tx = threadIdx.x & 31;
    const int ty = threadIdx.x >> 5;
#pragma unroll
    for (int i = 0; i < kPackedRows; ++i) {
#pragma unroll
      for (int j = 0; j < kLanesPerThread; ++j) {
        f(ty * kPackedRows + i, tx + 32 * j, s.best1[i][j], s.best2[i][j]);
      }
    }
  }

  // f(row in block, the block's discard-max of that row), once per row.
  template <typename F>
  static __device__ __forceinline__ void each_row_discard(const Slots& s,
                                                          F&& f) {
    const int ty = threadIdx.x >> 5;
#pragma unroll
    for (int i = 0; i < kPackedRows; ++i) {
      const int v = __reduce_max_sync(0xffffffffu, s.disc[i]);
      if ((threadIdx.x & 31) == 0) f(ty * kPackedRows + i, v);
    }
  }
};

// kAsync: corpus rows are a multiple of 16 bytes at a 16-byte-aligned
// pointer, so the ring fills with cp.async (see mma_sweep.cuh).
template <typename CT, bool kAsync>
struct MmaSweep {
  using Query = __nv_bfloat16;
  using Corpus = CT;
  static constexpr int kThreads = kMmaThreads;
  // blocks an SM that the registers are held to: four, or three for the
  // ring of plain loads, which needs a few registers more and is the
  // slow path anyway
  static constexpr int kMinBlocks = kAsync ? 4 : 3;
  static constexpr int kRows = kMmaRows;
  static constexpr int kLanes = kMmaLanes;
  static constexpr int kCols = kMmaLanes / 4;  // lanes of a thread

  // in the accumulator's layout: [row half][2 * column group + column]
  struct Slots {
    int best1[2][kCols];
    int best2[2][kCols];
    int disc[2];
  };

  static size_t smem_bytes(int dim) { return mma_smem_bytes<CT, kAsync>(dim); }

  // The contest of one tile's scores, where wgmma left them. kMasked:
  // some lane of the block is past the tile or some item of the tile is
  // padding, so every key is checked.
  template <bool kScaled, bool kMasked>
  static __device__ __forceinline__ void contest(
      const float (&acc)[kMmaAcc], Slots& s, const PackedSweepArgs& a, int t,
      int lane0, const float* scale_s) {
    const int q2 = (threadIdx.x & 3) * 2;
    const int stamp = t << a.reserve_bits;
    const int keep = ~a.low_mask;
    // +0.0f leaves a score that carries its own bias as it is
    const float bias = a.add_bias ? 1.5f : 0.f;
    const int shift =
        kMasked ? tile_shift(t, a.lane_shuffle, a.corpus_tile) : 0;
    const long long tile_base = static_cast<long long>(t) * a.corpus_tile;
#pragma unroll
    for (int j = 0; j < kMmaLanes / 8; ++j) {
      float2 scale = make_float2(1.f, 1.f);
      if (kScaled) {
        scale = *reinterpret_cast<const float2*>(scale_s + 8 * j + q2);
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        bool live = true;
        if (kMasked) {
          const int lane = lane0 + 8 * j + q2 + e;
          live = lane < a.corpus_tile &&
                 (a.true_num_items < 0 ||
                  tile_base + lane_column(lane, shift, a.corpus_tile) <
                      a.true_num_items);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float v = acc[4 * j + 2 * h + e];
          // separate roundings, never contracted into one FMA: the
          // reference multiplies by the scale, then adds the window bias
          if (kScaled) v = __fmul_rn(v, e ? scale.y : scale.x);
          v = __fadd_rn(v, bias);
          int key = (__float_as_int(v) & keep) | stamp;
          if (kMasked) key = live ? key : 0;
          slot_contest(key, s.best1[h][2 * j + e], s.best2[h][2 * j + e],
                       s.disc[h]);
        }
      }
    }
  }

  static __device__ __forceinline__ void contest_tile(
      const float (&acc)[kMmaAcc], Slots& s, const PackedSweepArgs& a, int t,
      int lane0, const float* scale_s, bool scaled) {
    const bool masked =
        lane0 + kMmaLanes > a.corpus_tile ||
        (a.true_num_items >= 0 &&
         static_cast<long long>(t + 1) * a.corpus_tile > a.true_num_items);
    if (masked) {
      if (scaled) {
        contest<true, true>(acc, s, a, t, lane0, scale_s);
      } else {
        contest<false, true>(acc, s, a, t, lane0, scale_s);
      }
    } else if (scaled) {
      contest<true, false>(acc, s, a, t, lane0, scale_s);
    } else {
      contest<false, false>(acc, s, a, t, lane0, scale_s);
    }
  }

  // Ends without a barrier: a thread may still be reading the scales.
  static __device__ __forceinline__ void run(
      unsigned char* smem, const __nv_bfloat16* __restrict__ queries,
      const CT* __restrict__ corpus, const float* __restrict__ scales,
      const PackedSweepArgs& a, int row0, int lane0, int tile_begin,
      int tile_end, Slots& s) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      s.disc[h] = 0;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        s.best1[h][c] = 0;
        s.best2[h][c] = 0;
      }
    }
    const bool scaled = scales != nullptr;
    mma_sweep<CT, kAsync>(
        smem, queries, corpus, scales, a.batch, a.dim, a.corpus_tile,
        a.lane_shuffle, row0, lane0, tile_begin, tile_end,
        [&](const float (&acc)[kMmaAcc], int t, const float* scale_s) {
          contest_tile(acc, s, a, t, lane0, scale_s, scaled);
        });
  }

  template <typename F>
  static __device__ __forceinline__ void each_slot(const Slots& s, F&& f) {
    const int lane = threadIdx.x & 31;
    const int row = (threadIdx.x >> 5) * 16 + (lane >> 2);
    const int q2 = (lane & 3) * 2;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        f(row + 8 * h, 8 * (c >> 1) + q2 + (c & 1), s.best1[h][c],
          s.best2[h][c]);
      }
    }
  }

  template <typename F>
  static __device__ __forceinline__ void each_row_discard(const Slots& s,
                                                          F&& f) {
    const int lane = threadIdx.x & 31;
    const int row = (threadIdx.x >> 5) * 16 + (lane >> 2);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // the four threads of a quad hold the same rows
      int v = s.disc[h];
      v = max(v, __shfl_xor_sync(0xffffffffu, v, 1));
      v = max(v, __shfl_xor_sync(0xffffffffu, v, 2));
      if ((lane & 3) == 0) f(row + 8 * h, v);
    }
  }
};

// Calls `f` with an instance of the sweep that serves these operands
// (q_kind: 0 bf16, 1 f32; corpus_kind: 0 bf16, 1 int8, 2 f32) and returns
// its result, or cudaErrorInvalidValue for any other pair. One sweep per
// pair; the asynchronous ring wherever the corpus rows allow it
// (`aligned`: the corpus pointer is a multiple of 16 bytes).
template <typename F>
int with_sweep(int q_kind, int corpus_kind, bool aligned, int dim, F&& f) {
  if (q_kind == 0 && corpus_kind == 0) {
    if (ring_async<__nv_bfloat16>(aligned, dim)) {
      return f(MmaSweep<__nv_bfloat16, true>{});
    }
    return f(MmaSweep<__nv_bfloat16, false>{});
  }
  if (q_kind == 0 && corpus_kind == 1) {
    if (ring_async<int8_t>(aligned, dim)) return f(MmaSweep<int8_t, true>{});
    return f(MmaSweep<int8_t, false>{});
  }
  if (q_kind == 1 && corpus_kind == 2) return f(FmaSweep{});
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace xfmr
