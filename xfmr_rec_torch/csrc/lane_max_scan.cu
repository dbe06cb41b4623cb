// f32 lane-max scan with positions, for Hopper (sm_90a).
//
// Replaces: xfmr_rec_tpu/ops/topk_pallas.py `_scan_kernel` (slots=1) and
// `_scan2_kernel` (slots=2), launched by `lane_max_scan`. Plain PyTorch
// version beside it: xfmr_rec_torch/ops/topk_f32.py
// `lane_max_scan_plain` (and `lane_max_scan_split_plain` for the split
// over blocks).
//
// What it computes. For every query row r and lane l of a corpus tile of
// width ct, tile t contributes the corpus row p = t*ct + ((l - shift) mod
// ct), shift = (t * lane_shuffle) mod ct, with score s = f32 dot of the
// bf16/f32 query with the bf16/int8/f32 corpus row, times the int8
// scale (a separate rounded multiply), -inf when p >= true_num_items.
// Each (row, lane) keeps its top-1 or top-2 (score, position) in
// ascending tile order under a strict `>`: on equal scores the earlier
// tile keeps slot 1 and the later one goes to slot 2. Empty slots are
// (-inf, 0). With track_discards each row also keeps the largest score
// that left a lane's slots (-inf when none did).
//
// What bounds it on this card. The contest: about 10 f32 and integer
// lane operations per score (2 compares, 5 selects, the discard max, the
// tile bookkeeping), against kernel 1's 7. The bf16 dot is a quarter of
// that on the tensor cores and would be twice it as an f32 fmaf chain.
// Bytes (corpus once, 2*slots (B, ct) outputs) are far below either.
//
// What the design does about it.
//   - bf16 queries against a bf16 or int8 corpus (`LaneMmaSweep`): the
//     scores come from `mma_sweep` (mma_sweep.cuh: wgmma behind the
//     cp.async corpus ring) and the contest runs on the accumulator
//     registers where they land. A slot keeps its value and the index of
//     its tile alone: the position is t*ct + lane_column(lane, shift_t),
//     recomputed at write-out, and the two slots' 16-bit tile indices
//     share one register (the wrapper refuses more than 65,536 tiles).
//     With two slots a thread holds 64 values, 32 tile pairs and 32
//     accumulators at 64 lanes: three blocks an SM.
//   - f32 x f32 (`LaneFmaSweep`): the f32 fmaf chain of scan_common.cuh,
//     32 rows x 128 lanes on 256 threads, two blocks an SM. TF32 would
//     drop mantissa bits that the reference keeps.
// When row tiles x lane chunks would leave SMs idle, the wrapper splits
// the tiles over gridDim.z blocks (as packed_scan.cu does). A value
// carries no tile, so the splits merge in tile order: each block parks
// its (value, tile) slots, and the last block of a (row tile, lane chunk)
// to arrive feeds them, split by split, into the same strict-`>` contest.
// The slots alone do not decide ties across splits: the contest keeps
// ties by history (slot 2 holds the second item of its value when two of
// them came before slot 1's, else the first), so feeding split 0's slot
// 1, its slot 2, then split 1's differs from the unsplit sweep on about
// 1% of heavily tied lanes. A split sweep therefore also keeps the tile
// of the first item that held slot 2's value (`first`), and each split
// feeds that item (where slot 2 holds a later one of a lower value than
// slot 1's), then its two slots, in ascending tile order: this gives the
// unsplit slots bit for bit, ties included. The extra register costs a
// block an SM, so it is only in the split instantiation. What the merge
// drops raises the discard-max. The discard-max reduces within the
// threads that share a row, then across blocks with the float-ordered
// `atomic_max_float`, which gives the same maximum in any order.

#include <math_constants.h>

#include "mma_sweep.cuh"
#include "scan_common.cuh"

namespace {

using namespace xfmr;

struct LaneScanArgs {
  int batch;
  int dim;
  int num_tiles;
  int corpus_tile;
  int true_num_items;  // < 0: no padding to mask
  int lane_shuffle;
  int track_discards;
};

constexpr int kMaxTiles = 1 << 16;  // tile indices are kept in 16 bits

// Score s of tile t enters a (row, lane)'s slots under the strict `>` of
// ascending tile order; what falls out raises `disc`. `tiles` holds slot
// 1's tile in its low 16 bits and slot 2's in its high 16 bits. With
// kFirst (two slots), `first` follows the tile of the first item that
// held slot 2's value: slot 1's when an item tied with slot 1 takes slot
// 2, else the item that takes it.
template <int SLOTS, bool kFirst = false>
__device__ __forceinline__ void value_contest(float s, uint32_t t, float& v1,
                                              float& v2, uint32_t& tiles,
                                              uint32_t& first, float& disc) {
  const bool beats1 = s > v1;
  // value displaced into the next contest
  const float contender = beats1 ? v1 : s;
  if constexpr (SLOTS == 1) {
    v1 = beats1 ? s : v1;
    tiles = beats1 ? t : tiles;
    disc = fmaxf(disc, contender);
  } else {
    const bool beats2 = contender > v2;
    if constexpr (kFirst) {
      first = beats2 ? (s >= v1 ? tiles & 0xFFFFu : t) : first;
    }
    v1 = beats1 ? s : v1;
    disc = fmaxf(disc, beats2 ? v2 : contender);
    v2 = beats2 ? contender : v2;
    // the tiles follow the values: the contender's tile takes slot 2 when
    // it beats it (a displaced slot 1 that ties slot 2 does not)
    const uint32_t contender_tile = beats1 ? tiles & 0xFFFFu : t;
    const uint32_t low = beats1 ? t : tiles;
    const uint32_t high = beats2 ? contender_tile << 16 : tiles;
    tiles = __byte_perm(low, high, 0x7610);  // low 16 bits of each
  }
}

// The corpus position of a slot, 0 for an empty (-inf) one.
__device__ __forceinline__ int slot_position(float v, uint32_t t, int lane,
                                             const LaneScanArgs& a) {
  if (v == -CUDART_INF_F) return 0;
  const int tile = static_cast<int>(t);
  return tile * a.corpus_tile +
         lane_column(lane, tile_shift(tile, a.lane_shuffle, a.corpus_tile),
                     a.corpus_tile);
}

template <typename CT, bool kAsync, int SLOTS, bool kSplit>
struct LaneMmaSweep {
  using Query = __nv_bfloat16;
  using Corpus = CT;
  static constexpr int kSlots = SLOTS;
  static constexpr bool kSplitTiles = kSplit;
  static constexpr bool kFirst = kSplit && SLOTS == 2;
  static constexpr int kThreads = kMmaThreads;
  static constexpr int kRows = kMmaRows;
  static constexpr int kLanes = kMmaLanes;
  static constexpr int kCols = kLanes / 4;  // lanes of a thread
  // the slot state sets the registers: three blocks an SM (at four, one
  // slot already spills), two with the split's `first` beside two slots
  static constexpr int kMinBlocks = kFirst ? 2 : 3;

  // in the accumulator's layout: [row half][2 * column group + column]
  struct Slots {
    float v1[2][kCols];
    float v2[2][kCols];  // untouched with one slot
    uint32_t tiles[2][kCols];
    uint32_t first[2][kCols];  // untouched unless kFirst
    float disc[2];
  };

  static size_t smem_bytes(int dim) {
    return mma_smem_bytes<CT, kAsync>(dim);
  }

  // The contest of one tile's scores, where wgmma left them. kMasked:
  // some lane of the block is past the tile or some item of the tile is
  // padding, so every score is checked.
  template <bool kScaled, bool kMasked>
  static __device__ __forceinline__ void contest(
      const float (&acc)[kMmaAcc], Slots& s, const LaneScanArgs& a, int t,
      int lane0, const float* scale_s) {
    const int q2 = (threadIdx.x & 3) * 2;
    const uint32_t tile = t;
    const int shift =
        kMasked ? tile_shift(t, a.lane_shuffle, a.corpus_tile) : 0;
    const long long tile_base = static_cast<long long>(t) * a.corpus_tile;
#pragma unroll
    for (int j = 0; j < kLanes / 8; ++j) {
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
          // a separate rounded multiply, never contracted into the dot:
          // the reference scales the finished f32 score
          if (kScaled) v = __fmul_rn(v, e ? scale.y : scale.x);
          if (kMasked) v = live ? v : -CUDART_INF_F;
          const int c = 2 * j + e;
          value_contest<SLOTS, kFirst>(v, tile, s.v1[h][c], s.v2[h][c],
                                       s.tiles[h][c], s.first[h][c],
                                       s.disc[h]);
        }
      }
    }
  }

  static __device__ __forceinline__ void contest_tile(
      const float (&acc)[kMmaAcc], Slots& s, const LaneScanArgs& a, int t,
      int lane0, const float* scale_s, bool scaled) {
    const bool masked =
        lane0 + kLanes > a.corpus_tile ||
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
      const LaneScanArgs& a, int row0, int lane0, int tile_begin,
      int tile_end, Slots& s) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      s.disc[h] = -CUDART_INF_F;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        s.v1[h][c] = -CUDART_INF_F;
        if constexpr (SLOTS == 2) s.v2[h][c] = -CUDART_INF_F;
        if constexpr (kFirst) s.first[h][c] = 0;
        s.tiles[h][c] = 0;
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

  // f(row in block, lane in block, v1, t1, v2, t2, first) for each of
  // the thread's (row, lanes) (v2 = -inf with one slot, first = t2
  // unless kFirst).
  template <typename F>
  static __device__ __forceinline__ void each_slot(const Slots& s, F&& f) {
    const int lane = threadIdx.x & 31;
    const int row = (threadIdx.x >> 5) * 16 + (lane >> 2);
    const int q2 = (lane & 3) * 2;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const uint32_t t2 = s.tiles[h][c] >> 16;
        f(row + 8 * h, 8 * (c >> 1) + q2 + (c & 1), s.v1[h][c],
          s.tiles[h][c] & 0xFFFFu, SLOTS == 2 ? s.v2[h][c] : -CUDART_INF_F,
          t2, kFirst ? s.first[h][c] : t2);
      }
    }
  }

  // f(row in block, the block's discard-max of that row), once per row.
  template <typename F>
  static __device__ __forceinline__ void each_row_discard(const Slots& s,
                                                          F&& f) {
    const int lane = threadIdx.x & 31;
    const int row = (threadIdx.x >> 5) * 16 + (lane >> 2);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // the four threads of a quad hold the same rows
      float v = s.disc[h];
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
      if ((lane & 3) == 0) f(row + 8 * h, v);
    }
  }
};

template <int SLOTS, bool kSplit>
struct LaneFmaSweep {
  using Query = float;
  using Corpus = float;
  static constexpr int kSlots = SLOTS;
  static constexpr bool kSplitTiles = kSplit;
  static constexpr bool kFirst = kSplit && SLOTS == 2;
  static constexpr int R = 4;  // rows per thread
  static constexpr int kThreads = xfmr::kThreads;
  static constexpr int kRows = kWarps * R;
  static constexpr int kLanes = kBlockLanes;
  // left to itself the compiler took 131 registers, one block an SM, and
  // ran markedly slower (PERF.md)
  static constexpr int kMinBlocks = 2;

  struct Slots {
    float v1[R][kLanesPerThread];
    float v2[R][kLanesPerThread];  // untouched with one slot
    uint32_t tiles[R][kLanesPerThread];
    uint32_t first[R][kLanesPerThread];  // untouched unless kFirst
    float disc[R];
  };

  static size_t smem_bytes(int dim) {
    return sizeof(float) * sweep_smem_floats<R>(dim);
  }

  // Ends without a barrier: threads may still be reading `smem`.
  static __device__ __forceinline__ void run(
      unsigned char* smem, const float* __restrict__ queries,
      const float* __restrict__ corpus, const float* __restrict__ scales,
      const LaneScanArgs& a, int row0, int lane0, int tile_begin,
      int tile_end, Slots& s) {
    const int tx = threadIdx.x & 31;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      s.disc[i] = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < kLanesPerThread; ++j) {
        s.v1[i][j] = -CUDART_INF_F;
        if constexpr (SLOTS == 2) s.v2[i][j] = -CUDART_INF_F;
        if constexpr (kFirst) s.first[i][j] = 0;
        s.tiles[i][j] = 0;
      }
    }
    fma_sweep<R>(
        reinterpret_cast<float*>(smem), queries, corpus, scales, a.batch,
        a.dim, a.corpus_tile, a.lane_shuffle, row0, lane0, tile_begin,
        tile_end,
        [&](const float (&acc)[R][kLanesPerThread], int t, int shift,
            const float* scale_s) {
          const long long tile_base =
              static_cast<long long>(t) * a.corpus_tile;
#pragma unroll
          for (int j = 0; j < kLanesPerThread; ++j) {
            const int ll = tx + 32 * j;
            const int lane = lane0 + ll;
            const long long item =
                tile_base + lane_column(lane, shift, a.corpus_tile);
            const bool live = lane < a.corpus_tile &&
                              (a.true_num_items < 0 || item < a.true_num_items);
            const float scale = scales != nullptr ? scale_s[ll] : 1.f;
#pragma unroll
            for (int i = 0; i < R; ++i) {
              float v = acc[i][j];
              // a separate rounded multiply, never contracted into the
              // dot's last FMA: the reference scales the finished score
              if (scales != nullptr) v = __fmul_rn(v, scale);
              v = live ? v : -CUDART_INF_F;
              value_contest<SLOTS, kFirst>(v, t, s.v1[i][j], s.v2[i][j],
                                           s.tiles[i][j], s.first[i][j],
                                           s.disc[i]);
            }
          }
        });
  }

  template <typename F>
  static __device__ __forceinline__ void each_slot(const Slots& s, F&& f) {
    const int tx = threadIdx.x & 31;
    const int ty = threadIdx.x >> 5;
#pragma unroll
    for (int i = 0; i < R; ++i) {
#pragma unroll
      for (int j = 0; j < kLanesPerThread; ++j) {
        const uint32_t t2 = s.tiles[i][j] >> 16;
        f(ty * R + i, tx + 32 * j, s.v1[i][j], s.tiles[i][j] & 0xFFFFu,
          SLOTS == 2 ? s.v2[i][j] : -CUDART_INF_F, t2,
          kFirst ? s.first[i][j] : t2);
      }
    }
  }

  template <typename F>
  static __device__ __forceinline__ void each_row_discard(const Slots& s,
                                                          F&& f) {
    const int ty = threadIdx.x >> 5;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      float v = s.disc[i];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
      }
      if ((threadIdx.x & 31) == 0) f(ty * R + i, v);
    }
  }
};

// Merges the (value, tile) slots that the `splits` blocks of one (row
// tile, lane chunk) parked in `work_vals` / `work_tiles` (`splits`
// buffers of (batch, slots*ct) each; slot 2's tile word carries `first`
// in its high 16 bits) in tile order, as the header says, and writes
// values and positions. What the merge drops raises `dmax` (unless null).
// Called by all threads of the block that arrived last; reads past L1,
// since other blocks wrote these.
template <typename Sweep>
__device__ __forceinline__ void merge_lane_slots(
    const float* work_vals, const int* work_tiles, int splits,
    const LaneScanArgs& a, int row0, int lane0, float* vals, int* pos,
    float* dmax) {
  constexpr int SLOTS = Sweep::kSlots;
  const int ct = a.corpus_tile;
  const size_t stride = static_cast<size_t>(SLOTS) * ct;
  const int rows = min(Sweep::kRows, a.batch - row0);
  for (int e = threadIdx.x; e < rows * Sweep::kLanes; e += Sweep::kThreads) {
    const size_t row = row0 + e / Sweep::kLanes;  // one row a warp and pass
    const int lane = lane0 + e % Sweep::kLanes;
    float dropped = -CUDART_INF_F;
    if (lane < ct) {
      float v1 = -CUDART_INF_F, v2 = -CUDART_INF_F;
      uint32_t tiles = 0, unused = 0;
      const auto feed = [&](float v, uint32_t t) {
        value_contest<SLOTS>(v, t, v1, v2, tiles, unused, dropped);
      };
      for (int s = 0; s < splits; ++s) {
        const size_t at = (static_cast<size_t>(s) * a.batch + row) * stride +
                          lane;
        const float p1 = __ldcg(work_vals + at);
        const uint32_t q1 = __ldcg(work_tiles + at);
        if constexpr (SLOTS == 1) {
          feed(p1, q1);
        } else {
          const float p2 = __ldcg(work_vals + at + ct);
          const uint32_t word = __ldcg(work_tiles + at + ct);
          const uint32_t q2 = word & 0xFFFFu, first = word >> 16;
          // the first item of slot 2's value, where slot 2 holds a later
          // one: it came before both slots
          if (p2 < p1 && first != q2) feed(p2, first);
          if (q2 < q1) {
            feed(p2, q2);
            feed(p1, q1);
          } else {
            feed(p1, q1);
            feed(p2, q2);
          }
        }
      }
      const size_t at = row * stride + lane;
      vals[at] = v1;
      pos[at] = slot_position(v1, tiles & 0xFFFFu, lane, a);
      if constexpr (SLOTS == 2) {
        vals[at + ct] = v2;
        pos[at + ct] = slot_position(v2, tiles >> 16, lane, a);
      }
    }
    if (dmax != nullptr) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        dropped = fmaxf(dropped, __shfl_xor_sync(0xffffffffu, dropped, off));
      }
      if ((threadIdx.x & 31) == 0) atomic_max_float(&dmax[row], dropped);
    }
  }
}

template <typename Sweep>
__global__ void __launch_bounds__(Sweep::kThreads, Sweep::kMinBlocks)
    lane_max_scan_kernel(const typename Sweep::Query* __restrict__ queries,
                         const typename Sweep::Corpus* __restrict__ corpus,
                         const float* __restrict__ scales, float* vals,
                         int* pos, float* dmax, float* work_vals,
                         int* work_tiles, int* arrivals, LaneScanArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int is_last;
  const int row0 = blockIdx.x * Sweep::kRows;
  const int lane0 = blockIdx.y * Sweep::kLanes;
  const int splits = gridDim.z;
  const int ct = a.corpus_tile;
  const size_t stride = static_cast<size_t>(Sweep::kSlots) * ct;

  {
    int tile_begin, tile_end;
    split_range(a.num_tiles, blockIdx.z, splits, tile_begin, tile_end);
    typename Sweep::Slots slots;
    Sweep::run(smem, queries, corpus, scales, a, row0, lane0, tile_begin,
               tile_end, slots);
    const size_t part = static_cast<size_t>(blockIdx.z) * a.batch * stride;
    Sweep::each_slot(slots, [&](int r, int l, float v1, uint32_t t1, float v2,
                                uint32_t t2, uint32_t first) {
      const int row = row0 + r;
      const int lane = lane0 + l;
      if (row >= a.batch || lane >= ct) return;
      const size_t at = row * stride + lane;
      if constexpr (!Sweep::kSplitTiles) {
        vals[at] = v1;
        pos[at] = slot_position(v1, t1, lane, a);
        if (Sweep::kSlots == 2) {
          vals[at + ct] = v2;
          pos[at + ct] = slot_position(v2, t2, lane, a);
        }
      } else {
        work_vals[part + at] = v1;
        work_tiles[part + at] = static_cast<int>(t1);
        if (Sweep::kSlots == 2) {
          work_vals[part + at + ct] = v2;
          work_tiles[part + at + ct] = static_cast<int>(t2 | first << 16);
        }
      }
    });
    if (a.track_discards) {
      Sweep::each_row_discard(slots, [&](int r, float v) {
        if (row0 + r < a.batch) atomic_max_float(&dmax[row0 + r], v);
      });
    }
  }
  if constexpr (!Sweep::kSplitTiles) return;
  if (!arrives_last(&arrivals[blockIdx.y * gridDim.x + blockIdx.x], splits,
                    &is_last)) {
    return;
  }
  // every split of this (row tile, lane chunk) is parked: merge them
  merge_lane_slots<Sweep>(work_vals, work_tiles, splits, a, row0, lane0, vals,
                          pos, a.track_discards ? dmax : nullptr);
}

template <int SLOTS, bool kSplit, typename F>
int with_lane_sweep_of(int q_kind, int corpus_kind, bool aligned, int dim,
                       F&& f) {
  if (q_kind == 0 && corpus_kind == 0) {
    if (ring_async<__nv_bfloat16>(aligned, dim)) {
      return f(LaneMmaSweep<__nv_bfloat16, true, SLOTS, kSplit>{});
    }
    return f(LaneMmaSweep<__nv_bfloat16, false, SLOTS, kSplit>{});
  }
  if (q_kind == 0 && corpus_kind == 1) {
    if (ring_async<int8_t>(aligned, dim)) {
      return f(LaneMmaSweep<int8_t, true, SLOTS, kSplit>{});
    }
    return f(LaneMmaSweep<int8_t, false, SLOTS, kSplit>{});
  }
  if (q_kind == 1 && corpus_kind == 2) return f(LaneFmaSweep<SLOTS, kSplit>{});
  return static_cast<int>(cudaErrorInvalidValue);
}

// Calls `f` with an instance of the sweep that serves these operands and
// slots (q_kind: 0 bf16, 1 f32; corpus_kind: 0 bf16, 1 int8, 2 f32),
// the instantiation that parks its slots for a merge when `split`, or
// returns cudaErrorInvalidValue for any other combination.
template <typename F>
int with_lane_sweep(int slots, bool split, int q_kind, int corpus_kind,
                    bool aligned, int dim, F&& f) {
  if (slots == 1 && split) {
    return with_lane_sweep_of<1, true>(q_kind, corpus_kind, aligned, dim, f);
  }
  if (slots == 1) {
    return with_lane_sweep_of<1, false>(q_kind, corpus_kind, aligned, dim, f);
  }
  if (slots == 2 && split) {
    return with_lane_sweep_of<2, true>(q_kind, corpus_kind, aligned, dim, f);
  }
  if (slots == 2) {
    return with_lane_sweep_of<2, false>(q_kind, corpus_kind, aligned, dim, f);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename Sweep>
int launch(const void* q, const void* c, const float* scales, float* vals,
           int* pos, float* dmax, float* work_vals, int* work_tiles,
           int* arrivals, const LaneScanArgs& a, int splits,
           cudaStream_t stream) {
  const size_t smem = Sweep::smem_bytes(a.dim);
  cudaError_t err = allow_smem(lane_max_scan_kernel<Sweep>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.batch + Sweep::kRows - 1) / Sweep::kRows,
                  (a.corpus_tile + Sweep::kLanes - 1) / Sweep::kLanes, splits);
  lane_max_scan_kernel<Sweep><<<grid, Sweep::kThreads, smem, stream>>>(
      static_cast<const typename Sweep::Query*>(q),
      static_cast<const typename Sweep::Corpus*>(c), scales, vals, pos, dmax,
      work_vals, work_tiles, arrivals, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The block shape of the split launch that these operands get (rows,
// lanes, blocks an SM: see `sweep_shape`), by which the wrapper plans the
// splits; `aligned`: the corpus pointer is a multiple of 16 bytes.
// Returns a CUDA error code (0 on success).
extern "C" int xfmr_lane_max_scan_shape(int aligned, int dim, int slots,
                                        int q_kind, int corpus_kind,
                                        int* shape) {
  return with_lane_sweep(slots, true, q_kind, corpus_kind, aligned != 0, dim,
                         [&](auto sweep) {
    using Sweep = decltype(sweep);
    return sweep_shape<Sweep>(lane_max_scan_kernel<Sweep>,
                              Sweep::smem_bytes(dim), shape);
  });
}

// q_kind: 0 bf16, 1 f32. corpus_kind: 0 bf16, 1 int8, 2 f32. `dmax` must
// hold -inf in every row when track_discards is set; it is not touched
// otherwise. With splits > 1, `work_vals` and `work_tiles` hold splits x
// (batch, slots*corpus_tile) f32 and int32, and `arrivals` one zeroed int
// per (row tile, lane chunk). Returns cudaGetLastError() after the launch
// (0 on success).
extern "C" int xfmr_lane_max_scan(const void* q, const void* corpus,
                                  const void* scales, void* vals, void* pos,
                                  void* dmax, void* work_vals,
                                  void* work_tiles, void* arrivals, int batch,
                                  int dim, int num_tiles, int corpus_tile,
                                  int slots, int true_num_items,
                                  int lane_shuffle, int track_discards,
                                  int splits, int q_kind, int corpus_kind,
                                  void* stream) {
  if (batch <= 0 || num_tiles <= 0) return 0;
  if (splits < 1 || splits > num_tiles || num_tiles > kMaxTiles) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const LaneScanArgs a = {batch,          dim,          num_tiles,
                          corpus_tile,    true_num_items, lane_shuffle,
                          track_discards};
  return with_lane_sweep(slots, splits > 1, q_kind, corpus_kind,
                         aligned16(corpus), dim, [&](auto sweep) {
    return launch<decltype(sweep)>(
        q, corpus, static_cast<const float*>(scales),
        static_cast<float*>(vals), static_cast<int*>(pos),
        static_cast<float*>(dmax), static_cast<float*>(work_vals),
        static_cast<int*>(work_tiles), static_cast<int*>(arrivals), a, splits,
        static_cast<cudaStream_t>(stream));
  });
}
