// The packed-key slot contest over a whole corpus, shared by
// packed_scan.cu (which writes the slots out) and packed_scan_select.cu
// (which goes on to merge and select them).
//
// For every query row r and lane l of a corpus tile of width ct, tile t
// contributes the corpus row t*ct + ((l - shift) mod ct), shift =
// (t * lane_shuffle) mod ct (the TPU kernel's roll, done here as index
// arithmetic). Its score s (f32 dot of the bf16/f32 query with the
// bf16/int8/f32 corpus row, times the int8 scale) becomes the key
//   (bits(s + 1.5) & ~low_mask) | t << reserve_bits
// (the +1.5 already inside s when the corpus carries the bias column), 0
// for padded rows. Each (row, lane) keeps its top-2 keys and each row of
// a thread the largest key its lanes evicted. The contest is elementwise
// per (row, lane) and does not depend on tile order.

#pragma once

#include "scan_common.cuh"

namespace xfmr {

constexpr int kPackedRows = 8;  // rows per thread
constexpr int kPackedBlockRows = kWarps * kPackedRows;  // 64

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

// Runs the sweep for the block's rows row0.. and lanes lane0.. and
// leaves the slots and per-row discard-max in the caller's registers.
// Ends without a barrier: threads may still be reading `smem`.
template <typename QT, typename CT>
__device__ __forceinline__ void packed_sweep(
    float* smem, const QT* __restrict__ queries,
    const CT* __restrict__ corpus, const float* __restrict__ scales,
    const PackedSweepArgs& a, int row0, int lane0,
    int (&best1)[kPackedRows][kLanesPerThread],
    int (&best2)[kPackedRows][kLanesPerThread], int (&disc)[kPackedRows]) {
  const SweepSmem<kPackedRows> sm(smem, a.dim);
  const int tx = threadIdx.x & 31;
  stage_queries<kPackedRows>(sm, queries, row0, a.batch, a.dim);
#pragma unroll
  for (int i = 0; i < kPackedRows; ++i) {
    disc[i] = 0;
#pragma unroll
    for (int j = 0; j < kLanesPerThread; ++j) {
      best1[i][j] = 0;
      best2[i][j] = 0;
    }
  }

  for (int t = 0; t < a.num_tiles; ++t) {
    const int shift = tile_shift(t, a.lane_shuffle, a.corpus_tile);
    const size_t tile_base = static_cast<size_t>(t) * a.corpus_tile;
    __syncthreads();  // previous tile fully consumed (and q_s written)
    stage_tile<kPackedRows>(sm, corpus, scales, tile_base, lane0, shift,
                            a.corpus_tile, a.dim);
    __syncthreads();

    float acc[kPackedRows][kLanesPerThread];
    tile_dot<kPackedRows>(sm, a.dim, acc);

    const int stamp = t << a.reserve_bits;
#pragma unroll
    for (int j = 0; j < kLanesPerThread; ++j) {
      const int ll = tx + 32 * j;
      const int lane = lane0 + ll;
      const long long item = static_cast<long long>(tile_base) +
                             lane_column(lane, shift, a.corpus_tile);
      const bool live = lane < a.corpus_tile &&
                        (a.true_num_items < 0 || item < a.true_num_items);
      const float scale = scales != nullptr ? sm.scale_s[ll] : 1.f;
#pragma unroll
      for (int i = 0; i < kPackedRows; ++i) {
        float s = acc[i][j];
        // separate roundings, never contracted into one FMA: the
        // reference multiplies by the scale, then adds the window bias
        if (scales != nullptr) s = __fmul_rn(s, scale);
        if (a.add_bias) s = __fadd_rn(s, 1.5f);
        int key = (__float_as_int(s) & ~a.low_mask) | stamp;
        key = live ? key : 0;
        const int b1 = best1[i][j];
        const int b2 = best2[i][j];
        const int contender = min(b1, key);
        best1[i][j] = max(b1, key);
        best2[i][j] = max(b2, contender);
        disc[i] = max(disc[i], min(b2, contender));
      }
    }
  }
}

}  // namespace xfmr
