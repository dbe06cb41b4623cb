// Per-row count of corpus scores at or above a threshold, for Hopper
// (sm_90a).
//
// Replaces: xfmr_rec_tpu/ops/topk_pallas.py `_count_kernel`, launched by
// `count_at_least`. Plain PyTorch version beside it:
// xfmr_rec_torch/ops/topk_f32.py `count_at_least_plain`.
//
// What it computes. counts[r] = #{p < true_num_items : dot(q_r, c_p) >=
// tau[r]}, the dot in f32. It is the cross-check of the discard
// certificate: tau is the k-th score the lane-max scan found, and the
// row is exact when the count is k.
//
// What bounds it on this card. The dot: 2*B*N*D operations (the
// compare and the add are 2 more per score), on f32 FMA units in this
// version. Bytes are the corpus once plus (B,) in and out.
//
// What the design does about it. tau's own item must compare >= tau, so
// every score has to round exactly as in lane_max_scan.cu: both kernels
// take their scores from `tile_dot` of scan_common.cuh, one f32 fmaf
// chain over d in ascending order. A block owns 64 rows x 128 lanes and
// walks all tiles; counts add up in registers, then across the warp,
// then across the lane-chunk blocks with one integer atomicAdd per row,
// which is exact in any order.

#include <math_constants.h>

#include "scan_common.cuh"

namespace {

using namespace xfmr;

constexpr int kCountRows = 8;  // rows per thread
constexpr int kCountBlockRows = kWarps * kCountRows;

template <typename QT, typename CT>
__global__ void __launch_bounds__(kThreads, 1) count_at_least_kernel(
    const QT* __restrict__ queries, const CT* __restrict__ corpus,
    const float* __restrict__ tau, int* counts, int batch, int dim,
    int num_tiles, int corpus_tile, int true_num_items) {
  extern __shared__ float smem[];
  const SweepSmem<kCountRows> sm(smem, dim);
  const int tx = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;
  const int row0 = blockIdx.x * kCountBlockRows;
  const int lane0 = blockIdx.y * kBlockLanes;

  stage_queries<kCountRows>(sm, queries, row0, batch, dim);

  float row_tau[kCountRows];
  int hits[kCountRows];
#pragma unroll
  for (int i = 0; i < kCountRows; ++i) {
    const int row = row0 + ty * kCountRows + i;
    row_tau[i] = row < batch ? tau[row] : CUDART_INF_F;
    hits[i] = 0;
  }

  for (int t = 0; t < num_tiles; ++t) {
    const size_t tile_base = static_cast<size_t>(t) * corpus_tile;
    __syncthreads();  // previous tile fully consumed (and q_s written)
    stage_tile<kCountRows>(sm, corpus, nullptr, tile_base, lane0, 0,
                           corpus_tile, dim);
    __syncthreads();

    float acc[kCountRows][kLanesPerThread];
    tile_dot<kCountRows>(sm, dim, acc);

#pragma unroll
    for (int j = 0; j < kLanesPerThread; ++j) {
      const int lane = lane0 + tx + 32 * j;
      const long long item = static_cast<long long>(tile_base) + lane;
      const bool live = lane < corpus_tile &&
                        (true_num_items < 0 || item < true_num_items);
#pragma unroll
      for (int i = 0; i < kCountRows; ++i) {
        hits[i] += (live && acc[i][j] >= row_tau[i]) ? 1 : 0;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kCountRows; ++i) {
    const int v = __reduce_add_sync(0xffffffffu, hits[i]);
    const int row = row0 + ty * kCountRows + i;
    if (tx == 0 && row < batch) atomicAdd(&counts[row], v);
  }
}

template <typename QT, typename CT>
int launch(const void* q, const void* c, const float* tau, int* counts,
           int batch, int dim, int num_tiles, int corpus_tile,
           int true_num_items, cudaStream_t stream) {
  const size_t smem = sizeof(float) * sweep_smem_floats<kCountRows>(dim);
  cudaError_t err = allow_smem(count_at_least_kernel<QT, CT>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((batch + kCountBlockRows - 1) / kCountBlockRows,
                  (corpus_tile + kBlockLanes - 1) / kBlockLanes);
  count_at_least_kernel<QT, CT><<<grid, kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const CT*>(c), tau, counts,
      batch, dim, num_tiles, corpus_tile, true_num_items);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q_kind: 0 bf16, 1 f32. corpus_kind: 0 bf16, 2 f32 (the reference takes
// no scales, so no int8). `counts` must hold 0 in every row. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int xfmr_count_at_least(const void* q, const void* corpus,
                                   const void* tau, void* counts, int batch,
                                   int dim, int num_tiles, int corpus_tile,
                                   int true_num_items, int q_kind,
                                   int corpus_kind, void* stream) {
  if (batch <= 0 || num_tiles <= 0) return 0;
  const float* t = static_cast<const float*>(tau);
  int* n = static_cast<int*>(counts);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_kind == 0 && corpus_kind == 0) {
    return launch<__nv_bfloat16, __nv_bfloat16>(q, corpus, t, n, batch, dim,
                                                num_tiles, corpus_tile,
                                                true_num_items, st);
  }
  if (q_kind == 1 && corpus_kind == 2) {
    return launch<float, float>(q, corpus, t, n, batch, dim, num_tiles,
                                corpus_tile, true_num_items, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
