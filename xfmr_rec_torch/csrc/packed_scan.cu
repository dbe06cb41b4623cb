// Packed-key lane scan for Hopper (sm_90a).
//
// Replaces: xfmr_rec_tpu/ops/topk_pallas.py `_packed_scan2_kernel`
// (launched by `packed_lane_scan`). Plain PyTorch version beside it:
// xfmr_rec_torch/ops/topk.py `packed_lane_scan_plain`.
//
// What it computes. The slot contest of packed_sweep.cuh (keys from f32
// dots, top-2 per (row, lane) over all corpus tiles), written out as
// (B, 2*ct) keys; with track_discards the row also keeps the largest key
// its lanes evicted.
//
// What bounds it on this card. The dot is 2*B*N*D operations on f32 FMA
// units: this first version does not use the tensor cores, so it is
// bound by f32 FMA issue (67 TFLOP/s peak), far from the 989 TFLOP/s
// bf16 bound the same work has on tensor cores. Bytes are not the
// limit: the corpus is read once from device memory per wave of blocks
// and re-read from L2 by the blocks of the other row tiles.
//
// What the design does about it. The contest is elementwise per
// (row, lane) and does not depend on tile order, so nothing is
// sequential across blocks: a block owns a 64-row x 128-lane slice of
// the key buffers in registers (8 rows x 4 lanes per thread) and loops
// over every corpus tile, staging the 128 corpus rows it needs in shared
// memory (row-major, odd stride, so the strided lane reads hit distinct
// banks) and its queries transposed (so the 8 rows of a thread load as
// two broadcast float4). Each staged value feeds 8 (corpus) or 4 (query)
// FMAs from registers. Blocks of one lane chunk differ only in their
// rows and are numbered next to each other, so they sweep the same
// corpus rows at about the same time and share them through L2. The
// discard-max reduces per row inside the thread, then across the warp
// with shuffles, then across lane-chunk blocks with one atomicMax per
// row (keys are non-negative int32, so integer max is key order).

#include "packed_sweep.cuh"

namespace {

using namespace xfmr;

template <typename QT, typename CT>
__global__ void __launch_bounds__(kThreads, 1) packed_scan_kernel(
    const QT* __restrict__ queries, const CT* __restrict__ corpus,
    const float* __restrict__ scales, int* __restrict__ keys,
    int* __restrict__ dmax, PackedSweepArgs a, int track_discards) {
  extern __shared__ float smem[];
  const int tx = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;
  const int row0 = blockIdx.x * kPackedBlockRows;
  const int lane0 = blockIdx.y * kBlockLanes;

  int best1[kPackedRows][kLanesPerThread];
  int best2[kPackedRows][kLanesPerThread];
  int disc[kPackedRows];
  packed_sweep<QT, CT>(smem, queries, corpus, scales, a, row0, lane0, best1,
                       best2, disc);

  const size_t key_stride = 2 * static_cast<size_t>(a.corpus_tile);
#pragma unroll
  for (int i = 0; i < kPackedRows; ++i) {
    const int row = row0 + ty * kPackedRows + i;
#pragma unroll
    for (int j = 0; j < kLanesPerThread; ++j) {
      const int lane = lane0 + tx + 32 * j;
      if (row < a.batch && lane < a.corpus_tile) {
        keys[row * key_stride + lane] = best1[i][j];
        keys[row * key_stride + a.corpus_tile + lane] = best2[i][j];
      }
    }
  }
  if (track_discards) {
#pragma unroll
    for (int i = 0; i < kPackedRows; ++i) {
      const int v = __reduce_max_sync(0xffffffffu, disc[i]);
      const int row = row0 + ty * kPackedRows + i;
      if (tx == 0 && row < a.batch) atomicMax(&dmax[row], v);
    }
  }
}

template <typename QT, typename CT>
int launch(const void* q, const void* c, const float* scales, int* keys,
           int* dmax, const PackedSweepArgs& a, int track_discards,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * sweep_smem_floats<kPackedRows>(a.dim);
  cudaError_t err = allow_smem(packed_scan_kernel<QT, CT>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.batch + kPackedBlockRows - 1) / kPackedBlockRows,
                  (a.corpus_tile + kBlockLanes - 1) / kBlockLanes);
  packed_scan_kernel<QT, CT><<<grid, kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const CT*>(c), scales, keys,
      dmax, a, track_discards);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q_kind: 0 bf16, 1 f32. corpus_kind: 0 bf16, 1 int8, 2 f32.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int xfmr_packed_scan(const void* q, const void* corpus,
                                const void* scales, void* keys, void* dmax,
                                int batch, int dim, int num_tiles,
                                int corpus_tile, int true_num_items,
                                int lane_shuffle, int low_mask,
                                int reserve_bits, int add_bias,
                                int track_discards, int q_kind,
                                int corpus_kind, void* stream) {
  if (batch <= 0 || num_tiles <= 0) return 0;
  const PackedSweepArgs a = {batch,          dim,          num_tiles,
                             corpus_tile,    true_num_items, lane_shuffle,
                             low_mask,       reserve_bits, add_bias};
  const float* s = static_cast<const float*>(scales);
  int* k = static_cast<int*>(keys);
  int* m = static_cast<int*>(dmax);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_kind == 0 && corpus_kind == 0) {
    return launch<__nv_bfloat16, __nv_bfloat16>(q, corpus, s, k, m, a,
                                                track_discards, st);
  }
  if (q_kind == 0 && corpus_kind == 1) {
    return launch<__nv_bfloat16, int8_t>(q, corpus, s, k, m, a,
                                         track_discards, st);
  }
  if (q_kind == 1 && corpus_kind == 2) {
    return launch<float, float>(q, corpus, s, k, m, a, track_discards, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
