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
// What bounds it on this card. The key and the contest, about seven
// integer operations per score on the CUDA cores; the bf16 dot is well
// under that on the tensor cores (2*B*N*D operations at 989 TFLOP/s).
// Bytes are not the limit: the corpus is read once from device memory
// per wave of blocks and re-read from L2 by the blocks of the other row
// tiles. A small batch is bound by how many SMs its blocks reach.
//
// What the design does about it. The dot runs on the tensor cores
// (`MmaSweep`, packed_sweep.cuh: wgmma behind an asynchronously filled
// ring of corpus tiles, the contest on the accumulator registers); the
// f32 x f32 instantiation keeps the f32 `fmaf` sweep (`FmaSweep`). The
// contest is elementwise per (row, lane) and does not depend on tile
// order, so nothing is sequential across blocks: a block owns 64 rows x
// kLanes lanes of the key buffers in registers and walks a contiguous
// range of corpus tiles. Blocks of one lane chunk differ only in their
// rows and are numbered next to each other, so they sweep the same
// corpus rows at about the same time and share them through L2.
//
// When row tiles x lane chunks would leave SMs idle, the wrapper splits
// the tiles over gridDim.z blocks. Each block then parks its slots in a
// workspace and counts itself in on its (row tile, lane chunk); the
// block that arrives last merges the partial top-2s (a key carries its
// tile, so the union's top-2 is the top-2 of the partial slots) and
// writes the keys. No block waits on another. The discard-max reduces
// per row inside the thread, across the threads that share the row, then
// across blocks with one atomicMax per row; the merge adds what it
// drops. Keys are non-negative int32 and every step is an integer max or
// min, so the result is the same whatever order blocks finish in.

#include <stdint.h>

#include "packed_sweep.cuh"

namespace {

using namespace xfmr;

template <typename Sweep>
__global__ void __launch_bounds__(Sweep::kThreads, Sweep::kMinBlocks)
    packed_scan_kernel(const typename Sweep::Query* __restrict__ queries,
                       const typename Sweep::Corpus* __restrict__ corpus,
                       const float* __restrict__ scales, int* keys, int* dmax,
                       int* work, int* arrivals, PackedSweepArgs a,
                       int track_discards) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int is_last;
  const int row0 = blockIdx.x * Sweep::kRows;
  const int lane0 = blockIdx.y * Sweep::kLanes;
  const int splits = gridDim.z;
  const int ct = a.corpus_tile;
  const size_t key_stride = 2 * static_cast<size_t>(ct);

  {
    int tile_begin, tile_end;
    split_range(a.num_tiles, blockIdx.z, splits, tile_begin, tile_end);
    typename Sweep::Slots slots;
    Sweep::run(smem, queries, corpus, scales, a, row0, lane0, tile_begin,
               tile_end, slots);
    int* dst = splits == 1 ? keys
                           : work + static_cast<size_t>(blockIdx.z) *
                                        a.batch * key_stride;
    Sweep::each_slot(slots, [&](int r, int l, int best1, int best2) {
      const int row = row0 + r;
      const int lane = lane0 + l;
      if (row < a.batch && lane < ct) {
        dst[row * key_stride + lane] = best1;
        dst[row * key_stride + ct + lane] = best2;
      }
    });
    if (track_discards) {
      Sweep::each_row_discard(slots, [&](int r, int v) {
        if (row0 + r < a.batch) atomicMax(&dmax[row0 + r], v);
      });
    }
  }
  if (splits == 1) return;
  if (!arrives_last(&arrivals[blockIdx.y * gridDim.x + blockIdx.x], splits,
                    &is_last)) {
    return;
  }

  // every split of this (row tile, lane chunk) is parked: merge them
  merge_patch<Sweep>(work, splits, a, row0, lane0, keys,
                     track_discards ? dmax : nullptr);
}

template <typename Sweep>
int launch(const void* q, const void* c, const float* scales, int* keys,
           int* dmax, int* work, int* arrivals, const PackedSweepArgs& a,
           int track_discards, int splits, cudaStream_t stream) {
  const size_t smem = Sweep::smem_bytes(a.dim);
  cudaError_t err = allow_smem(packed_scan_kernel<Sweep>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.batch + Sweep::kRows - 1) / Sweep::kRows,
                  (a.corpus_tile + Sweep::kLanes - 1) / Sweep::kLanes, splits);
  packed_scan_kernel<Sweep><<<grid, Sweep::kThreads, smem, stream>>>(
      static_cast<const typename Sweep::Query*>(q),
      static_cast<const typename Sweep::Corpus*>(c), scales, keys, dmax, work,
      arrivals, a, track_discards);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The block shape of the launch that these operands get (rows, lanes,
// blocks an SM: see `sweep_shape`), by which the wrapper plans the
// splits; `aligned`: the corpus pointer is a multiple of 16 bytes.
// Returns a CUDA error code (0 on success).
extern "C" int xfmr_packed_scan_shape(int aligned, int dim, int q_kind,
                                      int corpus_kind, int* shape) {
  return with_sweep(q_kind, corpus_kind, aligned != 0, dim, [&](auto sweep) {
    using Sweep = decltype(sweep);
    return sweep_shape<Sweep>(packed_scan_kernel<Sweep>,
                              Sweep::smem_bytes(dim), shape);
  });
}

// q_kind: 0 bf16, 1 f32. corpus_kind: 0 bf16, 1 int8, 2 f32. With
// splits > 1, `work` holds splits x (batch, 2*corpus_tile) int32 and
// `arrivals` one zeroed int per (row tile, lane chunk); `dmax` (batch)
// must hold 0. Returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int xfmr_packed_scan(const void* q, const void* corpus,
                                const void* scales, void* keys, void* dmax,
                                void* work, void* arrivals, int batch, int dim,
                                int num_tiles, int corpus_tile,
                                int true_num_items, int lane_shuffle,
                                int low_mask, int reserve_bits, int add_bias,
                                int track_discards, int splits, int q_kind,
                                int corpus_kind, void* stream) {
  if (batch <= 0 || num_tiles <= 0) return 0;
  if (splits < 1 || splits > num_tiles) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const PackedSweepArgs a = {batch,          dim,          num_tiles,
                             corpus_tile,    true_num_items, lane_shuffle,
                             low_mask,       reserve_bits, add_bias};
  return with_sweep(q_kind, corpus_kind, aligned16(corpus), dim,
                    [&](auto sweep) {
    return launch<decltype(sweep)>(
        q, corpus, static_cast<const float*>(scales), static_cast<int*>(keys),
        static_cast<int*>(dmax), static_cast<int*>(work),
        static_cast<int*>(arrivals), a, track_discards, splits,
        static_cast<cudaStream_t>(stream));
  });
}
