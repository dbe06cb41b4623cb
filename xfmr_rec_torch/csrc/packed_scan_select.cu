// Packed-key scan with the lane-pair merge and the threshold select
// fused into one launch, for Hopper (sm_90a).
//
// Replaces: xfmr_rec_tpu/ops/topk_pallas.py `_packed_scan_select_kernel`,
// launched by `packed_lane_scan_select`. Plain PyTorch version beside it:
// xfmr_rec_torch/ops/topk.py `packed_lane_scan_select_plain`.
//
// What it computes. The slot contest of packed_sweep.cuh over the whole
// corpus; then per row the lane-pair merge of the (ct, ct) slot buffers
// (keep-2: `merge_levels` rounds pairing column j with j + w/2 and
// keeping the pair's top-2, upper-half survivors stamped with bit
// `level`; keep-3: one round keeping the pair's top-3), the merge's
// discards folded into the row's discard-max; then the threshold select
// of select_common.cuh over the merged pool. Only (B, capacity) keys and
// metas and a (B,) discard-max leave the kernel.
//
// What bounds it on this card. As packed_scan.cu: the contest's integer
// operations, and in this version the dot on f32 FMA units. The select
// adds (searched bits + 3) passes over a row's pool in shared memory.
//
// What the design does about it. A row's merged pool (3*ct/2 keys, 12
// KiB at ct=2048) fits shared memory, but the slot buffers of a 64-row
// tile (1 MiB) do not, and a block that owned all ct lanes of a few
// rows would re-read the corpus from L2 sixteen times as often. So the
// sweep keeps packed_scan.cu's shape (a block owns 64 rows x 128 lanes
// and walks every tile), each block parks its slots in a global
// workspace, and the blocks of a row tile count their arrivals on a
// per-row-tile counter (__threadfence, then atomicAdd): the block that
// arrives last finds every chunk's slots written, and runs merge and
// select for the tile's 64 rows, one row at a time with all 256
// threads. No block ever waits on another, so any schedule completes.
// The workspace is written once and read once (2 x B x 2*ct x 4 bytes,
// mostly L2 hits); the tail of 64 sequential selects per row tile runs
// on as many SMs as there are row tiles.

#include "packed_sweep.cuh"
#include "select_common.cuh"

namespace {

using namespace xfmr;

static_assert(kThreads == kSelectThreads, "one block runs sweep and select");

struct FusedSelectArgs {
  int k;
  int capacity;
  int quantum_bits;
  int merge_levels;  // after clamping
  int keep3;         // one keep-3 round instead of keep-2 rounds
  int pool_width;
};

template <typename QT, typename CT>
__global__ void __launch_bounds__(kThreads, 1) packed_scan_select_kernel(
    const QT* __restrict__ queries, const CT* __restrict__ corpus,
    const float* __restrict__ scales, int* work, int* arrivals,
    int* __restrict__ out_keys, int* __restrict__ out_meta, int* dmax,
    PackedSweepArgs a, FusedSelectArgs s) {
  extern __shared__ float smem[];
  __shared__ SelectScratch scratch;
  __shared__ int is_last;
  const int tid = threadIdx.x;
  const int tx = tid & 31;
  const int ty = tid >> 5;
  const int row0 = blockIdx.x * kPackedBlockRows;
  const int lane0 = blockIdx.y * kBlockLanes;
  const int ct = a.corpus_tile;

  {
    int best1[kPackedRows][kLanesPerThread];
    int best2[kPackedRows][kLanesPerThread];
    int disc[kPackedRows];
    packed_sweep<QT, CT>(smem, queries, corpus, scales, a, row0, lane0, best1,
                         best2, disc);
    const size_t work_stride = 2 * static_cast<size_t>(ct);
#pragma unroll
    for (int i = 0; i < kPackedRows; ++i) {
      const int row = row0 + ty * kPackedRows + i;
#pragma unroll
      for (int j = 0; j < kLanesPerThread; ++j) {
        const int lane = lane0 + tx + 32 * j;
        if (row < a.batch && lane < ct) {
          work[row * work_stride + lane] = best1[i][j];
          work[row * work_stride + ct + lane] = best2[i][j];
        }
      }
      const int v = __reduce_max_sync(0xffffffffu, disc[i]);
      if (tx == 0 && row < a.batch) atomicMax(&dmax[row], v);
    }
  }

  // arrival: this block's slots and discards are visible device-wide
  // before its ticket is
  __threadfence();
  __syncthreads();  // also: every thread is done with the sweep's smem
  if (tid == 0) {
    const int ticket = atomicAdd(&arrivals[blockIdx.x], 1);
    is_last = ticket == static_cast<int>(gridDim.y) - 1;
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();

  int* slot1 = reinterpret_cast<int*>(smem);  // [ct]
  int* slot2 = slot1 + ct;                    // [ct]
  int* pool = slot2 + ct;                     // [pool_width]
  int* keys_s = pool + s.pool_width;          // [capacity]
  int* meta_s = keys_s + s.capacity;          // [capacity]
  const int rows = min(kPackedBlockRows, a.batch - row0);
  for (int r = 0; r < rows; ++r) {
    const size_t row = static_cast<size_t>(row0 + r);
    const int* src = work + row * 2 * ct;
    __syncthreads();  // the previous row's select is done with smem
    for (int i = tid; i < ct; i += kThreads) {
      // written by other blocks during this launch: read past L1
      slot1[i] = __ldcg(src + i);
      slot2[i] = __ldcg(src + ct + i);
    }
    __syncthreads();

    int merged_out = 0;  // largest key this thread's pairs discarded
    if (s.keep3) {
      const int w = ct >> 1;
      for (int j = tid; j < w; j += kThreads) {
        const int a1 = slot1[j], a2 = slot2[j];
        const int b1 = slot1[j + w] | 1, b2 = slot2[j + w] | 1;
        const int lo1 = min(a1, b1);
        const int hi2 = max(a2, b2);
        pool[j] = max(a1, b1);
        pool[w + j] = max(lo1, hi2);
        pool[2 * w + j] = min(lo1, hi2);
        merged_out = max(merged_out, min(a2, b2));
      }
    } else {
      int width = ct;
      for (int level = 0; level < s.merge_levels; ++level) {
        const int w = width >> 1;
        const int bit = 1 << level;
        // thread j reads and writes columns j and j + w only: in place
        for (int j = tid; j < w; j += kThreads) {
          const int a1 = slot1[j], a2 = slot2[j];
          const int b1 = slot1[j + w] | bit, b2 = slot2[j + w] | bit;
          const bool awins = a1 >= b1;
          slot1[j] = awins ? a1 : b1;
          slot2[j] = awins ? max(a2, b1) : max(b2, a1);
          const int out = max(awins ? min(a2, b1) : min(b2, a1),
                              awins ? b2 : a2);
          merged_out = max(merged_out, out);
        }
        __syncthreads();
        width = w;
      }
      for (int j = tid; j < width; j += kThreads) {
        pool[j] = slot1[j];
        pool[width + j] = slot2[j];
      }
    }
    __syncthreads();
    const int row_out = block_max(merged_out, scratch.red);
    if (tid == 0) atomicMax(&dmax[row], row_out);

    int local_max = 0;
    for (int i = tid; i < s.pool_width; i += kThreads) {
      local_max = max(local_max, pool[i]);
    }
    select_row(pool, local_max, s.pool_width, s.k, s.capacity,
               s.quantum_bits, /*shared_exponent=*/1, keys_s, meta_s,
               &scratch, out_keys + row * s.capacity,
               out_meta + row * s.capacity);
  }
}

template <typename QT, typename CT>
int launch(const void* q, const void* c, const float* scales, int* work,
           int* arrivals, int* keys, int* meta, int* dmax,
           const PackedSweepArgs& a, const FusedSelectArgs& s,
           cudaStream_t stream) {
  const size_t sweep = sizeof(float) * sweep_smem_floats<kPackedRows>(a.dim);
  const size_t epilogue =
      sizeof(int) * (2 * static_cast<size_t>(a.corpus_tile) + s.pool_width +
                     2 * static_cast<size_t>(s.capacity));
  const size_t smem = sweep > epilogue ? sweep : epilogue;
  cudaError_t err = allow_smem(packed_scan_select_kernel<QT, CT>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.batch + kPackedBlockRows - 1) / kPackedBlockRows,
                  (a.corpus_tile + kBlockLanes - 1) / kBlockLanes);
  packed_scan_select_kernel<QT, CT><<<grid, kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const CT*>(c), scales, work,
      arrivals, keys, meta, dmax, a, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q_kind: 0 bf16, 1 f32. corpus_kind: 0 bf16, 1 int8, 2 f32. `work` is a
// (batch, 2*corpus_tile) int32 scratch; `arrivals` (one int per 64-row
// tile) and `dmax` (batch) must hold 0. Returns cudaGetLastError() after
// the launch (0 on success).
extern "C" int xfmr_packed_scan_select(
    const void* q, const void* corpus, const void* scales, void* work,
    void* arrivals, void* keys, void* meta, void* dmax, int batch, int dim,
    int num_tiles, int corpus_tile, int true_num_items, int lane_shuffle,
    int low_mask, int reserve_bits, int add_bias, int k, int capacity,
    int quantum_bits, int merge_levels, int keep3, int pool_width,
    int q_kind, int corpus_kind, void* stream) {
  if (batch <= 0 || num_tiles <= 0) return 0;
  const PackedSweepArgs a = {batch,          dim,          num_tiles,
                             corpus_tile,    true_num_items, lane_shuffle,
                             low_mask,       reserve_bits, add_bias};
  const FusedSelectArgs s = {k,     capacity,  quantum_bits, merge_levels,
                             keep3, pool_width};
  const float* sc = static_cast<const float*>(scales);
  int* w = static_cast<int*>(work);
  int* arr = static_cast<int*>(arrivals);
  int* ko = static_cast<int*>(keys);
  int* mo = static_cast<int*>(meta);
  int* dm = static_cast<int*>(dmax);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_kind == 0 && corpus_kind == 0) {
    return launch<__nv_bfloat16, __nv_bfloat16>(q, corpus, sc, w, arr, ko, mo,
                                                dm, a, s, st);
  }
  if (q_kind == 0 && corpus_kind == 1) {
    return launch<__nv_bfloat16, int8_t>(q, corpus, sc, w, arr, ko, mo, dm, a,
                                         s, st);
  }
  if (q_kind == 1 && corpus_kind == 2) {
    return launch<float, float>(q, corpus, sc, w, arr, ko, mo, dm, a, s, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
