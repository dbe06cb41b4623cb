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
// operations on the CUDA cores, the dot being on the tensor cores. The
// select adds four passes over a row's pool in shared memory (the row
// max, one histogram for each of two radix digits, the compaction), for
// a row tile's 64 rows in one block.
//
// What the design does about it. A row's merged pool (3*ct/2 keys, 12
// KiB at ct=2048) fits shared memory, but the slot buffers of a 64-row
// tile (1 MiB) do not, and a block that owned all ct lanes of a few
// rows would re-read the corpus from L2 many times as often. So the
// sweep keeps packed_scan.cu's shape (a block owns 64 rows x kLanes
// lanes and walks a contiguous range of tiles: all of them, or one of
// gridDim.z splits when the batch is small), each block parks its slots
// in a global workspace, and the blocks of a row tile count their
// arrivals on a per-row-tile counter (__threadfence, then atomicAdd):
// the block that arrives last finds every slot written, and runs merge
// and select for the tile's 64 rows: a warp per row, as many rows at a
// time as the block has warps and shared memory beside the sweep's four
// blocks an SM allows (a whole block per row spent its time at block
// barriers and left the tail longer than the fusing saves). With splits
// there are two such counts: the last of the splits
// of a (row tile, lane chunk) merges their partial slots as
// packed_scan.cu does (the union's top-2 per lane is the top-2 of the
// partial slots; what that drops joins the discard-max), all lane chunks
// in parallel, and only then counts in on the row tile. No block ever
// waits on another, so any schedule completes, and every step is an
// integer max or min, so the result does not depend on the schedule.
// The workspace is written once and read once (mostly L2 hits).

#include <stdint.h>

#include "packed_sweep.cuh"
#include "select_common.cuh"

namespace {

using namespace xfmr;

// shared memory the tail may take without costing the sweep a block an SM
constexpr size_t kTailBudget = 55 * 1024;

struct FusedSelectArgs {
  int k;
  int capacity;
  int quantum_bits;
  int merge_levels;  // after clamping
  int keep3;         // one keep-3 round instead of keep-2 rounds
  int pool_width;
  int pool_ints;   // a warp's merge space (see select_args)
  int tail_warps;  // rows the tail selects at a time, one warp each
};

template <typename Sweep>
__global__ void __launch_bounds__(Sweep::kThreads, Sweep::kMinBlocks)
    packed_scan_select_kernel(
        const typename Sweep::Query* __restrict__ queries,
        const typename Sweep::Corpus* __restrict__ corpus,
        const float* __restrict__ scales, int* work, int* arrivals,
        int* __restrict__ out_keys, int* __restrict__ out_meta, int* dmax,
        PackedSweepArgs a, FusedSelectArgs s) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int is_last;
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * Sweep::kRows;
  const int lane0 = blockIdx.y * Sweep::kLanes;
  const int splits = gridDim.z;
  const int ct = a.corpus_tile;

  {
    int tile_begin, tile_end;
    split_range(a.num_tiles, blockIdx.z, splits, tile_begin, tile_end);
    typename Sweep::Slots slots;
    Sweep::run(smem, queries, corpus, scales, a, row0, lane0, tile_begin,
               tile_end, slots);
    const size_t work_stride = 2 * static_cast<size_t>(ct);
    int* dst = work + static_cast<size_t>(blockIdx.z) * a.batch * work_stride;
    Sweep::each_slot(slots, [&](int r, int l, int best1, int best2) {
      const int row = row0 + r;
      const int lane = lane0 + l;
      if (row < a.batch && lane < ct) {
        dst[row * work_stride + lane] = best1;
        dst[row * work_stride + ct + lane] = best2;
      }
    });
    Sweep::each_row_discard(slots, [&](int r, int v) {
      if (row0 + r < a.batch) atomicMax(&dmax[row0 + r], v);
    });
  }

  // arrivals: a block's slots and discards are visible device-wide
  // before its ticket is; the barriers inside also tell that every
  // thread is done with the sweep's shared memory. First among the
  // splits of this (row tile, lane chunk), whose last block merges them
  // into the first split's buffer; then among the lane chunks of the row
  // tile, whose last block runs the tail.
  if (splits > 1) {
    int* patch = arrivals + gridDim.x + blockIdx.y * gridDim.x + blockIdx.x;
    if (!arrives_last(patch, splits, &is_last)) return;
    merge_patch<Sweep>(work, splits, a, row0, lane0, work, dmax);
  }
  if (!arrives_last(&arrivals[blockIdx.x], gridDim.y, &is_last)) return;

  // The tail: a warp per row, `tail_warps` rows at a time, each warp in
  // a region of its own ([pool | histogram], the pool in whole steps of
  // 128 keys, select_common.cuh) with warp barriers only.
  // A row's slots are read from the workspace past L1 (other blocks
  // wrote them during this launch) straight into the first merge.
  const int warp = tid >> 5;
  const int lane = tid & 31;
  if (warp >= s.tail_warps) return;
  int* pool = reinterpret_cast<int*>(smem) +
              static_cast<size_t>(warp) * (s.pool_ints + kHistInts);
  int* hist = pool + s.pool_ints;  // [kHistInts]
  const int rows = min(Sweep::kRows, a.batch - row0);
  const int half = ct >> 1;
  for (int r = warp; r < rows; r += s.tail_warps) {
    const size_t row = static_cast<size_t>(row0 + r);
    const int* slot1 = work + row * 2 * ct;
    const int* slot2 = slot1 + ct;
    __syncwarp();  // the previous row's select is done with the region

    int merged_out = 0;  // largest key this thread's pairs discarded
    if (s.keep3) {
#pragma unroll 4
      for (int j = lane; j < half; j += 32) {
        const int a1 = __ldcg(slot1 + j), a2 = __ldcg(slot2 + j);
        const int b1 = __ldcg(slot1 + j + half) | 1;
        const int b2 = __ldcg(slot2 + j + half) | 1;
        const int lo1 = min(a1, b1);
        const int hi2 = max(a2, b2);
        pool[j] = max(a1, b1);
        pool[half + j] = max(lo1, hi2);
        pool[2 * half + j] = min(lo1, hi2);
        merged_out = max(merged_out, min(a2, b2));
      }
    } else if (s.merge_levels == 0) {
#pragma unroll 4
      for (int i = lane; i < ct; i += 32) {
        pool[i] = __ldcg(slot1 + i);
        pool[ct + i] = __ldcg(slot2 + i);
      }
    } else {
      // keep-2: level 0 from the workspace into two arrays of ct/2, the
      // further levels in place (lane j reads and writes columns j and
      // j + w of both arrays only), then the second array moves up
      int* top1 = pool;
      int* top2 = pool + half;
      int width = ct;
      for (int level = 0; level < s.merge_levels; ++level) {
        const int w = width >> 1;
        const int bit = 1 << level;
        for (int j = lane; j < w; j += 32) {
          int a1, a2, b1, b2;
          if (level == 0) {
            a1 = __ldcg(slot1 + j), a2 = __ldcg(slot2 + j);
            b1 = __ldcg(slot1 + j + w), b2 = __ldcg(slot2 + j + w);
          } else {
            a1 = top1[j], a2 = top2[j];
            b1 = top1[j + w], b2 = top2[j + w];
          }
          b1 |= bit;
          b2 |= bit;
          const bool awins = a1 >= b1;
          top1[j] = awins ? a1 : b1;
          top2[j] = awins ? max(a2, b1) : max(b2, a1);
          const int out = max(awins ? min(a2, b1) : min(b2, a1),
                              awins ? b2 : a2);
          merged_out = max(merged_out, out);
        }
        __syncwarp();
        width = w;
      }
      if (width < half) {
        // [width, 2 * width) lies below top2 and holds dead columns
        for (int j = lane; j < width; j += 32) pool[width + j] = top2[j];
      }
    }
    __syncwarp();
    merged_out = __reduce_max_sync(0xffffffffu, merged_out);
    if (lane == 0) atomicMax(&dmax[row], merged_out);

    select_row(RowView{pool, s.pool_width}, s.k, s.capacity,
               s.quantum_bits, /*shared_exponent=*/1, hist,
               out_keys + row * s.capacity, out_meta + row * s.capacity);
  }
}

// Shared memory of the tail for `warps` rows at a time.
inline size_t tail_bytes(const FusedSelectArgs& s, int warps) {
  return sizeof(int) * warps *
         (static_cast<size_t>(s.pool_ints) + static_cast<size_t>(kHistInts));
}

// The select's arguments as the kernel takes them. The tail selects as
// many rows at a time as fit beside four blocks an SM, one at least.
template <typename Sweep>
FusedSelectArgs select_args(int corpus_tile, int k, int capacity,
                            int quantum_bits, int merge_levels, int keep3,
                            int pool_width) {
  // keep-2 merges run in two arrays of ct/2 before the pool is formed;
  // the select reads whole steps of 128 keys
  const int pool_ints =
      max(!keep3 && merge_levels > 0 ? corpus_tile : pool_width,
          kQuadKeys * row_steps(pool_width));
  FusedSelectArgs s = {k,     capacity,   quantum_bits, merge_levels,
                       keep3, pool_width, pool_ints,    /*tail_warps=*/0};
  const int fit = static_cast<int>(kTailBudget / tail_bytes(s, 1));
  s.tail_warps = max(1, min(Sweep::kThreads / 32, fit));
  return s;
}

// Dynamic shared memory of a block: the sweep's, then reused by the tail.
template <typename Sweep>
size_t block_smem(int dim, const FusedSelectArgs& s) {
  const size_t sweep = Sweep::smem_bytes(dim);
  const size_t tail = tail_bytes(s, s.tail_warps);
  return sweep > tail ? sweep : tail;
}

template <typename Sweep>
int launch(const void* q, const void* c, const float* scales, int* work,
           int* arrivals, int* keys, int* meta, int* dmax,
           const PackedSweepArgs& a, const FusedSelectArgs& s, int splits,
           cudaStream_t stream) {
  const size_t smem = block_smem<Sweep>(a.dim, s);
  cudaError_t err = allow_smem(packed_scan_select_kernel<Sweep>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.batch + Sweep::kRows - 1) / Sweep::kRows,
                  (a.corpus_tile + Sweep::kLanes - 1) / Sweep::kLanes, splits);
  packed_scan_select_kernel<Sweep><<<grid, Sweep::kThreads, smem, stream>>>(
      static_cast<const typename Sweep::Query*>(q),
      static_cast<const typename Sweep::Corpus*>(c), scales, work, arrivals,
      keys, meta, dmax, a, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The block shape of the launch that these operands get (rows, lanes,
// blocks an SM: see `sweep_shape`), by which the wrapper plans the
// splits; `aligned`: the corpus pointer is a multiple of 16 bytes.
// Returns a CUDA error code (0 on success).
extern "C" int xfmr_packed_scan_select_shape(int aligned, int dim,
                                             int corpus_tile, int capacity,
                                             int merge_levels, int keep3,
                                             int pool_width, int q_kind,
                                             int corpus_kind, int* shape) {
  return with_sweep(q_kind, corpus_kind, aligned != 0, dim, [&](auto sweep) {
    using Sweep = decltype(sweep);
    const FusedSelectArgs s =
        select_args<Sweep>(corpus_tile, /*k=*/1, capacity, /*quantum_bits=*/0,
                           merge_levels, keep3, pool_width);
    return sweep_shape<Sweep>(packed_scan_select_kernel<Sweep>,
                              block_smem<Sweep>(dim, s), shape);
  });
}

// q_kind: 0 bf16, 1 f32. corpus_kind: 0 bf16, 1 int8, 2 f32. `work` is a
// splits x (batch, 2*corpus_tile) int32 scratch; `arrivals` (one int per
// 64-row tile, then with splits > 1 one per (row tile, lane chunk)) and
// `dmax` (batch) must hold 0. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int xfmr_packed_scan_select(
    const void* q, const void* corpus, const void* scales, void* work,
    void* arrivals, void* keys, void* meta, void* dmax, int batch, int dim,
    int num_tiles, int corpus_tile, int true_num_items, int lane_shuffle,
    int low_mask, int reserve_bits, int add_bias, int k, int capacity,
    int quantum_bits, int merge_levels, int keep3, int pool_width,
    int splits, int q_kind, int corpus_kind, void* stream) {
  if (batch <= 0 || num_tiles <= 0) return 0;
  if (splits < 1 || splits > num_tiles) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const PackedSweepArgs a = {batch,          dim,          num_tiles,
                             corpus_tile,    true_num_items, lane_shuffle,
                             low_mask,       reserve_bits, add_bias};
  return with_sweep(q_kind, corpus_kind, aligned16(corpus), dim,
                    [&](auto sweep) {
    using Sweep = decltype(sweep);
    return launch<Sweep>(
        q, corpus, static_cast<const float*>(scales), static_cast<int*>(work),
        static_cast<int*>(arrivals), static_cast<int*>(keys),
        static_cast<int*>(meta), static_cast<int*>(dmax), a,
        select_args<Sweep>(corpus_tile, k, capacity, quantum_bits,
                           merge_levels, keep3, pool_width),
        splits, static_cast<cudaStream_t>(stream));
  });
}
