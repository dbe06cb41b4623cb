// f32 lane-max scan with positions, for Hopper (sm_90a).
//
// Replaces: xfmr_rec_tpu/ops/topk_pallas.py `_scan_kernel` (slots=1) and
// `_scan2_kernel` (slots=2), launched by `lane_max_scan`. Plain PyTorch
// version beside it: xfmr_rec_torch/ops/topk_f32.py
// `lane_max_scan_plain`.
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
// What bounds it on this card. Operations: about 9 f32/int32 lane
// operations per score for the contest (2 compares, 5 selects, the
// position, the discard max) on top of the dot, which this version does
// on f32 FMA units as packed_scan.cu does. Bytes (corpus once, 2*slots
// (B, ct) outputs) are far below that.
//
// What the design does about it. The sweep of scan_common.cuh: a block
// owns rows x 128 lanes and walks all tiles in order, so each (row,
// lane) sees its tiles in ascending order inside one thread and the
// strict-`>` tie rule needs no merge across blocks. The state per (row,
// lane) is two floats and two positions with slots=2, twice the packed
// kernel's, so a thread holds 4 rows x 4 lanes (a block: 32 rows), 64
// state registers, and the launch bounds ask for two blocks per SM (at
// most 128 registers a thread, no spills): the second block's dot hides
// the first one's staging barriers (left to itself the compiler took
// 131 registers, one block per SM, and ran markedly slower: the times
// are in PERF.md). The discard-max may be negative or -inf,
// where integer atomicMax on the bits does not order floats: it reduces
// in the thread, then across the warp, then across the lane-chunk
// blocks with atomicMax on the bits for a non-negative value and
// atomicMin on the unsigned bits for a negative one, which together
// order every float (the buffer starts at -inf).

#include <math_constants.h>

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

__device__ __forceinline__ void atomic_max_float(float* addr, float v) {
  if (__float_as_int(v) >= 0) {
    atomicMax(reinterpret_cast<int*>(addr), __float_as_int(v));
  } else {
    atomicMin(reinterpret_cast<unsigned int*>(addr), __float_as_uint(v));
  }
}

constexpr int kLaneRows = 4;  // rows per thread
constexpr int kLaneBlockRows = kWarps * kLaneRows;  // 32

template <typename QT, typename CT, int SLOTS>
__global__ void __launch_bounds__(kThreads, 2) lane_max_scan_kernel(
    const QT* __restrict__ queries, const CT* __restrict__ corpus,
    const float* __restrict__ scales, float* __restrict__ vals,
    int* __restrict__ pos, float* dmax, LaneScanArgs a) {
  constexpr int R = kLaneRows;
  extern __shared__ float smem[];
  const SweepSmem<R> sm(smem, a.dim);
  const int tx = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;
  const int row0 = blockIdx.x * kLaneBlockRows;
  const int lane0 = blockIdx.y * kBlockLanes;

  stage_queries<R>(sm, queries, row0, a.batch, a.dim);

  float val1[R][kLanesPerThread];
  int pos1[R][kLanesPerThread];
  float val2[SLOTS == 2 ? R : 1][kLanesPerThread];
  int pos2[SLOTS == 2 ? R : 1][kLanesPerThread];
  float disc[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    disc[i] = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < kLanesPerThread; ++j) {
      val1[i][j] = -CUDART_INF_F;
      pos1[i][j] = 0;
      if constexpr (SLOTS == 2) {
        val2[i][j] = -CUDART_INF_F;
        pos2[i][j] = 0;
      }
    }
  }

  for (int t = 0; t < a.num_tiles; ++t) {
    const int shift = tile_shift(t, a.lane_shuffle, a.corpus_tile);
    const size_t tile_base = static_cast<size_t>(t) * a.corpus_tile;
    __syncthreads();  // previous tile fully consumed (and q_s written)
    stage_tile<R>(sm, corpus, scales, tile_base, lane0, shift, a.corpus_tile,
                  a.dim);
    __syncthreads();

    float acc[R][kLanesPerThread];
    tile_dot<R>(sm, a.dim, acc);

#pragma unroll
    for (int j = 0; j < kLanesPerThread; ++j) {
      const int ll = tx + 32 * j;
      const int lane = lane0 + ll;
      const long long item = static_cast<long long>(tile_base) +
                             lane_column(lane, shift, a.corpus_tile);
      const bool live = lane < a.corpus_tile &&
                        (a.true_num_items < 0 || item < a.true_num_items);
      const int position = static_cast<int>(item);
      const float scale = scales != nullptr ? sm.scale_s[ll] : 1.f;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        float s = acc[i][j];
        // a separate rounded multiply, never contracted into the dot's
        // last FMA: the reference scales the finished f32 score
        if (scales != nullptr) s = __fmul_rn(s, scale);
        s = live ? s : -CUDART_INF_F;
        const float b1 = val1[i][j];
        const int p1 = pos1[i][j];
        const bool beats1 = s > b1;
        // value and position displaced into the next contest
        const float contender = beats1 ? b1 : s;
        const int contender_pos = beats1 ? p1 : position;
        val1[i][j] = beats1 ? s : b1;
        pos1[i][j] = beats1 ? position : p1;
        if constexpr (SLOTS == 2) {
          const float b2 = val2[i][j];
          const bool beats2 = contender > b2;
          disc[i] = fmaxf(disc[i], beats2 ? b2 : contender);
          val2[i][j] = beats2 ? contender : b2;
          pos2[i][j] = beats2 ? contender_pos : pos2[i][j];
        } else {
          disc[i] = fmaxf(disc[i], contender);
        }
      }
    }
  }

  const size_t out_stride = static_cast<size_t>(SLOTS) * a.corpus_tile;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = row0 + ty * R + i;
#pragma unroll
    for (int j = 0; j < kLanesPerThread; ++j) {
      const int lane = lane0 + tx + 32 * j;
      if (row < a.batch && lane < a.corpus_tile) {
        vals[row * out_stride + lane] = val1[i][j];
        pos[row * out_stride + lane] = pos1[i][j];
        if constexpr (SLOTS == 2) {
          vals[row * out_stride + a.corpus_tile + lane] = val2[i][j];
          pos[row * out_stride + a.corpus_tile + lane] = pos2[i][j];
        }
      }
    }
  }
  if (a.track_discards) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      float v = disc[i];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
      }
      const int row = row0 + ty * R + i;
      if (tx == 0 && row < a.batch) atomic_max_float(&dmax[row], v);
    }
  }
}

template <typename QT, typename CT, int SLOTS>
int launch_slots(const void* q, const void* c, const float* scales,
                 float* vals, int* pos, float* dmax, const LaneScanArgs& a,
                 cudaStream_t stream) {
  const size_t smem = sizeof(float) * sweep_smem_floats<kLaneRows>(a.dim);
  cudaError_t err = allow_smem(lane_max_scan_kernel<QT, CT, SLOTS>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.batch + kLaneBlockRows - 1) / kLaneBlockRows,
                  (a.corpus_tile + kBlockLanes - 1) / kBlockLanes);
  lane_max_scan_kernel<QT, CT, SLOTS><<<grid, kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const CT*>(c), scales, vals, pos,
      dmax, a);
  return static_cast<int>(cudaGetLastError());
}

template <typename QT, typename CT>
int launch(int slots, const void* q, const void* c, const float* scales,
           float* vals, int* pos, float* dmax, const LaneScanArgs& a,
           cudaStream_t stream) {
  if (slots == 1) {
    return launch_slots<QT, CT, 1>(q, c, scales, vals, pos, dmax, a, stream);
  }
  return launch_slots<QT, CT, 2>(q, c, scales, vals, pos, dmax, a, stream);
}

}  // namespace

// q_kind: 0 bf16, 1 f32. corpus_kind: 0 bf16, 1 int8, 2 f32. `dmax` must
// hold -inf in every row when track_discards is set; it is not touched
// otherwise. Returns cudaGetLastError() after the launch (0 on success).
extern "C" int xfmr_lane_max_scan(const void* q, const void* corpus,
                                  const void* scales, void* vals, void* pos,
                                  void* dmax, int batch, int dim,
                                  int num_tiles, int corpus_tile, int slots,
                                  int true_num_items, int lane_shuffle,
                                  int track_discards, int q_kind,
                                  int corpus_kind, void* stream) {
  if (batch <= 0 || num_tiles <= 0) return 0;
  if (slots != 1 && slots != 2) return static_cast<int>(cudaErrorInvalidValue);
  const LaneScanArgs a = {batch,          dim,          num_tiles,
                          corpus_tile,    true_num_items, lane_shuffle,
                          track_discards};
  const float* s = static_cast<const float*>(scales);
  float* v = static_cast<float*>(vals);
  int* p = static_cast<int*>(pos);
  float* m = static_cast<float*>(dmax);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_kind == 0 && corpus_kind == 0) {
    return launch<__nv_bfloat16, __nv_bfloat16>(slots, q, corpus, s, v, p, m,
                                                a, st);
  }
  if (q_kind == 0 && corpus_kind == 1) {
    return launch<__nv_bfloat16, int8_t>(slots, q, corpus, s, v, p, m, a, st);
  }
  if (q_kind == 1 && corpus_kind == 2) {
    return launch<float, float>(slots, q, corpus, s, v, p, m, a, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
