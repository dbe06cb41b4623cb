// Packed-key lane scan for Hopper (sm_90a).
//
// Replaces: xfmr_rec_tpu/ops/topk_pallas.py `_packed_scan2_kernel`
// (launched by `packed_lane_scan`). Plain PyTorch version beside it:
// xfmr_rec_torch/ops/topk.py `packed_lane_scan_plain`.
//
// What it computes. For every query row r and lane l of a corpus tile of
// width ct, tile t contributes the corpus row t*ct + ((l - shift) mod ct),
// shift = (t * lane_shuffle) mod ct (the TPU kernel's roll, done here as
// index arithmetic). Its score s (f32 dot of the bf16/f32 query with the
// bf16/int8/f32 corpus row, times the int8 scale) becomes the key
//   (bits(s + 1.5) & ~low_mask) | t << reserve_bits
// (the +1.5 already inside s when the corpus carries the bias column), 0
// for padded rows. Each (row, lane) keeps its top-2 keys; with
// track_discards the row also keeps the largest key its lanes evicted.
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerThread = 8;
constexpr int kLanesPerThread = 4;
constexpr int kWarps = kThreads / 32;
constexpr int kBlockRows = kWarps * kRowsPerThread;  // 64
constexpr int kBlockLanes = 32 * kLanesPerThread;    // 128

__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(int8_t v) {
  return static_cast<float>(v);
}
__device__ __forceinline__ float to_f32(float v) { return v; }

template <typename QT, typename CT>
__global__ void __launch_bounds__(kThreads, 1) packed_scan_kernel(
    const QT* __restrict__ queries, const CT* __restrict__ corpus,
    const float* __restrict__ scales, int* __restrict__ keys,
    int* __restrict__ dmax, int batch, int dim, int num_tiles,
    int corpus_tile, int true_num_items, int lane_shuffle, int low_mask,
    int reserve_bits, int add_bias, int track_discards) {
  extern __shared__ float smem[];
  const int stride = dim | 1;                 // odd: conflict-free lanes
  float* q_s = smem;                          // [dim][kBlockRows]
  float* c_s = q_s + dim * kBlockRows;        // [kBlockLanes][stride]
  float* scale_s = c_s + kBlockLanes * stride;  // [kBlockLanes]

  const int tid = threadIdx.x;
  const int tx = tid & 31;
  const int ty = tid >> 5;
  const int row0 = blockIdx.x * kBlockRows;
  const int lane0 = blockIdx.y * kBlockLanes;

  for (int e = tid; e < kBlockRows * dim; e += kThreads) {
    const int r = e / dim;
    const int d = e - r * dim;
    const int row = row0 + r;
    q_s[d * kBlockRows + r] =
        row < batch ? to_f32(queries[(size_t)row * dim + d]) : 0.f;
  }

  int best1[kRowsPerThread][kLanesPerThread];
  int best2[kRowsPerThread][kLanesPerThread];
  int disc[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    disc[i] = 0;
#pragma unroll
    for (int j = 0; j < kLanesPerThread; ++j) {
      best1[i][j] = 0;
      best2[i][j] = 0;
    }
  }

  for (int t = 0; t < num_tiles; ++t) {
    const int shift =
        static_cast<int>((static_cast<long long>(t) * lane_shuffle) %
                         corpus_tile);
    const size_t tile_base = static_cast<size_t>(t) * corpus_tile;
    __syncthreads();  // previous tile fully consumed (and q_s written)
    for (int e = tid; e < kBlockLanes * dim; e += kThreads) {
      const int ll = e / dim;
      const int d = e - ll * dim;
      const int lane = lane0 + ll;
      float v = 0.f;
      if (lane < corpus_tile) {
        int col = lane - shift;
        if (col < 0) col += corpus_tile;
        v = to_f32(corpus[(tile_base + col) * dim + d]);
      }
      c_s[ll * stride + d] = v;
    }
    if (scales != nullptr) {
      for (int ll = tid; ll < kBlockLanes; ll += kThreads) {
        const int lane = lane0 + ll;
        float v = 0.f;
        if (lane < corpus_tile) {
          int col = lane - shift;
          if (col < 0) col += corpus_tile;
          v = scales[tile_base + col];
        }
        scale_s[ll] = v;
      }
    }
    __syncthreads();

    float acc[kRowsPerThread][kLanesPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
#pragma unroll
      for (int j = 0; j < kLanesPerThread; ++j) acc[i][j] = 0.f;
    }
    for (int d = 0; d < dim; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(
          &q_s[d * kBlockRows + ty * kRowsPerThread]);
      const float4 qb = *reinterpret_cast<const float4*>(
          &q_s[d * kBlockRows + ty * kRowsPerThread + 4]);
      const float qv[kRowsPerThread] = {qa.x, qa.y, qa.z, qa.w,
                                        qb.x, qb.y, qb.z, qb.w};
      float cv[kLanesPerThread];
#pragma unroll
      for (int j = 0; j < kLanesPerThread; ++j) {
        cv[j] = c_s[(tx + 32 * j) * stride + d];
      }
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
#pragma unroll
        for (int j = 0; j < kLanesPerThread; ++j) {
          acc[i][j] = fmaf(qv[i], cv[j], acc[i][j]);
        }
      }
    }

    const int stamp = t << reserve_bits;
#pragma unroll
    for (int j = 0; j < kLanesPerThread; ++j) {
      const int ll = tx + 32 * j;
      const int lane = lane0 + ll;
      int col = lane - shift;
      if (col < 0) col += corpus_tile;
      const long long item = static_cast<long long>(tile_base) + col;
      const bool live = lane < corpus_tile &&
                        (true_num_items < 0 || item < true_num_items);
      const float scale = scales != nullptr ? scale_s[ll] : 1.f;
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        float s = acc[i][j];
        // separate roundings, never contracted into one FMA: the
        // reference multiplies by the scale, then adds the window bias
        if (scales != nullptr) s = __fmul_rn(s, scale);
        if (add_bias) s = __fadd_rn(s, 1.5f);
        int key = (__float_as_int(s) & ~low_mask) | stamp;
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

  const size_t key_stride = 2 * static_cast<size_t>(corpus_tile);
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int row = row0 + ty * kRowsPerThread + i;
#pragma unroll
    for (int j = 0; j < kLanesPerThread; ++j) {
      const int lane = lane0 + tx + 32 * j;
      if (row < batch && lane < corpus_tile) {
        keys[row * key_stride + lane] = best1[i][j];
        keys[row * key_stride + corpus_tile + lane] = best2[i][j];
      }
    }
  }
  if (track_discards) {
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      int v = disc[i];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        v = max(v, __shfl_xor_sync(0xffffffffu, v, off));
      }
      const int row = row0 + ty * kRowsPerThread + i;
      if (tx == 0 && row < batch) atomicMax(&dmax[row], v);
    }
  }
}

template <typename QT, typename CT>
int launch(const void* q, const void* c, const float* scales, int* keys,
           int* dmax, int batch, int dim, int num_tiles, int corpus_tile,
           int true_num_items, int lane_shuffle, int low_mask,
           int reserve_bits, int add_bias, int track_discards,
           cudaStream_t stream) {
  const int stride = dim | 1;
  const size_t smem =
      sizeof(float) *
      (static_cast<size_t>(dim) * kBlockRows + kBlockLanes * stride +
       kBlockLanes);
  cudaError_t err = cudaFuncSetAttribute(
      packed_scan_kernel<QT, CT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((batch + kBlockRows - 1) / kBlockRows,
                  (corpus_tile + kBlockLanes - 1) / kBlockLanes);
  packed_scan_kernel<QT, CT><<<grid, kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const CT*>(c), scales, keys,
      dmax, batch, dim, num_tiles, corpus_tile, true_num_items, lane_shuffle,
      low_mask, reserve_bits, add_bias, track_discards);
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
  const float* s = static_cast<const float*>(scales);
  int* k = static_cast<int*>(keys);
  int* m = static_cast<int*>(dmax);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_kind == 0 && corpus_kind == 0) {
    return launch<__nv_bfloat16, __nv_bfloat16>(
        q, corpus, s, k, m, batch, dim, num_tiles, corpus_tile,
        true_num_items, lane_shuffle, low_mask, reserve_bits, add_bias,
        track_discards, st);
  }
  if (q_kind == 0 && corpus_kind == 1) {
    return launch<__nv_bfloat16, int8_t>(
        q, corpus, s, k, m, batch, dim, num_tiles, corpus_tile,
        true_num_items, lane_shuffle, low_mask, reserve_bits, add_bias,
        track_discards, st);
  }
  if (q_kind == 1 && corpus_kind == 2) {
    return launch<float, float>(q, corpus, s, k, m, batch, dim, num_tiles,
                                corpus_tile, true_num_items, lane_shuffle,
                                low_mask, reserve_bits, add_bias,
                                track_discards, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
