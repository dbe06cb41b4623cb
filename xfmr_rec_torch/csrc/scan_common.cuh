// Corpus sweep shared by the scan kernels (packed_scan.cu,
// lane_max_scan.cu, count_at_least.cu, packed_scan_select.cu).
//
// A block of 256 threads owns 8*R query rows and 128 lanes of the corpus
// tile (R rows x 4 lanes per thread) and walks every corpus tile. Per
// tile it stages the 128 corpus rows its lanes read (row-major, odd
// stride, so the strided lane reads hit distinct banks) and, once, its
// queries transposed (so the R rows of a thread load as broadcast
// float4), both converted to f32, then `tile_dot` forms the R x 4 scores
// of each thread.
//
// One accumulation order for every kernel: a score is the f32 chain
// fmaf(q[d], c[d], acc) over d = 0 .. dim-1 from acc = 0, whatever R is.
// The count kernel compares scores against a threshold that the lane-max
// scan produced, so the two must round every score identically; they do
// because both call `tile_dot`.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace xfmr {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLanesPerThread = 4;
constexpr int kBlockLanes = 32 * kLanesPerThread;  // 128

__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(int8_t v) {
  return static_cast<float>(v);
}
__device__ __forceinline__ float to_f32(float v) { return v; }

// Shared memory of one block's sweep, in floats: queries [dim][8*R],
// corpus rows [128][dim | 1], scales [128].
template <int R>
inline size_t sweep_smem_floats(int dim) {
  return static_cast<size_t>(dim) * (kWarps * R) +
         static_cast<size_t>(kBlockLanes) * (dim | 1) + kBlockLanes;
}

template <int R>
struct SweepSmem {
  float* q_s;      // [dim][8*R]
  float* c_s;      // [128][stride]
  float* scale_s;  // [128]
  int stride;
  __device__ SweepSmem(float* base, int dim) {
    stride = dim | 1;  // odd: conflict-free lanes
    q_s = base;
    c_s = q_s + dim * (kWarps * R);
    scale_s = c_s + kBlockLanes * stride;
  }
};

// The tile column that lane `lane` reads when the tile is rolled by
// `shift` (np.roll semantics: lane l holds column (l - shift) mod ct).
__device__ __forceinline__ int lane_column(int lane, int shift,
                                           int corpus_tile) {
  const int col = lane - shift;
  return col < 0 ? col + corpus_tile : col;
}

__device__ __forceinline__ int tile_shift(int tile, int lane_shuffle,
                                          int corpus_tile) {
  return static_cast<int>(
      (static_cast<long long>(tile) * lane_shuffle) % corpus_tile);
}

template <int R, typename QT>
__device__ __forceinline__ void stage_queries(const SweepSmem<R>& sm,
                                              const QT* __restrict__ queries,
                                              int row0, int batch, int dim) {
  constexpr int kBlockRows = kWarps * R;
  for (int e = threadIdx.x; e < kBlockRows * dim; e += kThreads) {
    const int r = e / dim;
    const int d = e - r * dim;
    const int row = row0 + r;
    sm.q_s[d * kBlockRows + r] =
        row < batch ? to_f32(queries[(size_t)row * dim + d]) : 0.f;
  }
}

// Stage the corpus rows (and scales) that lanes lane0 .. lane0+127 read
// from the tile at `tile_base`. Lanes past the tile stage zeros. The
// caller puts a __syncthreads() before (the previous tile is consumed)
// and after (this one is visible).
template <int R, typename CT>
__device__ __forceinline__ void stage_tile(const SweepSmem<R>& sm,
                                           const CT* __restrict__ corpus,
                                           const float* __restrict__ scales,
                                           size_t tile_base, int lane0,
                                           int shift, int corpus_tile,
                                           int dim) {
  for (int e = threadIdx.x; e < kBlockLanes * dim; e += kThreads) {
    const int ll = e / dim;
    const int d = e - ll * dim;
    const int lane = lane0 + ll;
    float v = 0.f;
    if (lane < corpus_tile) {
      const int col = lane_column(lane, shift, corpus_tile);
      v = to_f32(corpus[(tile_base + col) * dim + d]);
    }
    sm.c_s[ll * sm.stride + d] = v;
  }
  if (scales != nullptr) {
    for (int ll = threadIdx.x; ll < kBlockLanes; ll += kThreads) {
      const int lane = lane0 + ll;
      float v = 0.f;
      if (lane < corpus_tile) {
        v = scales[tile_base + lane_column(lane, shift, corpus_tile)];
      }
      sm.scale_s[ll] = v;
    }
  }
}

// acc[i][j] = dot(query row ty*R + i, staged corpus row tx + 32*j), the
// f32 chain described at the top. R is a multiple of 4.
template <int R>
__device__ __forceinline__ void tile_dot(const SweepSmem<R>& sm, int dim,
                                         float (&acc)[R][kLanesPerThread]) {
  static_assert(R % 4 == 0, "rows per thread load as float4");
  constexpr int kBlockRows = kWarps * R;
  const int tx = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int j = 0; j < kLanesPerThread; ++j) acc[i][j] = 0.f;
  }
  for (int d = 0; d < dim; ++d) {
    float qv[R];
#pragma unroll
    for (int i = 0; i < R; i += 4) {
      const float4 q4 = *reinterpret_cast<const float4*>(
          &sm.q_s[d * kBlockRows + ty * R + i]);
      qv[i] = q4.x;
      qv[i + 1] = q4.y;
      qv[i + 2] = q4.z;
      qv[i + 3] = q4.w;
    }
    float cv[kLanesPerThread];
#pragma unroll
    for (int j = 0; j < kLanesPerThread; ++j) {
      cv[j] = sm.c_s[(tx + 32 * j) * sm.stride + d];
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
#pragma unroll
      for (int j = 0; j < kLanesPerThread; ++j) {
        acc[i][j] = fmaf(qv[i], cv[j], acc[i][j]);
      }
    }
  }
}

// Raise the kernel's dynamic shared memory limit to `bytes`.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace xfmr
