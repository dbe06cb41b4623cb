// What every scan kernel (packed_scan.cu, lane_max_scan.cu,
// count_at_least.cu, packed_scan_select.cu) shares: the lane shuffle,
// the split of the corpus tiles over blocks and the count of arrivals
// that merges them, the block-shape query the wrappers plan splits by,
// and the f32 `fmaf` sweep of the f32 x f32 instantiations.
//
// The fmaf sweep (`fma_sweep`). A block of 256 threads owns 8*R query
// rows and 128 lanes of the corpus tile (R rows x 4 lanes per thread)
// and walks a range of corpus tiles. Per tile it stages the 128 corpus
// rows its lanes read (row-major, odd stride, so the strided lane reads
// hit distinct banks) and, once, its queries transposed (so the R rows of
// a thread load as broadcast float4), both converted to f32, then
// `tile_dot` forms the R x 4 scores of each thread.
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

// Walks corpus tiles [tile_begin, tile_end) for the block's 8*R rows
// from row0 and 128 lanes from lane0: stages the queries once, then per
// tile the corpus rows, and calls contest(acc, t, shift, scale_s) with
// the thread's R x 4 scores of tile t. Ends without a barrier: threads
// may still be reading shared memory.
template <int R, typename QT, typename CT, typename Contest>
__device__ __forceinline__ void fma_sweep(
    float* smem, const QT* __restrict__ queries,
    const CT* __restrict__ corpus, const float* __restrict__ scales,
    int batch, int dim, int corpus_tile, int lane_shuffle, int row0,
    int lane0, int tile_begin, int tile_end, Contest&& contest) {
  const SweepSmem<R> sm(smem, dim);
  stage_queries<R>(sm, queries, row0, batch, dim);
  for (int t = tile_begin; t < tile_end; ++t) {
    const int shift = tile_shift(t, lane_shuffle, corpus_tile);
    const size_t tile_base = static_cast<size_t>(t) * corpus_tile;
    __syncthreads();  // previous tile fully consumed (and q_s written)
    stage_tile<R>(sm, corpus, scales, tile_base, lane0, shift, corpus_tile,
                  dim);
    __syncthreads();
    float acc[R][kLanesPerThread];
    tile_dot<R>(sm, dim, acc);
    contest(acc, t, shift, sm.scale_s);
  }
}

// The contiguous range of tiles that split `split` of `splits` sweeps.
__device__ __forceinline__ void split_range(int num_tiles, int split,
                                            int splits, int& tile_begin,
                                            int& tile_end) {
  tile_begin = static_cast<int>(static_cast<long long>(num_tiles) * split /
                                splits);
  tile_end = static_cast<int>(static_cast<long long>(num_tiles) *
                              (split + 1) / splits);
}

// Counts this block in on `counter` after making its global writes
// visible; true in the block that arrives last of `expected`, which then
// sees every other block's writes. `flag` is a shared int. No block waits.
__device__ __forceinline__ bool arrives_last(int* counter, int expected,
                                             int* flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) *flag = atomicAdd(counter, 1) == expected - 1;
  __syncthreads();
  if (!*flag) return false;
  __threadfence();
  return true;
}

// Float max by integer atomics, for any float including -inf and
// negatives: atomicMax on the bits orders the non-negative ones,
// atomicMin on the unsigned bits the negative ones, and together they
// order every float (the buffer starts at -inf).
__device__ __forceinline__ void atomic_max_float(float* addr, float v) {
  if (__float_as_int(v) >= 0) {
    atomicMax(reinterpret_cast<int*>(addr), __float_as_int(v));
  } else {
    atomicMin(reinterpret_cast<unsigned int*>(addr), __float_as_uint(v));
  }
}

// Raise the kernel's dynamic shared memory limit to `bytes`.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// The block shape of `kernel` run with `Sweep` and `smem` bytes of shared
// memory, for the wrapper's split plan: shape[0] rows and shape[1] lanes
// of a block, shape[2] blocks that one SM holds at a time (by registers,
// threads and shared memory, as the runtime counts them).
template <typename Sweep, typename Kernel>
int sweep_shape(Kernel kernel, size_t smem, int* shape) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  shape[0] = Sweep::kRows;
  shape[1] = Sweep::kLanes;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&shape[2], kernel,
                                                      Sweep::kThreads, smem);
  return static_cast<int>(err);
}

}  // namespace xfmr
