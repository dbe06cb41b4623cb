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
// What bounds it on this card. A compare and an add per score on the
// CUDA cores, and the dot: 2*B*N*D operations, on the tensor cores for
// bf16. Bytes are the corpus once plus (B,) in and out.
//
// What the design does about it. tau's own item must compare >= tau, so
// every score has to round exactly as in lane_max_scan.cu. Both kernels
// take their scores from the same sweep with the same instructions: bf16
// from `mma_sweep` (mma_sweep.cuh) at the same 64-row tile, the same
// 64-lane chunk and the same k order, with lane shuffle 0 (the
// count's and the certified scan's), so a score lands in the same
// accumulator position in both; f32 from the fmaf chain of `tile_dot`
// (`fma_sweep`, scan_common.cuh). Counts add up in registers, then
// within the threads that share a row, then across blocks with one
// integer atomicAdd per row, which is exact in any order: so the corpus
// tiles split over blocks at small batches (as in packed_scan.cu) with
// no merge at all. The bf16 state is two counters and two thresholds a
// thread.

#include <math_constants.h>

#include "mma_sweep.cuh"
#include "scan_common.cuh"

namespace {

using namespace xfmr;

struct CountArgs {
  int batch;
  int dim;
  int num_tiles;
  int corpus_tile;
  int true_num_items;  // < 0: no padding to mask
};

template <bool kAsync>
struct CountMmaSweep {
  using Query = __nv_bfloat16;
  using Corpus = __nv_bfloat16;
  static constexpr int kThreads = kMmaThreads;
  static constexpr int kRows = kMmaRows;
  static constexpr int kLanes = kMmaLanes;
  static constexpr int kMinBlocks = 4;

  struct Hits {
    int n[2];  // by row half of the accumulator layout
  };

  static size_t smem_bytes(int dim) {
    return mma_smem_bytes<__nv_bfloat16, kAsync>(dim);
  }

  template <bool kMasked>
  static __device__ __forceinline__ void count(const float (&acc)[kMmaAcc],
                                               Hits& hits,
                                               const float (&tau)[2],
                                               const CountArgs& a, int t,
                                               int lane0) {
    const int q2 = (threadIdx.x & 3) * 2;
#pragma unroll
    for (int j = 0; j < kLanes / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        bool live = true;
        if (kMasked) {
          const int lane = lane0 + 8 * j + q2 + e;
          live = lane < a.corpus_tile &&
                 (a.true_num_items < 0 ||
                  static_cast<long long>(t) * a.corpus_tile + lane <
                      a.true_num_items);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          hits.n[h] += (live && acc[4 * j + 2 * h + e] >= tau[h]) ? 1 : 0;
        }
      }
    }
  }

  static __device__ __forceinline__ void run(
      unsigned char* smem, const __nv_bfloat16* __restrict__ queries,
      const __nv_bfloat16* __restrict__ corpus,
      const float* __restrict__ tau, const CountArgs& a, int row0,
      int lane0, int tile_begin, int tile_end, Hits& hits) {
    const int row = row0 + (threadIdx.x >> 5) * 16 + ((threadIdx.x & 31) >> 2);
    float row_tau[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      row_tau[h] = row + 8 * h < a.batch ? tau[row + 8 * h] : CUDART_INF_F;
      hits.n[h] = 0;
    }
    mma_sweep<__nv_bfloat16, kAsync>(
        smem, queries, corpus, nullptr, a.batch, a.dim, a.corpus_tile, 0,
        row0, lane0, tile_begin, tile_end,
        [&](const float (&acc)[kMmaAcc], int t, const float*) {
          const bool masked =
              lane0 + kLanes > a.corpus_tile ||
              (a.true_num_items >= 0 &&
               static_cast<long long>(t + 1) * a.corpus_tile >
                   a.true_num_items);
          if (masked) {
            count<true>(acc, hits, row_tau, a, t, lane0);
          } else {
            count<false>(acc, hits, row_tau, a, t, lane0);
          }
        });
  }

  // f(row in block, the block's count of that row), once per row.
  template <typename F>
  static __device__ __forceinline__ void each_row_count(const Hits& hits,
                                                        F&& f) {
    const int lane = threadIdx.x & 31;
    const int row = (threadIdx.x >> 5) * 16 + (lane >> 2);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // the four threads of a quad hold the same rows
      int v = hits.n[h];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      if ((lane & 3) == 0) f(row + 8 * h, v);
    }
  }
};

struct CountFmaSweep {
  using Query = float;
  using Corpus = float;
  static constexpr int R = 8;  // rows per thread
  static constexpr int kThreads = xfmr::kThreads;
  static constexpr int kRows = kWarps * R;
  static constexpr int kLanes = kBlockLanes;
  static constexpr int kMinBlocks = 1;

  struct Hits {
    int n[R];
  };

  static size_t smem_bytes(int dim) {
    return sizeof(float) * sweep_smem_floats<R>(dim);
  }

  static __device__ __forceinline__ void run(
      unsigned char* smem, const float* __restrict__ queries,
      const float* __restrict__ corpus, const float* __restrict__ tau,
      const CountArgs& a, int row0, int lane0, int tile_begin, int tile_end,
      Hits& hits) {
    const int tx = threadIdx.x & 31;
    const int ty = threadIdx.x >> 5;
    float row_tau[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int row = row0 + ty * R + i;
      row_tau[i] = row < a.batch ? tau[row] : CUDART_INF_F;
      hits.n[i] = 0;
    }
    fma_sweep<R>(
        reinterpret_cast<float*>(smem), queries, corpus,
        static_cast<const float*>(nullptr), a.batch, a.dim, a.corpus_tile, 0,
        row0, lane0, tile_begin, tile_end,
        [&](const float (&acc)[R][kLanesPerThread], int t, int,
            const float*) {
#pragma unroll
          for (int j = 0; j < kLanesPerThread; ++j) {
            const int lane = lane0 + tx + 32 * j;
            const long long item =
                static_cast<long long>(t) * a.corpus_tile + lane;
            const bool live = lane < a.corpus_tile &&
                              (a.true_num_items < 0 || item < a.true_num_items);
#pragma unroll
            for (int i = 0; i < R; ++i) {
              hits.n[i] += (live && acc[i][j] >= row_tau[i]) ? 1 : 0;
            }
          }
        });
  }

  template <typename F>
  static __device__ __forceinline__ void each_row_count(const Hits& hits,
                                                        F&& f) {
    const int ty = threadIdx.x >> 5;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int v = __reduce_add_sync(0xffffffffu, hits.n[i]);
      if ((threadIdx.x & 31) == 0) f(ty * R + i, v);
    }
  }
};

template <typename Sweep>
__global__ void __launch_bounds__(Sweep::kThreads, Sweep::kMinBlocks)
    count_at_least_kernel(const typename Sweep::Query* __restrict__ queries,
                          const typename Sweep::Corpus* __restrict__ corpus,
                          const float* __restrict__ tau, int* counts,
                          CountArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int row0 = blockIdx.x * Sweep::kRows;
  int tile_begin, tile_end;
  split_range(a.num_tiles, blockIdx.z, gridDim.z, tile_begin, tile_end);
  typename Sweep::Hits hits;
  Sweep::run(smem, queries, corpus, tau, a, row0, blockIdx.y * Sweep::kLanes,
             tile_begin, tile_end, hits);
  Sweep::each_row_count(hits, [&](int r, int n) {
    if (row0 + r < a.batch && n != 0) atomicAdd(&counts[row0 + r], n);
  });
}

// Calls `f` with an instance of the sweep that serves these operands
// (q_kind: 0 bf16, 1 f32; corpus_kind: 0 bf16, 2 f32: the reference takes
// no scales, so no int8), or returns cudaErrorInvalidValue.
template <typename F>
int with_count_sweep(int q_kind, int corpus_kind, bool aligned, int dim,
                     F&& f) {
  if (q_kind == 0 && corpus_kind == 0) {
    if (ring_async<__nv_bfloat16>(aligned, dim)) {
      return f(CountMmaSweep<true>{});
    }
    return f(CountMmaSweep<false>{});
  }
  if (q_kind == 1 && corpus_kind == 2) return f(CountFmaSweep{});
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename Sweep>
int launch(const void* q, const void* c, const float* tau, int* counts,
           const CountArgs& a, int splits, cudaStream_t stream) {
  const size_t smem = Sweep::smem_bytes(a.dim);
  cudaError_t err = allow_smem(count_at_least_kernel<Sweep>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.batch + Sweep::kRows - 1) / Sweep::kRows,
                  (a.corpus_tile + Sweep::kLanes - 1) / Sweep::kLanes, splits);
  count_at_least_kernel<Sweep><<<grid, Sweep::kThreads, smem, stream>>>(
      static_cast<const typename Sweep::Query*>(q),
      static_cast<const typename Sweep::Corpus*>(c), tau, counts, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The block shape of the launch that these operands get (rows, lanes,
// blocks an SM: see `sweep_shape`), by which the wrapper plans the
// splits. Returns a CUDA error code (0 on success).
extern "C" int xfmr_count_at_least_shape(int aligned, int dim, int q_kind,
                                         int corpus_kind, int* shape) {
  return with_count_sweep(q_kind, corpus_kind, aligned != 0, dim,
                          [&](auto sweep) {
    using Sweep = decltype(sweep);
    return sweep_shape<Sweep>(count_at_least_kernel<Sweep>,
                              Sweep::smem_bytes(dim), shape);
  });
}

// q_kind: 0 bf16, 1 f32. corpus_kind: 0 bf16, 2 f32. `counts` must hold
// 0 in every row. Returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int xfmr_count_at_least(const void* q, const void* corpus,
                                   const void* tau, void* counts, int batch,
                                   int dim, int num_tiles, int corpus_tile,
                                   int true_num_items, int splits, int q_kind,
                                   int corpus_kind, void* stream) {
  if (batch <= 0 || num_tiles <= 0) return 0;
  if (splits < 1 || splits > num_tiles) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const CountArgs a = {batch, dim, num_tiles, corpus_tile, true_num_items};
  return with_count_sweep(q_kind, corpus_kind, aligned16(corpus), dim,
                          [&](auto sweep) {
    return launch<decltype(sweep)>(q, corpus, static_cast<const float*>(tau),
                                   static_cast<int*>(counts), a, splits,
                                   static_cast<cudaStream_t>(stream));
  });
}
