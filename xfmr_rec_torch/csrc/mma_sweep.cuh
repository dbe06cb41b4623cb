// Score tiles on Hopper's tensor cores behind a ring of corpus tiles in
// shared memory: the machinery under every bf16 and int8 sweep (the
// packed sweep of packed_sweep.cuh, the value contest of
// lane_max_scan.cu, the count of count_at_least.cu). `mma_sweep` is the
// loop they share; each brings its own contest.
//
// One warpgroup (128 threads) forms the scores of 64 query rows against
// kMmaLanes lanes of a corpus tile with `wgmma.mma_async`, bf16 x bf16
// with an f32 sum. Both operands are K-major in shared memory, in the
// 128-byte swizzle that wgmma reads: an operand of R rows is a sequence
// of panels of 64 k-values, a panel is R rows of 128 bytes, and the
// 16-byte chunk c of row r sits at chunk position c ^ (r & 7). Corpus
// rows are (N, D) row-major in device memory, which is K-major already,
// so a row is copied as it lies; D is padded with zeros to a multiple of
// 16 in shared memory only.
//
// The queries (A) are staged once per block. The corpus (B) goes through
// `CorpusRing`, which keeps tiles in flight ahead of the one being
// multiplied:
//   - bf16 rows of a multiple of 16 bytes: `cp.async` 16-byte copies
//     straight to their swizzled places in a ring of three stages (the
//     tile in use and two on their way);
//   - int8 rows of a multiple of 16 bytes: `cp.async` into a ring of raw
//     rows, and each thread widens the chunks it copied itself to bf16
//     (int8 values are exact in bf16) into one of two stages, so the
//     widening needs no barrier of its own;
//   - any other row (an odd D, as with the bias column, or a pointer off
//     16 bytes): plain element loads into one of two stages. No
//     asynchronous copy can address such rows.
// The lane shuffle is index arithmetic on the source row: lane l of tile
// t reads column (l - shift) mod ct. Per-item scales ride along in a
// ring of their own.
//
// The accumulator layout of wgmma (m64nNk16, f32): thread `tid` of the
// warpgroup holds rows 16*(tid/32) + (tid%32)/4 + {0, 8}; of every group
// of 8 columns j it holds columns 8j + 2*(tid%4) + {0, 1}; register
// 4j + 2h + e is row-half h, column e. The product of a score depends on
// nothing but its query row, its corpus row and the k order, so every
// kernel that takes a score from `mma_tile` rounds it the same way.

#pragma once

#include "scan_common.cuh"

namespace xfmr {

// The shape of the sweep: 64 lanes and one accumulator take 128 registers
// a thread, so four blocks share an SM and hide each other's waits. A
// second accumulator (the product of tile t+1 started before the contest
// of tile t) or 128 lanes cost registers, hence blocks, and timed slower.
constexpr int kMmaThreads = 128;  // one warpgroup
constexpr int kMmaRows = 64;      // wgmma's M
constexpr int kMmaLanes = 64;     // wgmma's N
constexpr int kMmaAcc = kMmaLanes / 2;  // accumulator registers a thread
// corpus tiles in flight ahead of the product (1 and 3 time the same)
constexpr int kTilesAhead = 2;
// a tile's scales are read after the next tile's copies were started
constexpr int kScaleSlots = kTilesAhead + 2;

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}
// Shared-memory writes of this thread become visible to wgmma's reads.
__device__ __forceinline__ void fence_async_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending)
               : "memory");
}
// Pins an accumulator that wgmma writes behind the compiler's back: no
// read of it moves above this point, no write below.
template <int kRegs>
__device__ __forceinline__ void fence_acc(float (&acc)[kRegs]) {
#pragma unroll
  for (int i = 0; i < kRegs; ++i) asm volatile("" : "+f"(acc[i])::"memory");
}

// Descriptor of a K-major operand in the 128-byte swizzle: start address,
// leading offset 16 bytes (unused by this layout), 1024 bytes from one
// group of 8 rows to the next, layout type 1.
__device__ __forceinline__ uint64_t mma_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (64ull << 32) | (1ull << 62);
}

#define XFMR_ACC8(d, i)                                                 \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),           \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define XFMR_ACC32(d, i) \
  XFMR_ACC8(d, i), XFMR_ACC8(d, i + 8), XFMR_ACC8(d, i + 16), XFMR_ACC8(d, i + 24)

// d (64 x 64, f32) = or += a (64 x 16, bf16) times b (64 x 16, bf16)^T.
__device__ __forceinline__ void wgmma_k16(float (&d)[32], uint64_t a,
                                          uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : XFMR_ACC32(d, 0)
      : "l"(a), "l"(b), "r"(accumulate));
}

#undef XFMR_ACC32
#undef XFMR_ACC8

__host__ __device__ inline int mma_k_steps(int dim) { return (dim + 15) / 16; }
__host__ __device__ inline int mma_panels(int dim) { return (dim + 63) / 64; }

// Byte offset of 16-byte chunk `chunk` (8 k-values) of row `r` in a
// swizzled operand of `rows` rows.
__device__ __forceinline__ uint32_t swizzled_chunk(int rows, int r,
                                                   int chunk) {
  return static_cast<uint32_t>((chunk >> 3) * rows * 128 + r * 128 +
                               (((chunk & 7) ^ (r & 7)) << 4));
}

// Starts the product of the staged queries at `a_addr` with the staged
// corpus rows at `b_addr` into `acc`, as one committed group.
__device__ __forceinline__ void mma_tile(float (&acc)[kMmaAcc],
                                         uint32_t a_addr, uint32_t b_addr,
                                         int k_steps) {
  wgmma_fence();
  for (int kk = 0; kk < k_steps; ++kk) {
    const uint32_t panel = kk >> 2;
    const uint32_t within = (kk & 3) * 32;
    wgmma_k16(acc, mma_desc(a_addr + panel * (kMmaRows * 128) + within),
              mma_desc(b_addr + panel * (kMmaLanes * 128) + within), kk != 0);
  }
  wgmma_commit();
}

__device__ __forceinline__ uint32_t bf16_pair(int lo, int hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(static_cast<float>(lo),
                                                 static_cast<float>(hi));
  return *reinterpret_cast<const uint32_t*>(&p);
}
// Four int8 values of a word, widened to four bf16 in two words.
__device__ __forceinline__ uint2 widen_int8x4(uint32_t w) {
  return make_uint2(bf16_pair(static_cast<int8_t>(w), static_cast<int8_t>(w >> 8)),
                    bf16_pair(static_cast<int8_t>(w >> 16),
                              static_cast<int8_t>(w >> 24)));
}

template <typename CT, bool kAsync>
struct RingTraits {
  // cp.async straight into the swizzled stage
  static constexpr bool kDirect = kAsync && sizeof(CT) == 2;
  // cp.async into raw rows, widened into the stage by the copying thread
  static constexpr bool kRaw = kAsync && sizeof(CT) == 1;
  // a direct stage is refilled when its product has been waited for:
  // the tile in use and the tiles ahead; the other rings fill a stage
  // just before its product, and alternate two
  static constexpr int kStages = kDirect ? kTilesAhead + 1 : 2;
  static constexpr int kRawStages = kTilesAhead + 1;
};

// Shared memory of one block's sweep: 1024 bytes of slack to align the
// swizzled operands, the queries, the stages, the raw rows, the scales.
template <typename CT, bool kAsync>
inline size_t mma_smem_bytes(int dim) {
  using Traits = RingTraits<CT, kAsync>;
  const size_t panels = mma_panels(dim);
  return 1024 + panels * kMmaRows * 128 +
         Traits::kStages * panels * kMmaLanes * 128 +
         (Traits::kRaw ? Traits::kRawStages * kMmaLanes * dim : 0) +
         kScaleSlots * kMmaLanes * sizeof(float);
}

// Stages the block's 64 query rows (zeros past the batch and past dim)
// at `a` (generic pointer to 1024-byte-aligned shared memory).
__device__ __forceinline__ void stage_queries_mma(
    unsigned char* a, const __nv_bfloat16* __restrict__ queries, int row0,
    int batch, int dim) {
  const int width = mma_panels(dim) * 64;
  for (int e = threadIdx.x; e < kMmaRows * width; e += kMmaThreads) {
    const int r = e / width;
    const int k = e - r * width;
    const int row = row0 + r;
    __nv_bfloat16 v = __float2bfloat16_rn(0.f);
    if (row < batch && k < dim) v = queries[static_cast<size_t>(row) * dim + k];
    *reinterpret_cast<__nv_bfloat16*>(
        a + swizzled_chunk(kMmaRows, r, k >> 3) + (k & 7) * 2) = v;
  }
}

// The ring of corpus tiles of one block: lanes lane0 .. lane0+kMmaLanes-1
// of tiles [tile_begin, tile_end). `acquire(t)`, called for every tile in
// order by all threads, returns with tile t staged and visible to wgmma
// and later tiles on their way. It holds two barriers at most; the one
// before it returns also tells that every thread has left tile t-1
// (product waited for, scales read), whose place is then refilled.
template <typename CT, bool kAsync>
struct CorpusRing {
  using Traits = RingTraits<CT, kAsync>;

  const CT* corpus;
  const float* scales;
  int dim, corpus_tile, lane0, roll, tile_end;
  int next_tile, next_shift;  // the next tile to start, and its shift
  int chunks_per_row;         // 16-byte chunks of a corpus row
  int row_first, chunk_first, row_step, chunk_step;  // this thread's chunks
  unsigned char* stages;  // generic pointers into shared memory
  unsigned char* raw;
  float* scale_s;
  uint32_t stage_bytes;

  // `base` is 1024-byte aligned and free from there on.
  __device__ __forceinline__ void init(unsigned char* base,
                                       const CT* corpus_, const float* scales_,
                                       int dim_, int corpus_tile_, int lane0_,
                                       int lane_shuffle, int tile_begin,
                                       int tile_end_) {
    corpus = corpus_;
    scales = scales_;
    dim = dim_;
    corpus_tile = corpus_tile_;
    lane0 = lane0_;
    roll = lane_shuffle % corpus_tile;
    tile_end = tile_end_;
    next_tile = tile_begin;
    next_shift = tile_shift(tile_begin, lane_shuffle, corpus_tile);
    stage_bytes = mma_panels(dim) * kMmaLanes * 128;
    stages = base;
    raw = stages + Traits::kStages * stage_bytes;
    scale_s = reinterpret_cast<float*>(
        raw + (Traits::kRaw ? Traits::kRawStages * kMmaLanes * dim : 0));
    chunks_per_row = dim * static_cast<int>(sizeof(CT)) / 16;
    if constexpr (kAsync) {
      row_first = threadIdx.x / chunks_per_row;
      chunk_first = threadIdx.x - row_first * chunks_per_row;
      row_step = kMmaThreads / chunks_per_row;
      chunk_step = kMmaThreads - row_step * chunks_per_row;
    }
    // zeros where no copy lands: the k padding and lanes past the tile
    for (uint32_t off = threadIdx.x * 16; off < Traits::kStages * stage_bytes;
         off += kMmaThreads * 16) {
      *reinterpret_cast<uint4*>(stages + off) = make_uint4(0, 0, 0, 0);
    }
    __syncthreads();
    if constexpr (kAsync) {
      for (int i = 0; i < kTilesAhead; ++i) start_next();
    }
  }

  __device__ __forceinline__ void advance() {
    ++next_tile;
    next_shift += roll;
    if (next_shift >= corpus_tile) next_shift -= corpus_tile;
  }

  __device__ __forceinline__ unsigned char* stage(int tile) const {
    return stages + (tile % Traits::kStages) * stage_bytes;
  }
  __device__ __forceinline__ const float* tile_scales(int tile) const {
    return scale_s + (tile % kScaleSlots) * kMmaLanes;
  }

  // Starts the asynchronous copies of the next tile as one group (an
  // empty group past the last tile, so the groups stay countable).
  __device__ __forceinline__ void start_next() {
    const int tile = next_tile;
    if (tile < tile_end) {
      const size_t tile_base = static_cast<size_t>(tile) * corpus_tile;
      unsigned char* dst = Traits::kDirect
                               ? stage(tile)
                               : raw + (tile % Traits::kRawStages) *
                                           kMmaLanes * dim;
      int i = row_first;
      int chunk = chunk_first;
      while (i < kMmaLanes) {
        const int lane = lane0 + i;
        if (lane < corpus_tile) {
          const size_t item =
              tile_base + lane_column(lane, next_shift, corpus_tile);
          const unsigned char* src =
              reinterpret_cast<const unsigned char*>(corpus + item * dim) +
              chunk * 16;
          const uint32_t off = Traits::kDirect
                                   ? swizzled_chunk(kMmaLanes, i, chunk)
                                   : static_cast<uint32_t>(i * dim + chunk * 16);
          cp_async_16(shared_addr(dst + off), src);
        }
        i += row_step;
        chunk += chunk_step;
        if (chunk >= chunks_per_row) {
          chunk -= chunks_per_row;
          ++i;
        }
      }
      const int lane = lane0 + threadIdx.x;
      if (scales != nullptr && threadIdx.x < kMmaLanes && lane < corpus_tile) {
        cp_async_4(
            shared_addr(scale_s + (tile % kScaleSlots) * kMmaLanes + threadIdx.x),
            scales + tile_base + lane_column(lane, next_shift, corpus_tile));
      }
      advance();
    }
    cp_async_commit();
  }

  // Raw ring: widens the chunks this thread copied for `tile`.
  __device__ __forceinline__ void widen(int tile) {
    const unsigned char* src =
        raw + (tile % Traits::kRawStages) * kMmaLanes * dim;
    unsigned char* dst = stage(tile);
    int i = row_first;
    int chunk = chunk_first;
    while (i < kMmaLanes) {
      if (lane0 + i < corpus_tile) {
        const uint4 v =
            *reinterpret_cast<const uint4*>(src + i * dim + chunk * 16);
        const uint2 a = widen_int8x4(v.x), b = widen_int8x4(v.y);
        const uint2 c = widen_int8x4(v.z), d = widen_int8x4(v.w);
        *reinterpret_cast<uint4*>(
            dst + swizzled_chunk(kMmaLanes, i, 2 * chunk)) =
            make_uint4(a.x, a.y, b.x, b.y);
        *reinterpret_cast<uint4*>(
            dst + swizzled_chunk(kMmaLanes, i, 2 * chunk + 1)) =
            make_uint4(c.x, c.y, d.x, d.y);
      }
      i += row_step;
      chunk += chunk_step;
      if (chunk >= chunks_per_row) {
        chunk -= chunks_per_row;
        ++i;
      }
    }
  }

  // No asynchronous copy fits these rows: loads `tile` element by element.
  __device__ __forceinline__ void load_plain(int tile) {
    const size_t tile_base = static_cast<size_t>(tile) * corpus_tile;
    unsigned char* dst = stage(tile);
    const int width = 16 * mma_k_steps(dim);
    for (int e = threadIdx.x; e < kMmaLanes * width; e += kMmaThreads) {
      const int i = e / width;
      const int k = e - i * width;
      const int lane = lane0 + i;
      float v = 0.f;
      if (k < dim && lane < corpus_tile) {
        const size_t item =
            tile_base + lane_column(lane, next_shift, corpus_tile);
        v = to_f32(corpus[item * dim + k]);
      }
      *reinterpret_cast<__nv_bfloat16*>(
          dst + swizzled_chunk(kMmaLanes, i, k >> 3) + (k & 7) * 2) =
          __float2bfloat16_rn(v);
    }
    const int lane = lane0 + threadIdx.x;
    if (scales != nullptr && threadIdx.x < kMmaLanes && lane < corpus_tile) {
      scale_s[(tile % kScaleSlots) * kMmaLanes + threadIdx.x] =
          scales[tile_base + lane_column(lane, next_shift, corpus_tile)];
    }
    advance();
  }

  __device__ __forceinline__ void acquire(int tile) {
    if constexpr (kAsync) cp_async_wait<kTilesAhead - 1>();  // own copies have landed
    if constexpr (!Traits::kDirect) {
      __syncthreads();  // every thread has left the stage's previous tile
      if constexpr (Traits::kRaw) {
        widen(tile);
      } else {
        load_plain(tile);
      }
    }
    fence_async_proxy();
    __syncthreads();
    if constexpr (kAsync) start_next();
  }
};

// The loop every tensor-core sweep runs: the block's 64 query rows from
// row0 against lanes lane0 .. lane0+kMmaLanes-1 of corpus tiles
// [tile_begin, tile_end). Stages the queries, then per tile acquires it
// from the ring, multiplies, waits, and calls contest(acc, t, scale_s)
// with the thread's scores of tile t in the accumulator layout (scale_s:
// the tile's kMmaLanes scales in shared memory, when `scales` is not
// null). `smem` holds `mma_smem_bytes<CT, kAsync>(dim)` bytes. Ends
// without a barrier: a thread may still be reading the scales.
template <typename CT, bool kAsync, typename Contest>
__device__ __forceinline__ void mma_sweep(
    unsigned char* smem, const __nv_bfloat16* __restrict__ queries,
    const CT* __restrict__ corpus, const float* __restrict__ scales,
    int batch, int dim, int corpus_tile, int lane_shuffle, int row0,
    int lane0, int tile_begin, int tile_end, Contest&& contest) {
  // the swizzle pattern repeats every 1024 bytes of address
  unsigned char* base = smem + ((1024 - (shared_addr(smem) & 1023)) & 1023);
  CorpusRing<CT, kAsync> ring;
  ring.init(base + mma_panels(dim) * kMmaRows * 128, corpus, scales, dim,
            corpus_tile, lane0, lane_shuffle, tile_begin, tile_end);
  stage_queries_mma(base, queries, row0, batch, dim);
  if (tile_begin >= tile_end) return;

  const uint32_t a_addr = shared_addr(base);
  const int k_steps = mma_k_steps(dim);
  float acc[kMmaAcc];
  for (int t = tile_begin; t < tile_end; ++t) {
    ring.acquire(t);
    mma_tile(acc, a_addr, shared_addr(ring.stage(t)), k_steps);
    wgmma_wait<0>();
    fence_acc(acc);
    contest(acc, t, ring.tile_scales(t));
  }
}

// The asynchronous ring serves rows of a multiple of 16 bytes at a
// 16-byte-aligned pointer (`aligned`).
template <typename CT>
inline bool ring_async(bool aligned, int dim) {
  return aligned && dim * sizeof(CT) % 16 == 0;
}
inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace xfmr
