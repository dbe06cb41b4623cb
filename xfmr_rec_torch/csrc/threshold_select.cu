// Per-row threshold-select over a packed-key pool, for Hopper (sm_90a).
//
// Replaces: xfmr_rec_tpu/ops/topk_pallas.py `_select_kernel` (body
// `_threshold_select_body`, launched by `select_topk_keys`). Plain
// PyTorch version beside it: xfmr_rec_torch/ops/topk.py
// `select_topk_keys_plain` (and `radix_tau_plain` for the search).
//
// What it computes. For each row of a (B, W) pool of non-negative int32
// keys, the select of select_common.cuh: tau, the k-th largest key at
// quantum granularity, by a radix search, then every key above the tau
// quantum and tau-quantum ties in lane order up to `capacity`, compacted
// to their rank with meta = lane + 1. The final sort over `capacity`
// lanes stays in the wrapper.
//
// What bounds it on this card. Bytes: the pool is read once (B*W*4) and
// 2*B*capacity*4 written, 0.016 ms at (4096, 3072). A warp then makes
// four passes over its row in shared memory (the row max, one histogram
// for each of two 8-bit digits, the compaction). At the full batch the
// integer work and shared-memory atomics of those passes, more than the
// bytes, set the time; at the 128-row retry each SM holds one warp, and
// its passes run on one of the SM's four integer pipes (a block of warps
// a row would use all four, at the price of block barriers; PERF.md).
//
// What the design does about it. A warp per row, with no block barrier
// and no branch a key (select_common.cuh). Each warp stages its row with
// 16-byte `cp.async` copies into its own buffer and is persistent over
// rows (row, row + all warps of the grid, ...). The warps a block and
// the grid are chosen by the wrapper (`kernels.select_grid`) from what
// the occupancy API reports: at a small batch a block holds one or two
// warps, so the rows spread over all SMs; at a large one each SM holds
// as many warps as its shared memory takes.

#include "mma_sweep.cuh"
#include "select_common.cuh"

namespace {

using namespace xfmr;

constexpr int kSelectMaxWarps = 8;  // warps of a block at most
constexpr int kMaxDevices = 64;

// ints of a warp's region: the row in whole steps, then the histogram
__host__ __device__ inline int warp_ints(int width) {
  return kQuadKeys * row_steps(width) + kHistInts;
}
inline size_t warp_bytes(int width) { return sizeof(int) * warp_ints(width); }

// Starts the copy of one pool row into the warp's buffer.
__device__ __forceinline__ void stage_row(const int* __restrict__ src,
                                          int* dst, int width, bool vec) {
  const int lane = threadIdx.x & 31;
  if (vec) {
    for (int i = 4 * lane; i < width; i += kQuadKeys) {
      cp_async_16(shared_addr(dst + i), src + i);
    }
  } else {
    for (int i = lane; i < width; i += 32) {
      cp_async_4(shared_addr(dst + i), src + i);
    }
  }
  cp_async_commit();
}

__global__ void __launch_bounds__(kSelectMaxWarps * 32) threshold_select_kernel(
    const int* __restrict__ pool, int* __restrict__ out_keys,
    int* __restrict__ out_meta, int batch, int width, int k, int capacity,
    int quantum_bits, int shared_exponent, int vec) {
  extern __shared__ __align__(16) int smem[];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  int* buf = smem + static_cast<size_t>(warp) * warp_ints(width);
  int* hist = buf + kQuadKeys * row_steps(width);
  const RowView staged{buf, width};
  const int stride = gridDim.x * warps;
  for (int row = blockIdx.x * warps + warp; row < batch; row += stride) {
    __syncwarp();  // the previous row's select is done with the buffer
    stage_row(pool + static_cast<size_t>(row) * width, buf, width, vec);
    cp_async_wait<0>();  // this thread's copies have landed
    __syncwarp();        // and every thread's
    const size_t out = static_cast<size_t>(row) * capacity;
    select_row(staged, k, capacity, quantum_bits, shared_exponent, hist,
               out_keys + out, out_meta + out);
  }
}
// The most shared memory a block may opt into on `dev`.
inline cudaError_t most_smem(int dev, int* most) {
  return cudaDeviceGetAttribute(most, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                dev);
}

// The attribute is set once per device, to the most a block may opt
// into, so no launch pays for the call.
cudaError_t allow_select_smem(int dev) {
  static bool done[kMaxDevices] = {};
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  int most = 0;
  cudaError_t err = most_smem(dev, &most);
  if (err == cudaSuccess) err = allow_smem(threshold_select_kernel, most);
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}

}  // namespace

// The launch shape for rows of `width` keys: shape[0] the warps of a
// block that let an SM hold the most warps (at most kSelectMaxWarps, the
// larger block among equals), shape[1] how many such blocks one SM
// holds at a time (occupancy API: registers and shared memory). Returns
// a CUDA error code (0 on success).
extern "C" int xfmr_threshold_select_shape(int width, int* shape) {
  int dev = 0, most = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = allow_select_smem(dev);
  if (err == cudaSuccess) err = most_smem(dev, &most);
  if (err != cudaSuccess) return static_cast<int>(err);
  shape[0] = 0;
  shape[1] = 0;
  for (int warps = kSelectMaxWarps; warps >= 1; --warps) {
    const size_t bytes = warps * warp_bytes(width);
    if (bytes > static_cast<size_t>(most)) continue;
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, threshold_select_kernel, 32 * warps, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (blocks * warps > shape[0] * shape[1]) {
      shape[0] = warps;
      shape[1] = blocks;
    }
  }
  return static_cast<int>(shape[0] ? cudaSuccess : cudaErrorInvalidValue);
}

// `block_warps` rows a block at a time, `blocks` blocks (persistent over
// the rest). Returns cudaGetLastError() after the launch (0 on success).
extern "C" int xfmr_threshold_select(const void* pool, void* keys,
                                     void* meta, int batch, int width, int k,
                                     int capacity, int quantum_bits,
                                     int shared_exponent, int block_warps,
                                     int blocks, void* stream) {
  if (batch <= 0) return 0;
  if (block_warps < 1 || block_warps > kSelectMaxWarps || blocks < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = allow_select_smem(dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec = width % 4 == 0 && aligned16(pool);
  threshold_select_kernel<<<blocks, 32 * block_warps,
                            block_warps * warp_bytes(width),
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(pool), static_cast<int*>(keys),
      static_cast<int*>(meta), batch, width, k, capacity, quantum_bits,
      shared_exponent, vec);
  return static_cast<int>(cudaGetLastError());
}
