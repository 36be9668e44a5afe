// Scheduling helpers shared by the fused forward kernels (fused_kernels.cu)
// and the fused adjoint kernels (fused_bwd_kernels.cu): the pieces that run
// a step's live lanes densely, packed into full warps over the whole grid,
// instead of one thread per lane in lane order.
//
// - block_exclusive_scan: a prefix sum of one int per thread over a block.
// - warp_count / warp_append / warp_push: each lane of a converged warp
//   adds one to the counter of its key; the lanes of one key share one
//   atomic (__match_any_sync; a ballot where there is one key), and
//   warp_append and warp_push return each lane's slot.
// - load_vec / store_vec: a lane's row of a lane-major table (one row per
//   lane, padded to whole float4s), so that a gathered lane reads and writes
//   a few 32-byte sectors instead of one per value.
// - launch_cooperative: a persistent launch of as many blocks as the card
//   holds at once, sized by the occupancy calculator, for kernels whose
//   stages meet at grid.sync().
#pragma once

#include <cuda_runtime.h>

namespace ls {

constexpr unsigned FULL = 0xffffffffu;

constexpr int round4(int n) { return (n + 3) & ~3; }

// Exclusive scan of one int per thread over the block (blockDim.x a multiple
// of 32, at most 1024); ``tmp`` holds 32 ints of shared memory. Returns the
// thread's exclusive prefix; ``total`` receives the block's sum.
__device__ __forceinline__ int block_exclusive_scan(int v, int* tmp,
                                                    int& total) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  int x = v;
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    int y = __shfl_up_sync(FULL, x, s);
    if (lane >= s) x += y;
  }
  if (lane == 31) tmp[w] = x;
  __syncthreads();
  if (w == 0) {
    int t = lane < nw ? tmp[lane] : 0;
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
      int y = __shfl_up_sync(FULL, t, s);
      if (lane >= s) t += y;
    }
    tmp[lane] = t;  // inclusive prefix of the warp totals
  }
  __syncthreads();
  total = tmp[nw - 1];
  int before = w > 0 ? tmp[w - 1] : 0;
  __syncthreads();  // tmp may be reused by the caller
  return before + x - v;
}

// Every lane of the converged warp calls these; a lane with ``key`` >= 0
// adds one to ``counter[key]``, one atomic per key the warp holds.
__device__ __forceinline__ void warp_count(int key, int* counter) {
  const unsigned peers = __match_any_sync(FULL, key);
  if (key >= 0 && (int)(threadIdx.x & 31) == __ffs(peers) - 1)
    atomicAdd(counter + key, __popc(peers));
}

// As warp_count, and returns the lane's slot: the counter's value before
// the warp's atomic plus the lane's rank among the warp's lanes of its key
// (meaningless for key < 0). The order of slots between warps is the
// atomics'.
__device__ __forceinline__ int warp_append(int key, int* counter) {
  const int lane = threadIdx.x & 31;
  const unsigned peers = __match_any_sync(FULL, key);
  const int leader = __ffs(peers) - 1;
  int at = 0;
  if (key >= 0 && lane == leader) at = atomicAdd(counter + key, __popc(peers));
  at = __shfl_sync(FULL, at, leader);
  return at + __popc(peers & ((1u << lane) - 1u));
}

// warp_append with one key: a lane that ``take``s gets a slot of
// ``counter``, one atomic a warp (a ballot, cheaper than __match_any_sync).
__device__ __forceinline__ int warp_push(bool take, int* counter) {
  const int lane = threadIdx.x & 31;
  const unsigned m = __ballot_sync(FULL, take);
  int at = 0;
  if (m != 0u && lane == __ffs(m) - 1) at = atomicAdd(counter, __popc(m));
  at = __shfl_sync(FULL, at, m != 0u ? __ffs(m) - 1 : 0);
  return at + __popc(m & ((1u << lane) - 1u));
}

// W floats (a multiple of 4) at a 16-byte aligned address, as float4s
template <int W>
__device__ __forceinline__ void load_vec(const float* p, float* v) {
  static_assert(W % 4 == 0, "rows are whole float4s");
#pragma unroll
  for (int k = 0; k < W / 4; ++k) {
    const float4 q = reinterpret_cast<const float4*>(p)[k];
    v[4 * k] = q.x;
    v[4 * k + 1] = q.y;
    v[4 * k + 2] = q.z;
    v[4 * k + 3] = q.w;
  }
}
template <int W>
__device__ __forceinline__ void store_vec(float* p, const float* v) {
  static_assert(W % 4 == 0, "rows are whole float4s");
#pragma unroll
  for (int k = 0; k < W / 4; ++k)
    reinterpret_cast<float4*>(p)[k] =
        make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
}

// Launch ``kernel`` (blocks of ``threads``, ``smem`` bytes of dynamic shared
// memory, its arguments ``args``) cooperatively on ``stream``: as many
// blocks as the occupancy calculator fits on the card at once, and no more
// than ``max_blocks``. A cooperative kernel may meet at grid.sync() only
// because every block is resident; never launch it with <<<>>>.
inline cudaError_t launch_cooperative(const void* kernel, int threads,
                                      size_t smem, int max_blocks,
                                      void** args, cudaStream_t stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int blocks = per_sm * sms < max_blocks ? per_sm * sms : max_blocks;
  err = cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(threads), args,
                                    smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace ls
