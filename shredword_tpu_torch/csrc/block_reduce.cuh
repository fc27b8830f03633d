// Block-wide reductions shared by the kernels of this directory.  Every
// thread of the block must call them; the result is valid in thread 0.
#pragma once

#include <limits.h>

namespace shred {

__device__ __forceinline__ int block_max(int x) {
  __shared__ int warp_val[32];
  for (int o = 16; o > 0; o >>= 1) x = max(x, __shfl_xor_sync(0xffffffffu, x, o));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) warp_val[warp] = x;
  __syncthreads();
  const int nw = (blockDim.x + 31) >> 5;
  x = threadIdx.x < nw ? warp_val[threadIdx.x] : INT_MIN;
  if (warp == 0)
    for (int o = 16; o > 0; o >>= 1) x = max(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ unsigned long long block_max_u64(unsigned long long x) {
  __shared__ unsigned long long warp_val[32];
  for (int o = 16; o > 0; o >>= 1) {
    unsigned long long y = __shfl_xor_sync(0xffffffffu, x, o);
    x = y > x ? y : x;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) warp_val[warp] = x;
  __syncthreads();
  const int nw = (blockDim.x + 31) >> 5;
  x = threadIdx.x < nw ? warp_val[threadIdx.x] : 0ull;
  if (warp == 0)
    for (int o = 16; o > 0; o >>= 1) {
      unsigned long long y = __shfl_xor_sync(0xffffffffu, x, o);
      x = y > x ? y : x;
    }
  return x;
}

__device__ __forceinline__ int block_sum(int x) {
  __shared__ int warp_val[32];
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) warp_val[warp] = x;
  __syncthreads();
  const int nw = (blockDim.x + 31) >> 5;
  x = threadIdx.x < nw ? warp_val[threadIdx.x] : 0;
  if (warp == 0)
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ int block_min(int x) {
  return -block_max(-x);  // callers pass values in [0, INT_MAX]
}

// Key that orders by value, then by the smaller index: the lex
// tie-break of every pick.  block_max_u64 of it finds the smallest index
// of the largest value.
__device__ __forceinline__ unsigned long long max_key(int val, int idx,
                                                      int n) {
  return ((unsigned long long)((unsigned)val ^ 0x80000000u) << 32) |
         (unsigned)(n - 1 - idx);
}

__device__ __forceinline__ int key_val(unsigned long long key) {
  return (int)((unsigned)(key >> 32) ^ 0x80000000u);
}

__device__ __forceinline__ int key_idx(unsigned long long key, int n) {
  return n - 1 - (int)(key & 0xffffffffu);
}

}  // namespace shred
