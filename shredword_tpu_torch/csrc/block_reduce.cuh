// Reductions shared by the kernels of this directory.  Every thread of
// the block (warp) must call a block_ (warp_) function; a block result is
// valid in thread 0.
#pragma once

namespace shred {

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

__device__ __forceinline__ unsigned long long umax64(unsigned long long x,
                                                     unsigned long long y) {
  return x > y ? x : y;
}

// Warp-wide maximum; the result is valid in every lane.
__device__ __forceinline__ unsigned long long warp_max_u64(
    unsigned long long x) {
  for (int o = 16; o > 0; o >>= 1)
    x = umax64(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// block_max_u64 of N values at once, for the price of one: x[k] becomes
// the block's maximum of x[k], valid in thread 0.
template <int N>
__device__ __forceinline__ void block_max_u64_n(unsigned long long (&x)[N]) {
  __shared__ unsigned long long warp_val[N][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < N; ++k) x[k] = warp_max_u64(x[k]);
  __syncthreads();
  if (lane == 0)
#pragma unroll
    for (int k = 0; k < N; ++k) warp_val[k][warp] = x[k];
  __syncthreads();
  const int nw = (blockDim.x + 31) >> 5;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    x[k] = threadIdx.x < nw ? warp_val[k][threadIdx.x] : 0ull;
    if (warp == 0) x[k] = warp_max_u64(x[k]);
  }
}

// max_key over the columns c < n of one table row (n <= v), the value of
// column c being value(c, row[c]): threads start..n step stride, 16-byte
// loads (rows are 16-byte aligned: v % 4 == 0).  A load may read up to
// three columns past n; those hold 0 in every table of this directory,
// which a key for a column < n already equals or beats.
template <class F>
__device__ __forceinline__ unsigned long long row_max_key(
    const int* row, int n, int v, int start, int stride, F value) {
  unsigned long long best = 0ull;
  const int4* row4 = reinterpret_cast<const int4*>(row);
#pragma unroll 8  // loads in flight: a warp may scan a whole row
  for (int q = start; q < (n + 3) >> 2; q += stride) {
    const int4 x = row4[q];
    const int c = q << 2;
    best = umax64(best, max_key(value(c, x.x), c, v));
    best = umax64(best, max_key(value(c + 1, x.y), c + 1, v));
    best = umax64(best, max_key(value(c + 2, x.z), c + 2, v));
    best = umax64(best, max_key(value(c + 3, x.w), c + 3, v));
  }
  return best;
}

}  // namespace shred
