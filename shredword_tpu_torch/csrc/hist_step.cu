// Per-merge hist-engine steps for Hopper (sm_90a): one given merge
// (a, b) -> new over the corpus, with the delta vectors it implies.
//
// Replaces the TPU kernels shredword_tpu/ops/bpe_hist.py::_merge_kernel
// (make_merge_step: every [L, 512] block of the corpus) and
// ::_merge_kernel_sparse (make_merge_step_sparse: only the 512-column
// chunks whose presence bitmap holds both a and b, with that bitmap
// rewritten for the chunks it processes).  The pick and the table update
// around them are PyTorch ops on the device (ops/bpe_hist.py
// merge_steps), so every scalar comes from a device buffer:
//   scal int32 [5] = (a, b, new, unk, do); do == 0 changes nothing, as
//   the JAX loop's lax.cond skips the step
//   out  int32 [2v + 1] = dl | dr | nm, zeroed by the caller: the left
//   and right neighbour weights of every merged occurrence and their
//   number (dl | dr is the one buffer the sharded engine all-reduces)
// Both kernels run merge_column.cuh, one thread per word column (greedy
// left-to-right merge, compaction, int32 atomics into dl/dr); nm is a
// block sum and one atomic per block.  The TPU kernels' slot histograms
// and masked lane reductions have no counterpart.
//
// What bounds it on the H100: one pass over the corpus, L * W * 2 bytes
// read (2.6 MB on the 16 MB bench corpus, under a microsecond at
// 3.35 TB/s) and rewritten only where a column matched, so a launch
// costs a few microseconds of latency, not bandwidth; the sparse kernel
// reads only flagged chunks.  The train loop around them enqueues about
// twenty PyTorch ops per merge (the thresholded argmax over [v, v] among
// them), which cost more than the kernel; a fused pick (hist_fused.cu)
// is the remedy.

#include <cuda_runtime.h>
#include <stdint.h>

#include "block_reduce.cuh"
#include "merge_column.cuh"

namespace {

using namespace shred;

constexpr int STEP_THREADS = 256;
constexpr int CHUNK = 512;  // columns per presence bit (bpe_hist.CHUNK)

enum { P_A = 0, P_B, P_NEW, P_UNK, P_DO };

// _merge_kernel (bpe_hist.py:262-285): every column of the corpus.
template <int L>
__global__ void __launch_bounds__(STEP_THREADS)
step_kernel(int16_t* __restrict__ tw, const int* __restrict__ wcount, int W,
            const int* __restrict__ scal, int v, int* __restrict__ out) {
  if (!scal[P_DO] || scal[P_NEW] >= v) return;
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  int n = 0;
  if (col < W)
    n = merge_column<L>(tw, W, col, scal[P_A], scal[P_B], scal[P_NEW],
                        scal[P_UNK], wcount, out, out + v) >>
        MC_COUNT_SHIFT;
  n = block_sum(n);
  if (threadIdx.x == 0 && n) atomicAdd(out + 2 * v, n);
}

// _merge_kernel_sparse (bpe_hist.py:288-357): one block per 512-column
// chunk; a chunk whose presence lacks a or b returns at once.  A
// processed chunk rewrites the presence of a, b and new: the bitmap is
// exact (build_presence, then every rewrite), and a merge changes no
// other id's presence, so this equals the TPU kernel's rewrite of the
// whole row.  A flagged chunk that did not match keeps a and b and gets
// new = 0.
template <int L>
__global__ void __launch_bounds__(CHUNK)
sparse_kernel(int16_t* __restrict__ tw, const int* __restrict__ wcount,
              int W, int8_t* __restrict__ presT, int NC,
              const int* __restrict__ scal, int v, int* __restrict__ out) {
  const int a = scal[P_A], b = scal[P_B], nw = scal[P_NEW];
  if (!scal[P_DO] || nw >= v) return;
  const int c = blockIdx.x;
  if (!(presT[(size_t)a * NC + c] && presT[(size_t)b * NC + c])) return;
  const int r = merge_column<L>(tw, W, c * CHUNK + threadIdx.x, a, b, nw,
                                scal[P_UNK], wcount, out, out + v);
  const int matched = __syncthreads_or(r & MC_MATCHED);
  const int has_a = __syncthreads_or(r & MC_HAS_A);
  const int has_b = __syncthreads_or(r & MC_HAS_B);
  const int n = block_sum(r >> MC_COUNT_SHIFT);
  if (threadIdx.x == 0) {
    if (n) atomicAdd(out + 2 * v, n);
    presT[(size_t)a * NC + c] = has_a ? 1 : 0;
    presT[(size_t)b * NC + c] = has_b ? 1 : 0;
    presT[(size_t)nw * NC + c] = matched ? 1 : 0;
  }
}

}  // namespace

extern "C" {

// One merge over tw int16 [L, W] (in place) with wcount int32 [W]; scal
// and out as above.  Returns the launch's CUDA error, or 0.
int shred_hist_merge_step(int16_t* tw, const int* wcount, const int* scal,
                          int* out, int L, int W, int v, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (W < 1) return (int)cudaErrorInvalidValue;
  const int blocks = (W + STEP_THREADS - 1) / STEP_THREADS;
  if (L == 16)
    step_kernel<16><<<blocks, STEP_THREADS, 0, s>>>(tw, wcount, W, scal, v,
                                                    out);
  else if (L == 32)
    step_kernel<32><<<blocks, STEP_THREADS, 0, s>>>(tw, wcount, W, scal, v,
                                                    out);
  else if (L == 64)
    step_kernel<64><<<blocks, STEP_THREADS, 0, s>>>(tw, wcount, W, scal, v,
                                                    out);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// The sparse step: W = NC * 512 columns, presT int8 [v, NC] exact
// presence, both updated in place.  Returns the launch's CUDA error, or 0.
int shred_hist_merge_step_sparse(int16_t* tw, const int* wcount,
                                 int8_t* presT, const int* scal, int* out,
                                 int L, int W, int v, int NC, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (NC < 1 || (long long)NC * CHUNK != W) return (int)cudaErrorInvalidValue;
  if (L == 16)
    sparse_kernel<16><<<NC, CHUNK, 0, s>>>(tw, wcount, W, presT, NC, scal, v,
                                           out);
  else if (L == 32)
    sparse_kernel<32><<<NC, CHUNK, 0, s>>>(tw, wcount, W, presT, NC, scal, v,
                                           out);
  else if (L == 64)
    sparse_kernel<64><<<NC, CHUNK, 0, s>>>(tw, wcount, W, presT, NC, scal, v,
                                           out);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"
