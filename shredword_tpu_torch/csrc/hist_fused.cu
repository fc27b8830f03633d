// Fused hist-engine BPE merge loop for Hopper (sm_90a).
//
// Replaces the TPU kernels shredword_tpu/ops/bpe_hist.py::_fused_kernel
// (pair table resident in VMEM, v <= ~1280) and ::_fused_kernel_big
// (table streamed from HBM, v <= 4096).  Both compute the same greedy
// merges; on the card the int32 [v, v] table lives in device memory at
// every v, so one kernel chain serves v <= 4096.
//
// One C call runs `steps` merges and enqueues, on the caller's stream,
// one row-max pass and then three kernels per merge:
//   pick    one block: best pair from the maintained row maxima
//           (threshold min_freq, smallest row, then smallest column),
//           the (a, b, freq, did) record, the sticky done flag, and the
//           zeroing of the delta vectors dl/dr
//   corpus  one thread per word column of the int16 [L, W] layout:
//           greedy left-to-right merge with compaction, and the
//           left/right neighbour weights of every merged occurrence
//           added to dl/dr with int32 atomics (exact, order-free)
//   update  one block per row r <= new: the five exact table updates
//           (column a -dl, column new +dl, row b -dr, row new +dr,
//           cell (a, b) = 0) and the row's maximum
// No host synchronisation happens inside the call; the host reads the
// records once per call.
//
// What bounds it on the H100: each merge is a serial dependency chain
// of three small launches, so launch latency (a few microseconds each)
// bounds it once the corpus shrinks.  The corpus pass reads L*W*2 bytes
// (about 2.6 MB on the 16 MB bench corpus) and the table update touches
// only rows whose dl is non-zero; both stay inside the 50 MB L2.  A
// persistent kernel with grid sync, or a CUDA graph of the chain, is the
// later step that removes the launch bound.

#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>

#include "block_reduce.cuh"
#include "merge_column.cuh"

namespace {

using namespace shred;

constexpr int CORPUS_THREADS = 256;
constexpr int UPDATE_THREADS = 256;
constexpr int PICK_THREADS = 1024;

// per-merge device state, written by pick and read by corpus/update
enum { S_A = 0, S_B, S_NEW, S_DO, S_DONE, S_LEN };

// rowmax[r] = max_c hist[r, c], once per call (bpe_hist.py:502)
__global__ void rowmax_kernel(const int* __restrict__ hist, int v,
                              int* __restrict__ rowmax) {
  const int* row = hist + (size_t)blockIdx.x * v;
  int m = INT_MIN;
  for (int c = threadIdx.x; c < v; c += blockDim.x) m = max(m, row[c]);
  m = block_max(m);
  if (threadIdx.x == 0) rowmax[blockIdx.x] = m;
}

// bpe_hist.py:512-534
__global__ void pick_kernel(const int* __restrict__ hist,
                            const int* __restrict__ rowmax, int v, int i,
                            int new_id, int min_freq, int allowed,
                            int init_done, int* __restrict__ state,
                            int* __restrict__ records, int* __restrict__ dl,
                            int* __restrict__ dr) {
  __shared__ int s_a, s_m, s_do;
  // smallest row of the largest thresholded row max
  unsigned long long best = 0ull;
  for (int r = threadIdx.x; r < v; r += blockDim.x) {
    const int rm = rowmax[r];
    const unsigned long long key = max_key(rm >= min_freq ? rm : 0, r, v);
    best = key > best ? key : best;
  }
  best = block_max_u64(best);
  if (threadIdx.x == 0) {
    const int m = key_val(best);
    const int done = i == 0 ? init_done : state[S_DONE];
    const int d = (m > 0) && !done && (i < allowed);
    s_a = d ? key_idx(best, v) : 0;
    s_m = m;
    s_do = d;
  }
  __syncthreads();
  const int a = s_a, m = s_m, d = s_do;
  int b = INT_MAX;
  if (d) {
    const int* row = hist + (size_t)a * v;
    for (int c = threadIdx.x; c < v; c += blockDim.x)
      if (row[c] == m) { b = c; break; }  // strided: first hit is this thread's min
  }
  b = block_min(b);
  if (threadIdx.x == 0) {
    b = d ? b : 0;
    records[4 * i + 0] = a;
    records[4 * i + 1] = b;
    records[4 * i + 2] = m;
    records[4 * i + 3] = d;
    state[S_A] = a;
    state[S_B] = b;
    state[S_NEW] = new_id;
    state[S_DO] = d;
    state[S_DONE] = (i == 0 ? init_done : state[S_DONE]) || !d;
  }
  for (int c = threadIdx.x; c < v; c += blockDim.x) {
    dl[c] = 0;
    dr[c] = 0;
  }
}

// _select_and_apply + _slot_delta_accum (bpe_hist.py:141-248): one
// column per thread (merge_column.cuh).
template <int L>
__global__ void corpus_kernel(int16_t* __restrict__ tw,
                              const int* __restrict__ wcount, int W,
                              const int* __restrict__ state,
                              int* __restrict__ dl, int* __restrict__ dr,
                              int unk) {
  if (!state[S_DO]) return;
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= W) return;
  merge_column<L>(tw, W, col, state[S_A], state[S_B], state[S_NEW], unk,
                  wcount, dl, dr);
}

// apply_hist_updates (bpe_hist.py:251-259) and the row-max refresh
// (:549-571).  Rows with dl[r] == 0 other than a, b and new keep their
// values and their maximum.
__global__ void update_kernel(int* __restrict__ hist, int v,
                              const int* __restrict__ dl,
                              const int* __restrict__ dr,
                              const int* __restrict__ state,
                              int* __restrict__ rowmax) {
  if (!state[S_DO]) return;
  const int r = blockIdx.x;
  const int a = state[S_A], b = state[S_B], nw = state[S_NEW];
  const int dlr = dl[r];
  const bool rb = r == b, rn = r == nw;
  if (dlr == 0 && r != a && !rb && !rn) return;
  int* row = hist + (size_t)r * v;
  int m = INT_MIN;
  for (int c = threadIdx.x; c < v; c += blockDim.x) {
    const int h0 = row[c];
    int h = h0;
    if (c == a) h -= dlr;
    if (c == nw) h += dlr;
    if (rb) h -= dr[c];
    if (rn) h += dr[c];
    if (r == a && c == b) h = 0;
    if (h != h0) row[c] = h;
    m = max(m, h);
  }
  m = block_max(m);
  if (threadIdx.x == 0) rowmax[r] = m;
}

}  // namespace

extern "C" {

const char* shred_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Runs `steps` merges of the fused hist engine on `stream`.  tw int16
// [L, W], wcount int32 [W], hist int32 [v, v] are updated in place;
// rowmax/dl/dr int32 [v] and state int32 [S_LEN] are scratch; records
// int32 [steps, 4] receives (a, b, freq, did) per step.  Returns the
// first CUDA error of a launch, or 0.
int shred_hist_fused_train(int16_t* tw, const int* wcount, int* hist,
                           int* rowmax, int* dl, int* dr, int* state,
                           int* records, int L, int W, int v, int steps,
                           int unk, int min_freq, int n_done, int init_done,
                           int allowed, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (L != 16 && L != 32 && L != 64) return (int)cudaErrorInvalidValue;
  rowmax_kernel<<<v, UPDATE_THREADS, 0, s>>>(hist, v, rowmax);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int col_blocks = (W + CORPUS_THREADS - 1) / CORPUS_THREADS;
  for (int i = 0; i < steps; ++i) {
    const int new_id = 256 + n_done + i;
    pick_kernel<<<1, PICK_THREADS, 0, s>>>(hist, rowmax, v, i, new_id,
                                           min_freq, allowed, init_done,
                                           state, records, dl, dr);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    if (L == 16)
      corpus_kernel<16><<<col_blocks, CORPUS_THREADS, 0, s>>>(
          tw, wcount, W, state, dl, dr, unk);
    else if (L == 32)
      corpus_kernel<32><<<col_blocks, CORPUS_THREADS, 0, s>>>(
          tw, wcount, W, state, dl, dr, unk);
    else
      corpus_kernel<64><<<col_blocks, CORPUS_THREADS, 0, s>>>(
          tw, wcount, W, state, dl, dr, unk);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    // rows above new hold no pair yet and are never a, b or new
    const int rows = new_id + 1 < v ? new_id + 1 : v;
    update_kernel<<<rows, UPDATE_THREADS, 0, s>>>(hist, v, dl, dr, state,
                                                  rowmax);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // extern "C"
