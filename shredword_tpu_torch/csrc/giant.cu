// Giant-vocab BPE merge loop for Hopper (sm_90a): vocab up to 32768.
//
// Replaces the TPU kernel shredword_tpu/ops/bpe_giant.py::_giant_kernel
// (make_giant_train).  State, all in device memory and updated in place:
//   hist    int32 [v, v] exact pair counts (4.3 GB at v 32768; offsets
//           are size_t throughout)
//   rowmax  int32 [v] an UPPER BOUND on each row's maximum, confirmed
//           lazily by the pick (the analogue of the reference's lazy heap,
//           bpe.cpp:406-415)
//   tw      int16 [L, W] one word per column, words sorted by length into
//           chunks of cw columns; wcount int32 [W]
//   presT   int8 [v, NC] exact presence of each id in each chunk
//
// One C call runs `steps` merges and enqueues four kernels per merge on
// the caller's stream; every per-merge scalar lives in a device state
// buffer, so the host never waits inside a call:
//   pick    one block: the lazy pick (bpe_giant.py:327-368) -- take the
//           largest thresholded bound (smallest row on ties), read that
//           row, and if its true maximum differs, store it as the row's
//           bound and repeat; then b, the (a, b, freq, did, n_refresh)
//           record, the sticky done flag, and the zeroing of dl/dr and
//           the per-chunk bits
//   corpus  the blocks of the chunks c < nc_used; a block whose chunk
//           does not hold both a and b (presT) exits at once.  One thread
//           per column runs merge_column.cuh (merge, compaction, int32
//           atomics into dl/dr) and the block ORs into the chunk's bits
//           whether it matched and whether a and b remain in it
//   rows    one thread per live column: row b -= dr (its maximum at this
//           point is row b's new bound), row new = dr, and the exact
//           maxima of the final rows new and a computed from dl/dr; the
//           presence rows a, b, new of the matched chunks (:520-540)
//   cols    one thread per live row r with dl[r] != 0: column a -= dl[r],
//           column new += dl[r]; cell (a, b) = 0 last; the bounds
//           rowmax = max(rowmax, dl), then the exact maxima of rows new
//           and a (:542-612)
// Ids above the merge's new id hold no pair yet, so every table scan is
// bounded by the live ids (lim = new + 1), not by v.  All counts are
// non-negative, which makes a maximum over the live columns (started at
// 0) equal to the maximum over all v columns.
//
// What bounds it on the H100: each merge is a serial chain of four
// launches, so it is bound by latency, not bandwidth.  The one-block pick
// -- a scan of up to 32768 bounds and one 128 KB row per retry -- takes
// most of the device time (about 60% at vocab 32768 on a 16 MB corpus);
// the corpus pass reads only the chunks the presence index flags, and the
// table passes touch O(v) words, all inside the 50 MB L2.  The design
// keeps every scan bounded by the live ids and the host out of the chain;
// a multi-block pick and a persistent kernel or a CUDA graph of the chain
// are the next steps.

#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>

#include "block_reduce.cuh"
#include "merge_column.cuh"

namespace {

using namespace shred;

constexpr int PICK_THREADS = 1024;
constexpr int CORPUS_THREADS = 256;
constexpr int TABLE_THREADS = 256;

// per-merge device state, written by pick and read by the later kernels
enum { S_A = 0, S_B, S_NEW, S_DO, S_DONE, S_MAXB, S_MAXNEW, S_MAXA, S_LEN };

// per-chunk bits, int32 [3, NC]
enum { CB_MATCHED = 0, CB_STILL_A, CB_STILL_B };

__global__ void __launch_bounds__(PICK_THREADS)
pick_kernel(const int* __restrict__ hist, int* rowmax, int v, int lim, int i,
            int new_id, int min_freq, int allowed, int init_done, int* state,
            int* __restrict__ records, int* __restrict__ dl,
            int* __restrict__ dr, int* __restrict__ bits, int n_bits) {
  __shared__ int s_a, s_m, s_stale;
  int a = 0, m = 0, n_refresh = 0;
  for (;;) {
    ++n_refresh;
    unsigned long long best = 0ull;
    for (int r = threadIdx.x; r < lim; r += blockDim.x) {
      const int rm = rowmax[r];
      const unsigned long long key = max_key(rm >= min_freq ? rm : 0, r, lim);
      best = key > best ? key : best;
    }
    best = block_max_u64(best);
    if (threadIdx.x == 0) {
      s_m = key_val(best);
      s_a = key_idx(best, lim);
    }
    __syncthreads();
    m = s_m;
    a = s_a;
    if (m <= 0) break;
    const int* row = hist + (size_t)a * v;
    int true_max = 0;
    for (int c = threadIdx.x; c < lim; c += blockDim.x)
      true_max = max(true_max, row[c]);
    true_max = block_max(true_max);
    if (threadIdx.x == 0) {
      s_stale = true_max != m;
      if (true_max != m) rowmax[a] = true_max;  // refresh the bound, retry
    }
    __syncthreads();
    if (!s_stale) break;
  }
  const int done = i == 0 ? init_done : state[S_DONE];
  const int d = (m > 0) && !done && (i < allowed);
  int b = INT_MAX;
  if (d) {
    const int* row = hist + (size_t)a * v;
    for (int c = threadIdx.x; c < lim; c += blockDim.x)
      if (row[c] == m) { b = c; break; }  // strided: first hit is this thread's min
  }
  b = block_min(b);
  if (threadIdx.x == 0) {
    records[5 * i + 0] = d ? a : 0;
    records[5 * i + 1] = d ? b : 0;
    records[5 * i + 2] = m;
    records[5 * i + 3] = d;
    records[5 * i + 4] = n_refresh;
    state[S_A] = d ? a : 0;
    state[S_B] = d ? b : 0;
    state[S_NEW] = new_id;
    state[S_DO] = d;
    state[S_DONE] = done || !d;
    state[S_MAXB] = 0;
    state[S_MAXNEW] = 0;
    state[S_MAXA] = 0;
  }
  if (d) {
    for (int c = threadIdx.x; c < lim; c += blockDim.x) {
      dl[c] = 0;
      dr[c] = 0;
    }
    for (int c = threadIdx.x; c < n_bits; c += blockDim.x) bits[c] = 0;
  }
}

// bpe_giant.py:375-518 with kb = 1: cw / CORPUS_THREADS blocks per chunk.
template <int L>
__global__ void corpus_kernel(int16_t* __restrict__ tw,
                              const int* __restrict__ wcount, int W, int cw,
                              int NC, const int8_t* __restrict__ presT,
                              const int* __restrict__ state,
                              int* __restrict__ dl, int* __restrict__ dr,
                              int unk, int* __restrict__ bits) {
  if (!state[S_DO]) return;
  const int per_chunk = cw / CORPUS_THREADS;
  const int c = blockIdx.x / per_chunk;
  const int a = state[S_A], b = state[S_B];
  if (!(presT[(size_t)a * NC + c] && presT[(size_t)b * NC + c])) return;
  const int col = c * cw + (blockIdx.x % per_chunk) * CORPUS_THREADS +
                  threadIdx.x;
  const int r = merge_column<L>(tw, W, col, a, b, state[S_NEW], unk, wcount,
                                dl, dr);
  // every block of a flagged chunk reports, matched or not: a and b must
  // be looked for in the whole chunk after the merge
  const int matched = __syncthreads_or(r & MC_MATCHED);
  const int has_a = __syncthreads_or(r & MC_HAS_A);
  const int has_b = __syncthreads_or(r & MC_HAS_B);
  if (threadIdx.x == 0) {
    if (matched) atomicOr(&bits[CB_MATCHED * NC + c], 1);
    if (has_a) atomicOr(&bits[CB_STILL_A * NC + c], 1);
    if (has_b) atomicOr(&bits[CB_STILL_B * NC + c], 1);
  }
}

// Table steps 1 and 2 (bpe_giant.py:544-562), the exact maxima that the
// bound rules of step 5 need, and the presence rewrite (:520-540).
__global__ void rows_kernel(int* __restrict__ hist, int v, int lim,
                            const int* __restrict__ dl,
                            const int* __restrict__ dr, int* state,
                            int8_t* __restrict__ presT, int NC, int nc_used,
                            const int* __restrict__ bits) {
  if (!state[S_DO]) return;
  const int a = state[S_A], b = state[S_B], nw = state[S_NEW];
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  int max_b = 0, max_new = 0, max_a = 0;
  if (c < lim) {
    const int dla = dl[a], dln = dl[nw], d = dr[c];
    int* row_b = hist + (size_t)b * v;
    const int hb = row_b[c] - d;  // 1. row b -= dr
    if (d != 0) row_b[c] = hb;
    hist[(size_t)nw * v + c] = d;  // 2. row new = dr
    max_b = hb;
    // final row new: dr, then column a -= dl[new], column new += dl[new]
    max_new = d + (c == nw ? dln : 0) - (c == a ? dln : 0);
    // final row a: after steps 1 and 3, with cell (a, b) zeroed
    const int ha = (a == b ? hb : hist[(size_t)a * v + c]) -
                   (c == a ? dla : 0) + (c == nw ? dla : 0);
    max_a = c == b ? 0 : ha;
  }
  max_b = block_max(max_b);
  max_new = block_max(max_new);
  max_a = block_max(max_a);
  if (threadIdx.x == 0) {
    atomicMax(&state[S_MAXB], max_b);
    atomicMax(&state[S_MAXNEW], max_new);
    atomicMax(&state[S_MAXA], max_a);
  }
  // presence rows a, b, new of the chunks that matched, in that order
  if (c < nc_used && bits[CB_MATCHED * NC + c]) {
    presT[(size_t)a * NC + c] = (int8_t)bits[CB_STILL_A * NC + c];
    presT[(size_t)b * NC + c] = (int8_t)bits[CB_STILL_B * NC + c];
    presT[(size_t)nw * NC + c] = 1;
  }
}

// Table steps 3-5 (bpe_giant.py:564-612), one thread per live row.
__global__ void cols_kernel(int* __restrict__ hist, int v, int lim,
                            const int* __restrict__ dl,
                            const int* __restrict__ state,
                            int* __restrict__ rowmax) {
  if (!state[S_DO]) return;
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= lim) return;
  const int a = state[S_A], b = state[S_B], nw = state[S_NEW];
  const int d = dl[r];
  int* row = hist + (size_t)r * v;
  if (d != 0) {
    row[a] -= d;   // 3. column a -= dl
    row[nw] += d;  //    column new += dl
  }
  const int old = rowmax[r];
  int rm = r == b ? state[S_MAXB] : old;  // set by step 1
  rm = max(rm, d);                        // 5. bounds
  if (r == nw) rm = state[S_MAXNEW];
  if (r == a) {
    row[b] = 0;                           // 4. merged cell, last
    rm = state[S_MAXA];
  }
  if (rm != old) rowmax[r] = rm;
}

}  // namespace

extern "C" {

// Runs `steps` merges of the giant engine on `stream`.  tw int16 [L, W],
// wcount int32 [W], hist int32 [v, v], presT int8 [v, NC] and rowmax
// int32 [v] are updated in place; dl/dr int32 [v], bits int32 [3 * NC]
// and state int32 [S_LEN] are scratch; records int32 [steps, 5] receives
// (a, b, freq, did, n_refresh) per step.  Chunk c covers the columns
// [c * cw, (c + 1) * cw); only chunks c < nc_used hold words.  Returns the
// first CUDA error of a launch, or 0.
int shred_giant_train(int16_t* tw, const int* wcount, int* hist,
                      int8_t* presT, int* rowmax, int* dl, int* dr,
                      int* bits, int* state, int* records, int L, int W,
                      int v, int NC, int cw, int nc_used, int steps, int unk,
                      int min_freq, int n_done, int init_done, int allowed,
                      void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if ((L != 16 && L != 32 && L != 64) || cw % CORPUS_THREADS != 0 ||
      (long long)NC * cw != W || nc_used < 1 || nc_used > NC)
    return (int)cudaErrorInvalidValue;
  const int corpus_blocks = nc_used * (cw / CORPUS_THREADS);
  for (int i = 0; i < steps; ++i) {
    const int new_id = 256 + n_done + i;
    const int lim = new_id + 1 < v ? new_id + 1 : v;
    pick_kernel<<<1, PICK_THREADS, 0, s>>>(hist, rowmax, v, lim, i, new_id,
                                           min_freq, allowed, init_done,
                                           state, records, dl, dr, bits,
                                           3 * NC);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    if (L == 16)
      corpus_kernel<16><<<corpus_blocks, CORPUS_THREADS, 0, s>>>(
          tw, wcount, W, cw, NC, presT, state, dl, dr, unk, bits);
    else if (L == 32)
      corpus_kernel<32><<<corpus_blocks, CORPUS_THREADS, 0, s>>>(
          tw, wcount, W, cw, NC, presT, state, dl, dr, unk, bits);
    else
      corpus_kernel<64><<<corpus_blocks, CORPUS_THREADS, 0, s>>>(
          tw, wcount, W, cw, NC, presT, state, dl, dr, unk, bits);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    const int rows_n = lim > nc_used ? lim : nc_used;
    rows_kernel<<<(rows_n + TABLE_THREADS - 1) / TABLE_THREADS,
                  TABLE_THREADS, 0, s>>>(hist, v, lim, dl, dr, state, presT,
                                         NC, nc_used, bits);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    cols_kernel<<<(lim + TABLE_THREADS - 1) / TABLE_THREADS, TABLE_THREADS,
                  0, s>>>(hist, v, lim, dl, state, rowmax);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // extern "C"
