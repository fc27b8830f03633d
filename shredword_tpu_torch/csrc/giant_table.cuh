// The lazily bounded pair table and the presence-indexed corpus of the
// giant kernels (giant.cu, K3; giant_sharded.cu, G1): one copy of what
// both do alike, included by each.
//
//   - bounds int32 [n]: an UPPER BOUND on each row's maximum, confirmed
//     lazily by the pick (the analogue of the reference's lazy heap,
//     bpe.cpp:406-415), with one exact 64-bit key per group of 32 rows
//     (the largest bound, then the smallest row holding it, as max_key):
//     the pick reads n / 32 group keys, one load each, instead of n
//     bounds.  Thresholding commutes with the maximum, so the smallest
//     row of the largest thresholded key is the row a flat scan finds.
//     Bound increases go to the keys by atomicMax; the rows whose bound
//     is set or lowered have their groups recomputed (regroup);
//   - the pick's read of the claimed row is spread over the grid with
//     16-byte loads and yields the maximum and its first column in one
//     key, so the confirming read also gives b;
//   - the corpus: words sorted by length into chunks of cw columns and
//     an exact int8 presence index presT [v, NC]; a merge reads only the
//     chunks that hold both ids, each block compacting the flagged chunk
//     ids itself, and rewrites the presence of a, b and new in the chunks
//     that matched after a grid barrier.
// Data written by other blocks of the same launch is read through L2:
// the files are built with -dlcm=cg, and grid.sync() orders the phases.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_reduce.cuh"
#include "merge_column.cuh"

namespace shred {

constexpr int GIANT_THREADS = 256;  // threads a block of the giant kernels
constexpr int GIANT_WARPS = GIANT_THREADS / 32;
constexpr int GROUP = 32;           // rows per group key: one warp's lanes

// chunk bits of the corpus pass
constexpr int CB_MATCHED = 1, CB_HAS_A = 2, CB_HAS_B = 4;

__device__ __forceinline__ int thresh(int x, int min_freq) {
  return x >= min_freq ? x : 0;
}

// A phase clock that counts nothing (phase_clock.cuh's PhaseClock counts).
struct NoClock {
  __device__ void mark(int) {}
};

// The key of group g of the n rows: max_key of its largest bound and the
// smallest row that holds it.  regroup rewrites the keys of the groups of
// rows r[k] (r[k] < 0: none), row r[k] taken as val[k] whatever bounds
// holds; warp 0 of the block, all groups' loads at once.  Every block
// writes the same values.
__device__ __forceinline__ void regroup(const int* bounds,
                                        unsigned long long* gkey,
                                        const int (&r)[3], const int (&val)[3],
                                        int n) {
  const int lane = threadIdx.x & 31;
  int x[3];
#pragma unroll
  for (int k = 0; k < 3; ++k)
    x[k] = r[k] >= 0 ? bounds[r[k] / GROUP * GROUP + lane] : 0;
#pragma unroll
  for (int k = 0; k < 3; ++k)
    if (r[k] >= 0) {
      const int row = r[k] / GROUP * GROUP + lane;
#pragma unroll
      for (int q = 0; q < 3; ++q)
        if (row == r[q]) x[k] = val[q];
      const unsigned long long key = warp_max_u64(max_key(x[k], row, n));
      if (lane == 0) gkey[r[k] / GROUP] = key;
    }
}

// Every group key of the n bounds (n a multiple of GROUP), over the grid.
__device__ __forceinline__ void init_group_keys(const int* bounds,
                                                unsigned long long* gkey,
                                                int n, int gtid,
                                                int nthreads) {
  for (int g = gtid; g < n / GROUP; g += nthreads) {
    unsigned long long k = 0ull;
    for (int r = g * GROUP; r < (g + 1) * GROUP; ++r)
      k = umax64(k, max_key(bounds[r], r, n));
    gkey[g] = k;
  }
}

struct LazyPick {
  int m;          // the pick's count; <= 0: nothing to merge
  int a, b;       // its row (of the n) and column
  int n_refresh;  // row reads
};

// The lazy pick (bpe_giant.py:327-368) over rows [0, n_live) of the
// table hist [n, v] (row r at hist + r * v, live columns < lim), every
// block alike: the largest thresholded bound (smallest row on ties); read
// that row over the grid; if its true maximum differs, store it as the
// row's bound and repeat.  keys [3] are the row reads' keys, used in turn
// (t counts the reads of the launch: slot t % 3 is zero when read t
// starts); one grid barrier per read.  clk marks ph_pick, ph_read and
// ph_sync around each read.
template <class Clock>
__device__ __forceinline__ LazyPick lazy_pick(
    cooperative_groups::grid_group& grid, const int* hist, int* bounds,
    unsigned long long* gkey, unsigned long long* keys, unsigned& t,
    int n_live, int lim, int v, int n, int min_freq, Clock& clk,
    int ph_pick, int ph_read, int ph_sync) {
  __shared__ int s_m, s_a;
  __shared__ unsigned long long s_key;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = gridDim.x * blockDim.x;
  const int gtid = blockIdx.x * blockDim.x + tid;
  const auto same = [](int, int h) { return h; };
  int m = 0, a = 0, b = 0, n_refresh = 0;
  for (;;) {
    ++n_refresh;
    const int ng = (n_live + GROUP - 1) / GROUP;
    unsigned long long best = 0ull;
    for (int g = tid; g < ng; g += blockDim.x) {
      const unsigned long long gk = gkey[g];
      best = umax64(best, max_key(thresh(key_val(gk), min_freq),
                                  key_idx(gk, n), n));
    }
    best = block_max_u64(best);
    if (tid == 0) {
      s_m = key_val(best);
      s_a = key_idx(best, n);
    }
    __syncthreads();
    m = s_m;
    if (m <= 0) break;
    a = s_a;
    clk.mark(ph_pick);
    // the row read, spread over the grid: (max, first column) as a key
    unsigned long long* key = keys + t % 3;
    if (gtid == 0) keys[(t + 1) % 3] = 0ull;  // last read two reads ago
    const unsigned long long k = block_max_u64(row_max_key(
        hist + (size_t)a * v, lim, v, gtid, nthreads, same));
    if (tid == 0 && k) atomicMax(key, k);
    clk.mark(ph_read);
    grid.sync();
    clk.mark(ph_sync);
    ++t;
    // one load of the key per block: a line that every thread loads at
    // once queues at its L2 slice
    if (tid == 0) s_key = *key;
    __syncthreads();
    const unsigned long long row_key = s_key;
    const int true_max = key_val(row_key);
    if (true_max == m) {
      b = key_idx(row_key, v);
      break;
    }
    if (warp == 0) {  // refresh the bound, retry
      regroup(bounds, gkey, {a, -1, -1}, {true_max, 0, 0}, n);
      if (lane == 0) bounds[a] = true_max;
    }
    __syncthreads();
  }
  return LazyPick{m, a, b, n_refresh};
}

// The corpus pass of merge (a, b) -> nw (bpe_giant.py:375-518) over tw
// [L, W] (T int16_t or int32_t; chunk c is the columns [c * cw, (c + 1) *
// cw), cw a multiple of GIANT_THREADS): the chunks c < nc_used whose
// presence holds a and b, in units of GIANT_THREADS columns; unit u of
// the merge goes to block u % G.  Deltas into dl/dr; each flagged chunk's
// CB_ bits into bits[c].
template <int L, class T>
__device__ __forceinline__ void flagged_pass(
    T* tw, const int* wcount, const int8_t* presT, int* bits, int W,
    int NC, int cw, int nc_used, int a, int b, int nw, int unk, int* dl,
    int* dr) {
  __shared__ int s_warp[GIANT_WARPS];
  __shared__ int s_list[GIANT_THREADS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = gridDim.x;
  const int per_chunk = cw / GIANT_THREADS;
  int base = 0;
  for (int w0 = 0; w0 < nc_used; w0 += GIANT_THREADS) {
    const int c = w0 + tid;
    const bool flagged = c < nc_used && presT[(size_t)a * NC + c] &&
                         presT[(size_t)b * NC + c];
    const unsigned bal = __ballot_sync(0xffffffffu, flagged);
    if (lane == 0) s_warp[warp] = __popc(bal);
    __syncthreads();
    int before = 0, n_flagged = 0;
    for (int w = 0; w < GIANT_WARPS; ++w) {
      before += w < warp ? s_warp[w] : 0;
      n_flagged += s_warp[w];
    }
    if (flagged) s_list[before + __popc(bal & ((1u << lane) - 1u))] = c;
    __syncthreads();
    const int units = n_flagged * per_chunk;
    for (int u = ((int)blockIdx.x - base % G + G) % G; u < units; u += G) {
      const int chunk = s_list[u / per_chunk];
      const int col = chunk * cw + (u % per_chunk) * GIANT_THREADS + tid;
      const int r = merge_column<L>(tw, W, col, a, b, nw, unk, wcount, dl,
                                    dr);
      // every unit of a flagged chunk reports, matched or not: a and b
      // must be looked for in the whole chunk after the merge
      const int cb = (__syncthreads_or(r & MC_MATCHED) ? CB_MATCHED : 0) |
                     (__syncthreads_or(r & MC_HAS_A) ? CB_HAS_A : 0) |
                     (__syncthreads_or(r & MC_HAS_B) ? CB_HAS_B : 0);
      if (tid == 0 && cb) atomicOr(&bits[chunk], cb);
    }
    base += units;
    __syncthreads();  // s_warp and s_list are rewritten next window
  }
}

// After the corpus pass of merge (a, b) -> nw and a grid barrier: the
// presence rows a, b and new of the chunks that matched
// (bpe_giant.py:520-540), and the chunk bits zeroed for the next merge.
__device__ __forceinline__ void presence_update(int8_t* presT, int* bits,
                                                int NC, int nc_used, int a,
                                                int b, int nw, int gtid,
                                                int nthreads) {
  for (int c = gtid; c < nc_used; c += nthreads) {
    const int x = bits[c];
    if (!x) continue;
    bits[c] = 0;
    if (x & CB_MATCHED) {
      presT[(size_t)a * NC + c] = (x & CB_HAS_A) ? 1 : 0;
      presT[(size_t)b * NC + c] = (x & CB_HAS_B) ? 1 : 0;
      presT[(size_t)nw * NC + c] = 1;
    }
  }
}

}  // namespace shred
