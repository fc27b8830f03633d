// The row-sharded giant merge step for Hopper (sm_90a): vocab up to 65536
// over the ranks of a torch.distributed group, two launches per merge.
//
// Replaces the per-merge body of shredword_tpu/parallel/giant.py
// (shard_body of build_sharded_giant_loop, with _select_apply and
// _local_deltas), XLA in the JAX package.  State of one rank, in device
// memory and updated in place:
//   hist    int32 [rows, v]: global rows [base, base + rows) of the exact
//           pair table (17.2 GB at v 65536 on one rank; offsets are size_t)
//   bounds  int32 [rows]: an UPPER BOUND on each own row's maximum,
//           confirmed lazily by the pick, as giant.cu keeps them
//   tw      int32 [L, W]: this rank's word columns (merged ids pass 32767)
// Per merge i of a call, on the current stream:
//   launch A (apply_pick_kernel, cooperative): apply merge i - 1's
//     reduced deltas dl | dr to the own rows in apply_hist_updates order
//     (column a -= dl, column new += dl, row b -= dr, row new += dr, cell
//     (a, b) = 0 on a's owner), then the own rows' bounds; grid barrier;
//     zero dl | dr; block 0 takes the lex-first local pick through the
//     bounds (the largest thresholded bound, smallest row; its row read
//     confirms it or refreshes the bound) and writes one 64-bit key
//     (freq << 32) | ((65535 - a) << 16) | (65535 - b), freq 0 below
//     min_freq;
//   the host's all_reduce(MAX) of the key over the ranks;
//   launch B (merge_kernel): decode the key (freq 0: done), record the
//     merge, and merge (a, b) -> new over this rank's columns (greedy left
//     to right, compaction, dl/dr accounting of bpe.cpp:437-470:
//     merge_column.cuh), one thread per column;
//   the host's all_reduce(SUM) of dl | dr.
// Launch A of step `steps` applies the call's last merge only, so a call
// is 2 * steps + 1 launches and nothing waits for the device inside it.
//
// What bounds it on the H100: little work per merge -- the corpus pass
// reads L * W * 4 bytes (5.1 MB on one rank of the 16 MB bench corpus),
// the apply touches two cells of each own row with dl != 0 and three whole
// rows -- so the host does: two launches and two collectives to enqueue
// per merge.  This first version keeps every step simple: block 0 alone
// scans the bounds and reads a row in the pick (a few microseconds at v
// 65536), blocks 0-2 rewrite rows a, new and b; a CUDA graph of the chain
// and giant.cu's presence skipping are later work.
// Data written by other blocks of the same launch is read through L2: the
// file is built with -dlcm=cg, and grid.sync() orders the phases.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_reduce.cuh"
#include "hist_table.cuh"
#include "merge_column.cuh"

namespace {

using namespace shred;

constexpr int THREADS = TABLE_THREADS;

// the step's state, written by launch B for the launches after it
enum { ST_A, ST_B, ST_NEW, ST_DONE, ST_LEN };
constexpr int REC = 5;  // record: (a, b, freq, did, n_refresh)

struct ShardArgs {
  int32_t* tw;           // [L, W] this rank's columns
  const int* wcount;     // [W]
  int* hist;             // [rows, v] global rows [base, base + rows)
  int* bounds;           // [rows]
  int* d;                // [2v]: dl | dr
  long long* key;        // [1]: the pick's key, all-reduced (MAX)
  int* state;            // [ST_LEN]
  int* records;          // [steps, REC]
  int W, rows, v, base, steps, unk, min_freq, n_done, init_done, allowed;
};

__device__ __forceinline__ int thresh(int x, int min_freq) {
  return x >= min_freq ? x : 0;
}

// Launch i <= steps: apply merge i - 1 (when it happened); for i < steps
// also zero dl | dr and write the local pick of merge i.
__global__ void __launch_bounds__(THREADS)
apply_pick_kernel(ShardArgs p, int i) {
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const int v = p.v, rows = p.rows, base = p.base, tid = threadIdx.x;
  const int nthreads = gridDim.x * THREADS;
  const int gtid = blockIdx.x * THREADS + tid;
  if (i > 0) {
    const volatile int* st = p.state;
    if (st[ST_DONE]) return;  // the same in every block
    const int a = st[ST_A], b = st[ST_B], nw = st[ST_NEW];
    const int lim = nw + 1 < v ? nw + 1 : v;  // ids above new hold no pair
    const int* dl = p.d;
    const int* dr = p.d + v;
    // rows a, new and b, where this rank owns them: blocks 0, 1 and 2
    // rewrite one each, 16 bytes a thread, and set its bound exactly
    const int which = blockIdx.x;
    const int sr = which == 0 ? a : which == 1 ? nw
                   : which == 2 && b != a ? b : -1;
    if (sr >= base && sr < base + rows) {
      int* row = p.hist + (size_t)(sr - base) * v;
      const int dls = dl[sr];
      unsigned long long best = 0ull;
      for (int q = tid; q < (lim + 3) >> 2; q += THREADS) {
        const int c0 = q << 2;
        int4* cell = reinterpret_cast<int4*>(row + c0);
        const int4 x0 = *cell;
        const int4 d4 = *reinterpret_cast<const int4*>(dr + c0);
        const int h0[4] = {x0.x, x0.y, x0.z, x0.w};
        const int dv[4] = {d4.x, d4.y, d4.z, d4.w};
        int h[4];
        bool changed = false;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = c0 + e;
          int y = h0[e] - (c == a ? dls : 0) + (c == nw ? dls : 0);
          if (sr == b) y -= dv[e];
          if (sr == nw) y += dv[e];
          if (sr == a && c == b) y = 0;
          h[e] = y;
          changed |= y != h0[e];
          best = umax64(best, max_key(y, c, v));
        }
        if (changed) *cell = make_int4(h[0], h[1], h[2], h[3]);
      }
      best = block_max_u64(best);
      if (tid == 0) p.bounds[sr - base] = key_val(best);
    }
    // every other own live row with dl != 0 changes in two cells; its
    // bound rises to the new cell (r, new) = dl[r] if that is larger
    const int nl = lim - base < rows ? lim - base : rows;
    for (int lr = gtid; lr < nl; lr += nthreads) {
      const int r = base + lr;
      const int dd = dl[r];
      if (dd == 0 || r == a || r == b || r == nw) continue;
      int* row = p.hist + (size_t)lr * v;
      const int ha = row[a], hn = row[nw], bound = p.bounds[lr];
      row[a] = ha - dd;
      row[nw] = hn + dd;
      if (dd > bound) p.bounds[lr] = dd;
    }
    if (i == p.steps) return;
    grid.sync();
  }
  for (int c = gtid; c < 2 * v; c += nthreads) p.d[c] = 0;  // for launch B
  if (blockIdx.x != 0) return;

  // the local pick of merge i (bpe_giant.py:327-368's lazy pick on the
  // own rows): every thread of block 0 alike
  __shared__ int s_m, s_a, s_b, s_true;
  const int lim = min(256 + p.n_done + i + 1, v);
  const int nl = max(0, min(lim - base, rows));
  const auto same = [](int, int h) { return h; };
  int n_refresh = 0;
  for (;;) {
    ++n_refresh;
    unsigned long long best = 0ull;
    const int4* b4 = reinterpret_cast<const int4*>(p.bounds);
    for (int q = tid; q < (nl + 3) >> 2; q += THREADS) {
      const int4 x = b4[q];
      const int r = q << 2;
      const int xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (r + e < nl)
          best = umax64(best, max_key(thresh(xs[e], p.min_freq), r + e,
                                      rows));
    }
    best = block_max_u64(best);
    if (tid == 0) {
      s_m = best ? key_val(best) : 0;
      s_a = key_idx(best, rows);
    }
    __syncthreads();
    const int m = s_m;
    if (m <= 0) break;
    const int la = s_a;
    const unsigned long long rk = block_max_u64(
        row_max_key(p.hist + (size_t)la * v, lim, v, tid, THREADS, same));
    if (tid == 0) {
      s_true = key_val(rk);
      s_b = key_idx(rk, v);
      if (s_true != m) p.bounds[la] = s_true;  // stale: refresh, retry
    }
    __syncthreads();
    if (s_true == m) break;
  }
  if (tid == 0) {
    const int m = s_m;
    *p.key = m > 0 ? (long long)(((unsigned long long)m << 32) |
                                 ((unsigned)(65535 - (base + s_a)) << 16) |
                                 (unsigned)(65535 - s_b))
                   : 0ll;
    p.records[REC * i + 4] = n_refresh;
    if (i == 0) p.state[ST_DONE] = 0;
  }
}

// Launch B of merge i: the global pick from the reduced key, the record,
// and the merge over this rank's columns into dl | dr.
template <int L>
__global__ void __launch_bounds__(THREADS) merge_kernel(ShardArgs p, int i) {
  const volatile int* st = p.state;
  if (st[ST_DONE]) return;
  const long long key = *(const volatile long long*)p.key;
  const int m = (int)(key >> 32);
  const int a = 65535 - (int)((key >> 16) & 0xffff);
  const int b = 65535 - (int)(key & 0xffff);
  const int nw = 256 + p.n_done + i;
  const int gtid = blockIdx.x * THREADS + threadIdx.x;
  if (!(m > 0 && !p.init_done && i < p.allowed)) {
    // nothing changes any more: every later step is not merged
    if (blockIdx.x == 0) {
      for (int j = i + (int)threadIdx.x; j < p.steps; j += THREADS) {
        int* rec = p.records + REC * j;
        rec[0] = rec[1] = rec[3] = 0;
        rec[2] = m;
        if (j > i) rec[4] = 0;
      }
      if (threadIdx.x == 0) p.state[ST_DONE] = 1;
    }
    return;
  }
  if (gtid == 0) {
    int* rec = p.records + REC * i;
    rec[0] = a;
    rec[1] = b;
    rec[2] = m;
    rec[3] = 1;
    p.state[ST_A] = a;
    p.state[ST_B] = b;
    p.state[ST_NEW] = nw;
  }
  if (gtid < p.W)
    merge_column<L>(p.tw, p.W, gtid, a, b, nw, p.unk, p.wcount, p.d,
                    p.d + p.v);
}

}  // namespace

extern "C" {

// Launch A of step i (0 <= i <= steps) of a call on this rank's row shard:
// hist int32 [rows, v] (global rows [base, base + rows)) and bounds int32
// [rows] in place, d int32 [2v] (dl | dr, all-reduced by the caller after
// launch B), key int64 [1] (all-reduced MAX by the caller before launch
// B), state int32 [4], records int32 [steps, 5] (a, b, freq, did,
// n_refresh).  v and rows multiples of 4, v <= 65536.  Returns the
// launch's CUDA error, or 0.
int shred_giant_sharded_apply_pick(int* hist, int* bounds, int* d,
                                   long long* key, int* state, int* records,
                                   int rows, int v, int base, int i,
                                   int steps, int min_freq, int n_done,
                                   void* stream) {
  if (v % 4 || rows % 4 || v > 65536 || rows > v || base < 0 ||
      base + rows > v || i < 0 || i > steps)
    return (int)cudaErrorInvalidValue;
  ShardArgs p{};
  p.hist = hist;
  p.bounds = bounds;
  p.d = d;
  p.key = key;
  p.state = state;
  p.records = records;
  p.rows = rows;
  p.v = v;
  p.base = base;
  p.steps = steps;
  p.min_freq = min_freq;
  p.n_done = n_done;
  return (int)coop_launch<apply_pick_kernel>((cudaStream_t)stream, &p, &i);
}

// Launch B of step i < steps: merges the pick of the reduced key over this
// rank's tw int32 [L, W] (in place; wcount int32 [W]) into d, with the
// buffers of shred_giant_sharded_apply_pick.  Returns the launch's CUDA
// error, or 0.
int shred_giant_sharded_merge(int32_t* tw, const int* wcount, int* d,
                              long long* key, int* state, int* records,
                              int L, int W, int v, int i, int steps,
                              int unk, int n_done, int init_done,
                              int allowed, void* stream) {
  if (v % 4 || v > 65536 || W < 1 || i < 0 || i >= steps)
    return (int)cudaErrorInvalidValue;
  ShardArgs p{};
  p.tw = tw;
  p.wcount = wcount;
  p.d = d;
  p.key = key;
  p.state = state;
  p.records = records;
  p.W = W;
  p.v = v;
  p.steps = steps;
  p.unk = unk;
  p.n_done = n_done;
  p.init_done = init_done;
  p.allowed = allowed;
  const dim3 grid((W + THREADS - 1) / THREADS);
  cudaStream_t s = (cudaStream_t)stream;
  if (L == 16)
    merge_kernel<16><<<grid, THREADS, 0, s>>>(p, i);
  else if (L == 32)
    merge_kernel<32><<<grid, THREADS, 0, s>>>(p, i);
  else if (L == 64)
    merge_kernel<64><<<grid, THREADS, 0, s>>>(p, i);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"
