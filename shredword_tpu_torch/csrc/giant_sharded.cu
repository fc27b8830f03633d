// The row-sharded giant merge loop for Hopper (sm_90a): vocab up to 65536
// over the ranks of a torch.distributed group.
//
// Replaces the per-merge body of shredword_tpu/parallel/giant.py
// (shard_body of build_sharded_giant_loop, with _select_apply and
// _local_deltas), XLA in the JAX package.  State of one rank, in device
// memory and updated in place:
//   hist    int32 [rows, v]: global rows [base, base + rows) of the exact
//           pair table (17.2 GB at v 65536 on one rank; offsets are size_t)
//   bounds  int32 [rows]: an UPPER BOUND on each own row's maximum,
//           confirmed lazily by the pick, with one exact key per group of
//           32 own rows (giant_table.cuh)
//   tw      int32 [L, W]: this rank's word columns (merged ids pass 32767),
//           sorted by length into NC chunks of cw columns; wcount [W]
//   presT   int8 [v, NC]: exact presence of each id in each own chunk
// A merge, on every rank alike: the lex-first local pick over the own
// rows (giant_table.cuh's lazy pick) as one 64-bit key (freq << 32) |
// ((65535 - a) << 16) | (65535 - b), freq 0 below min_freq; its maximum
// over the ranks; the merge over the own chunks that hold a and b
// (giant_table.cuh's flagged pass) into dl | dr; their sum over the ranks;
// then the update of the own rows in apply_hist_updates order (column a
// -= dl, column new += dl, row b -= dr, row new += dr, cell (a, b) = 0 on
// a's owner), the presence of a, b and new in the chunks that matched,
// and the bounds: an own row outside {a, b, new} rises to dl[r] where
// that is larger, own rows a, b and new take their exact maxima.
//
// Two forms of one call of `steps` merges, sharing the pick, the corpus
// pass (flagged_pass), the update (update_rows) and the bounds
// (set_bounds):
//   - alone (no reduce, world 1): sharded_train_kernel, one persistent
//     cooperative launch: per merge the pick, the corpus pass, a grid
//     barrier, the update, a grid barrier, the bounds -- giant.cu's
//     loop on a row shard;
//   - the chain (world > 1): per merge launch A (apply_pick_kernel,
//     cooperative: the previous merge's update with the reduced deltas,
//     a grid barrier, its bounds, then the pick into the key), the host's
//     all_reduce(MAX) of the key, launch B (merge_kernel: decode the key,
//     the record, the corpus pass) and the host's all_reduce(SUM) of
//     dl | dr; launch A of step `steps` applies the call's last merge
//     only, so a call is 2 * steps + 1 launches and nothing waits for the
//     device inside it.
// dl/dr and the bounds' slots are pairs used in turn, zeroed one merge
// ahead, so zeroing costs no barrier.
//
// What bounds it on the H100: as giant.cu, little work per merge in a
// serial chain, so the grid barriers and the dependent L2 round trips of
// the pick's row reads; in the chain, the host's two launches and two
// collectives per merge.
// Data written by other blocks of the same launch is read through L2: the
// file is built with -dlcm=cg, and grid.sync() orders the phases.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_reduce.cuh"
#include "giant_table.cuh"
#include "hist_table.cuh"
#include "merge_column.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace shred;

constexpr int THREADS = TABLE_THREADS;
static_assert(THREADS == GIANT_THREADS, "one block shape for both headers");

// the chain's state, written by launch B for the launches after it
enum { ST_A, ST_B, ST_NEW, ST_DONE, ST_LEN };
// per-merge maxima slots of the own rows a, new and b, two sets in turn
enum { SL_A = 0, SL_NEW, SL_B, SL_LEN };
constexpr int REC = 5;  // record: (a, b, freq, did, n_refresh)

struct ShardArgs {
  int32_t* tw;               // [L, W] this rank's columns, in chunks
  const int* wcount;         // [W]
  int* hist;                 // [rows, v] global rows [base, base + rows)
  int* bounds;               // [rows]
  int8_t* presT;             // [v, NC]
  int* d;                    // [2][2v]: dl | dr, two buffers used in turn
  unsigned long long* gkey;  // [rows / GROUP]: group keys
  unsigned long long* keys;  // [3]: row-read keys, used in turn
  long long* key;            // [1]: the pick's key (the chain reduces it)
  int* bits;                 // [NC]: per-chunk bits
  int* slots;                // [2 * SL_LEN]
  int* state;                // [ST_LEN]
  int* records;              // [steps, REC]
  int W, NC, cw, nc_used, rows, v, base, steps, unk, min_freq, n_done,
      init_done, allowed;
};

__device__ __forceinline__ bool owned(const ShardArgs& p, int r) {
  return r >= p.base && r < p.base + p.rows;
}

// own live rows of a merge whose live ids are < lim
__device__ __forceinline__ int live_rows(const ShardArgs& p, int lim) {
  return max(0, min(lim - p.base, p.rows));
}

// The start of a call, over the grid: group keys, both delta buffers,
// chunk bits, row-read keys and slots.
__device__ __forceinline__ void init_call(const ShardArgs& p, int gtid,
                                          int nthreads) {
  init_group_keys(p.bounds, p.gkey, p.rows, gtid, nthreads);
  for (int c = gtid; c < 4 * p.v; c += nthreads) p.d[c] = 0;
  for (int c = gtid; c < p.NC; c += nthreads) p.bits[c] = 0;
  if (gtid < 3) p.keys[gtid] = 0ull;
  if (gtid < 2 * SL_LEN) p.slots[gtid] = 0;
}

// The pick of merge i (all blocks alike), as the 64-bit key of a global
// pick; n_refresh into the record.
__device__ __forceinline__ unsigned long long pick(const ShardArgs& p,
                                                   cg::grid_group& grid,
                                                   int i, unsigned& t) {
  const int nw = 256 + p.n_done + i;
  const int lim = min(nw + 1, p.v);  // ids above new hold no pair
  NoClock clk;
  const LazyPick pk =
      lazy_pick(grid, p.hist, p.bounds, p.gkey, p.keys, t,
                live_rows(p, lim), lim, p.v, p.rows, p.min_freq, clk, 0, 0,
                0);
  if (blockIdx.x == 0 && threadIdx.x == 0)
    p.records[REC * i + 4] = pk.n_refresh;
  return pk.m > 0 ? ((unsigned long long)pk.m << 32) |
                        ((unsigned)(65535 - (p.base + pk.a)) << 16) |
                        (unsigned)(65535 - pk.b)
                  : 0ull;
}

// Merge i's global pick from its key: did it merge?  Writes the records
// (every later step: not merged), in block 0.
__device__ __forceinline__ bool record(const ShardArgs& p, int i,
                                       unsigned long long key, int& a,
                                       int& b) {
  const int m = (int)(key >> 32);
  a = 65535 - (int)((key >> 16) & 0xffff);
  b = 65535 - (int)(key & 0xffff);
  const bool merge = m > 0 && !p.init_done && i < p.allowed;
  if (blockIdx.x == 0) {
    if (merge) {
      if (threadIdx.x == 0) {
        int* rec = p.records + REC * i;
        rec[0] = a;
        rec[1] = b;
        rec[2] = m;
        rec[3] = 1;
      }
    } else {
      // nothing changes any more: no later step is merged
      for (int j = i + (int)threadIdx.x; j < p.steps; j += THREADS) {
        int* rec = p.records + REC * j;
        rec[0] = rec[1] = rec[3] = 0;
        rec[2] = m;
        if (j > i) rec[4] = 0;
      }
    }
  }
  return merge;
}

// The table update of merge j, (a, b) -> nw, on the own rows with the
// (reduced) deltas of buffer j & 1, over the grid; then the presence of
// the chunks that matched, the next merge's buffers and slots zeroed, and
// the exact maxima of the own rows a, new and b into slot set j & 1.
__device__ __forceinline__ void update_rows(const ShardArgs& p, int j,
                                            int a, int b, int nw) {
  const int v = p.v, rows = p.rows, base = p.base, tid = threadIdx.x;
  const int lane = tid & 31, nthreads = gridDim.x * THREADS;
  const int gtid = blockIdx.x * THREADS + tid;
  const int gwarp = gtid >> 5, nwarps = nthreads >> 5;
  const int lim = min(nw + 1, v);
  const int* dl = p.d + (size_t)(j & 1) * 2 * v;
  const int* dr = dl + v;
  // rows a, new (and b), where this rank owns them: every 16-byte group
  // of their live columns is one job of the grid
  const int n4 = (lim + 3) >> 2;
  const int n_rows = b == a ? 2 : 3;
  int max_a = -1, max_new = -1, max_b = -1;  // -1: no column here
  for (int q = gtid; q < n_rows * n4; q += nthreads) {
    const int which = q / n4, c0 = (q % n4) << 2;
    const int sr = which == 0 ? a : which == 1 ? nw : b;
    if (!owned(p, sr)) continue;
    int4* cell =
        reinterpret_cast<int4*>(p.hist + (size_t)(sr - base) * v + c0);
    const int4 x0 = *cell;
    const int4 d4 = *reinterpret_cast<const int4*>(dr + c0);
    const int dls = dl[sr];
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
      if (which == 0) max_a = max(max_a, y);
      if (which == 1) max_new = max(max_new, y);
      if (which == 2) max_b = max(max_b, y);
    }
    if (changed) *cell = make_int4(h[0], h[1], h[2], h[3]);
  }
  // every other own live row with dl != 0 changes in two cells; its
  // bound rises to the new cell (r, new) = dl[r] if that is larger.  One
  // group of rows per warp, from the grid's last warp down (the jobs
  // above start at block 0), and one atomicMax per group key.
  const int nl = live_rows(p, lim);
  for (int r0 = (nwarps - 1 - gwarp) * GROUP; r0 < nl;
       r0 += nwarps * GROUP) {
    const int lr = r0 + lane, r = base + lr;
    const int dd = lr < nl ? dl[r] : 0;
    unsigned long long up = 0ull;
    if (dd != 0 && r != a && r != b && r != nw) {
      int* row = p.hist + (size_t)lr * v;
      const int ha = row[a], hn = row[nw], bound = p.bounds[lr];  // at once
      row[a] = ha - dd;
      row[nw] = hn + dd;
      if (dd > bound) {
        p.bounds[lr] = dd;
        up = max_key(dd, lr, rows);
      }
    }
    up = warp_max_u64(up);
    if (lane == 0 && up) atomicMax(&p.gkey[r0 / GROUP], up);
  }
  presence_update(p.presT, p.bits, p.NC, p.nc_used, a, b, nw, gtid,
                  nthreads);
  // the other deltas and slots were last read by the previous merge;
  // the next merge adds at ids <= nw only
  int* next = p.d + (size_t)((j + 1) & 1) * 2 * v;
  for (int c = gtid; c < lim; c += nthreads) next[c] = next[v + c] = 0;
  if (gtid < SL_LEN) p.slots[((j + 1) & 1) * SL_LEN + gtid] = 0;
  // one atomic per row and per block that holds some of its columns
  int* slot = p.slots + (j & 1) * SL_LEN;
  unsigned long long mx[3] = {(unsigned)(max_a + 1), (unsigned)(max_new + 1),
                              (unsigned)(max_b + 1)};
  block_max_u64_n(mx);
  if (tid == 0) {
    if (mx[0]) atomicMax(&slot[SL_A], (int)mx[0] - 1);
    if (mx[1]) atomicMax(&slot[SL_NEW], (int)mx[1] - 1);
    if (mx[2]) atomicMax(&slot[SL_B], (int)mx[2] - 1);
  }
}

// After update_rows of merge j and a grid barrier: the own rows a, new
// and b take their exact maxima as bounds, and their groups are
// recomputed, every block alike.
__device__ __forceinline__ void set_bounds(const ShardArgs& p, int j, int a,
                                           int b, int nw) {
  if (threadIdx.x < 32) {
    const int* slot = p.slots + (j & 1) * SL_LEN;
    const int val[3] = {slot[SL_A], slot[SL_NEW], slot[SL_B]};
    const int r[3] = {owned(p, a) ? a - p.base : -1,
                      owned(p, nw) ? nw - p.base : -1,
                      b != a && owned(p, b) ? b - p.base : -1};
    regroup(p.bounds, p.gkey, r, val, p.rows);
    if (threadIdx.x == 0)
      for (int k = 0; k < 3; ++k)
        if (r[k] >= 0) p.bounds[r[k]] = val[k];
  }
  __syncthreads();
}

// The corpus pass of merge i, (a, b) -> nw, on this rank's chunks into
// delta buffer i & 1.
template <int L>
__device__ __forceinline__ void corpus(const ShardArgs& p, int i, int a,
                                       int b, int nw) {
  int* dl = p.d + (size_t)(i & 1) * 2 * p.v;
  flagged_pass<L>(p.tw, p.wcount, p.presT, p.bits, p.W, p.NC, p.cw,
                  p.nc_used, a, b, nw, p.unk, dl, dl + p.v);
}

// The call alone (no other rank): every merge in one launch.
template <int L>
__global__ void __launch_bounds__(THREADS)
sharded_train_kernel(ShardArgs p) {
  cg::grid_group grid = cg::this_grid();
  const int nthreads = gridDim.x * THREADS;
  const int gtid = blockIdx.x * THREADS + threadIdx.x;
  init_call(p, gtid, nthreads);
  grid.sync();
  unsigned t = 0;  // row reads so far in this call, the same in every block
  for (int i = 0; i < p.steps; ++i) {
    const int nw = 256 + p.n_done + i;
    int a, b;
    if (!record(p, i, pick(p, grid, i, t), a, b)) break;
    corpus<L>(p, i, a, b, nw);
    grid.sync();
    update_rows(p, i, a, b, nw);
    grid.sync();
    set_bounds(p, i, a, b, nw);
  }
}

// Launch A of step i <= steps of the chain: apply merge i - 1 (when it
// happened) with its reduced deltas; for i < steps also the local pick of
// merge i into the key.
__global__ void __launch_bounds__(THREADS)
apply_pick_kernel(ShardArgs p, int i) {
  cg::grid_group grid = cg::this_grid();
  const int nthreads = gridDim.x * THREADS;
  const int gtid = blockIdx.x * THREADS + threadIdx.x;
  int a = 0, b = 0, nw = 0;
  if (i == 0) {
    init_call(p, gtid, nthreads);
  } else {
    const volatile int* st = p.state;
    if (st[ST_DONE]) return;  // the same in every block
    a = st[ST_A];
    b = st[ST_B];
    nw = st[ST_NEW];
    update_rows(p, i - 1, a, b, nw);
    if (gtid < 3) p.keys[gtid] = 0ull;  // this launch's row reads
  }
  grid.sync();
  if (i > 0) set_bounds(p, i - 1, a, b, nw);
  if (i == p.steps) return;
  unsigned t = 0;
  const unsigned long long key = pick(p, grid, i, t);
  if (gtid == 0) {
    *p.key = (long long)key;
    if (i == 0) p.state[ST_DONE] = 0;
  }
}

// Launch B of step i < steps of the chain: the global pick from the
// reduced key, the record, and the merge over this rank's chunks.
template <int L>
__global__ void __launch_bounds__(THREADS) merge_kernel(ShardArgs p, int i) {
  if (((const volatile int*)p.state)[ST_DONE]) return;
  const unsigned long long key = *(const volatile long long*)p.key;
  const int nw = 256 + p.n_done + i;
  int a, b;
  if (!record(p, i, key, a, b)) {
    if (blockIdx.x == 0 && threadIdx.x == 0) p.state[ST_DONE] = 1;
    return;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    p.state[ST_A] = a;
    p.state[ST_B] = b;
    p.state[ST_NEW] = nw;
  }
  corpus<L>(p, i, a, b, nw);
}

// The state of one call from the C interface's arguments.
ShardArgs make_args(int32_t* tw, const int* wcount, int* hist, int* bounds,
                    int8_t* presT, int* d, long long* keys, int* scratch,
                    int* records, int W, int NC, int nc_used, int rows,
                    int v, int base, int steps, int unk, int min_freq,
                    int n_done, int init_done, int allowed) {
  ShardArgs p{};
  p.tw = tw;
  p.wcount = wcount;
  p.hist = hist;
  p.bounds = bounds;
  p.presT = presT;
  p.d = d;
  p.gkey = reinterpret_cast<unsigned long long*>(keys);
  p.keys = p.gkey + rows / GROUP;
  p.key = keys + rows / GROUP + 3;
  p.bits = scratch;
  p.slots = scratch + NC;
  p.state = p.slots + 2 * SL_LEN;
  p.records = records;
  p.W = W;
  p.NC = NC;
  p.cw = W / NC;
  p.nc_used = nc_used;
  p.rows = rows;
  p.v = v;
  p.base = base;
  p.steps = steps;
  p.unk = unk;
  p.min_freq = min_freq;
  p.n_done = n_done;
  p.init_done = init_done;
  p.allowed = allowed;
  return p;
}

bool valid(int L, int W, int NC, int nc_used, int rows, int v, int base,
           int steps) {
  return (L == 16 || L == 32 || L == 64) && NC >= 1 && W % NC == 0 &&
         (W / NC) % THREADS == 0 && nc_used >= 1 && nc_used <= NC &&
         v % 128 == 0 && rows % 128 == 0 && v <= 65536 && rows <= v &&
         base >= 0 && base + rows <= v && steps >= 1;
}

}  // namespace

extern "C" {

// The arguments of every entry point below: this rank's tw int32 [L, W]
// (NC chunks of W / NC columns, a multiple of 256; only chunks c <
// nc_used hold words) and wcount int32 [W]; hist int32 [rows, v] (global
// rows [base, base + rows)), bounds int32 [rows] and presT int8 [v, NC],
// all updated in place; d int32 [2][2v] (two dl | dr buffers: merge i
// adds into buffer i & 1, which the chain's caller all-reduces after
// launch B); keys int64 [rows / 32 + 4] (group keys, row-read keys, then
// the pick's key, which the chain's caller all-reduces (MAX) between
// launches A and B); scratch int32 [NC + 10]; records int32 [steps, 5]
// (a, b, freq, did, n_refresh).  v and rows multiples of 128, v <= 65536.
// Each returns the launch's CUDA error, or 0.

// The whole call in one persistent launch (no other rank).
int shred_giant_sharded_train(int32_t* tw, const int* wcount, int* hist,
                              int* bounds, int8_t* presT, int* d,
                              long long* keys, int* scratch, int* records,
                              int L, int W, int NC, int nc_used, int rows,
                              int v, int base, int steps, int unk,
                              int min_freq, int n_done, int init_done,
                              int allowed, void* stream) {
  if (!valid(L, W, NC, nc_used, rows, v, base, steps))
    return (int)cudaErrorInvalidValue;
  ShardArgs p = make_args(tw, wcount, hist, bounds, presT, d, keys, scratch,
                          records, W, NC, nc_used, rows, v, base, steps, unk,
                          min_freq, n_done, init_done, allowed);
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(L == 16   ? coop_launch<sharded_train_kernel<16>>(s, &p)
               : L == 32 ? coop_launch<sharded_train_kernel<32>>(s, &p)
                         : coop_launch<sharded_train_kernel<64>>(s, &p));
}

// Launch A of step i (0 <= i <= steps) of the chain.
int shred_giant_sharded_apply_pick(int32_t* tw, const int* wcount, int* hist,
                                   int* bounds, int8_t* presT, int* d,
                                   long long* keys, int* scratch,
                                   int* records, int L, int W, int NC,
                                   int nc_used, int rows, int v, int base,
                                   int steps, int unk, int min_freq,
                                   int n_done, int init_done, int allowed,
                                   int i, void* stream) {
  if (!valid(L, W, NC, nc_used, rows, v, base, steps) || i < 0 || i > steps)
    return (int)cudaErrorInvalidValue;
  ShardArgs p = make_args(tw, wcount, hist, bounds, presT, d, keys, scratch,
                          records, W, NC, nc_used, rows, v, base, steps, unk,
                          min_freq, n_done, init_done, allowed);
  return (int)coop_launch<apply_pick_kernel>((cudaStream_t)stream, &p, &i);
}

// Launch B of step i < steps of the chain.
int shred_giant_sharded_merge(int32_t* tw, const int* wcount, int* hist,
                              int* bounds, int8_t* presT, int* d,
                              long long* keys, int* scratch, int* records,
                              int L, int W, int NC, int nc_used, int rows,
                              int v, int base, int steps, int unk,
                              int min_freq, int n_done, int init_done,
                              int allowed, int i, void* stream) {
  if (!valid(L, W, NC, nc_used, rows, v, base, steps) || i < 0 || i >= steps)
    return (int)cudaErrorInvalidValue;
  ShardArgs p = make_args(tw, wcount, hist, bounds, presT, d, keys, scratch,
                          records, W, NC, nc_used, rows, v, base, steps, unk,
                          min_freq, n_done, init_done, allowed);
  // no grid barrier: a plain launch, TABLE_BLOCKS_PER_SM blocks an SM
  int dev, sms;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return (int)err;
  const dim3 grid(sms * TABLE_BLOCKS_PER_SM);
  cudaStream_t s = (cudaStream_t)stream;
  if (L == 16)
    merge_kernel<16><<<grid, THREADS, 0, s>>>(p, i);
  else if (L == 32)
    merge_kernel<32><<<grid, THREADS, 0, s>>>(p, i);
  else
    merge_kernel<64><<<grid, THREADS, 0, s>>>(p, i);
  return (int)cudaGetLastError();
}

}  // extern "C"
