// Giant-vocab BPE merge loop for Hopper (sm_90a), vocab up to 32768: one
// persistent cooperative launch per call.
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
// Ids above the merge's new id hold no pair yet, so every table scan is
// bounded by the live ids (lim = new + 1), not by v.  All counts are
// non-negative, which makes a maximum over the live columns equal to the
// maximum over all v columns.
//
// What bounds it on the H100: each merge is a serial chain -- the lazy
// pick (a scan of the row bounds, then a read of the claimed row, repeated
// while the bound is stale), the corpus pass over the chunks that hold
// both ids, the table update -- of small work inside the 50 MB L2, so its
// latency bounds it: the grid barriers between the phases, the pick's
// row reads (up to 128 KB each) and the dependent L2 round trips inside
// each phase (chip_smoke.py's phase clocks count them).  The design:
//   - one launch per call, every block co-resident (grid sized from the
//     occupancy calculator); a grid barrier after each row read of the
//     pick, after the corpus pass and after the update;
//   - the group keys, the pick, the flagged-chunk corpus pass and the
//     presence update are giant_table.cuh's, shared with giant_sharded.cu;
//   - a key per group of 32 rows (the largest bound, then the smallest
//     row holding it, as one 64-bit max_key), kept exact: the pick reads
//     v / 32 group keys, one load each, instead of v bounds, and the
//     winning key names the row.  Thresholding commutes with the maximum,
//     so the smallest row of the largest thresholded key is the row a
//     flat scan finds.  Bound increases go to the keys by atomicMax; the
//     rows whose bound is set or lowered (a refreshed row, and a, b, new
//     after each merge) have their groups recomputed by every block
//     alike, all in one round of loads;
//   - the read of row a is spread over the grid with 16-byte loads and
//     yields the maximum and its first column in one 64-bit key, so the
//     confirming read also gives b;
//   - each block compacts the flagged chunk ids (presence of a and of b)
//     itself and takes every G-th unit of 256 columns of them;
//   - rows a, b and new are rewritten by the whole grid, 16 bytes a
//     thread; every other live row with dl != 0 changes in two cells,
//     one warp per group of rows and one atomicMax per group key; the
//     exact maxima of the final rows a and new (and of row b after its
//     own update) are reduced into per-merge slots, one atomic per block
//     that holds their columns (atomics on one address queue at L2);
//   - dl/dr and the slots are pairs used in turn, zeroed one merge ahead,
//     so zeroing costs no barrier.
// Data written by other blocks in the same launch is read through L2:
// the file is built with -dlcm=cg (global loads bypass the incoherent
// L1), and grid.sync() orders the phases.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>

#include "block_reduce.cuh"
#include "giant_table.cuh"
#include "merge_column.cuh"
#include "phase_clock.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace shred;

constexpr int THREADS = GIANT_THREADS;
// co-resident blocks per SM, at most: more only make the grid barrier
// dearer
constexpr int BLOCKS_PER_SM = 2;

// phases of a merge, as phase_clock.cuh counts them; the pick's three
// repeat with each row read
enum { PH_INIT, PH_INIT_SYNC, PH_PICK, PH_ROW_READ, PH_ROW_SYNC, PH_CORPUS,
       PH_CORPUS_SYNC, PH_UPDATE_ROWS, PH_UPDATE_OTHERS, PH_UPDATE,
       PH_UPDATE_SYNC, PH_BOUNDS };

// per-merge maxima slots, two sets used in turn
enum { SL_A = 0, SL_B, SL_NEW, SL_LEN };

struct GiantArgs {
  int16_t* tw;
  const int* wcount;
  int* hist;                 // [v, v]
  int8_t* presT;             // [v, NC]
  int* rowmax;               // [v]
  int* dl;                   // [2v]: two buffers used in turn
  int* dr;                   // [2v]
  int* bits;                 // [NC]: per-chunk bits
  unsigned long long* gkey;  // [v / GROUP]: group keys
  unsigned long long* keys;  // [3]: row-read keys, used in turn
  int* slots;                // [2 * SL_LEN]
  int* records;              // [steps, 5]
  int W, v, NC, cw, nc_used, steps, unk, min_freq, n_done, init_done,
      allowed;
};

template <int L>
__global__ void __launch_bounds__(THREADS) giant_train_kernel(GiantArgs p) {
  cg::grid_group grid = cg::this_grid();
  const int v = p.v, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = gridDim.x, nthreads = G * THREADS;
  const int gtid = blockIdx.x * THREADS + tid;
  const int gwarp = gtid >> 5, nwarps = nthreads >> 5;
  int* rowmax = p.rowmax;
  unsigned long long* gkey = p.gkey;
  PhaseClock clk;

  init_group_keys(rowmax, gkey, v, gtid, nthreads);
  for (int c = gtid; c < 2 * v; c += nthreads) p.dl[c] = p.dr[c] = 0;
  for (int c = gtid; c < p.NC; c += nthreads) p.bits[c] = 0;
  if (gtid < 3) p.keys[gtid] = 0ull;
  if (gtid < 2 * SL_LEN) p.slots[gtid] = 0;
  clk.mark(PH_INIT);
  grid.sync();
  clk.mark(PH_INIT_SYNC);

  unsigned t = 0;  // row reads so far in this call, the same in every block
  for (int i = 0; i < p.steps; ++i) {
    const int nw = 256 + p.n_done + i;
    const int lim = nw + 1 < v ? nw + 1 : v;
    int* dl = p.dl + (i & 1) * v;
    int* dr = p.dr + (i & 1) * v;
    int* slot = p.slots + (i & 1) * SL_LEN;

    // lazy pick (giant_table.cuh), every block alike
    const LazyPick pk =
        lazy_pick(grid, p.hist, rowmax, gkey, p.keys, t, lim, lim, v, v,
                  p.min_freq, clk, PH_PICK, PH_ROW_READ, PH_ROW_SYNC);
    const int m = pk.m, a = pk.a, b = pk.b, n_refresh = pk.n_refresh;
    if (!(m > 0 && !p.init_done && i < p.allowed)) {
      // nothing changes any more: every later step confirms the same
      // pick with one row read
      if (blockIdx.x == 0)
        for (int j = i + tid; j < p.steps; j += THREADS) {
          int* rec = p.records + 5 * j;
          rec[0] = rec[1] = rec[3] = 0;
          rec[2] = m;
          rec[4] = j == i ? n_refresh : 1;
        }
      break;
    }
    if (gtid == 0) {
      int* rec = p.records + 5 * i;
      rec[0] = a;
      rec[1] = b;
      rec[2] = m;
      rec[3] = 1;
      rec[4] = n_refresh;
    }

    // corpus (giant_table.cuh): the chunks that hold a and b
    flagged_pass<L>(p.tw, p.wcount, p.presT, p.bits, p.W, p.NC, p.cw,
                    p.nc_used, a, b, nw, p.unk, dl, dr);
    clk.mark(PH_CORPUS);
    grid.sync();
    clk.mark(PH_CORPUS_SYNC);

    // table (bpe_giant.py:544-612), as steps 1-5 in the TPU kernel's
    // order: 1. row b -= dr; 2. row new = dr; 3. column a -= dl, column
    // new += dl; 4. cell (a, b) = 0; 5. bounds.  Rows a, new (and b):
    // every 16-byte group of their live columns is one job of the grid.
    const int n4 = (lim + 3) >> 2;
    const int n_rows = b == a ? 2 : 3;
    int max_a = -1, max_new = -1, max_b = -1;  // -1: no column here
    for (int j = gtid; j < n_rows * n4; j += nthreads) {
      const int which = j / n4, c0 = (j % n4) << 2;
      const int sr = which == 0 ? a : which == 1 ? nw : b;
      int4* cell = reinterpret_cast<int4*>(p.hist + (size_t)sr * v + c0);
      const int4 x0 = *cell;
      const int4 d4 = *reinterpret_cast<const int4*>(dr + c0);
      const int dls = dl[sr];
      int h0[4] = {x0.x, x0.y, x0.z, x0.w};
      const int dv[4] = {d4.x, d4.y, d4.z, d4.w};
      int h[4];
      bool changed = false;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = c0 + e;
        const int hb = h0[e] - (sr == b ? dv[e] : 0);       // step 1
        int y = (sr == nw ? dv[e] : hb)                      // step 2
                - (c == a ? dls : 0) + (c == nw ? dls : 0);  // step 3
        if (sr == a && c == b) y = 0;                        // step 4
        h[e] = y;
        changed |= y != h0[e];
        if (which == 0) max_a = max(max_a, y);
        if (which == 1) max_new = max(max_new, y);
        if (which == 2) max_b = max(max_b, hb);  // bound after step 1
      }
      if (changed) *cell = make_int4(h[0], h[1], h[2], h[3]);
    }
    clk.mark(PH_UPDATE_ROWS);
    // every other live row: step 3 in two cells, then its bound.  One
    // group of rows per warp, from the grid's last warp down (the jobs
    // above start at block 0), and one atomicMax per group.
    for (int r0 = (nwarps - 1 - gwarp) * GROUP; r0 < lim;
         r0 += nwarps * GROUP) {
      const int r = r0 + lane;
      const int d = r < lim ? dl[r] : 0;
      unsigned long long up = 0ull;
      if (d != 0 && r != a && r != b && r != nw) {
        int* row = p.hist + (size_t)r * v;
        const int ha = row[a], hn = row[nw], bound = rowmax[r];  // at once
        row[a] = ha - d;
        row[nw] = hn + d;
        if (d > bound) {
          rowmax[r] = d;
          up = max_key(d, r, v);
        }
      }
      up = warp_max_u64(up);
      if (lane == 0 && up) atomicMax(&gkey[r0 / GROUP], up);
    }
    clk.mark(PH_UPDATE_OTHERS);
    // presence rows a, b, new of the chunks that matched (:520-540)
    presence_update(p.presT, p.bits, p.NC, p.nc_used, a, b, nw, gtid,
                    nthreads);
    // the other deltas and slots were last read by the previous merge
    int* dl_next = p.dl + ((i + 1) & 1) * v;
    int* dr_next = p.dr + ((i + 1) & 1) * v;
    for (int c = gtid; c < lim; c += nthreads) dl_next[c] = dr_next[c] = 0;
    if (gtid < SL_LEN) p.slots[((i + 1) & 1) * SL_LEN + gtid] = 0;
    // one atomic per row and per block that holds some of its columns:
    // atomics on one address queue up at L2
    unsigned long long mx[3] = {(unsigned)(max_a + 1), (unsigned)(max_new + 1),
                                (unsigned)(max_b + 1)};
    block_max_u64_n(mx);
    if (tid == 0) {
      if (mx[0]) atomicMax(&slot[SL_A], (int)mx[0] - 1);
      if (mx[1]) atomicMax(&slot[SL_NEW], (int)mx[1] - 1);
      if (mx[2]) atomicMax(&slot[SL_B], (int)mx[2] - 1);
    }
    clk.mark(PH_UPDATE);
    grid.sync();
    clk.mark(PH_UPDATE_SYNC);

    // step 5 for rows b, new and a and their groups, every block alike:
    // row b's bound after step 1, raised to dl[b] (rowmax = max(rowmax,
    // dl)); rows new and a exact
    if (warp == 0) {
      const int val[3] = {slot[SL_A], slot[SL_NEW], max(slot[SL_B], dl[b])};
      regroup(rowmax, gkey, {a, nw, b != a ? b : -1}, val, v);
      if (lane == 0) {
        rowmax[a] = val[0];
        rowmax[nw] = val[1];
        if (b != a) rowmax[b] = val[2];
      }
    }
    __syncthreads();
    clk.mark(PH_BOUNDS);
  }
}

template <int L>
cudaError_t launch(const GiantArgs& p, cudaStream_t s) {
  int dev, sms, per_sm;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, giant_train_kernel<L>, THREADS, 0)) != cudaSuccess)
    return err;
  const int blocks = sms * (per_sm < BLOCKS_PER_SM ? per_sm : BLOCKS_PER_SM);
  if (blocks < 1) return cudaErrorCooperativeLaunchTooLarge;
  GiantArgs q = p;
  void* args[] = {&q};
  return cudaLaunchCooperativeKernel((const void*)giant_train_kernel<L>,
                                     dim3(blocks), dim3(THREADS), args, 0,
                                     s);
}

}  // namespace

SHRED_PHASE_READER(shred_giant_phase_cycles)

extern "C" {

// Runs `steps` merges of the giant engine on `stream` in one kernel
// launch.  tw int16 [L, W], wcount int32 [W], hist int32 [v, v], presT
// int8 [v, NC] and rowmax int32 [v] are updated in place (v a multiple of
// 128); dl/dr int32 [2v], bits int32 [NC + NC % 2 + v / 16] (chunk bits,
// then 8-byte group keys) and state int32 [16] are scratch; records int32 [steps, 5] receives (a, b, freq, did,
// n_refresh) per step.  Chunk c covers the columns [c * cw, (c + 1) * cw);
// only chunks c < nc_used hold words.  Returns the launch's CUDA error,
// or 0.
int shred_giant_train(int16_t* tw, const int* wcount, int* hist,
                      int8_t* presT, int* rowmax, int* dl, int* dr,
                      int* bits, int* state, int* records, int L, int W,
                      int v, int NC, int cw, int nc_used, int steps, int unk,
                      int min_freq, int n_done, int init_done, int allowed,
                      void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if ((L != 16 && L != 32 && L != 64) || cw % THREADS != 0 || v % 128 ||
      (long long)NC * cw != W || nc_used < 1 || nc_used > NC)
    return (int)cudaErrorInvalidValue;
  if (steps < 1) return 0;
  const GiantArgs p{tw, wcount, hist, presT, rowmax, dl, dr, bits,
                    reinterpret_cast<unsigned long long*>(bits + NC + NC % 2),
                    reinterpret_cast<unsigned long long*>(state), state + 8,
                    records, W, v, NC, cw, nc_used, steps, unk, min_freq,
                    n_done, init_done, allowed};
  cudaError_t err = L == 16   ? launch<16>(p, s)
                    : L == 32 ? launch<32>(p, s)
                              : launch<64>(p, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
