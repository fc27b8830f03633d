// The pair table of the hist-engine kernels (hist_fused.cu, hist_step.cu):
// int32 [v, v] exact pair counts with an exact (max, arg) per row, the
// pick over it and the table update of one merge.  One copy, included by
// every kernel that keeps the table on the device.
//
//   - (max, arg) of a row: its largest count and the smallest column
//     holding it, built once per call (table_init_rowmax) and kept exact
//     by the update;
//   - the pick: every block scans the live rows' (max, arg) itself (the
//     same answer everywhere, so no barrier), with the arg packed into
//     the key, so b = arg[a] comes out of the same reduction;
//   - the update (bpe_hist.py:251-259, :549-571) in the JAX order:
//     column a -= dl, column new += dl, row b -= dr, row new += dr, cell
//     (a, b) = 0.  Rows a, new and b are rewritten by blocks 0, 1 and 2,
//     which also write the row's new (max, arg); no other block touches
//     those rows, so the update needs no barrier of its own.  A row r
//     outside {a, b, new} with dl[r] != 0 changes in two cells, (r, a)
//     -= dl[r] and (r, new) += dl[r]; its new maximum follows from those
//     two cells (counts are non-negative and new is the largest live id,
//     so a tie keeps the old arg), and only a row whose arg was a is
//     rescanned, by one warp with 16-byte loads.
//   - table_train_loop: the persistent loop of one call around a corpus
//     pass (K1/K2's whole corpus, K5's flagged chunks): per merge the
//     pick, the pass, a grid barrier, the update, a grid barrier.  dl/dr
//     are two buffers used in turn: merge i adds into buffer i & 1 and
//     zeroes the other one during its update, after the last read of it,
//     so the zeroing costs no barrier.
// Kernels that read what other blocks of the same launch wrote are built
// with -dlcm=cg (global loads bypass the incoherent L1) and order their
// phases with grid.sync().
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_reduce.cuh"
#include "phase_clock.cuh"

namespace shred {

// Blocks of the table kernels: 256 threads, at most two co-resident per
// SM (more only make the grid barrier dearer).
constexpr int TABLE_THREADS = 256;
constexpr int TABLE_BLOCKS_PER_SM = 2;

// Launches `Kernel` (TABLE_THREADS a block) cooperatively on `s` with
// every block co-resident, at most TABLE_BLOCKS_PER_SM per SM; the grid
// is computed once per device and kernel.
template <auto Kernel, class... A>
cudaError_t coop_launch(cudaStream_t s, A*... args) {
  static int cached[64];
  int dev, sms, per_sm;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  int blocks = dev < 64 ? cached[dev] : 0;
  if (!blocks) {
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, Kernel, TABLE_THREADS, 0)) != cudaSuccess)
      return err;
    blocks = sms * (per_sm < TABLE_BLOCKS_PER_SM ? per_sm
                                                 : TABLE_BLOCKS_PER_SM);
    if (blocks < 3) return cudaErrorCooperativeLaunchTooLarge;
    if (dev < 64) cached[dev] = blocks;
  }
  void* argv[] = {args...};
  err = cudaLaunchCooperativeKernel((const void*)Kernel, dim3(blocks),
                                    dim3(TABLE_THREADS), argv, 0, s);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// Pick key of a row: its thresholded maximum, then the smaller row (the
// lex tie-break), with the row's arg in the low 16 bits, so the block's
// maximum of the keys also names b (v <= 65536).
__device__ __forceinline__ unsigned long long pick_key(int val, int r,
                                                       int arg, int v) {
  return ((unsigned long long)((unsigned)val ^ 0x80000000u) << 32) |
         ((unsigned)(v - 1 - r) << 16) | (unsigned)arg;
}

// exact (max, first arg) of every row (bpe_hist.py:502), one warp per row
__device__ __forceinline__ void table_init_rowmax(const int* hist,
                                                  int2* rowmax, int v,
                                                  int gwarp, int nwarps) {
  const int lane = threadIdx.x & 31;
  const auto same = [](int, int h) { return h; };
  for (int r = gwarp; r < v; r += nwarps) {
    const unsigned long long k = warp_max_u64(
        row_max_key(hist + (size_t)r * v, v, v, lane, 32, same));
    if (lane == 0) rowmax[r] = make_int2(key_val(k), key_idx(k, v));
  }
}

// This thread's share of the pick (bpe_hist.py:512-534): the largest key
// of the live rows r < lim, thresholded at min_freq.
template <int THREADS>
__device__ __forceinline__ unsigned long long table_pick_scan(
    const int2* rowmax, int lim, int min_freq, int v) {
  unsigned long long best = 0ull;
  for (int r = threadIdx.x; r < lim; r += THREADS) {
    const int2 x = rowmax[r];
    best = umax64(best, pick_key(x.x >= min_freq ? x.x : 0, r, x.y, v));
  }
  return best;
}

struct Pick {
  int m, a, b;  // frequency, row (the smallest), column (the smallest)
};

// The block's maximum of the table_pick_scan keys, in every thread.
__device__ __forceinline__ Pick table_pick_reduce(unsigned long long best,
                                                  int v) {
  __shared__ Pick s;
  best = block_max_u64(best);
  if (threadIdx.x == 0)
    s = Pick{key_val(best), v - 1 - (int)((best >> 16) & 0xffffu),
             (int)(best & 0xffffu)};
  __syncthreads();
  return s;
}

// Rows a, new and b of the update, by blocks 0, 1 and 2 (block 2 idles
// when b == a): 16-byte loads, cells rewritten where they change, then
// the row's (max, arg).  lim bounds the live columns (new + 1).
template <int THREADS>
__device__ __forceinline__ void table_update_rows(int* hist, int2* rowmax,
                                                  int a, int b, int nw,
                                                  int lim, int v,
                                                  const int* dl,
                                                  const int* dr) {
  const int which = blockIdx.x;
  const int sr = which == 0 ? a : which == 1 ? nw
                 : which == 2 && b != a ? b : -1;
  if (sr < 0) return;
  const int d = dl[sr];
  unsigned long long rk = 0ull;
  for (int q = threadIdx.x; q < (lim + 3) >> 2; q += THREADS) {
    const int c0 = q << 2;
    int4* cell = reinterpret_cast<int4*>(hist + (size_t)sr * v + c0);
    const int4 x0 = *cell;
    const int4 d4 = *reinterpret_cast<const int4*>(dr + c0);
    const int h0[4] = {x0.x, x0.y, x0.z, x0.w};
    const int dv[4] = {d4.x, d4.y, d4.z, d4.w};
    int h[4];
    bool changed = false;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = c0 + e;
      int y = h0[e] - (c == a ? d : 0) + (c == nw ? d : 0);
      if (sr == b) y -= dv[e];
      if (sr == nw) y += dv[e];
      if (sr == a && c == b) y = 0;
      h[e] = y;
      changed |= y != h0[e];
      rk = umax64(rk, max_key(y, c, v));
    }
    if (changed) *cell = make_int4(h[0], h[1], h[2], h[3]);
  }
  rk = block_max_u64(rk);
  if (threadIdx.x == 0) rowmax[sr] = make_int2(key_val(rk), key_idx(rk, v));
}

// Every other live row with dl[r] != 0, one warp each, from the grid's
// last warp down (table_update_rows starts at block 0); x is loaded with
// d, and dropped for rows a, b and new.
__device__ __forceinline__ void table_update_others(int* hist, int2* rowmax,
                                                    int a, int b, int nw,
                                                    int lim, int v,
                                                    const int* dl, int gwarp,
                                                    int nwarps) {
  const int lane = threadIdx.x & 31;
  for (int r = nwarps - 1 - gwarp; r < lim; r += nwarps) {
    const int d = dl[r];
    const int2 x = rowmax[r];
    if (d == 0 || r == a || r == b || r == nw) continue;
    int* row = hist + (size_t)r * v;
    if (x.y == a) {  // its maximum may have moved: rescan
      const unsigned long long k = warp_max_u64(row_max_key(
          row, lim, v, lane, 32, [=](int c, int h) {
            return h - (c == a ? d : 0) + (c == nw ? d : 0);
          }));
      if (lane == 0) {
        row[a] -= d;
        row[nw] += d;
        rowmax[r] = make_int2(key_val(k), key_idx(k, v));
      }
    } else if (lane == 0) {
      const int ha = row[a], hn = row[nw] + d;  // both loads at once
      row[a] = ha - d;
      row[nw] = hn;
      if (hn > x.x) rowmax[r] = make_int2(hn, nw);
    }
  }
}

// Records of steps i.. once a step cannot merge (block 0): nothing
// changes any more, so every later step picks the same m.
__device__ __forceinline__ void table_finish_records(int* records, int i,
                                                     int steps, int m) {
  for (int j = i + (int)threadIdx.x; j < steps; j += blockDim.x) {
    int* rec = records + 4 * j;
    rec[0] = rec[1] = rec[3] = 0;
    rec[2] = m;
  }
}

// phases of a merge of table_train_loop, as phase_clock.cuh counts them
enum { PH_INIT, PH_INIT_SYNC, PH_PICK_SCAN, PH_PICK, PH_CORPUS,
       PH_CORPUS_SYNC, PH_UPDATE_ROWS, PH_UPDATE, PH_UPDATE_SYNC };

struct TableArgs {
  int* hist;     // [v, v]
  int* rowmax;   // [2v]: (max, arg) per row
  int* dl;       // [2v]: two buffers used in turn
  int* dr;       // [2v]
  int* records;  // [steps, 4]: (a, b, freq, did)
  int v, steps, min_freq, n_done, init_done, allowed;
};

// `steps` merges in one cooperative launch of THREADS-thread blocks:
// corpus(a, b, nw, dl, dr) merges (a, b) -> nw over the corpus and adds
// the neighbour weights into dl/dr; everything else is the table's.
template <int THREADS, class Corpus>
__device__ __forceinline__ void table_train_loop(const TableArgs& p,
                                                 Corpus corpus) {
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const int v = p.v;
  const int nthreads = gridDim.x * THREADS;
  const int gtid = blockIdx.x * THREADS + threadIdx.x;
  const int gwarp = gtid >> 5, nwarps = nthreads >> 5;
  int2* rowmax = reinterpret_cast<int2*>(p.rowmax);
  PhaseClock clk;

  table_init_rowmax(p.hist, rowmax, v, gwarp, nwarps);
  for (int c = gtid; c < 2 * v; c += nthreads) p.dl[c] = p.dr[c] = 0;
  clk.mark(PH_INIT);
  grid.sync();
  clk.mark(PH_INIT_SYNC);

  for (int i = 0; i < p.steps; ++i) {
    const int nw = 256 + p.n_done + i;
    const int lim = nw + 1 < v ? nw + 1 : v;  // rows above new hold no pair
    int* dl = p.dl + (i & 1) * v;
    int* dr = p.dr + (i & 1) * v;

    const unsigned long long best =
        table_pick_scan<THREADS>(rowmax, lim, p.min_freq, v);
    clk.mark(PH_PICK_SCAN);
    const Pick pk = table_pick_reduce(best, v);
    clk.mark(PH_PICK);
    if (!(pk.m > 0 && !p.init_done && i < p.allowed)) {
      if (blockIdx.x == 0) table_finish_records(p.records, i, p.steps, pk.m);
      break;
    }
    if (gtid == 0) {
      int* rec = p.records + 4 * i;
      rec[0] = pk.a;
      rec[1] = pk.b;
      rec[2] = pk.m;
      rec[3] = 1;
    }

    corpus(pk.a, pk.b, nw, dl, dr);
    clk.mark(PH_CORPUS);
    grid.sync();
    clk.mark(PH_CORPUS_SYNC);

    table_update_rows<THREADS>(p.hist, rowmax, pk.a, pk.b, nw, lim, v, dl,
                               dr);
    clk.mark(PH_UPDATE_ROWS);
    table_update_others(p.hist, rowmax, pk.a, pk.b, nw, lim, v, dl, gwarp,
                        nwarps);
    // the other delta buffer was last read by the previous merge's update
    int* dl_next = p.dl + ((i + 1) & 1) * v;
    int* dr_next = p.dr + ((i + 1) & 1) * v;
    for (int c = gtid; c < lim; c += nthreads) dl_next[c] = dr_next[c] = 0;
    clk.mark(PH_UPDATE);
    grid.sync();
    clk.mark(PH_UPDATE_SYNC);
  }
}

}  // namespace shred
