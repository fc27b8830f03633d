// Fused hist-engine BPE merge loop for Hopper (sm_90a): one persistent
// cooperative launch per call.
//
// Replaces the TPU kernels shredword_tpu/ops/bpe_hist.py::_fused_kernel
// (pair table resident in VMEM, v <= ~1280) and ::_fused_kernel_big
// (table streamed from HBM, v <= 4096).  Both compute the same greedy
// merges; on the card the int32 [v, v] table lives in device memory at
// every v, so one kernel serves v <= 4096.
//
// What bounds it on the H100: each merge is a serial chain -- pick,
// corpus pass, table update -- whose work is small (the corpus pass reads
// L * W * 2 bytes, 2.6 MB on the 16 MB bench corpus; the update touches a
// few cells per row), all inside the 50 MB L2.  So the chain's latency
// bounds it, not bandwidth: one launch per step of the chain cost 2-3 us
// each, and a full re-read of every changed row for its maximum cost more.
// What remains is latency: two grid barriers per merge and the dependent
// L2 round trips of each phase (chip_smoke.py's phase clocks count
// them).  The design:
//   - one launch per call, every block co-resident (grid sized from the
//     occupancy calculator), two grid barriers per merge;
//   - an exact (max, arg) pair per row, built once per call: arg is
//     the smallest column holding the row's maximum.  Every block runs
//     the pick itself over the live rows (the same answer everywhere, so
//     no barrier) with the arg packed into the key: b = arg[a] comes
//     out of the same reduction and row a is not read;
//   - the update touches only what changes.  A row r outside {a, b, new}
//     with dl[r] != 0 changes in two cells, (r, a) -= dl[r] and
//     (r, new) += dl[r]; its new maximum follows from those two cells
//     (counts are non-negative and new is the largest live id, so a tie
//     keeps the old arg), and only a row whose arg was a is rescanned, by
//     one warp with 16-byte loads.  Rows a, b and new are rewritten by
//     one block each (spreading them over the grid measured slower), which
//     also writes the row's new (max, arg): no other block touches that
//     row in the update, so no third barrier;
//   - dl/dr are two buffers used in turn: merge i adds into buffer i & 1
//     and zeroes the other one during its update, after the last read of
//     it, so the zeroing costs no barrier.
// Data written by other blocks in the same launch is read through L2:
// the file is built with -dlcm=cg (global loads bypass the incoherent
// L1), and grid.sync() orders the phases.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>

#include "block_reduce.cuh"
#include "merge_column.cuh"
#include "phase_clock.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace shred;

constexpr int THREADS = 256;
// co-resident blocks per SM, at most: more only make the grid barrier
// dearer
constexpr int BLOCKS_PER_SM = 2;

// phases of a merge, as phase_clock.cuh counts them
enum { PH_INIT, PH_INIT_SYNC, PH_PICK_SCAN, PH_PICK, PH_CORPUS,
       PH_CORPUS_SYNC, PH_UPDATE_ROWS, PH_UPDATE, PH_UPDATE_SYNC };

// Pick key of a row: its thresholded maximum, then the smaller row (the
// lex tie-break), with the row's arg in the low 16 bits, so the block's
// maximum of the keys also names b (v <= 65536).
__device__ __forceinline__ unsigned long long pick_key(int val, int r,
                                                       int arg, int v) {
  return ((unsigned long long)((unsigned)val ^ 0x80000000u) << 32) |
         ((unsigned)(v - 1 - r) << 16) | (unsigned)arg;
}

struct HistArgs {
  int16_t* tw;
  const int* wcount;
  int* hist;     // [v, v]
  int* rowmax;   // [2v]: (max, arg) per row
  int* dl;       // [2v]: two buffers used in turn
  int* dr;       // [2v]
  int* records;  // [steps, 4]
  int W, v, steps, unk, min_freq, n_done, init_done, allowed;
};

template <int L>
__global__ void __launch_bounds__(THREADS) hist_train_kernel(HistArgs p) {
  cg::grid_group grid = cg::this_grid();
  __shared__ int s_a, s_b, s_m;
  const int v = p.v, tid = threadIdx.x, lane = tid & 31;
  const int nthreads = gridDim.x * THREADS;
  const int gtid = blockIdx.x * THREADS + tid;
  const int gwarp = gtid >> 5, nwarps = nthreads >> 5;
  int2* rowmax = reinterpret_cast<int2*>(p.rowmax);  // (max, arg) per row
  const auto same = [](int, int h) { return h; };
  PhaseClock clk;

  // exact (max, first arg) of every row (bpe_hist.py:502); both delta
  // buffers zeroed
  for (int r = gwarp; r < v; r += nwarps) {
    const unsigned long long k =
        warp_max_u64(row_max_key(p.hist + (size_t)r * v, v, v, lane, 32,
                                 same));
    if (lane == 0) rowmax[r] = make_int2(key_val(k), key_idx(k, v));
  }
  for (int c = gtid; c < 2 * v; c += nthreads) p.dl[c] = p.dr[c] = 0;
  clk.mark(PH_INIT);
  grid.sync();
  clk.mark(PH_INIT_SYNC);

  for (int i = 0; i < p.steps; ++i) {
    const int nw = 256 + p.n_done + i;
    const int lim = nw + 1 < v ? nw + 1 : v;  // rows above new hold no pair
    int* dl = p.dl + (i & 1) * v;
    int* dr = p.dr + (i & 1) * v;

    // pick (bpe_hist.py:512-534): the smallest row of the largest
    // thresholded row max, then its smallest column; every block alike
    unsigned long long best = 0ull;
    for (int r = tid; r < lim; r += THREADS) {
      const int2 x = rowmax[r];
      best = umax64(best, pick_key(x.x >= p.min_freq ? x.x : 0, r, x.y, v));
    }
    clk.mark(PH_PICK_SCAN);
    best = block_max_u64(best);
    if (tid == 0) {
      s_m = key_val(best);
      s_a = v - 1 - (int)((best >> 16) & 0xffffu);
      s_b = (int)(best & 0xffffu);
    }
    __syncthreads();
    const int m = s_m, a = s_a, b = s_b;
    clk.mark(PH_PICK);
    if (!(m > 0 && !p.init_done && i < p.allowed)) {
      // nothing changes any more: every later step picks the same m
      if (blockIdx.x == 0)
        for (int j = i + tid; j < p.steps; j += THREADS) {
          int* rec = p.records + 4 * j;
          rec[0] = rec[1] = rec[3] = 0;
          rec[2] = m;
        }
      break;
    }
    if (gtid == 0) {
      int* rec = p.records + 4 * i;
      rec[0] = a;
      rec[1] = b;
      rec[2] = m;
      rec[3] = 1;
    }

    // corpus (bpe_hist.py:141-248): one thread per word column
    for (int col = gtid; col < p.W; col += nthreads)
      merge_column<L>(p.tw, p.W, col, a, b, nw, p.unk, p.wcount, dl, dr);
    clk.mark(PH_CORPUS);
    grid.sync();
    clk.mark(PH_CORPUS_SYNC);

    // table update (bpe_hist.py:251-259, :549-571) in the JAX order:
    // column a -= dl, column new += dl, row b -= dr, row new += dr, cell
    // (a, b) = 0.  Rows a, new (and b): one block each, 16-byte loads,
    // then the row's (max, arg).
    const int which = blockIdx.x;
    const int sr = which == 0 ? a : which == 1 ? nw
                   : which == 2 && b != a ? b : -1;
    if (sr >= 0) {
      const int d = dl[sr];
      unsigned long long rk = 0ull;
      for (int q = tid; q < (lim + 3) >> 2; q += THREADS) {
        const int c0 = q << 2;
        int4* cell = reinterpret_cast<int4*>(p.hist + (size_t)sr * v + c0);
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
      if (tid == 0) rowmax[sr] = make_int2(key_val(rk), key_idx(rk, v));
    }
    clk.mark(PH_UPDATE_ROWS);
    // every other live row with dl[r] != 0, one warp each, from the
    // grid's last warp down (the jobs above start at block 0); x is loaded
    // with d, and dropped for rows a, b and new
    for (int r = nwarps - 1 - gwarp; r < lim; r += nwarps) {
      const int d = dl[r];
      const int2 x = rowmax[r];
      if (d == 0 || r == a || r == b || r == nw) continue;
      int* row = p.hist + (size_t)r * v;
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
    // the other delta buffer was last read by the previous merge's update
    int* dl_next = p.dl + ((i + 1) & 1) * v;
    int* dr_next = p.dr + ((i + 1) & 1) * v;
    for (int c = gtid; c < lim; c += nthreads) dl_next[c] = dr_next[c] = 0;
    clk.mark(PH_UPDATE);
    grid.sync();
    clk.mark(PH_UPDATE_SYNC);
  }
}

template <int L>
cudaError_t launch(HistArgs p, cudaStream_t s) {
  int dev, sms, per_sm;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, hist_train_kernel<L>, THREADS, 0)) != cudaSuccess)
    return err;
  const int blocks = sms * (per_sm < BLOCKS_PER_SM ? per_sm : BLOCKS_PER_SM);
  if (blocks < 3) return cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&p};
  return cudaLaunchCooperativeKernel((const void*)hist_train_kernel<L>,
                                     dim3(blocks), dim3(THREADS), args, 0,
                                     s);
}

}  // namespace

SHRED_PHASE_READER(shred_hist_phase_cycles)

extern "C" {

const char* shred_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Runs `steps` merges of the fused hist engine on `stream` in one kernel
// launch.  tw int16 [L, W], wcount int32 [W], hist int32 [v, v] are
// updated in place (v a multiple of 4, at most 65536); rowmax int32
// [2v] ((max, arg) per row; 8-byte aligned) and dl/dr int32 [2v] are
// scratch; records int32 [steps, 4] receives (a, b, freq, did)
// per step.  Returns the launch's CUDA error, or 0.
int shred_hist_fused_train(int16_t* tw, const int* wcount, int* hist,
                           int* rowmax, int* dl, int* dr, int* records,
                           int L, int W, int v, int steps, int unk,
                           int min_freq, int n_done, int init_done,
                           int allowed, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (v % 4 || v > 65536) return (int)cudaErrorInvalidValue;
  if (steps < 1) return 0;
  const HistArgs p{tw, wcount, hist, rowmax, dl, dr, records, W, v, steps,
                   unk, min_freq, n_done, init_done, allowed};
  cudaError_t err;
  if (L == 16)
    err = launch<16>(p, s);
  else if (L == 32)
    err = launch<32>(p, s);
  else if (L == 64)
    err = launch<64>(p, s);
  else
    return (int)cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
