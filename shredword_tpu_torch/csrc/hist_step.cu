// The per-merge hist engines for Hopper (sm_90a): the sparse merge loop
// (K5) and the sharded merge chain (K4), with the pick and the table
// update on the device and no PyTorch op per merge.
//
// Replaces the TPU kernels shredword_tpu/ops/bpe_hist.py::_merge_kernel
// (make_merge_step: one given merge over every [L, 512] block of the
// corpus; the step of make_train_loop and of sharded hist training) and
// ::_merge_kernel_sparse (make_merge_step_sparse: only the 512-column
// chunks whose presence bitmap holds both a and b, with that bitmap
// rewritten for the chunks it processes).  On the TPU an XLA while_loop
// around them picks the pair and updates the table; here the table, its
// (max, arg) per row, the pick and the update are hist_table.cuh's, shared
// with hist_fused.cu.  The corpus pass is merge_column.cuh, one thread per
// word column (greedy left-to-right merge, compaction, int32 atomics into
// dl/dr); the TPU kernels' slot histograms have no counterpart.
//
// What bounds it on the H100: a merge's work is small -- the corpus pass
// reads L * W * 2 bytes (2.6 MB on the 16 MB bench corpus, under a
// microsecond at 3.35 TB/s) and rewrites only the matched columns, the
// update touches a few cells per row -- so latency bounds it: the grid
// barriers and L2 round trips of each merge, as in hist_fused.cu, and
// for the sharded chain the host, which enqueues a launch and an
// all-reduce per merge.  A pick and update enqueued as PyTorch ops around
// a corpus kernel would cost far more than the kernel (about twenty ops
// per merge), so both keep the whole merge on the device.  The design:
//   - sparse_train_kernel (K5): one persistent cooperative launch per
//     call, table_train_loop around a corpus pass over the chunks whose
//     presence (int8 [v, NC]) holds a and b, one block per flagged chunk
//     in a grid-stride loop; the block rewrites the presence of a, b and
//     new for the chunk from its columns' block ORs.  The bitmap is exact
//     (build_presence, then every rewrite), and a merge changes no other
//     id's presence, so this equals the TPU kernel's rewrite of the whole
//     row;
//   - the sharded chain (K4): every merge needs one all-reduce of this
//     rank's dl | dr between the corpus pass and the update, and NCCL
//     collectives stay outside kernels, so a merge is one cooperative
//     launch (apply the previous merge's reduced deltas, grid barrier,
//     pick, corpus pass over this rank's columns) followed by the host's
//     all_reduce on the same stream.  chain_init_kernel builds the (max,
//     arg) of every row once per call; a last launch applies the call's
//     last merge, so the table is whole when the call returns.  Every rank
//     holds the same table, so every rank picks alike with no broadcast.
//     Once a step cannot merge, later launches return at once.
// Data written by other blocks (or the previous launch) is read through
// L2: the file is built with -dlcm=cg.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hist_table.cuh"
#include "merge_column.cuh"
#include "phase_clock.cuh"

namespace {

using namespace shred;

constexpr int THREADS = TABLE_THREADS;
constexpr int CHUNK = 512;        // columns per presence bit (bpe_hist.CHUNK)

// ---------------------------------------------------------------------
// K5: the sparse merge loop, one launch per call
// ---------------------------------------------------------------------

struct SparseArgs {
  TableArgs table;
  int16_t* tw;
  const int* wcount;
  int8_t* presT;  // [v, NC]
  int W, NC, unk;
};

// _merge_kernel_sparse (bpe_hist.py:288-357) inside the loop: a chunk
// whose presence lacks a or b is skipped by the whole block; a flagged
// chunk that did not match keeps a and b and gets new = 0.
template <int L>
__global__ void __launch_bounds__(THREADS) sparse_train_kernel(SparseArgs p) {
  table_train_loop<THREADS>(
      p.table, [&](int a, int b, int nw, int* dl, int* dr) {
        for (int c = blockIdx.x; c < p.NC; c += gridDim.x) {
          int8_t* pa = p.presT + (size_t)a * p.NC + c;
          int8_t* pb = p.presT + (size_t)b * p.NC + c;
          if (!(*pa && *pb)) continue;
          int r = 0;
          for (int col = c * CHUNK + threadIdx.x; col < (c + 1) * CHUNK;
               col += THREADS)
            r |= merge_column<L>(p.tw, p.W, col, a, b, nw, p.unk, p.wcount,
                                 dl, dr);
          const int matched = __syncthreads_or(r & MC_MATCHED);
          const int has_a = __syncthreads_or(r & MC_HAS_A);
          const int has_b = __syncthreads_or(r & MC_HAS_B);
          if (threadIdx.x == 0) {
            *pa = has_a ? 1 : 0;
            *pb = has_b ? 1 : 0;
            p.presT[(size_t)nw * p.NC + c] = matched ? 1 : 0;
          }
        }
      });
}

// ---------------------------------------------------------------------
// K4: the sharded merge chain, one launch per merge
// ---------------------------------------------------------------------

struct ChainArgs {
  int16_t* tw;       // this rank's columns [L, W]
  const int* wcount;
  int* hist;         // [v, v], the same on every rank
  int* rowmax;       // [2v]: (max, arg) per row
  int* d;            // [2, 2v]: dl | dr of merge i in d[i & 1]
  int* state;        // [8]: ST_ below
  int* records;      // [steps, 4]: (a, b, freq, did)
  int W, v, steps, unk, min_freq, n_done, init_done, allowed;
};

// the merge whose reduced deltas are still to be applied (pending), and
// whether a step could not merge (done: every record is written)
enum { ST_A, ST_B, ST_NEW, ST_PENDING, ST_DONE };

// phases of a chain launch, as phase_clock.cuh counts them
enum { CH_APPLY_ROWS, CH_APPLY, CH_APPLY_SYNC, CH_PICK, CH_CORPUS };

__global__ void __launch_bounds__(THREADS) chain_init_kernel(ChainArgs p) {
  const int nthreads = gridDim.x * THREADS;
  const int gtid = blockIdx.x * THREADS + threadIdx.x;
  table_init_rowmax(p.hist, reinterpret_cast<int2*>(p.rowmax), p.v,
                    gtid >> 5, nthreads >> 5);
  for (int c = gtid; c < 4 * p.v; c += nthreads) p.d[c] = 0;
  if (gtid == 0) p.state[ST_PENDING] = p.state[ST_DONE] = 0;
}

// Launch i < steps: apply merge i - 1, then merge i up to its deltas.
// Launch i == steps: apply the call's last merge only.
template <int L>
__global__ void __launch_bounds__(THREADS)
chain_step_kernel(ChainArgs p, int i) {
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const int v = p.v;
  const int nthreads = gridDim.x * THREADS;
  const int gtid = blockIdx.x * THREADS + threadIdx.x;
  const int gwarp = gtid >> 5, nwarps = nthreads >> 5;
  int2* rowmax = reinterpret_cast<int2*>(p.rowmax);
  // read by every block before the barrier; block 0 rewrites it after
  const volatile int* st = p.state;
  if (st[ST_DONE]) return;
  const int pending = st[ST_PENDING];
  const int pa = st[ST_A], pb = st[ST_B], pn = st[ST_NEW];
  PhaseClock clk;

  int* prev = p.d + ((i - 1) & 1) * 2 * v;  // dl | dr of merge i - 1
  if (pending) {
    const int lim = pn + 1 < v ? pn + 1 : v;
    table_update_rows<THREADS>(p.hist, rowmax, pa, pb, pn, lim, v, prev,
                               prev + v);
    clk.mark(CH_APPLY_ROWS);
    table_update_others(p.hist, rowmax, pa, pb, pn, lim, v, prev, gwarp,
                        nwarps);
    clk.mark(CH_APPLY);
  }
  if (i == p.steps) return;
  grid.sync();
  clk.mark(CH_APPLY_SYNC);
  if (pending)  // its last reader was the update above
    for (int c = gtid; c < 2 * v; c += nthreads) prev[c] = 0;

  const int nw = 256 + p.n_done + i;
  const int lim = nw + 1 < v ? nw + 1 : v;
  const Pick pk = table_pick_reduce(
      table_pick_scan<THREADS>(rowmax, lim, p.min_freq, v), v);
  clk.mark(CH_PICK);
  if (!(pk.m > 0 && !p.init_done && i < p.allowed)) {
    if (blockIdx.x == 0) {
      table_finish_records(p.records, i, p.steps, pk.m);
      if (threadIdx.x == 0) {
        p.state[ST_PENDING] = 0;
        p.state[ST_DONE] = 1;
      }
    }
    return;
  }
  if (gtid == 0) {
    int* rec = p.records + 4 * i;
    rec[0] = pk.a;
    rec[1] = pk.b;
    rec[2] = pk.m;
    rec[3] = 1;
    p.state[ST_A] = pk.a;
    p.state[ST_B] = pk.b;
    p.state[ST_NEW] = nw;
    p.state[ST_PENDING] = 1;
  }
  // _merge_kernel (bpe_hist.py:262-285): one thread per word column
  int* dl = p.d + (i & 1) * 2 * v;
  for (int col = gtid; col < p.W; col += nthreads)
    merge_column<L>(p.tw, p.W, col, pk.a, pk.b, nw, p.unk, p.wcount, dl,
                    dl + v);
  clk.mark(CH_CORPUS);
}

}  // namespace

SHRED_PHASE_READER(shred_step_phase_cycles)

extern "C" {

// `steps` merges of the sparse loop on `stream` in one kernel launch.
// tw int16 [L, W] (W = NC * 512), wcount int32 [W], hist int32 [v, v]
// and presT int8 [v, NC] (exact presence) are updated in place (v a
// multiple of 4, at most 65536); rowmax int32 [2v] (8-byte aligned) and
// dl/dr int32 [2v] are scratch; records int32 [steps, 4] receives (a, b,
// freq, did) per step.  Returns the launch's CUDA error, or 0.
int shred_hist_sparse_train(int16_t* tw, const int* wcount, int* hist,
                            int8_t* presT, int* rowmax, int* dl, int* dr,
                            int* records, int L, int W, int v, int NC,
                            int steps, int unk, int min_freq, int n_done,
                            int init_done, int allowed, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (v % 4 || v > 65536 || NC < 1 || (long long)NC * CHUNK != W)
    return (int)cudaErrorInvalidValue;
  if (steps < 1) return 0;
  SparseArgs p{{hist, rowmax, dl, dr, records, v, steps, min_freq, n_done,
                init_done, allowed},
               tw, wcount, presT, W, NC, unk};
  if (L == 16) return (int)coop_launch<sparse_train_kernel<16>>(s, &p);
  if (L == 32) return (int)coop_launch<sparse_train_kernel<32>>(s, &p);
  if (L == 64) return (int)coop_launch<sparse_train_kernel<64>>(s, &p);
  return (int)cudaErrorInvalidValue;
}

// The sharded chain's first launch of a call: the (max, arg) of every
// row of hist int32 [v, v] into rowmax int32 [2v] (8-byte aligned), both
// delta buffers d int32 [2, 2v] and the state int32 [8] zeroed.  Returns
// the launch's CUDA error, or 0.
int shred_hist_chain_init(int* hist, int* rowmax, int* d, int* state,
                          int v, void* stream) {
  if (v % 4 || v > 65536) return (int)cudaErrorInvalidValue;
  ChainArgs p{};
  p.hist = hist;
  p.rowmax = rowmax;
  p.d = d;
  p.state = state;
  p.v = v;
  int dev, sms;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return (int)err;
  chain_init_kernel<<<sms * TABLE_BLOCKS_PER_SM, THREADS, 0,
                      (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// Launch i of the chain (0 <= i <= steps) on this rank's tw int16 [L, W]
// and wcount int32 [W], after shred_hist_chain_init with the same
// buffers: i < steps applies merge i - 1 and runs merge i up to its
// deltas in d[i & 1], which the caller all-reduces before launch i + 1;
// i == steps applies the last merge.  records int32 [steps, 4] as in
// shred_hist_sparse_train.  Returns the launch's CUDA error, or 0.
int shred_hist_chain_step(int16_t* tw, const int* wcount, int* hist,
                          int* rowmax, int* d, int* state, int* records,
                          int L, int W, int v, int i, int steps, int unk,
                          int min_freq, int n_done, int init_done,
                          int allowed, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (v % 4 || v > 65536 || i < 0 || i > steps)
    return (int)cudaErrorInvalidValue;
  ChainArgs p{tw, wcount, hist, rowmax, d, state, records, W, v, steps,
              unk, min_freq, n_done, init_done, allowed};
  if (L == 16) return (int)coop_launch<chain_step_kernel<16>>(s, &p, &i);
  if (L == 32) return (int)coop_launch<chain_step_kernel<32>>(s, &p, &i);
  if (L == 64) return (int)coop_launch<chain_step_kernel<64>>(s, &p, &i);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
