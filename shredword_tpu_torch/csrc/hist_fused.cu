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
//     occupancy calculator, hist_table.cuh's coop_launch), two grid
//     barriers per merge;
//   - the table, its (max, arg) per row, the pick and the update of
//     hist_table.cuh: the pick needs no barrier and the update only
//     touches what changes;
//   - dl/dr are two buffers used in turn: merge i adds into buffer i & 1
//     and zeroes the other one during its update, after the last read of
//     it, so the zeroing costs no barrier.
// Data written by other blocks in the same launch is read through L2:
// the file is built with -dlcm=cg (global loads bypass the incoherent
// L1), and grid.sync() orders the phases.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hist_table.cuh"
#include "merge_column.cuh"
#include "phase_clock.cuh"

namespace {

using namespace shred;

constexpr int THREADS = TABLE_THREADS;

struct HistArgs {
  TableArgs table;
  int16_t* tw;
  const int* wcount;
  int W, unk;
};

template <int L>
__global__ void __launch_bounds__(THREADS) hist_train_kernel(HistArgs p) {
  const int nthreads = gridDim.x * THREADS;
  const int gtid = blockIdx.x * THREADS + threadIdx.x;
  table_train_loop<THREADS>(
      p.table, [&](int a, int b, int nw, int* dl, int* dr) {
        // corpus (bpe_hist.py:141-248): one thread per word column
        for (int col = gtid; col < p.W; col += nthreads)
          merge_column<L>(p.tw, p.W, col, a, b, nw, p.unk, p.wcount, dl, dr);
      });
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
  HistArgs p{{hist, rowmax, dl, dr, records, v, steps, min_freq, n_done,
              init_done, allowed},
             tw, wcount, W, unk};
  if (L == 16) return (int)coop_launch<hist_train_kernel<16>>(s, &p);
  if (L == 32) return (int)coop_launch<hist_train_kernel<32>>(s, &p);
  if (L == 64) return (int)coop_launch<hist_train_kernel<64>>(s, &p);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
