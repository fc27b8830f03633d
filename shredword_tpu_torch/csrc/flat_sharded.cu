// The sharded flat-engine BPE merge loop for Hopper (sm_90a), any vocab
// and any word length, over the ranks of a torch.distributed group (S1).
//
// Replaces shard_body of build_sharded_train_loop
// (shredword_tpu/parallel/train.py:175), XLA in the JAX package, which at
// every merge sorts the pairs of each chip's span again, all-gathers the
// distinct ones, sums them by key and takes the argmax on every chip
// alike, then merges and compacts the own span.  Here each rank keeps
// F1's state (flat.cu; bpe_ops.FlatState) of its own words, and its pair
// table holds the counts of the WHOLE corpus: every rank adds every
// rank's deltas, so the tables hold the same counts (in other slots: the
// keys arrive in other orders) and every rank picks the same pair with
// no broadcast; the pick depends on (count, key) alone.  The table's
// capacity is sized on the whole stream's N, since F1's bound of 3N keys
// holds only over the whole corpus.
//
// A rank alone (world 1) runs F1's persistent launch (flat.cu) on its
// span.  This file is the chain of world > 1; per merge i of a call:
//   - launch A (flat_apply_pick_kernel, cooperative): the gathered delta
//     lists of every rank (of the merge before, or the ranks' initial
//     pair counts) added to the table (flat_table.cuh's add_keys, 128
//     entries a warp side by side; pads have key -1, the table's EMPTY),
//     a grid barrier, the pick (table_best), the record and (a, b)'s
//     count set to 0; below min_freq it sets ST_DONE instead;
//   - launch M (flat_merge_kernel, a plain launch): unless done, F1's
//     pass over this rank's chunks that hold a and b (pair_pass), its net
//     deltas summed by key in each warp's buffer and appended to the
//     rank's delta list, (key, delta) int64 pairs, not to the table;
//     deltas to (a, b) are dropped, as in F1;
//   - the host (parallel/train.py gather_padded): the list's length and
//     the state read back, one all_reduce(MAX) of the length, one
//     all_gather of the lists padded to it: launch A's input for the
//     next merge, kept across calls.
// A pass appends at most 2N_r deltas (N_r the rank's tokens): at most
// four a merged occurrence, and at most N_r / 2 occurrences.
//
// What bounds it on the H100: per merge two launches, a host round trip
// for the list's length and two collectives; the device work is F1's
// (flat.cu's header), plus the adds of every rank's deltas.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flat_table.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace shred;

constexpr int ADD_K = BUF / 32;  // gathered deltas a lane adds side by side

// Launch A of merge i: add the n_in gathered (key, delta) pairs of `in`
// to the table, then the pick and its record.
__global__ void __launch_bounds__(THREADS)
flat_apply_pick_kernel(FlatArgs p, const long long* in, int n_in, int i) {
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gwarp = blockIdx.x * WARPS + warp, nwarps = gridDim.x * WARPS;
  __shared__ int s_c[WARPS], s_e[WARPS];
  __shared__ unsigned long long s_k[WARPS];
  PhaseClock clk;
  int refreshed = 0;
  if (blockIdx.x == 0 && tid == 0) p.st[ST_LISTED] = 0;  // M appends from 0
  for (int base = gwarp * 32 * ADD_K; base < n_in;
       base += nwarps * 32 * ADD_K) {
    unsigned long long key[ADD_K];
    int d[ADD_K];
#pragma unroll
    for (int r = 0; r < ADD_K; ++r) {
      const int j = base + 32 * r + lane;
      key[r] = j < n_in ? (unsigned long long)in[2 * (size_t)j] : EMPTY;
      d[r] = j < n_in ? (int)in[2 * (size_t)j + 1] : 0;
    }
    add_keys<ADD_K>(p, key, d);
  }
  if (n_in) grid.sync();
  int c, e;
  unsigned long long k;
  table_best(p, grid, gwarp, nwarps, c, k, e, refreshed, s_c, s_k, s_e,
             clk);
  if (lane == 0 && refreshed) atomicAdd(p.st + ST_REFRESHED, refreshed);
  if (c < max(p.min_freq, 1)) {
    if (blockIdx.x == 0 && tid == 0) p.st[ST_DONE] = 1;
    return;
  }
  record_pick(p, i, c, k, e);
}

// Launch M of merge i: the pass over this rank's words, its deltas into
// the delta list.
__global__ void __launch_bounds__(THREADS)
flat_merge_kernel(FlatArgs p, int i) {
  if (p.st[ST_DONE]) return;  // launch A found no pair
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gwarp = blockIdx.x * WARPS + warp, nwarps = gridDim.x * WARPS;
  __shared__ int s_lanes[THREADS];
  __shared__ unsigned long long s_dkey[WARPS * BUF];
  __shared__ int s_d[WARPS * BUF];
  int* lanes = s_lanes + warp * 32;
  Deltas q{s_dkey + warp * BUF, s_d + warp * BUF, 0};
  int merged = 0, visited = 0, candidates = 0;
  const int* rec = p.records + 3 * i;
  pair_pass<true>(p, q, gwarp, nwarps, rec[0], rec[1], 256 + p.n_done + i,
                  lanes, merged, visited, candidates);
  if (q.n) flush<true>(p, q.key, q.d, q.n);
  if (lane == 0 && merged) atomicAdd(p.st + ST_MERGED, merged);
  if (lane == 0 && visited) atomicAdd(p.st + ST_VISITED, visited);
  if (lane == 0 && candidates)
    atomicAdd(p.st + ST_CANDIDATES, candidates);
}

}  // namespace

extern "C" {

// Launch A (phase 0) or M (phase 1) of merge i (0 <= i < steps) of S1's
// chain on `stream`; merge i creates id 256 + n_done + i.  The state is
// F1's (shred_flat_train's arguments, the table sized on the whole
// stream, already counted); records int32 [steps, 3] receives merge i's
// (a, b, count) from launch A; in int64 [n_in, 2] holds the gathered
// (key, delta) pairs launch A adds first (key -1: none); dlist int64
// [lcap, 2] receives launch M's deltas, st[ST_LISTED] their number.
// st[ST_DONE] != 0 after launch A: no pair reaches min_freq (launch M then
// does nothing); st[ST_OVERFLOW] != 0: the table or the list was full.
// Returns the launch's CUDA error, or 0.
int shred_flat_sharded_step(int* tokens, const int* off, int* len,
                            const int* wcnt, unsigned* pres, uint4* sig,
                            unsigned long long* tkey, int* cnt,
                            unsigned long long* skey,
                            unsigned long long* sce, int* dirty, int* st,
                            unsigned long long* bbest, int* records,
                            long long* dlist, const long long* in, int W,
                            int ncw, int cap, int steps, int unk,
                            int min_freq, int n_done, int lcap, int n_in,
                            int i, int phase, int max_blocks, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int nc = (W + CHUNK_WORDS - 1) / CHUNK_WORDS;
  if (cap < SEG || cap > (1 << 30) || (cap & (cap - 1)) || W < 0 ||
      steps < 1 || ncw < (nc + 31) / 32 || i < 0 || i >= steps ||
      n_in < 0 || lcap < 1 || (phase != 0 && phase != 1))
    return (int)cudaErrorInvalidValue;
  FlatArgs p{tokens, off,   len,     wcnt, pres, sig,  tkey, cnt,
             skey,   sce,   dirty,   st,   bbest, records,
             W,      nc,    ncw,     (unsigned)(cap - 1),
             steps,  unk,   min_freq, n_done, 0, dlist, lcap};
  cudaError_t err;
  if (phase == 0) {
    const int blocks =
        grid_blocks(flat_apply_pick_kernel, max_blocks, &err);
    if (!blocks) return (int)err;
    void* args[] = {&p, &in, &n_in, &i};
    err = cudaLaunchCooperativeKernel((const void*)flat_apply_pick_kernel,
                                      dim3(blocks), dim3(THREADS), args, 0,
                                      s);
    if (err != cudaSuccess) return (int)err;
  } else {
    const int blocks = grid_blocks(flat_merge_kernel, max_blocks, &err);
    if (!blocks) return (int)err;
    flat_merge_kernel<<<blocks, THREADS, 0, s>>>(p, i);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
