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
//   - launch A (flat_apply_pick_kernel, cooperative): every rank's
//     compact list of the merge before, as gathered (or the ranks'
//     initial pair counts), read through its header: a rank whose count
//     passes the exchange's rows L halts the chain (HALT_FALLBACK), a
//     rank's overflow flag halts it too (HALT_OVERFLOW); every rank reads
//     the same headers, so every rank halts alike.  Otherwise the live
//     rows (only those: no pads) are added to the table (add_keys, 128
//     rows a warp side by side), a grid barrier, the pick (table_best),
//     the record and (a, b)'s count set to 0; below min_freq ST_DONE;
//   - launch M (flat_merge_kernel, a plain launch): unless halted or
//     done, F1's pass over this rank's chunks that hold a and b
//     (pair_pass), its net deltas summed in each warp's buffer and added
//     to the rank's delta table (add_keys<DELTA>, the same probes on a
//     table of at least twice the most distinct pairs a pass can change,
//     its used slots listed); the last block to finish (a ticket) reads
//     each used slot once, clears it and appends its nonzero sum to the
//     compact list, then writes the header (the count, the rank's
//     overflow flag).  So the list holds each changed pair of the span
//     once, exactly: the (key, delta) rows of bpe_ops.sum_by_key over the
//     span's pair counts before and after the merge, (a, b) left out
//     (deltas to (a, b) are dropped, as in F1).  When done it writes an
//     empty list with the flag; when halted it leaves the list as it is;
//   - the host (parallel/train.py exchange_rows): one all_gather of the
//     first 1 + L rows of every rank's list, a fixed size, with no host
//     read: the next merge's launch A reads it.
// The host reads the state once a call, and at a halt: on a fallback
// every rank exchanges the lists again with L grown to hold the longest
// and goes on from the halted merge; on an overflow flag every rank
// raises.
//
// What bounds it on the H100: per merge two launches and one collective
// (gloo stages a CUDA tensor through the host); the device work is F1's
// (flat.cu's header), plus the adds of every rank's distinct changed
// pairs and the compaction of one rank's.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flat_table.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace shred;

constexpr int ADD_K = BUF / 32;  // gathered rows a lane adds side by side

// The j-th live row of the nb gathered lists of `in` ([nb, 1 + rows, 2];
// a list's header holds its count), taken in rank order
__device__ __forceinline__ const long long* live_row(const long long* in,
                                                     size_t stride, int j) {
  for (;; in += stride) {
    const int n = (int)in[0];
    if (j < n) return in + 2 * (size_t)(j + 1);
    j -= n;
  }
}

// Launch A of merge i: the gathered lists' headers, their live rows
// added to the table, then the pick and its record.
__global__ void __launch_bounds__(THREADS)
flat_apply_pick_kernel(FlatArgs p, const long long* in, int nb, int rows,
                       int i) {
  if (p.st[ST_HALT] || p.st[ST_DONE]) return;  // the call's chain stopped
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gwarp = blockIdx.x * WARPS + warp, nwarps = gridDim.x * WARPS;
  __shared__ int s_c[WARPS], s_e[WARPS];
  __shared__ unsigned long long s_k[WARPS];
  PhaseClock clk;
  int refreshed = 0;
  // every thread reads the headers alike, so every block halts alike
  const size_t stride = 2 * (size_t)(1 + rows);
  long long total = 0;
  bool flagged = false, longer = false;
  for (int r = 0; r < nb; ++r) {
    const long long n = in[r * stride];
    flagged |= in[r * stride + 1] != 0;
    longer |= n < 0 || n > rows;
    total += n;
  }
  if (flagged || longer) {
    if (blockIdx.x == 0 && tid == 0)
      p.st[ST_HALT] = flagged ? HALT_OVERFLOW : HALT_FALLBACK;
    return;
  }
  if (blockIdx.x == 0 && tid == 0) p.st[ST_ADDED] += (int)total;
  for (int base = gwarp * 32 * ADD_K; base < total;
       base += nwarps * 32 * ADD_K) {
    unsigned long long key[ADD_K];
    int d[ADD_K];
#pragma unroll
    for (int r = 0; r < ADD_K; ++r) {
      const int j = base + 32 * r + lane;
      const long long* row = j < total ? live_row(in, stride, j) : nullptr;
      key[r] = row ? (unsigned long long)row[0] : EMPTY;
      d[r] = row ? (int)row[1] : 0;
    }
    add_keys<ADD_K>(p, key, d);
  }
  if (total) grid.sync();
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
  if (blockIdx.x == 0 && tid == 0) p.st[ST_STEPS] = i + 1;
}

// The end of launch M, on its last block to finish: every used slot of
// the delta table read once and cleared, the nonzero sums appended to the
// compact list, then its header.  s_n is a shared int.
__device__ void compact_deltas(const FlatArgs& p, int* s_n) {
  const int tid = threadIdx.x, lane = tid & 31;
  const int used = __ldcg(p.st + ST_USED);
  if (tid == 0) *s_n = 0;
  __syncthreads();
  for (int base = 0; base < used; base += THREADS) {
    const int j = base + tid;
    unsigned long long key = EMPTY;
    int d = 0;
    if (j < used) {
      const int slot = __ldcg(p.dused + j);
      key = __ldcg(p.dkey + slot);
      d = __ldcg(p.dval + slot);
      p.dkey[slot] = EMPTY;
      p.dval[slot] = 0;
    }
    const unsigned live = __ballot_sync(FULL, d != 0);
    int at = 0;
    if (lane == 0 && live) at = atomicAdd(s_n, __popc(live));
    at = __shfl_sync(FULL, at, 0) + __popc(live & ((1u << lane) - 1));
    if (d != 0 && at < p.scap) {
      p.send[2 * (size_t)(at + 1)] = (long long)key;
      p.send[2 * (size_t)(at + 1) + 1] = d;
    }
  }
  __syncthreads();
  if (tid == 0) {
    const int n = *s_n;
    // cannot happen: scap is at least the most distinct pairs a pass
    // can change
    if (n > p.scap) atomicExch(p.st + ST_OVERFLOW, 1);
    p.send[0] = n;
    p.send[1] = __ldcg(p.st + ST_OVERFLOW);
    p.st[ST_LISTED] += n;
    p.st[ST_USED] = 0;
    p.st[ST_TICKET] = 0;
  }
}

// Launch M of merge i: the pass over this rank's words, its deltas into
// the delta table, then (the last block) the compact list.
__global__ void __launch_bounds__(THREADS)
flat_merge_kernel(FlatArgs p, int i) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (p.st[ST_HALT]) return;  // the lists stay for the exchange again
  if (p.st[ST_DONE]) {        // launch A found no pair: an empty list
    if (blockIdx.x == 0 && tid == 0) {
      p.send[0] = 0;
      p.send[1] = p.st[ST_OVERFLOW];
    }
    return;
  }
  const int gwarp = blockIdx.x * WARPS + warp, nwarps = gridDim.x * WARPS;
  __shared__ int s_lanes[THREADS];
  __shared__ unsigned long long s_dkey[WARPS * BUF];
  __shared__ int s_d[WARPS * BUF];
  __shared__ int s_last, s_n;
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
  // the last block to finish sees every block's adds and listed slots:
  // each thread fences them before its block takes a ticket
  __threadfence();
  __syncthreads();
  if (tid == 0)
    s_last = atomicAdd(p.st + ST_TICKET, 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  compact_deltas(p, &s_n);
}

}  // namespace

extern "C" {

// Launch A (phase 0) or M (phase 1) of merge i (0 <= i < steps) of S1's
// chain on `stream`; merge i creates id 256 + n_done + i.  The state is
// F1's (shred_flat_train's arguments, the table sized on the whole
// stream, already counted; st int32 [ST_WORDS]); records int32
// [steps, 3] receives merge i's (a, b, count) from launch A and
// st[ST_STEPS] i + 1; in int64 [nb, 1 + rows, 2] holds the gathered
// lists launch A adds first, each a header (count, overflow flag) and
// its rows; dkey uint64 [dcap] (all ~0 at first) and dval int32 [dcap]
// are the delta table launch M adds to and leaves clear (dcap a power of
// two, at least twice the most distinct pairs a merge changes on the
// span), dused int32 [dcap] its used slots; send int64 [1 + scap, 2]
// receives launch M's compact list: its header, then (key, delta) rows.
// st[ST_DONE] != 0 after launch A: no pair reaches min_freq (launch M
// then writes an empty list); st[ST_HALT] != 0: a list was longer than
// rows (HALT_FALLBACK) or flagged (HALT_OVERFLOW), and the launches
// after it do nothing until the caller clears it; st[ST_OVERFLOW] != 0:
// this rank's table, delta table or list was full.  Returns the
// launch's CUDA error, or 0.
int shred_flat_sharded_step(int* tokens, const int* off, int* len,
                            const int* wcnt, unsigned* pres, uint4* sig,
                            unsigned long long* tkey, int* cnt,
                            unsigned long long* skey,
                            unsigned long long* sce, int* dirty, int* st,
                            unsigned long long* bbest, int* records,
                            unsigned long long* dkey, int* dval, int* dused,
                            long long* send, const long long* in, int W,
                            int ncw, int cap, int dcap, int scap, int steps,
                            int unk, int min_freq, int n_done, int nb,
                            int rows, int i, int phase, int max_blocks,
                            void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int nc = (W + CHUNK_WORDS - 1) / CHUNK_WORDS;
  if (cap < SEG || cap > (1 << 30) || (cap & (cap - 1)) || dcap < 2 ||
      dcap > (1 << 30) || (dcap & (dcap - 1)) || scap < 1 || W < 0 ||
      steps < 1 || ncw < (nc + 31) / 32 || i < 0 || i >= steps || nb < 1 ||
      rows < 0 || (phase != 0 && phase != 1))
    return (int)cudaErrorInvalidValue;
  FlatArgs p{tokens, off,   len,     wcnt, pres, sig,  tkey, cnt,
             skey,   sce,   dirty,   st,   bbest, records,
             W,      nc,    ncw,     (unsigned)(cap - 1),
             steps,  unk,   min_freq, n_done, 0,
             dkey,   dval,  dused,   (unsigned)(dcap - 1), send, scap};
  cudaError_t err;
  if (phase == 0) {
    const int blocks =
        grid_blocks(flat_apply_pick_kernel, max_blocks, &err);
    if (!blocks) return (int)err;
    void* args[] = {&p, &in, &nb, &rows, &i};
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
