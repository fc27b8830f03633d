// Flat-engine BPE merge loop for Hopper (sm_90a), any vocab and any word
// length (F1): one persistent cooperative launch per call.
//
// Replaces the XLA loop shredword_tpu/ops/bpe_ops.py::train_loop (with
// best_pair, pair_counts_sorted, select_matches and apply_merge), which
// sorts every pair of the stream again at every merge and compacts the
// stream after it.  Here the pair counts live in a hash table that each
// merge updates exactly, and the words are merged in place.  State, all in
// device memory, built once per train() (bpe_ops.FlatState) and updated in
// place by every call:
//   tokens  int32 [N]   the unique words, word w at off[w] with its live
//                       length len[w]; a merge rewrites the word in place,
//                       left-aligned (positions past len[w] are stale)
//   off     int32 [W+1], len int32 [W], wcnt int32 [W] (the word's count)
//   pres    uint32 [rows, ncw]  the presence index: bit c of row x is set
//                       when chunk c (words 32c .. 32c + 31) may hold id
//                       x; nc = ceil(W / 32) chunks, ncw = ceil(nc / 32)
//                       words a row, a row for every id the run makes
//   sig     uint4 [W]   each word's signature: bit sig_bit(x) of its 128
//                       set for every id x it holds
//   tkey    uint64 [cap] open-addressing table of the pair keys
//                       (a << 32) | b (EMPTY = ~0), linear probing, cap a
//                       power of two >= 6N; keys are never removed
//   cnt     int32 [cap]  each slot's exact count (a pair no longer in the
//                       stream counts 0)
//   skey, sce uint64 [cap / SEG], dirty int32 [cap / SEG]: the kept
//                       maximum of each segment of SEG slots, its key and
//                       (count << 32) | slot, valid unless dirty
//   st      int32 [8]    the ST_ words of flat_table.cuh
// At most 3N keys: the stream starts with at most N - 1 pairs, and each
// merged occurrence shortens it by one and creates at most two keys, so
// the table stays at most half full.  On the long-word corpus at vocab
// 32768 pres takes 4.7 MB and sig 0.6 MB, the table 201 MB.
//
// A merge (a, b) -> nw, nw = 256 + n_done + i:
//   - pick: each warp reads the kept maxima of its segments, 32 at once,
//     and recomputes the dirty ones (a segment is dirty when one of its
//     counts changed); the largest count, ties to the smallest key, which
//     is the smallest (a, b) at any vocab (ids are >= 0), found by warp
//     reductions (__reduce_max_sync, __reduce_min_sync); a block result
//     each, a grid barrier, then every block reduces the block results
//     alike, one a thread; done when it is below min_freq;
//   - record (a, b, count), and set the count of (a, b) to 0: after the
//     merge no (a, b) is left in the stream (greedy left to right takes
//     every occurrence not consumed by a run), so that is exact;
//   - pass: the chunks whose presence holds both a and b (a for a ==
//     b), a warp for each unit of 8 of their words, unit u on warp u mod
//     (warps) in every merge of a launch, so its words stay in that SM's
//     L1.  A word whose signature lacks a or b is skipped; the others are
//     merged in place, each by a lane group of 4, 8, 16 or 32 lanes by
//     its live length, one token a lane (a word over 32 tokens in
//     segments of 32): a ballot of the positions that hold (a, b), the
//     reference's greedy left-to-right rule (bpe.cpp:480-482: in a run
//     "a a a a" with a == b the pairs at 0 and 2 merge) by bit operations
//     with the selection carried across segments, the compaction by a
//     popcount of the kept positions, and the new signature.  At a
//     merged occurrence at r, the left pair (t[r-1], a) -> (t[r-1], nw),
//     or, right after another merged occurrence, (b, a) -> (nw, nw); the
//     right pair (b, t[r+2]) -> (nw, t[r+2]) unless the next occurrence
//     starts at r + 2 (that one takes it as its left pair).  Each pair
//     destroyed or created is counted once, so the counts stay exact with
//     no pair created and cancelled (the net form of the reference's
//     delta accounting, bpe.cpp:437-517).  Pairs that hold unk are never
//     counted, as pair_counts skips them; the merge itself matches raw
//     ids (select_matches has no unk exclusion).  Deltas to (a, b) are
//     skipped: its count is 0 already.  The deltas gather in the warp's
//     buffer in shared memory; at its end (or when full) the deltas of
//     equal keys are summed (__match_any_sync) and each lane probes its
//     share of the keys side by side: the slot loads at once, the swaps
//     of empty slots at once, then the adds, which mark their segments
//     dirty.  A chunk where a merge happened gets nw's presence bit.  Then
//     a grid barrier.
// The first launch counts the stream's pairs the same way, a lane a pair.
// The presence index and the signatures are exact as supersets: a word
// gains an id only through the merge that creates it, which sets the
// id's presence bit in its chunk and recomputes the word's signature;
// presence bits are never cleared.
//
// What bounds it on the H100: the bytes a merge must move are the tokens
// of the words that hold (a, b), the pairs whose counts change and the
// record, well under a microsecond; the time is latency: the dependent
// loads of a unit's words, the table probes, the pick's loads and two
// grid barriers.  The first version's split of a merge (phase clocks,
// the long-word corpus at vocab 32768, whole run, µs per merge, mean
// block; PERF.md) led the design: the pass barrier 10.2 and the pass 4.4
// (its largest block 9.2: a thread walked each word, every word at every
// merge, its probes in one chain), so the presence index, the
// signatures, the lane groups and the buffered side-by-side probes; the
// pick's scan of every entry 4.3, so the kept segment maxima; its reduce
// of the block results by one warp 1.8, so one a thread.  Tried on the
// card and left out: the pick's barrier as an exchange of tagged block
// results (slower: the spinning threads), a prefetch of each unit's
// tokens into L1, dealing the flagged units to the warps in turn (the
// units' words then leave L1), marking a segment dirty only when its kept
// maximum may change (fewer recomputes, but the adds then wait for their
// old counts), segments of 1,024 slots, and a grid barrier of
// release/acquire atomics in place of grid.sync().  The two grid
// barriers stay: each costs about 2.3 µs of its own.
//
// Data written by other blocks in the same launch (the table, the
// segment maxima, the presence index, the state and the block results)
// is read through L2 (__ldcg and atomics); a unit's words (tokens,
// lengths, signatures) are read and written only by the warp that owns
// the unit in this launch, through L1.
//
// The table, the pick and the word pass are in flat_table.cuh, which S1
// (flat_sharded.cu, the sharded flat loop) shares.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flat_table.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace shred;

__global__ void __launch_bounds__(THREADS) flat_train_kernel(FlatArgs p) {
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gwarp = blockIdx.x * WARPS + warp, nwarps = gridDim.x * WARPS;
  __shared__ int s_c[WARPS], s_e[WARPS];
  __shared__ unsigned long long s_k[WARPS];
  __shared__ int s_lanes[THREADS];
  __shared__ unsigned long long s_dkey[WARPS * BUF];
  __shared__ int s_d[WARPS * BUF];
  int* lanes = s_lanes + warp * 32;
  Deltas q{s_dkey + warp * BUF, s_d + warp * BUF, 0};
  PhaseClock clk;
  // this warp's occurrences merged, chunks visited, words whose
  // signature holds the pair and segments refreshed, over the launch
  int merged = 0, visited = 0, candidates = 0, refreshed = 0;

  if (p.init) {  // the initial count: each pair adds its word's count
    for (int u = gwarp; u < p.nc * UNITS; u += nwarps)
      unit_pass<true>(p, q, u * UNIT_WORDS, 0, 0, 0, EMPTY, lanes,
                      candidates);
    if (q.n) flush(p, q.key, q.d, q.n);
    q.n = 0;
    grid.sync();
    clk.mark(PH_INIT);
  }

  int i = 0, done = 0;
  for (; i < p.steps; ++i) {
    if (__ldcg(p.st + ST_OVERFLOW)) break;
    int c, e;
    unsigned long long k;
    table_best(p, grid, gwarp, nwarps, c, k, e, refreshed, s_c, s_k, s_e,
               clk);
    if (c < max(p.min_freq, 1)) {
      done = 1;
      break;
    }
    const int a = (int)(k >> 32), b = (int)(unsigned)k;
    record_pick(p, i, c, k, e);
    pair_pass<false>(p, q, gwarp, nwarps, a, b, 256 + p.n_done + i, lanes,
                     merged, visited, candidates);
    clk.mark(PH_PASS);
    if (q.n) flush(p, q.key, q.d, q.n);
    q.n = 0;
    clk.mark(PH_PASS_TABLE);
    grid.sync();
    clk.mark(PH_PASS_SYNC);
  }
  if (lane == 0 && merged) atomicAdd(p.st + ST_MERGED, merged);
  if (lane == 0 && visited) atomicAdd(p.st + ST_VISITED, visited);
  if (lane == 0 && refreshed) atomicAdd(p.st + ST_REFRESHED, refreshed);
  if (lane == 0 && candidates)
    atomicAdd(p.st + ST_CANDIDATES, candidates);
  if (blockIdx.x == 0 && tid == 0) {
    p.st[ST_STEPS] = i;
    p.st[ST_DONE] = done;
  }
}

}  // namespace

SHRED_PHASE_READER(shred_flat_phase_cycles)

extern "C" {

// Runs up to `steps` merges of the flat engine on `stream` in one kernel
// launch, the first creating id 256 + n_done; init != 0 counts the
// stream's pairs into the (empty) table first.  tokens, len, pres, sig,
// tkey, cnt, skey, sce, dirty and st are updated in place (layout in the
// header; cap a power of two, at least 256 and at most 2^30; skey, sce
// and dirty hold cap / 256; pres has a row for every id up to
// 256 + n_done + steps and ncw >= ceil(nc / 32) words a row, nc =
// ceil(W / 32)); bbest uint64 [2 * max_blocks] is scratch; records int32
// [steps, 3] receives (a, b, count) per merge.  st[ST_STEPS] and
// st[ST_DONE] give the merges made and whether the loop found no pair
// reaching min_freq; st[ST_OVERFLOW] != 0 means the table was full and
// the counts are no longer exact; st[ST_VISITED], st[ST_CANDIDATES] and
// st[ST_REFRESHED] count the chunks the passes visited, the words there
// whose signature holds the pair and the segment maxima the picks
// recomputed.  Returns the launch's CUDA error, or 0.
int shred_flat_train(int* tokens, const int* off, int* len, const int* wcnt,
                     unsigned* pres, uint4* sig, unsigned long long* tkey,
                     int* cnt, unsigned long long* skey,
                     unsigned long long* sce, int* dirty, int* st,
                     unsigned long long* bbest, int* records, int W, int ncw,
                     int cap, int steps, int unk, int min_freq, int n_done,
                     int init, int max_blocks, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int nc = (W + CHUNK_WORDS - 1) / CHUNK_WORDS;
  if (cap < SEG || cap > (1 << 30) || (cap & (cap - 1)) || W < 0 ||
      steps < 1 || ncw < (nc + 31) / 32)
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
  const int blocks = grid_blocks(flat_train_kernel, max_blocks, &err);
  if (!blocks) return (int)err;
  FlatArgs p{tokens, off,   len,     wcnt, pres, sig,  tkey, cnt,
             skey,   sce,   dirty,   st,   bbest, records,
             W,      nc,    ncw,     (unsigned)(cap - 1),
             steps,  unk,   min_freq, n_done, init};
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel((const void*)flat_train_kernel,
                                    dim3(blocks), dim3(THREADS), args, 0, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
