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
//   tkey    uint64 [cap] open-addressing table of the pair keys
//                       (a << 32) | b (EMPTY = ~0), linear probing, cap a
//                       power of two; keys are never removed
//   tent    int32 [cap]  the entry of each slot (-1 until its inserter
//                       has set it)
//   ekey    uint64 [ecap], ecnt int32 [ecap]: one dense entry per key, in
//                       the order of insertion, with its exact count (a
//                       pair no longer in the stream counts 0)
//   st      int32 [8]    the ST_ words below
// ecap = cap / 2 >= 3N: the stream starts with at most N - 1 pairs, and
// each merged occurrence shortens it by one and creates at most two keys.
//
// A merge (a, b) -> nw, nw = 256 + n_done + i:
//   - pick: every thread scans its share of the entries for the largest
//     count that reaches min_freq, ties to the smallest key, which is the
//     smallest (a, b) at any vocab (ids are >= 0); a block result each,
//     a grid barrier, then every block reduces the block results alike;
//   - record (a, b, count), and set the count of (a, b) to 0: after the
//     merge no (a, b) is left in the stream (greedy left to right takes
//     every occurrence not consumed by a run), so that is exact;
//   - merge pass: one thread per word scans it for (a, b); a word that
//     holds it is rewritten left to right as the reference's
//     non-advancing splice does (bpe.cpp:480-482: in a run "a a a a"
//     with a == b the pairs at 0 and 2 merge), and the pairs it destroys
//     and creates go to the table as integer atomics: at a merged
//     occurrence at r, the left pair (t[r-1], a) -> (t[r-1], nw), or,
//     right after another merged occurrence, (b, a) -> (nw, nw); the
//     right pair (b, t[r+2]) -> (nw, t[r+2]) unless the next occurrence
//     starts at r + 2 (that one takes it as its left pair).  Each pair
//     destroyed or created is counted once, so the counts stay exact
//     with no pair created and cancelled (the net form of the reference's
//     delta accounting, bpe.cpp:437-517).  Pairs that hold unk are never
//     counted, as pair_counts skips them; the merge itself matches raw
//     ids (select_matches has no unk exclusion).  Deltas to (a, b) are
//     skipped: its count is 0 already.  Then a grid barrier.
//
// What bounds it on the H100: per merge the pick reads every entry's
// count (4 bytes an entry; its key only where the count ties or beats
// the thread's best) and the merge pass reads every live token, one
// thread per word; two grid barriers order the phases.  The bound of a
// merge is those bytes over the memory rate.  This first version keeps
// zero-count entries in the scan and scans every word at every merge:
// presence skipping and a warp for each long word come later.
//
// Data written by other blocks in the same launch (the table, the
// entries, the state and the block results) is read through L2 (__ldcg,
// volatile loads and atomics); a word's tokens and length are read and
// written only by the thread that owns it, through L1.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int THREADS = 256;
// co-resident blocks per SM, at most: more only make the grid barrier
// dearer
constexpr int BLOCKS_PER_SM = 2;
constexpr unsigned long long EMPTY = ~0ull;
constexpr int UNSET = -1;  // tent: the inserter has not set the entry yet
constexpr int LOST = -2;   // tent: no entry was left (the overflow flag)

// st[]
enum { ST_ENTRIES = 0, ST_OVERFLOW, ST_MERGED, ST_STEPS, ST_DONE };

struct FlatArgs {
  int* tokens;
  const int* off;
  int* len;
  const int* wcnt;
  unsigned long long* tkey;
  int* tent;
  unsigned long long* ekey;
  int* ecnt;
  int* st;
  unsigned long long* bbest;  // [2 * gridDim.x]: key, (count << 32) | entry
  int* records;               // [steps, 3]
  int W;
  unsigned mask;  // cap - 1
  int ecap, steps, unk, min_freq, n_done, init;
};

__device__ __forceinline__ unsigned slot_of(unsigned long long k,
                                            unsigned mask) {
  k ^= k >> 33;
  k *= 0xff51afd7ed558ccdull;
  k ^= k >> 33;
  k *= 0xc4ceb9fe1a85ec53ull;
  k ^= k >> 33;
  return (unsigned)k & mask;
}

// The entry of `key`, inserted if absent; < 0 when the table or the
// entries are full (the overflow flag is then set).
__device__ int entry_of(const FlatArgs& p, unsigned long long key) {
  unsigned s = slot_of(key, p.mask);
  for (unsigned probe = 0; probe <= p.mask; ++probe, s = (s + 1) & p.mask) {
    unsigned long long k = __ldcg(p.tkey + s);
    if (k == EMPTY) {
      k = atomicCAS(p.tkey + s, EMPTY, key);
      if (k == EMPTY) {  // this thread inserted the key
        int e = atomicAdd(p.st + ST_ENTRIES, 1);
        if (e < p.ecap) {
          p.ekey[e] = key;
        } else {
          atomicExch(p.st + ST_OVERFLOW, 1);
          e = LOST;
        }
        __threadfence();
        atomicExch(p.tent + s, e);
        return e;
      }
    }
    if (k == key) {  // wait for its inserter to publish the entry
      int e;
      while ((e = *(volatile int*)(p.tent + s)) == UNSET) {
      }
      return e;
    }
  }
  atomicExch(p.st + ST_OVERFLOW, 1);
  return LOST;
}

// count(x, y) += d, unless the pair holds unk or is `skip`
__device__ __forceinline__ void add_pair(const FlatArgs& p, int x, int y,
                                         int d, unsigned long long skip) {
  if (x == p.unk || y == p.unk) return;
  const unsigned long long key =
      ((unsigned long long)(unsigned)x << 32) | (unsigned)y;
  if (key == skip) return;
  const int e = entry_of(p, key);
  if (e >= 0) atomicAdd(p.ecnt + e, d);
}

// (c, k, e) becomes the better of itself and (c2, k2, e2): the larger
// count, then the smaller key
__device__ __forceinline__ void take_better(int& c, unsigned long long& k,
                                            int& e, int c2,
                                            unsigned long long k2, int e2) {
  if (c2 > c || (c2 == c && k2 < k)) {
    c = c2;
    k = k2;
    e = e2;
  }
}

__device__ __forceinline__ void warp_best(int& c, unsigned long long& k,
                                          int& e) {
  for (int o = 16; o > 0; o >>= 1)
    take_better(c, k, e, __shfl_xor_sync(0xffffffffu, c, o),
                __shfl_xor_sync(0xffffffffu, k, o),
                __shfl_xor_sync(0xffffffffu, e, o));
}

// Merges (a, b) -> nw in one word in place; returns the occurrences
// merged.  The table gets the word's net pair deltas (header).
__device__ int merge_word(const FlatArgs& p, int w, int a, int b, int nw,
                          unsigned long long ab) {
  const int n = p.len[w];
  if (n < 2) return 0;
  int* t = p.tokens + p.off[w];
  int r = -1, prev = t[0];
  for (int j = 1; j < n; ++j) {
    const int cur = t[j];
    if (prev == a && cur == b) {
      r = j - 1;
      break;
    }
    prev = cur;
  }
  if (r < 0) return 0;
  const int wc = p.wcnt[w];
  int o = r, last = r > 0 ? t[r - 1] : 0, merged = 0;
  bool prev_merged = false;  // the last token written is a merged one
  while (r < n) {  // o <= r: every read is ahead of every write
    const int x = t[r];
    if (r + 1 < n && x == a && t[r + 1] == b) {
      if (o > 0) {  // the left pair
        if (prev_merged) {
          add_pair(p, b, a, -wc, ab);
          add_pair(p, nw, nw, wc, ab);
        } else {
          add_pair(p, last, a, -wc, ab);
          add_pair(p, last, nw, wc, ab);
        }
      }
      if (r + 2 < n) {  // the right pair
        const int y = t[r + 2];
        if (!(y == a && r + 3 < n && t[r + 3] == b)) {
          add_pair(p, b, y, -wc, ab);
          add_pair(p, nw, y, wc, ab);
        }
      }
      t[o++] = nw;
      last = nw;
      prev_merged = true;
      r += 2;
      ++merged;
    } else {
      t[o++] = x;
      last = x;
      prev_merged = false;
      ++r;
    }
  }
  p.len[w] = o;
  return merged;
}

__global__ void __launch_bounds__(THREADS) flat_train_kernel(FlatArgs p) {
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = gridDim.x, nthreads = G * THREADS;
  const int gtid = blockIdx.x * THREADS + tid;
  __shared__ int s_c[THREADS / 32], s_e[THREADS / 32];
  __shared__ unsigned long long s_k[THREADS / 32];

  if (p.init) {  // the initial count: each pair adds its word's count
    for (int w = gtid; w < p.W; w += nthreads) {
      const int n = p.len[w], wc = p.wcnt[w];
      const int* t = p.tokens + p.off[w];
      int x = n > 0 ? t[0] : 0;
      for (int j = 1; j < n; ++j) {
        const int y = t[j];
        add_pair(p, x, y, wc, EMPTY);
        x = y;
      }
    }
    grid.sync();
  }

  int i = 0, done = 0;
  for (; i < p.steps; ++i) {
    if (__ldcg(p.st + ST_OVERFLOW)) break;
    // pick: this thread's best entry, then the block's
    const int ne = min(__ldcg(p.st + ST_ENTRIES), p.ecap);
    const int floor_c = max(p.min_freq, 1);
    int c = 0, e = -1;
    unsigned long long k = EMPTY;
    for (int j = gtid; j < ne; j += nthreads) {
      const int cj = __ldcg(p.ecnt + j);
      if (cj >= floor_c && cj >= c) take_better(c, k, e, cj,
                                                __ldcg(p.ekey + j), j);
    }
    warp_best(c, k, e);
    if (lane == 0) {
      s_c[warp] = c;
      s_k[warp] = k;
      s_e[warp] = e;
    }
    __syncthreads();
    if (tid == 0) {
      for (int q = 1; q < THREADS / 32; ++q)
        take_better(c, k, e, s_c[q], s_k[q], s_e[q]);
      p.bbest[2 * blockIdx.x] = k;
      p.bbest[2 * blockIdx.x + 1] =
          ((unsigned long long)(unsigned)c << 32) | (unsigned)e;
    }
    grid.sync();
    // every block alike: the best of the block results
    if (warp == 0) {
      c = 0;
      e = -1;
      k = EMPTY;
      for (int q = lane; q < G; q += 32) {
        const unsigned long long ce = __ldcg(p.bbest + 2 * q + 1);
        take_better(c, k, e, (int)(ce >> 32), __ldcg(p.bbest + 2 * q),
                    (int)(unsigned)ce);
      }
      warp_best(c, k, e);
      if (lane == 0) {
        s_c[0] = c;
        s_k[0] = k;
        s_e[0] = e;
      }
    }
    __syncthreads();
    c = s_c[0];
    k = s_k[0];
    e = s_e[0];
    __syncthreads();  // s_* are written again by the next pick
    if (c == 0) {
      done = 1;
      break;
    }
    const int a = (int)(k >> 32), b = (int)(unsigned)k;
    const int nw = 256 + p.n_done + i;
    if (gtid == 0) {
      int* rec = p.records + 3 * i;
      rec[0] = a;
      rec[1] = b;
      rec[2] = c;
      p.ecnt[e] = 0;  // no delta below touches (a, b)
    }
    // merge pass: one thread per word
    for (int w = gtid; w < p.W; w += nthreads) {
      const int m = merge_word(p, w, a, b, nw, k);
      if (m) atomicAdd(p.st + ST_MERGED, m);
    }
    grid.sync();
  }
  if (gtid == 0) {
    p.st[ST_STEPS] = i;
    p.st[ST_DONE] = done;
  }
}

}  // namespace

extern "C" {

// Runs up to `steps` merges of the flat engine on `stream` in one kernel
// launch, the first creating id 256 + n_done; init != 0 counts the
// stream's pairs into the (empty) table first.  tokens, len, tkey, tent,
// ekey, ecnt and st are updated in place (layout in the header; cap a
// power of two, at most 2^30; ecap <= cap); bbest uint64 [2 * max_blocks]
// is scratch; records int32 [steps, 3] receives (a, b, count) per merge.
// st[ST_STEPS] and st[ST_DONE] give the merges made and whether the loop
// found no pair reaching min_freq; st[ST_OVERFLOW] != 0 means the table
// was full and the counts are no longer exact.  Returns the launch's CUDA
// error, or 0.
int shred_flat_train(int* tokens, const int* off, int* len, const int* wcnt,
                     unsigned long long* tkey, int* tent,
                     unsigned long long* ekey, int* ecnt, int* st,
                     unsigned long long* bbest, int* records, int W, int cap,
                     int ecap, int steps, int unk, int min_freq, int n_done,
                     int init, int max_blocks, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (cap < 2 || cap > (1 << 30) || (cap & (cap - 1)) || ecap < 1 ||
      ecap > cap || W < 0 || steps < 1)
    return (int)cudaErrorInvalidValue;
  int dev, sms, per_sm;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, flat_train_kernel, THREADS, 0)) != cudaSuccess)
    return (int)err;
  const int blocks = sms * (per_sm < BLOCKS_PER_SM ? per_sm : BLOCKS_PER_SM);
  if (blocks < 1 || blocks > max_blocks)
    return (int)cudaErrorCooperativeLaunchTooLarge;
  FlatArgs p{tokens, off, len, wcnt, tkey, tent, ekey, ecnt, st, bbest,
             records, W, (unsigned)(cap - 1), ecap, steps, unk, min_freq,
             n_done, init};
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel((const void*)flat_train_kernel,
                                    dim3(blocks), dim3(THREADS), args, 0, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
