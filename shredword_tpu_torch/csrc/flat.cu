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
//   st      int32 [8]    the ST_ words below
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

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "phase_clock.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
// co-resident blocks per SM, at most: one block of 512 threads an SM ran
// the long-word corpus faster than two of 256 or one of 1,024 (a cheaper
// grid barrier, half the block results to reduce)
constexpr int BLOCKS_PER_SM = 1;
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned long long EMPTY = ~0ull;
constexpr int CHUNK_WORDS = 32;  // words per presence bit
constexpr int UNIT_WORDS = 8;    // words per warp's unit of a pass
constexpr int UNITS = CHUNK_WORDS / UNIT_WORDS;  // units per chunk
constexpr int SEG_SHIFT = 8;     // SEG = 256 slots per kept maximum
constexpr int SEG = 1 << SEG_SHIFT;

// st[]
enum { ST_OVERFLOW = 0, ST_MERGED, ST_STEPS, ST_DONE, ST_VISITED,
       ST_CANDIDATES, ST_REFRESHED };

// the phases of the clocked build (csrc/phase_clock.cuh); a barrier phase
// is the wait in the grid barrier that ends the phase before it
enum { PH_INIT = 0, PH_PICK_SCAN, PH_PICK_SYNC, PH_PICK_REDUCE, PH_PASS,
       PH_PASS_TABLE, PH_PASS_SYNC };

struct FlatArgs {
  int* tokens;
  const int* off;
  int* len;
  const int* wcnt;
  unsigned* pres;
  uint4* sig;  // [W] each word's signature: bit sig_bit(x) per live id x
  unsigned long long* tkey;
  int* cnt;
  unsigned long long* skey;
  unsigned long long* sce;
  int* dirty;
  int* st;
  unsigned long long* bbest;  // [2 * gridDim.x]: key, (count << 32) | slot
  int* records;               // [steps, 3]
  int W, nc, ncw;
  unsigned mask;  // cap - 1
  int steps, unk, min_freq, n_done, init;
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

// count(key[r]) += d[r] for each of this lane's K keys (EMPTY: none), the
// keys probed side by side: each round loads the slot of every key still
// probing at once and swaps EMPTY for the key in every empty one at
// once; then the adds into the slots, each marking its slot's segment
// dirty.
template <int K>
__device__ __forceinline__ void add_keys(const FlatArgs& p,
                                         const unsigned long long (&key)[K],
                                         const int (&d)[K]) {
  enum { NONE, PROBING, FOUND };
  unsigned slot[K];
  int state[K];
#pragma unroll
  for (int r = 0; r < K; ++r) {
    state[r] = key[r] != EMPTY ? PROBING : NONE;
    slot[r] = slot_of(key[r], p.mask);
  }
  for (unsigned probe = 0;; ++probe) {
    unsigned long long t[K];
#pragma unroll
    for (int r = 0; r < K; ++r)
      t[r] = state[r] == PROBING ? __ldcg(p.tkey + slot[r]) : 0;
#pragma unroll
    for (int r = 0; r < K; ++r)
      if (state[r] == PROBING && t[r] == EMPTY) {
        t[r] = atomicCAS(p.tkey + slot[r], EMPTY, key[r]);
        if (t[r] == EMPTY) state[r] = FOUND;  // this thread inserted it
      }
    bool probing = false;
#pragma unroll
    for (int r = 0; r < K; ++r) {
      if (state[r] != PROBING) continue;
      if (t[r] == key[r]) {
        state[r] = FOUND;
      } else {
        slot[r] = (slot[r] + 1) & p.mask;
        probing = true;
      }
    }
    if (!probing) break;
    if (probe == p.mask) {  // every slot probed: the table is full
      atomicExch(p.st + ST_OVERFLOW, 1);
      break;
    }
  }
#pragma unroll
  for (int r = 0; r < K; ++r)
    if (state[r] == FOUND) {
      atomicAdd(p.cnt + slot[r], d[r]);
      p.dirty[slot[r] >> SEG_SHIFT] = 1;
    }
}

// The key of pair (x, y), or EMPTY when it holds unk or is `skip`
__device__ __forceinline__ unsigned long long pair_key(
    const FlatArgs& p, int x, int y, unsigned long long skip) {
  if (x == p.unk || y == p.unk) return EMPTY;
  const unsigned long long key =
      ((unsigned long long)(unsigned)x << 32) | (unsigned)y;
  return key == skip ? EMPTY : key;
}

// A warp's pending count deltas, in its slice of shared memory: BUF keys
// and deltas, n of them (the same on every lane).
constexpr int BUF = 128;
struct Deltas {
  unsigned long long* key;
  int* d;
  int n;
};

// Applies the n deltas of a warp's buffer (every lane of the warp calls
// it): the deltas of equal keys in each window of 32 are summed
// (__match_any_sync) and compacted in place, then lane l adds the sums l,
// l + 32, ..., side by side (add_keys).
__device__ void flush(const FlatArgs& p, unsigned long long* keys, int* ds,
                      int n) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1;
  __syncwarp();
  int m = 0;
  for (int base = 0; base < n; base += 32) {
    const int i = base + lane;
    const unsigned long long key = i < n ? keys[i] : EMPTY;
    const int d = i < n ? ds[i] : 0;
    const unsigned peers = __match_any_sync(FULL, key);
    const int sum = (int)__reduce_add_sync(peers, (unsigned)d);
    const bool lead = key != EMPTY && lane == __ffs(peers) - 1;
    const unsigned leads = __ballot_sync(FULL, lead);
    if (lead) {  // below this window's reads: m <= base
      const int at = m + __popc(leads & below);
      keys[at] = key;
      ds[at] = sum;
    }
    m += __popc(leads);
    __syncwarp();
  }
  constexpr int K = BUF / 32;
  unsigned long long key[K];
  int d[K];
#pragma unroll
  for (int r = 0; r < K; ++r) {
    const int i = lane + 32 * r;
    key[r] = i < m ? keys[i] : EMPTY;
    d[r] = i < m ? ds[i] : 0;
  }
  add_keys<K>(p, key, d);
  __syncwarp();  // the buffer is written again after this
}

// Adds one delta per lane to the warp's buffer (key EMPTY: none); every
// lane of the warp calls it.  A full buffer is applied first.
__device__ __forceinline__ void push(const FlatArgs& p, Deltas& q,
                                     unsigned long long key, int d) {
  const unsigned v = __ballot_sync(FULL, key != EMPTY);
  if (!v) return;
  if (q.n + 32 > BUF) {
    flush(p, q.key, q.d, q.n);
    q.n = 0;
  }
  if (key != EMPTY) {
    const int at = q.n + __popc(v & ((1u << (threadIdx.x & 31)) - 1));
    q.key[at] = key;
    q.d[at] = d;
  }
  q.n += __popc(v);
}

// the greedy left-to-right pick among the matches m (encode.cu's): in
// each run of consecutive bits, the 1st, 3rd, 5th, ...  Adding a run's
// lowest bit clears the run, so m & ~(m + starts) is the runs that start
// at an even position; their even bits and the other runs' odd bits are
// the picks.
__device__ __forceinline__ unsigned every_other(unsigned m) {
  const unsigned even = 0x55555555u;
  const unsigned starts = m & ~(m << 1);
  const unsigned even_runs = m & ~(m + (starts & even));
  return (even_runs & even) | (m & ~even_runs & ~even);
}

// The bit of id x in a word's 128-bit signature
__device__ __forceinline__ unsigned sig_bit(int x) {
  return ((unsigned)x * 0x9E3779B1u) >> 25;
}

__device__ __forceinline__ bool sig_has(const uint4& s, unsigned bit) {
  const unsigned w = bit < 64 ? (bit < 32 ? s.x : s.y)
                              : (bit < 96 ? s.z : s.w);
  return (w >> (bit & 31)) & 1;
}

__device__ __forceinline__ void sig_set(uint4& s, unsigned bit) {
  const unsigned m = 1u << (bit & 31);
  if (bit < 32) s.x |= m;
  else if (bit < 64) s.y |= m;
  else if (bit < 96) s.z |= m;
  else s.w |= m;
}

// One word t[0, n) of count wc on a group of G lanes of the warp, one
// token a lane, in `segs` segments of G positions (every lane of the warp
// calls it with the same segs).  COUNT adds the word's pairs; otherwise
// the word's (a, b) merge into nw in place with the table's deltas.
// Returns the occurrences merged; *new_len gets the live length and, when
// a merge happened, *sig the signature of the live ids.
template <int G, bool COUNT>
__device__ __forceinline__ int merge_word(const FlatArgs& p, Deltas& q,
                                          int* t, int n, int wc, int segs,
                                          int a, int b, int nw,
                                          unsigned long long ab,
                                          int* new_len, uint4* sig) {
  const int lane = threadIdx.x & 31, l = lane & (G - 1), head = lane - l;
  const unsigned low = G == 32 ? FULL : (1u << G) - 1;
  uint4 live = make_uint4(0, 0, 0, 0);  // this lane's kept ids' bits
  // carried from the segment before: whether its last two positions were
  // merged (the selection's state), its last token, the output index
  bool csel = false, csel2 = false;
  int ctok = 0, out = 0, merged = 0;
  for (int s = 0; s < segs; ++s) {
    const int j = s * G + l;
    const int x0 = j < n ? t[j] : 0;
    int x1 = __shfl_down_sync(FULL, x0, 1, G);
    if (l + 1 >= G && j + 1 < n) x1 = t[j + 1];
    if (COUNT) {
      push(p, q, j + 1 < n ? pair_key(p, x0, x1, EMPTY) : EMPTY, wc);
      continue;
    }
    // the positions past the segment are not written before the next one
    int x2 = __shfl_down_sync(FULL, x0, 2, G);
    int x3 = __shfl_down_sync(FULL, x0, 3, G);
    if (l + 2 >= G && j + 2 < n) x2 = t[j + 2];
    if (l + 3 >= G && j + 3 < n) x3 = t[j + 3];
    const int xl = __shfl_up_sync(FULL, x0, 1, G);
    const bool m = j + 1 < n && x0 == a && x1 == b;
    const unsigned M = (__ballot_sync(FULL, m) >> head) & low;
    // a match at the segment's first position right after a merged one is
    // the right half of that one; the run goes on from the next position
    const unsigned S = every_other(csel ? M & ~1u : M);
    const unsigned dropped = ((S << 1) | (unsigned)csel) & low;
    const int rem = n - s * G;
    const unsigned valid =
        rem >= G ? low : (rem > 0 ? (1u << rem) - 1 : 0u);
    const unsigned keep = valid & ~dropped;
    const bool sel = (S >> l) & 1;
    if ((keep >> l) & 1) {
      const int to = out + __popc(keep & ((1u << l) - 1));
      if (sel || to != j) t[to] = sel ? nw : x0;
      sig_set(live, sig_bit(sel ? nw : x0));
    }
    if (__any_sync(FULL, S != 0)) {
      unsigned long long k0 = EMPTY, k1 = EMPTY, k2 = EMPTY, k3 = EMPTY;
      if (sel) {
        if (j > 0) {  // the left pair
          const bool after = l >= 2 ? (S >> (l - 2)) & 1
                                    : (l == 1 ? csel : csel2);
          const int left = l > 0 ? xl : ctok;
          k0 = after ? pair_key(p, b, a, ab) : pair_key(p, left, a, ab);
          k1 = after ? pair_key(p, nw, nw, ab) : pair_key(p, left, nw, ab);
        }
        if (j + 2 < n && !(x2 == a && j + 3 < n && x3 == b)) {  // right
          k2 = pair_key(p, b, x2, ab);
          k3 = pair_key(p, nw, x2, ab);
        }
      }
      push(p, q, k0, -wc);
      push(p, q, k1, wc);
      push(p, q, k2, -wc);
      push(p, q, k3, wc);
    }
    csel2 = (S >> (G - 2)) & 1;
    csel = (S >> (G - 1)) & 1;
    ctok = __shfl_sync(FULL, x0, head + G - 1);
    out += __popc(keep);
    merged += __popc(S);
  }
  *new_len = COUNT ? n : out;
  if (!COUNT && merged) {  // the group's signature
    const unsigned gm = low << head;
    *sig = make_uint4(
        __reduce_or_sync(gm, live.x), __reduce_or_sync(gm, live.y),
        __reduce_or_sync(gm, live.z), __reduce_or_sync(gm, live.w));
  }
  return merged;
}

// The words w0 + lane for the lanes set in `cls`, 32 / G at a time,
// group g taking the (first + g)-th of them; n_l, o_l, wc_l are this
// lane's own word's length, offset and count; lanes is the warp's 32 ints
// of shared memory.  Returns the occurrences merged (on each group's lane
// 0).
template <int G, bool COUNT>
__device__ __forceinline__ int word_class(const FlatArgs& p, Deltas& q,
                                          unsigned cls, int w0, int n_l,
                                          int o_l, int wc_l, int a, int b,
                                          int nw, unsigned long long ab,
                                          int* lanes) {
  constexpr int NG = 32 / G;
  const int lane = threadIdx.x & 31, g = lane / G, l = lane & (G - 1);
  const int total = __popc(cls);
  if (total == 0) return 0;
  if ((cls >> lane) & 1) lanes[__popc(cls & ((1u << lane) - 1))] = lane;
  __syncwarp();
  int merged = 0;
  for (int first = 0; first < total; first += NG) {
    const int k = first + g;
    const int src = k < total ? lanes[k] : 0;
    int n = __shfl_sync(FULL, n_l, src);
    const int o = __shfl_sync(FULL, o_l, src);
    const int wc = __shfl_sync(FULL, wc_l, src);
    if (k >= total) n = 0;
    const int segs = G == 32 ? (n + G - 1) / G : 1;
    int new_len;
    uint4 sig;
    const int m = merge_word<G, COUNT>(p, q, p.tokens + o, n, wc, segs, a,
                                       b, nw, ab, &new_len, &sig);
    if (m && l == 0) {
      p.len[w0 + src] = new_len;
      p.sig[w0 + src] = sig;
      merged += m;
    }
  }
  __syncwarp();  // lanes[] is written again by the next class
  return merged;
}

// Merges (COUNT: counts) the UNIT_WORDS words from w0 on the calling
// warp, each by a lane group by its live length, their deltas into q;
// returns the occurrences merged, on every lane.
template <bool COUNT>
__device__ int unit_pass(const FlatArgs& p, Deltas& q, int w0, int a, int b,
                         int nw, unsigned long long ab, int* lanes,
                         int& candidates) {
  if (w0 >= p.W) return 0;
  const int lane = threadIdx.x & 31;
  const int w = w0 + lane;
  int n = 0, o = 0, wc = 0;
  if (lane < UNIT_WORDS && w < p.W) {
    n = p.len[w];
    o = p.off[w];
    wc = p.wcnt[w];
    // a word whose signature lacks a or b cannot hold (a, b)
    if (!COUNT) {
      const uint4 sg = p.sig[w];
      if (!sig_has(sg, sig_bit(a)) || !sig_has(sg, sig_bit(b))) n = 0;
    }
  }
  // the unit's token lines into L1 at once: the groups below read them
  // one segment after another
  int end = lane == UNIT_WORDS ? p.off[min(w0 + UNIT_WORDS, p.W)] : 0;
  end = __shfl_sync(FULL, end, UNIT_WORDS);
  const int start = __shfl_sync(FULL, o, 0);
  if (!COUNT) candidates += __popc(__ballot_sync(FULL, n >= 2));
  int m = word_class<4, COUNT>(p, q, __ballot_sync(FULL, n >= 2 && n <= 4),
                               w0, n, o, wc, a, b, nw, ab, lanes);
  m += word_class<8, COUNT>(p, q, __ballot_sync(FULL, n > 4 && n <= 8), w0,
                            n, o, wc, a, b, nw, ab, lanes);
  m += word_class<16, COUNT>(p, q, __ballot_sync(FULL, n > 8 && n <= 16),
                             w0, n, o, wc, a, b, nw, ab, lanes);
  m += word_class<32, COUNT>(p, q, __ballot_sync(FULL, n > 16), w0, n, o,
                             wc, a, b, nw, ab, lanes);
  return (int)__reduce_add_sync(FULL, (unsigned)m);
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
  // the largest count, then the smallest key among its holders: one
  // reduction each for the count and the key's two halves
  const int cmax = (int)__reduce_max_sync(FULL, (unsigned)c);
  const unsigned hi = __reduce_min_sync(
      FULL, c == cmax ? (unsigned)(k >> 32) : 0xffffffffu);
  const unsigned lo = __reduce_min_sync(
      FULL, c == cmax && (unsigned)(k >> 32) == hi ? (unsigned)k
                                                   : 0xffffffffu);
  const unsigned long long kmin = (unsigned long long)hi << 32 | lo;
  const int src =
      __ffs(__ballot_sync(FULL, c == cmax && k == kmin)) - 1;
  c = cmax;
  k = kmin;
  e = __shfl_sync(FULL, e, src);
}

// The block's best of each thread's (c, k, e) into s_*[0]; every thread
// returns it.
__device__ __forceinline__ void block_best(int& c, unsigned long long& k,
                                           int& e, int* s_c,
                                           unsigned long long* s_k,
                                           int* s_e) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  warp_best(c, k, e);
  if (lane == 0) {
    s_c[warp] = c;
    s_k[warp] = k;
    s_e[warp] = e;
  }
  __syncthreads();
  if (warp == 0) {
    c = lane < WARPS ? s_c[lane] : 0;
    k = lane < WARPS ? s_k[lane] : EMPTY;
    e = lane < WARPS ? s_e[lane] : -1;
    warp_best(c, k, e);  // every lane has read s_* when it returns
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
  __syncthreads();  // s_* are written again by the next call
}

// The maximum (count, key, slot) of segment s of the table, recomputed
// and kept, on every lane of the calling warp: each lane loads its
// SEG / 32 counts at once, then the keys of its largest.
__device__ __forceinline__ void refresh_segment(const FlatArgs& p, int s,
                                                int& c,
                                                unsigned long long& k,
                                                int& e) {
  constexpr int R = SEG / 32;
  const int lane = threadIdx.x & 31;
  const int j0 = (s << SEG_SHIFT) + lane;
  int cj[R];
#pragma unroll
  for (int r = 0; r < R; ++r)
    cj[r] = __ldcg(p.cnt + j0 + 32 * r);
  c = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) c = max(c, cj[r]);
  k = EMPTY;
  e = -1;
#pragma unroll
  for (int r = 0; r < R; ++r)
    if (c > 0 && cj[r] == c)
      take_better(c, k, e, c, __ldcg(p.tkey + j0 + 32 * r), j0 + 32 * r);
  warp_best(c, k, e);
  if (lane == 0) {
    p.skey[s] = k;
    p.sce[s] = ((unsigned long long)(unsigned)c << 32) | (unsigned)e;
    p.dirty[s] = 0;
  }
}

// The best (count, key, slot) of the segments s0, s0 + stride, ... below
// nseg, over the calling warp's lanes: lane j reads the kept maximum
// and the dirty flag of the j-th of each 32 at once, and the dirty ones
// are recomputed by the warp, one after another.
__device__ __forceinline__ void segments_best(const FlatArgs& p, int s0,
                                              int stride, int nseg,
                                              int& c, unsigned long long& k,
                                              int& e, int& refreshed) {
  const int lane = threadIdx.x & 31;
  c = 0;
  k = EMPTY;
  e = -1;
  for (int b0 = s0; b0 < nseg; b0 += 32 * stride) {
    const int s = b0 + lane * stride;
    int dirty = 0;
    if (s < nseg) {
      dirty = __ldcg(p.dirty + s);
      const unsigned long long sk = __ldcg(p.skey + s);
      const unsigned long long ce = __ldcg(p.sce + s);
      if (!dirty) take_better(c, k, e, (int)(ce >> 32), sk, (int)(unsigned)ce);
    }
    unsigned dm = __ballot_sync(FULL, dirty);
    refreshed += __popc(dm);
    for (; dm; dm &= dm - 1) {
      int sc, se;
      unsigned long long sk;
      refresh_segment(p, b0 + (__ffs(dm) - 1) * stride, sc, sk, se);
      take_better(c, k, e, sc, sk, se);
    }
  }
}

__global__ void __launch_bounds__(THREADS) flat_train_kernel(FlatArgs p) {
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = gridDim.x;
  const int gwarp = blockIdx.x * WARPS + warp, nwarps = G * WARPS;
  __shared__ int s_c[WARPS], s_e[WARPS];
  __shared__ unsigned long long s_k[WARPS];
  __shared__ int s_lanes[THREADS];
  __shared__ unsigned long long s_dkey[WARPS * BUF];
  __shared__ int s_d[WARPS * BUF];
  int* lanes = s_lanes + warp * 32;
  Deltas q{s_dkey + warp * BUF, s_d + warp * BUF, 0};
  shred::PhaseClock clk;
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
    // pick: this warp's segments, then the block's best
    int c, e;
    unsigned long long k;
    segments_best(p, gwarp, nwarps, (int)((p.mask + 1) >> SEG_SHIFT), c, k,
                  e, refreshed);
    block_best(c, k, e, s_c, s_k, s_e);
    if (tid == 0) {
      p.bbest[2 * blockIdx.x] = k;
      p.bbest[2 * blockIdx.x + 1] =
          ((unsigned long long)(unsigned)c << 32) | (unsigned)e;
    }
    clk.mark(PH_PICK_SCAN);
    grid.sync();
    clk.mark(PH_PICK_SYNC);
    // every block alike: the best of the block results, one a thread
    c = 0;
    e = -1;
    k = EMPTY;
    for (int blk = tid; blk < G; blk += THREADS) {
      const unsigned long long ce = __ldcg(p.bbest + 2 * blk + 1);
      take_better(c, k, e, (int)(ce >> 32), __ldcg(p.bbest + 2 * blk),
                  (int)(unsigned)ce);
    }
    block_best(c, k, e, s_c, s_k, s_e);
    clk.mark(PH_PICK_REDUCE);
    if (c < max(p.min_freq, 1)) {
      done = 1;
      break;
    }
    const int a = (int)(k >> 32), b = (int)(unsigned)k;
    const int nw = 256 + p.n_done + i;
    if (blockIdx.x == 0 && tid == 0) {
      int* rec = p.records + 3 * i;
      rec[0] = a;
      rec[1] = b;
      rec[2] = c;
      p.cnt[e] = 0;  // no delta below touches (a, b)
      p.dirty[e >> SEG_SHIFT] = 1;
    }
    // pass: the chunks whose presence holds a and b, a warp for each
    // UNIT_WORDS of their words (unit u on warp u mod nwarps, in every
    // merge of the launch)
    const unsigned* ra = p.pres + (size_t)a * p.ncw;
    const unsigned* rb = p.pres + (size_t)b * p.ncw;
    unsigned* rn = p.pres + (size_t)nw * p.ncw;
    for (int u = gwarp; u < p.nc * UNITS; u += nwarps) {
      const int ch = u / UNITS;
      const unsigned bit = 1u << (ch & 31);
      if (!(__ldcg(ra + (ch >> 5)) & __ldcg(rb + (ch >> 5)) & bit)) continue;
      visited += u % UNITS == 0;
      const int m = unit_pass<false>(p, q, u * UNIT_WORDS, a, b, nw, k,
                                     lanes, candidates);
      if (m) {
        merged += m;
        if (lane == 0) atomicOr(rn + (ch >> 5), bit);
      }
    }
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
