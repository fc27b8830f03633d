// The flat engine's pair table and word pass, shared by F1 (flat.cu, one
// device) and S1 (flat_sharded.cu, over the ranks of a process group):
// one copy of what both do alike, included by each.  The state's layout
// and the design are in flat.cu's header.
//
//   - the table: an open-addressing hash table of the pair keys
//     (a << 32) | b with a count per slot, updated by buffered
//     side-by-side probes (add_keys), and the kept maximum of every SEG
//     slots;
//   - the pick: each warp's segments (dirty ones recomputed), the
//     block's best, a grid barrier, then every block reduces the block
//     results alike (table_best); the largest count, ties to the
//     smallest key, whatever slot holds it, so two tables that hold the
//     same counts in other slots pick alike;
//   - the word pass: a warp for each unit of UNIT_WORDS words, each word
//     merged in place by a lane group by its live length, its net deltas
//     gathered in the warp's buffer in shared memory.  A full buffer is
//     summed by key and added to the pair table (F1) or, with DELTA, to
//     the rank's delta table of the pass (S1 at world > 1: the same
//     probes on a second, smaller table, whose used slots are listed so
//     that the pass's end compacts and clears only those).
// Data written by other blocks of the same launch (the tables, the
// segment maxima, the presence index, the state and the block results)
// is read through L2 (__ldcg and atomics).
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "phase_clock.cuh"

namespace shred {

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

// st[] (ST_WORDS ints); from ST_LISTED on S1's, over several ranks:
// the rows its passes listed, the chain's halt (HALT_*), the delta
// table's used slots, the gathered rows launch A added, launch M's
// ticket of finished blocks
enum { ST_OVERFLOW = 0, ST_MERGED, ST_STEPS, ST_DONE, ST_VISITED,
       ST_CANDIDATES, ST_REFRESHED, ST_LISTED, ST_HALT, ST_USED, ST_ADDED,
       ST_TICKET, ST_WORDS = 16 };
// why launch A stopped S1's chain: a rank's list did not fit the
// exchange (the fallback), or a rank's table or list overflowed
enum { HALT_FALLBACK = 1, HALT_OVERFLOW = 2 };

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
  // S1 at world > 1 (null in F1): the rank's delta table of a pass,
  // dkey uint64 [dmask + 1] (EMPTY when clean) with dval int32, the
  // slots it used (dused int32 [dmask + 1], st[ST_USED] of them), and
  // the compact list send int64 [1 + scap, 2]: a header (the count, the
  // rank's overflow flag), then (key, delta) rows
  unsigned long long* dkey;
  int* dval;
  int* dused;
  unsigned dmask;
  long long* send;
  int scap;
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
// dirty.  DELTA adds to S1's delta table instead, with no segments, and
// lists every slot it takes.
template <int K, bool DELTA = false>
__device__ __forceinline__ void add_keys(const FlatArgs& p,
                                         const unsigned long long (&key)[K],
                                         const int (&d)[K]) {
  enum { NONE, PROBING, FOUND };
  unsigned long long* const tkey = DELTA ? p.dkey : p.tkey;
  int* const cnt = DELTA ? p.dval : p.cnt;
  const unsigned mask = DELTA ? p.dmask : p.mask;
  unsigned slot[K];
  int state[K];
#pragma unroll
  for (int r = 0; r < K; ++r) {
    state[r] = key[r] != EMPTY ? PROBING : NONE;
    slot[r] = slot_of(key[r], mask);
  }
  for (unsigned probe = 0;; ++probe) {
    unsigned long long t[K];
#pragma unroll
    for (int r = 0; r < K; ++r)
      t[r] = state[r] == PROBING ? __ldcg(tkey + slot[r]) : 0;
#pragma unroll
    for (int r = 0; r < K; ++r)
      if (state[r] == PROBING && t[r] == EMPTY) {
        t[r] = atomicCAS(tkey + slot[r], EMPTY, key[r]);
        if (t[r] == EMPTY) {  // this thread inserted it
          state[r] = FOUND;
          if (DELTA) p.dused[atomicAdd(p.st + ST_USED, 1)] = (int)slot[r];
        }
      }
    bool probing = false;
#pragma unroll
    for (int r = 0; r < K; ++r) {
      if (state[r] != PROBING) continue;
      if (t[r] == key[r]) {
        state[r] = FOUND;
      } else {
        slot[r] = (slot[r] + 1) & mask;
        probing = true;
      }
    }
    if (!probing) break;
    if (probe == mask) {  // every slot probed: the table is full
      atomicExch(p.st + ST_OVERFLOW, 1);
      break;
    }
  }
#pragma unroll
  for (int r = 0; r < K; ++r)
    if (state[r] == FOUND) {
      atomicAdd(cnt + slot[r], d[r]);
      if (!DELTA) p.dirty[slot[r] >> SEG_SHIFT] = 1;
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
// l + 32, ..., side by side (add_keys) to the pair table or, with DELTA,
// to the delta table.
template <bool DELTA = false>
static __device__ void flush(const FlatArgs& p, unsigned long long* keys,
                             int* ds, int n) {
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
  add_keys<K, DELTA>(p, key, d);
  __syncwarp();  // the buffer is written again after this
}

// Adds one delta per lane to the warp's buffer (key EMPTY: none); every
// lane of the warp calls it.  A full buffer is applied first.
template <bool DELTA>
__device__ __forceinline__ void push(const FlatArgs& p, Deltas& q,
                                     unsigned long long key, int d) {
  const unsigned v = __ballot_sync(FULL, key != EMPTY);
  if (!v) return;
  if (q.n + 32 > BUF) {
    flush<DELTA>(p, q.key, q.d, q.n);
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
template <int G, bool COUNT, bool DELTA>
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
      push<DELTA>(p, q, j + 1 < n ? pair_key(p, x0, x1, EMPTY) : EMPTY, wc);
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
      push<DELTA>(p, q, k0, -wc);
      push<DELTA>(p, q, k1, wc);
      push<DELTA>(p, q, k2, -wc);
      push<DELTA>(p, q, k3, wc);
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
template <int G, bool COUNT, bool DELTA>
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
    const int m = merge_word<G, COUNT, DELTA>(p, q, p.tokens + o, n, wc,
                                              segs, a, b, nw, ab, &new_len,
                                              &sig);
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
template <bool COUNT, bool DELTA = false>
static __device__ int unit_pass(const FlatArgs& p, Deltas& q, int w0, int a,
                                int b, int nw, unsigned long long ab,
                                int* lanes, int& candidates) {
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
  int m = word_class<4, COUNT, DELTA>(
      p, q, __ballot_sync(FULL, n >= 2 && n <= 4), w0, n, o, wc, a, b, nw,
      ab, lanes);
  m += word_class<8, COUNT, DELTA>(
      p, q, __ballot_sync(FULL, n > 4 && n <= 8), w0, n, o, wc, a, b, nw,
      ab, lanes);
  m += word_class<16, COUNT, DELTA>(
      p, q, __ballot_sync(FULL, n > 8 && n <= 16), w0, n, o, wc, a, b, nw,
      ab, lanes);
  m += word_class<32, COUNT, DELTA>(p, q, __ballot_sync(FULL, n > 16), w0,
                                    n, o, wc, a, b, nw, ab, lanes);
  return (int)__reduce_add_sync(FULL, (unsigned)m);
}

// The pass of merge (a, b) -> nw: the chunks whose presence holds a and
// b, a warp for each UNIT_WORDS of their words (unit u on warp u mod
// nwarps, in every merge of a launch); a chunk where a merge happened
// gets nw's presence bit.  The deltas stay in q (the caller flushes it).
template <bool DELTA>
__device__ __forceinline__ void pair_pass(const FlatArgs& p, Deltas& q,
                                          int gwarp, int nwarps, int a,
                                          int b, int nw, int* lanes,
                                          int& merged, int& visited,
                                          int& candidates) {
  const int lane = threadIdx.x & 31;
  const unsigned long long ab =
      ((unsigned long long)(unsigned)a << 32) | (unsigned)b;
  const unsigned* ra = p.pres + (size_t)a * p.ncw;
  const unsigned* rb = p.pres + (size_t)b * p.ncw;
  unsigned* rn = p.pres + (size_t)nw * p.ncw;
  for (int u = gwarp; u < p.nc * UNITS; u += nwarps) {
    const int ch = u / UNITS;
    const unsigned bit = 1u << (ch & 31);
    if (!(__ldcg(ra + (ch >> 5)) & __ldcg(rb + (ch >> 5)) & bit)) continue;
    visited += u % UNITS == 0;
    const int m = unit_pass<false, DELTA>(p, q, u * UNIT_WORDS, a, b, nw,
                                          ab, lanes, candidates);
    if (m) {
      merged += m;
      if (lane == 0) atomicOr(rn + (ch >> 5), bit);
    }
  }
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

// The best (count, key, slot) of the whole table, the same on every
// thread of the grid: this warp's segments, the block's best into
// bbest, a grid barrier, then every block alike the best of the block
// results, one a thread.  s_* are the block's WARPS entries of shared
// memory.
__device__ __forceinline__ void table_best(const FlatArgs& p,
                                           cooperative_groups::grid_group&
                                               grid,
                                           int gwarp, int nwarps, int& c,
                                           unsigned long long& k, int& e,
                                           int& refreshed, int* s_c,
                                           unsigned long long* s_k, int* s_e,
                                           PhaseClock& clk) {
  const int tid = threadIdx.x, G = gridDim.x;
  segments_best(p, gwarp, nwarps, (int)((p.mask + 1) >> SEG_SHIFT), c, k, e,
                refreshed);
  block_best(c, k, e, s_c, s_k, s_e);
  if (tid == 0) {
    p.bbest[2 * blockIdx.x] = k;
    p.bbest[2 * blockIdx.x + 1] =
        ((unsigned long long)(unsigned)c << 32) | (unsigned)e;
  }
  clk.mark(PH_PICK_SCAN);
  grid.sync();
  clk.mark(PH_PICK_SYNC);
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
}

// Thread 0 of block 0: record merge i (a, b, c) and set the count of
// (a, b), in slot e, to 0: after the merge no (a, b) is left in the
// stream (greedy left to right takes every occurrence not consumed by a
// run), so that is exact, and no delta of the pass touches (a, b).
__device__ __forceinline__ void record_pick(const FlatArgs& p, int i, int c,
                                            unsigned long long k, int e) {
  if (blockIdx.x != 0 || threadIdx.x != 0) return;
  int* rec = p.records + 3 * i;
  rec[0] = (int)(k >> 32);
  rec[1] = (int)(unsigned)k;
  rec[2] = c;
  p.cnt[e] = 0;
  p.dirty[e >> SEG_SHIFT] = 1;
}

// The blocks of a launch: one an SM (BLOCKS_PER_SM at most, as many as
// fit), at most max_blocks (the block results' room); 0 with *err set
// when the card refuses.
template <class Kernel>
int grid_blocks(Kernel kernel, int max_blocks, cudaError_t* err) {
  int dev, sms, per_sm;
  if ((*err = cudaGetDevice(&dev)) != cudaSuccess ||
      (*err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev)) != cudaSuccess ||
      (*err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, THREADS, 0)) != cudaSuccess)
    return 0;
  const int blocks = sms * (per_sm < BLOCKS_PER_SM ? per_sm : BLOCKS_PER_SM);
  if (blocks < 1 || blocks > max_blocks) {
    *err = cudaErrorCooperativeLaunchTooLarge;
    return 0;
  }
  return blocks;
}

}  // namespace shred
