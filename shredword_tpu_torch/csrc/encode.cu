// BPE encode merge loop for Hopper (sm_90a): E1, lane groups per chunk.
//
// Replaces the JAX package's XLA merge loops of
// shredword_tpu/ops/encode_ops.py: _encode_core (through _encode_device,
// dense rank table, and _encode_device_hash, hash probe), which runs the
// chunks of at most 64 bytes as lockstep columns of an [L, W] block in a
// lax.while_loop, and encode_flat (through encode_chunks), the flat-stream
// loop for chunks of any length.  The contract (tokenizer.merge): per
// chunk, merge the lowest-rank adjacent pair, every occurrence greedily
// left to right, until no adjacent pair is a merge.
//
// What bounds it on the H100: the bytes are a few MB per call (the chunks
// in, 16 B of lengths and offsets per chunk, the ids out, one int32 or one
// hash probe per rank lookup), a bound of microseconds; what takes the
// time is the instructions of the merge rounds (the dense table at vocab
// 4096, 64 MB and larger than L2, costs little more than the 2.3 MB one at
// 768, while the hash probe's instructions cost much more).
//
// The first version ran one thread per chunk, with the chunk and its pair
// ranks in thread-local int32[64] arrays indexed at run time: 512 bytes of
// stack a thread (ptxas), so every step went through local memory; half
// the lanes of a warp held one-byte chunks and idled; and each merge
// rescanned the chunk for its minimum and looked up the dirty pairs one
// after another.  Here a chunk lives in registers, two tokens a lane of a
// lane group, and the kernel keeps no stack (ptxas: 0 bytes).  A warp
// takes a window of 32 consecutive chunks, one lane each:
//   - a chunk of 0 or 1 byte is written at once (no pair, no lookup);
//   - the others go by length class, found by __ballot_sync, to groups
//     of 4 lanes for 2-8 bytes (eight chunks at a time), 8 for 9-16
//     (four), 16 for 17-32 (two) and the warp for 33-64, each group
//     taking its chunk from the class's lanes listed in shared memory (a
//     popcount each; __fns in its place took 8% longer).  The whitespace
//     chunks of the bench text (891,313 in 4 MB) are half of one byte,
//     29% of 2-8 bytes, 21% of 9-16 and none longer, so a window's 2-8
//     and 9-16 byte chunks mostly fit one or two passes each; two tokens a
//     lane halve the passes that one a lane took, and a pass runs as many
//     rounds as its slowest chunk;
//   - a chunk over 64 bytes (rare with whitespace or GPT pre-tokenization,
//     but any length is taken) is merged in place by its own lane in a
//     global int32 scratch of tokens and ranks, as the first version did.
// One round of a group: a min over the group of the pair ranks (a rank
// names one pair, so rank equality is pair equality); a ballot of the
// positions whose pair has that rank; the greedy left-to-right rule worked
// out from that word by bit operations (in a run of consecutive matches,
// possible only when the pair is (a, a), the 1st, 3rd, ... merge); the
// compaction, each kept position writing its token and rank to its new
// index (the kept positions below it, a popcount) in the warp's shared
// slots; then only the positions whose pair touches a new id look their
// rank up, all at once, so a round's dependent chain is one lookup.  The
// lookups are the first version's: one for each pair of a chunk and one
// for each pair that a merge creates.  Blocks of 64 threads (two
// windows) ran 7% faster than 128 on the bench chunks (PERF.md §6).
//
// Output: launch 1 writes each chunk's ids at the chunk's byte offset of
// an int32 buffer and its count; the caller's torch.cumsum of the counts
// gives each chunk's output offset; launch 2 packs the ids in chunk order
// as uint16 (every id < 65536) or int32.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int RANK_INF = 0x7fffffff;
constexpr int DIRTY = -2;     // a pair whose rank must be looked up again
constexpr int LOCAL = 64;     // the longest chunk kept in registers
constexpr int THREADS = 64;
constexpr unsigned FULL = 0xffffffffu;

// the JAX package's _np_mix / _jnp_mix, in uint32 arithmetic
__device__ __forceinline__ uint32_t mix(int a, int b) {
  uint32_t h = (uint32_t)a * 0x9E3779B1u + (uint32_t)b * 0x85EBCA6Bu;
  h ^= h >> 16;
  h *= 0x045D9F3Bu;
  h ^= h >> 16;
  return h;
}

// dense pair -> rank table int32 [v * v]; RANK_INF = no merge
struct DenseRank {
  const int* table;
  int v;
  __device__ __forceinline__ int operator()(int a, int b) const {
    if ((unsigned)a >= (unsigned)v || (unsigned)b >= (unsigned)v)
      return RANK_INF;
    return __ldg(table + (size_t)a * v + b);
  }
};

// open-addressing table of encode_ops.build_merge_table: linear probing
// from mix(a, b), at most max_probe slots, an empty slot (rank -1) ends it
struct HashRank {
  const int *ka, *kb, *rank;
  uint32_t mask;
  int max_probe;
  __device__ __forceinline__ int operator()(int a, int b) const {
    const uint32_t h = mix(a, b);
    for (int k = 0; k < max_probe; ++k) {
      const uint32_t slot = (h + k) & mask;
      const int r = __ldg(rank + slot);
      if (__ldg(ka + slot) == a && __ldg(kb + slot) == b)
        return r >= 0 ? r : RANK_INF;
      if (r < 0) return RANK_INF;
    }
    return RANK_INF;
  }
};

// ---------------------------------------------------------------------
// chunks of at most 64 bytes: a group of G lanes, two tokens a lane
// (position p = s * G + l is slot s of the group's lane l); every lane of
// the warp runs every step, so a group whose chunk is done idles through
// the others' rounds.  The warp's 128 ints of shared memory hold its
// groups' tokens and ranks between the compaction's writes and reads.
// ---------------------------------------------------------------------

constexpr int K = 2;          // tokens a lane
constexpr int SH_INTS = 2 * 64 + 32;   // a warp's tokens, ranks and lanes

template <int G>
using Bits = typename std::conditional<(G * K > 32), uint64_t, uint32_t>::type;

__device__ __forceinline__ int popc(uint32_t m) { return __popc(m); }
__device__ __forceinline__ int popc(uint64_t m) { return __popcll(m); }

// the greedy left-to-right pick among the matches m: in each run of
// consecutive bits, the 1st, 3rd, 5th, ...  Adding a run's lowest bit
// clears the run, so m & ~(m + starts) is the runs that start at an even
// position; their even bits and the other runs' odd bits are the picks.
template <class M>
__device__ __forceinline__ M every_other(M m) {
  const M even = (M)0x5555555555555555ull;
  const M starts = m & ~(m << 1);
  const M even_runs = m & ~(m + (starts & even));
  return (even_runs & even) | (m & ~even_runs & ~even);
}

// The chunks of the window whose lanes are set in `mask`, NG = 32 / G at
// a time: group g takes the (first + g)-th of them.  o_l, n_l are this
// lane's own chunk's offset and length; sh is the warp's SH_INTS ints.
template <int G, class Rank>
__device__ __forceinline__ void merge_class(
    uint32_t mask, int wbase, int64_t o_l, int n_l,
    const uint8_t* __restrict__ flat, const Rank& rank_of,
    int* __restrict__ tok, int* __restrict__ counts, int* sh,
    unsigned& lookups) {
  using M = Bits<G>;
  constexpr int NG = 32 / G, P = G * K;
  const int lane = threadIdx.x & 31, g = lane / G, l = lane & (G - 1);
  // position p of group g at word p * NG + g: a slot's reads are
  // conflict-free
  int* st = sh + g;
  int* sr = sh + 64 + g;
  int* lanes = sh + 128;        // the class's lanes, in lane order
  const int total = __popc(mask);
  if ((mask >> lane) & 1) lanes[__popc(mask & ((1u << lane) - 1))] = lane;
  __syncwarp();
  for (int first = 0; first < total; first += NG) {
    const int k = first + g;
    const int src = k < total ? lanes[k] : 0;
    const int64_t o = __shfl_sync(FULL, (long long)o_l, src);
    int n = __shfl_sync(FULL, n_l, src);
    if (k >= total) n = 0;
    int t[K], rk[K];
#pragma unroll
    for (int s = 0; s < K; ++s) {
      const int p = s * G + l;
      t[s] = p < n ? (int)flat[o + p] : -1;
      st[p * NG] = t[s];
    }
    __syncwarp();
#pragma unroll
    for (int s = 0; s < K; ++s) {
      const int p = s * G + l;
      rk[s] = RANK_INF;
      if (p + 1 < n) {
        rk[s] = rank_of(t[s], st[(p + 1) * NG]);
        ++lookups;
      }
    }
    while (true) {
      int best = min(rk[0], rk[1]);
      if (G == 32) {
        best = __reduce_min_sync(FULL, best);
      } else {
#pragma unroll
        for (int x = G / 2; x > 0; x >>= 1)
          best = min(best, __shfl_xor_sync(FULL, best, x));
      }
      if (__all_sync(FULL, best == RANK_INF)) break;
      M m = 0;
#pragma unroll
      for (int s = 0; s < K; ++s) {
        uint32_t b = __ballot_sync(FULL, best != RANK_INF && rk[s] == best);
        if (G < 32) b = (b >> (g * G)) & ((1u << (G % 32)) - 1);
        m |= (M)b << (s * G);
      }
      const M valid = n >= 8 * (int)sizeof(M) ? ~(M)0 : ((M)1 << n) - 1;
      const M sel = every_other(m);
      const M keep = valid & ~(sel << 1);
      // the new ids, and the kept pairs that end at one
      const M dirty = sel | ((sel >> 1) & keep);
      __syncwarp();                 // the last round's reads are done
#pragma unroll
      for (int s = 0; s < K; ++s) {
        const int p = s * G + l;
        if ((keep >> p) & 1) {
          const int d = popc(keep & (((M)1 << p) - 1));
          st[d * NG] = (sel >> p) & 1 ? 256 + best : t[s];
          sr[d * NG] = (dirty >> p) & 1 ? DIRTY : rk[s];
        }
      }
      n = popc(keep);
      __syncwarp();
#pragma unroll
      for (int s = 0; s < K; ++s) {
        const int q = s * G + l;
        t[s] = q < n ? st[q * NG] : -1;
        rk[s] = q < n ? sr[q * NG] : RANK_INF;
        if (rk[s] == DIRTY) {
          rk[s] = RANK_INF;
          if (q + 1 < n) {
            rk[s] = rank_of(t[s], st[(q + 1) * NG]);
            ++lookups;
          }
        }
      }
    }
#pragma unroll
    for (int s = 0; s < K; ++s) {
      const int p = s * G + l;
      if (p < n) tok[o + p] = t[s];
    }
    if (l == 0 && k < total) counts[wbase + src] = n;
    __syncwarp();                   // before the next chunks' writes
  }
}

// ---------------------------------------------------------------------
// chunks over 64 bytes: one lane merges t[0, n) in place in global
// scratch; rk[i] is the rank of (t[i], t[i + 1]).  Returns the new length.
// ---------------------------------------------------------------------
template <class Rank>
__device__ __forceinline__ int merge_long(int* t, int* rk, int n,
                                          const Rank& rank_of,
                                          unsigned& lookups) {
  for (int i = 0; i + 1 < n; ++i) rk[i] = rank_of(t[i], t[i + 1]);
  lookups += n - 1;
  rk[n - 1] = RANK_INF;
  while (true) {
    // the lowest rank and its first site, looking up the dirty pairs
    int best = RANK_INF, p = 0;
    for (int i = 0; i + 1 < n; ++i) {
      int r = rk[i];
      if (r == DIRTY) {
        r = rank_of(t[i], t[i + 1]);
        rk[i] = r;
        ++lookups;
      }
      if (r < best) {
        best = r;
        p = i;
      }
    }
    if (best == RANK_INF) return n;
    // replace every occurrence from p on, left to right, compacting in
    // place (reads stay ahead of writes); the pairs around each new id
    // become dirty
    const int a = t[p], b = t[p + 1], nw = 256 + best;
    int j = p;
    for (int i = p; i < n; ++j) {
      if (i + 1 < n && t[i] == a && t[i + 1] == b) {
        t[j] = nw;
        rk[j] = DIRTY;
        if (j > 0) rk[j - 1] = DIRTY;
        i += 2;
      } else {
        t[j] = t[i];
        rk[j] = rk[i];
        i += 1;
      }
    }
    n = j;
    rk[n - 1] = RANK_INF;
  }
}

template <class Rank>
__global__ void __launch_bounds__(THREADS)
    encode_kernel(const uint8_t* __restrict__ flat,
                  const int64_t* __restrict__ start,
                  const int* __restrict__ lens, int W, Rank rank_of,
                  int* __restrict__ tok, int* __restrict__ rkbuf,
                  int* __restrict__ counts,
                  unsigned long long* __restrict__ lookups) {
  const int lane = threadIdx.x & 31;
  // 64-bit until checked against W < 2^31: past it the product wraps
  const int64_t wb = ((int64_t)blockIdx.x * THREADS + threadIdx.x) & ~31;
  if (wb >= W) return;                          // the whole warp
  const int wbase = (int)wb;                    // <= 2^31 - 32
  const int w = wbase + lane;
  const bool live = w < W;
  const int n = live ? lens[w] : 0;
  const int64_t o = live ? start[w] : 0;
  unsigned nl = 0;
  if (live && n <= 1) {
    if (n == 1) tok[o] = flat[o];
    counts[w] = n;
  }
  __shared__ int sh[THREADS / 32][SH_INTS];
  int* wsh = sh[threadIdx.x >> 5];
  merge_class<4>(__ballot_sync(FULL, live && n >= 2 && n <= 8), wbase, o, n,
                 flat, rank_of, tok, counts, wsh, nl);
  merge_class<8>(__ballot_sync(FULL, live && n >= 9 && n <= 16), wbase, o,
                 n, flat, rank_of, tok, counts, wsh, nl);
  merge_class<16>(__ballot_sync(FULL, live && n >= 17 && n <= 32), wbase, o,
                  n, flat, rank_of, tok, counts, wsh, nl);
  merge_class<32>(__ballot_sync(FULL, live && n >= 33 && n <= LOCAL), wbase,
                  o, n, flat, rank_of, tok, counts, wsh, nl);
  if (live && n > LOCAL) {
    int* t = tok + o;
    for (int i = 0; i < n; ++i) t[i] = flat[o + i];
    counts[w] = merge_long(t, rkbuf + o, n, rank_of, nl);
  }
  if (lookups) {
    const unsigned sum = __reduce_add_sync(FULL, nl);
    if (lane == 0) atomicAdd(lookups, (unsigned long long)sum);
  }
}

template <class T>
__global__ void __launch_bounds__(THREADS)
    pack_kernel(const int* __restrict__ tok,
                const int64_t* __restrict__ start,
                const int* __restrict__ counts,
                const int64_t* __restrict__ ends, int W, T* __restrict__ out) {
  const int64_t w = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (w >= W) return;
  const int n = counts[w];
  const int* src = tok + start[w];
  T* dst = out + (ends[w] - n);
  for (int i = 0; i < n; ++i) dst[i] = (T)src[i];
}

int blocks(int W) { return (int)(((int64_t)W + THREADS - 1) / THREADS); }

}  // namespace

extern "C" {

// Merges W contiguous chunks on `stream`: chunk w is
// flat[start[w], start[w] + lens[w]) (start int64, exclusive cumsum of
// lens).  Ranks come from `table` (int32 [v * v]) when it is not null,
// else from the hash table ka/kb/rank (int32 [cap], cap a power of two).
// tok and rk are int32 scratch of the stream's length (rk is used by
// chunks over 64 bytes only): chunk w's ids go to
// tok[start[w], start[w] + counts[w]).  lookups (uint64, may be null) gets
// the rank lookups added.  Returns the launch's CUDA error, or 0.
int shred_encode_chunks(const uint8_t* flat, const int64_t* start,
                        const int* lens, int W, const int* table,
                        const int* ka, const int* kb, const int* rank, int v,
                        int cap, int max_probe, int* tok, int* rk,
                        int* counts, unsigned long long* lookups,
                        void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (W < 1) return 0;
  if (table) {
    encode_kernel<<<blocks(W), THREADS, 0, s>>>(
        flat, start, lens, W, DenseRank{table, v}, tok, rk, counts, lookups);
  } else {
    if (cap < 1 || (cap & (cap - 1))) return (int)cudaErrorInvalidValue;
    encode_kernel<<<blocks(W), THREADS, 0, s>>>(
        flat, start, lens, W,
        HashRank{ka, kb, rank, (uint32_t)(cap - 1), max_probe}, tok, rk,
        counts, lookups);
  }
  return (int)cudaGetLastError();
}

// Packs each chunk's ids from tok (as shred_encode_chunks left them) into
// out in chunk order: chunk w's ids end at ends[w] (int64, inclusive
// cumsum of counts).  out_bytes 2 writes uint16, 4 int32.
int shred_encode_pack(const int* tok, const int64_t* start, const int* counts,
                      const int64_t* ends, int W, void* out, int out_bytes,
                      void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (W < 1) return 0;
  if (out_bytes == 2)
    pack_kernel<<<blocks(W), THREADS, 0, s>>>(tok, start, counts, ends, W,
                                              (uint16_t*)out);
  else if (out_bytes == 4)
    pack_kernel<<<blocks(W), THREADS, 0, s>>>(tok, start, counts, ends, W,
                                              (int*)out);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"
