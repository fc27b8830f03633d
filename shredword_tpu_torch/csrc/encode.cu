// BPE encode merge loop for Hopper (sm_90a): one thread per chunk.
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
// What bounds it on the H100: a chunk's merges are a serial chain that
// depends on no other chunk, and the work per chunk is tiny (the
// unique chunks of natural text average a few bytes), so the lockstep
// rounds of the TPU formulation -- as many rounds as the longest chunk
// needs, each over every chunk -- become one thread per chunk that
// stops when its own chunk is done.  Per merge the thread keeps the rank
// of every adjacent pair, so a merge looks up only the pairs it creates
// (the pair ending at each new id and the one starting there); the
// rest is a scan of at most 63 ints for the minimum.  The bytes it must
// move are the unique chunks in and the ids out, a few MB per call, so
// the bound is the rank lookups (dense int32 [v*v] table, 64 MB at vocab
// 4096, or the open-addressing hash table above that) and the latency
// of one thread's chain: the longest chunk sets the call's time.
//
// Memory: a chunk of at most 64 bytes lives in a thread-local int32[64]
// (with its int32[64] ranks); a longer one works in place on its own
// slice of a global int32 buffer (tokens and ranks, int64 offsets).  Its
// time grows with the square of its length (a scan per merge), which
// whitespace and GPT pre-tokenization keep rare.
//
// Output: launch 1 writes each chunk's ids at the chunk's byte offset of
// an int32 buffer and its count; the caller's torch.cumsum of the counts
// gives each chunk's output offset; launch 2 packs the ids in chunk order
// as uint16 (every id < 65536) or int32.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int RANK_INF = 0x7fffffff;
constexpr int DIRTY = -2;     // a pair whose rank must be looked up again
constexpr int LOCAL = 64;     // the longest chunk kept in thread-local arrays
constexpr int THREADS = 128;

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

// Merges t[0, n) to the end; rk[i] is the rank of (t[i], t[i + 1]).
// Returns the new length; counts the rank lookups into `lookups`.
template <class Rank>
__device__ __forceinline__ int merge_chunk(int* t, int* rk, int n,
                                           const Rank& rank_of,
                                           unsigned& lookups) {
  if (n < 2) return n;
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
    // a rank names one pair, so p is its first occurrence: replace every
    // occurrence from p on, left to right, compacting in place (reads stay
    // ahead of writes); the pairs around each new id become dirty
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
  const int w = blockIdx.x * THREADS + threadIdx.x;
  if (w >= W) return;
  const int64_t o = start[w];
  int n = lens[w];
  unsigned nl = 0;
  if (n <= LOCAL) {
    int t[LOCAL], rk[LOCAL];
    for (int i = 0; i < n; ++i) t[i] = flat[o + i];
    n = merge_chunk(t, rk, n, rank_of, nl);
    for (int i = 0; i < n; ++i) tok[o + i] = t[i];
  } else {
    int* t = tok + o;
    for (int i = 0; i < n; ++i) t[i] = flat[o + i];
    n = merge_chunk(t, rkbuf + o, n, rank_of, nl);
  }
  counts[w] = n;
  if (lookups) atomicAdd(lookups, (unsigned long long)nl);
}

template <class T>
__global__ void __launch_bounds__(THREADS)
    pack_kernel(const int* __restrict__ tok,
                const int64_t* __restrict__ start,
                const int* __restrict__ counts,
                const int64_t* __restrict__ ends, int W, T* __restrict__ out) {
  const int w = blockIdx.x * THREADS + threadIdx.x;
  if (w >= W) return;
  const int n = counts[w];
  const int* src = tok + start[w];
  T* dst = out + (ends[w] - n);
  for (int i = 0; i < n; ++i) dst[i] = (T)src[i];
}

int blocks(int W) { return (W + THREADS - 1) / THREADS; }

}  // namespace

extern "C" {

// Merges W contiguous chunks on `stream`: chunk w is
// flat[start[w], start[w] + lens[w]) (start int64, exclusive cumsum of
// lens).  Ranks come from `table` (int32 [v * v]) when it is not null,
// else from the hash table ka/kb/rank (int32 [cap], cap a power of two).
// tok and rk are int32 scratch of the stream's length: chunk w's ids go
// to tok[start[w], start[w] + counts[w]).  lookups (uint64, may be null)
// gets the rank lookups added.  Returns the launch's CUDA error, or 0.
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
