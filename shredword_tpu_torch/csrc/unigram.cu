// Unigram lattice kernels for Hopper (sm_90a): sixteen lanes per word.
//
// U1 (fb_kernel) replaces the JAX package's _fb_core
// (shredword_tpu/ops/unigram_ops.py, through _fb_device_resident and the
// sharded body of parallel/unigram.py), the E-step of Unigram EM: per word,
// the forward and backward log-sum-exp over the word's lattice, the
// posterior of every piece occurrence times the word's count added into the
// expected counts, and alpha[len] times the count added into the corpus
// log-likelihood.  U2 (viterbi_kernel) replaces _viterbi_device and the host
// backtrace of viterbi(): the max over the same lattice, the best piece per
// end position, the backtrace and the final score.
//
// Layout: ids int32 [L, K, W], W innermost (cell (j, k) of word w is the
// piece that starts at j with length k + 1, -1 when absent).  The JAX
// table is [L, W, K] (ops/unigram_ops.device_table_from_jax maps it).  A
// lane reads only the cells inside its word (j + k + 1 <= len).
//
// What bounded the first version (one thread per word; NVIDIA H100 80GB
// HBM3, 700.00 W): U1 took 0.682-0.686 ms on the default config's slab
// [16, 65536] (112x its bound from the bytes), 0.149 ms with every cell's
// id distinct, so 78% of the call was the float64 atomics of the hot
// pieces: the marker and the single bytes sit in nearly every word, and
// each posterior was one global atomic, up to 65,536 on one address.  On
// the slabs of 7,667 and 6,686 words, 60 and 53 blocks of 128 threads left
// most of the 132 SMs idle (127-131x and 103-104x).  A thread ran its word
// as one dependent chain of L positions x K cells, with its DP arrays in
// local memory (indexed by a runtime position).  U2, with no atomics, took
// 0.041 ms on the prune slab [15, 65536] (17x).
//
// This design:
//   * a word is a group of 16 lanes of one warp, lane k owning the pieces
//     of length k + 1 (K <= 15, lane 15 idle), two words a warp.  At end
//     position j lane k reads cell (j - k - 1, k) and takes the alpha it
//     needs from a register window that shifts one lane per position
//     (__shfl_up_sync in the group); the log-sum-exp is a max and a sum
//     over the 16 lanes (butterflies, so every lane holds the same value).
//     The backward pass mirrors it with beta; the posterior of (j, k) is
//     lane k's own.  Only alpha[0..len] is kept, in shared memory (one
//     row of 65 floats per word), for the backward pass; U2 keeps only its
//     back pointers (bytes), and only when it backtraces.  16x the threads
//     of the first version, and no local memory.
//   * the slab's most frequent piece ids (by cell occurrence, computed
//     once per slab where the resident table is built or remapped:
//     unigram_ops.hot_ids, with the map from every id to its place among
//     them) get float64 accumulators in shared memory, one set per block;
//     the other ids add straight into the global counts.  The grid is
//     persistent (as many blocks as are resident on the card, a
//     grid-stride loop over the words), so a hot id costs one global
//     atomic per block, not one per word.
//   * U2's max is a (score, k) reduction whose ties go to the smaller k:
//     the JAX package's argmax takes the first maximum.
//   * a step's cell is loaded two steps ahead and its lp one step ahead,
//     so that its loads are in flight while the step before it reduces.
//
// Times of this design (chip_smoke.py phase 14, NVIDIA H100 80GB HBM3,
// 700.00 W, two runs): U1 0.183-0.184 ms on [16, 65536] (30x its bound;
// 0.657-0.658 ms with no hot ids in shared memory, 0.178 ms with every
// cell's id distinct), 0.029-0.030 ms on [16, 7667] (29x) and 0.033-0.034
// ms on [32, 6686] (21x); U2 0.034 ms on [15, 65536] scores only (15x),
// 0.040-0.042 ms with the backtrace.  What bounds it now is not measured
// (no hardware counters were read): not the atomics (distinct ids
// save 3%); at full occupancy the big slab takes 2.8 ns a word.  The
// instruction rate fits: on every step each of the 16 lanes runs an
// accurate expf and logf, two 4-step shuffle reductions and the window's
// shift, and the 15 lanes of a word read 15 rows of the table (a 32-byte
// sector each, shared with one other word).
//
// Numbers: the DP and the posteriors are float32 as in the JAX package, in
// its order of operations (((alpha + lp) + beta) - norm); exp and log are
// the accurate expf/logf.  The sum inside a log-sum-exp runs in a tree
// over the lanes, not in the JAX package's order, so U1 agrees with its
// plain version to rounding (counts rtol 1e-5, atol 1e-6; log-likelihood
// 1e-6 relative).  The expected counts and the log-likelihood are
// accumulated in float64 (atomicAdd(double*), native on sm_90): float32
// atomics sum in an order that changes from run to run, and a one-ulp
// change in an expected count can flip a prune near-tie (the stable argsort
// of the loss deltas, models/unigram.py).
//
// Subnormals: XLA flushes float32 subnormals to zero on the CPU and the
// TPU, so a posterior whose exp (or its product with the count) falls below
// FLT_MIN counts 0 there; both versions here flush it the same way (and
// skip its atomic).  A piece whose every posterior underflows thus gets an
// expected count of 0 and logp -1e30, as in the JAX package.
//
// Overflow (where the port departs from the JAX package): a word that can
// be split only through pieces pruned to logp -1e30 has alpha of -1e30 or
// below, where one float32 ulp is 1e23 or more, so ((alpha + lp) + beta) -
// norm is no longer near 0 and its exp can be +inf.  The JAX package then
// counts inf, and its next M-step gives NaN log-probs.  Here a posterior whose
// product with the count is not finite counts as 1 (the word's count), as
// the float64 "cpu" backend finds.  Wherever the JAX package's counts are
// finite the two agree bit for bit.
//
// -inf semantics (the JAX package's _lse): a position with no finite
// contribution gets -inf, not NaN; beta[len] = 0; a word whose alpha[len] is
// -inf adds no counts and no log-likelihood.  Only id -1 (any negative id)
// is absent: a piece pruned to logp = -1e30 is finite.
//
// Memory: alpha (U1) and the back pointers (U2) live in shared memory up
// to L = 64; a longer L uses a column of a global scratch buffer, [L + 1, W]
// with W innermost, so one kernel takes every L.

#include <cuda_runtime.h>
#include <float.h>
#include <math_constants.h>
#include <stdint.h>

// CUDART_INF_F is not a constant expression
#define NEG_INF (-CUDART_INF_F)

namespace {

constexpr int KMAX = 15;        // UnigramConfig's max_piece_len limit
constexpr int GROUP = 16;       // lanes per word
constexpr int THREADS = 256;
constexpr int WORDS = THREADS / GROUP;   // words of a block in flight
constexpr int LOCAL = 64;       // the longest L kept in shared memory
constexpr int HOT_MAX = 1024;   // shared float64 accumulators per block

// a word's per-position values: its row of a shared array (stride 1) or
// its column of a global [L + 1, W] buffer (stride W)
template <class T>
struct Column {
  T* p;
  int stride;
  __device__ __forceinline__ T& operator[](int j) const {
    return p[(size_t)j * stride];
  }
};

// this thread's place: its word group's lanes, its piece length - 1, and
// the group's index in the block
struct Lane {
  unsigned mask;
  int k;
  int word;
};

__device__ __forceinline__ Lane lane_of() {
  const int t = threadIdx.x;
  return {0xffffu << (t & GROUP), t & (GROUP - 1), t / GROUP};
}

struct Lattice {
  const int* ids;   // [L, K, W]
  const float* lp;  // [n_pieces]
  int K, W;
  __device__ __forceinline__ int cell(int j, int k, int w) const {
    return __ldg(ids + ((size_t)j * K + k) * W + w);
  }
  __device__ __forceinline__ float lp_of(int id) const {
    return id >= 0 ? __ldg(lp + id) : 0.f;
  }
};

// Lane k's cell of word w at the position that a DP step visits, loaded
// two steps ahead and its lp one step ahead, so that a step's loads are
// in flight while the step before it reduces.  Cell(j) gives the id of
// step j (-1: none) and loads nothing outside the word.
template <class Cell>
struct Ahead {
  Cell cell;
  const Lattice& t;
  int dir;          // +1: forward, -1: backward
  int step;         // the step whose cell `after` holds
  int id, after;    // the ids of the next two steps
  float l;          // lp of `id`
  __device__ __forceinline__ Ahead(Cell c, const Lattice& t_, int first,
                                   int dir_)
      : cell(c), t(t_), dir(dir_), step(first + dir_), id(c(first)),
        after(c(first + dir_)), l(t_.lp_of(id)) {}
  // the current step's (id, lp); then the loads of one step further
  __device__ __forceinline__ int next(float& lp_out) {
    const int cur = id;
    lp_out = l;
    id = after;
    l = t.lp_of(id);
    step += dir;
    after = cell(step);
    return cur;
  }
};

// x, or 0 when it is a float32 subnormal (x >= 0)
__device__ __forceinline__ float flush(float x) {
  return x < FLT_MIN ? 0.f : x;
}

// log-sum-exp over the group's lanes as the JAX package's _lse: -inf when
// no entry is finite.  Every lane returns the same value.
__device__ __forceinline__ float group_lse(float c, unsigned mask) {
  float m = c;
#pragma unroll
  for (int o = GROUP / 2; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(mask, m, o, GROUP));
  if (m == NEG_INF) return NEG_INF;
  float s = expf(c - m);
#pragma unroll
  for (int o = GROUP / 2; o > 0; o >>= 1)
    s += __shfl_xor_sync(mask, s, o, GROUP);
  return m + logf(s);
}

// the group's (max, its smallest k): every lane returns the same pair
__device__ __forceinline__ float group_argmax(float v, int& k,
                                              unsigned mask) {
#pragma unroll
  for (int o = GROUP / 2; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(mask, v, o, GROUP);
    const int ok = __shfl_xor_sync(mask, k, o, GROUP);
    if (ov > v || (ov == v && ok < k)) {
      v = ov;
      k = ok;
    }
  }
  return v;
}

// the window one position on: lane k takes lane k - 1's value, lane 0 x
__device__ __forceinline__ float shift_in(float win, float x,
                                          const Lane& g) {
  const float up = __shfl_up_sync(g.mask, win, 1, GROUP);
  return g.k == 0 ? x : up;
}

// the expected counts: a hot id into the block's shared accumulator, any
// other straight into the global counts
struct Counts {
  const int* slot;   // [> every id]: the id's accumulator, or -1
  double* hot;       // shared [H]
  double* counts;    // global [n_pieces]
  int H;
  __device__ __forceinline__ int slot_of(int id) const {
    return slot != nullptr && id >= 0 ? __ldg(slot + id) : -1;
  }
  // a slot outside [0, H) counts as no accumulator
  __device__ __forceinline__ void add(int id, int s, float p) const {
    if ((unsigned)s < (unsigned)H)
      atomicAdd(hot + s, (double)p);
    else
      atomicAdd(counts + id, (double)p);
  }
};

// U1 on word w of length n, by its group: returns alpha[n] (-inf:
// unsegmentable), in every lane
template <class A>
__device__ __forceinline__ float fb_word(const Lattice& t, int w, int n,
                                         float wc, A alpha, const Lane& g,
                                         const Counts& out) {
  const int k = g.k;
  const bool live = k < t.K;
  // forward: lane k holds alpha[j - k - 1], where its piece ending at j
  // starts
  const auto ending = [&](int j) {
    return live && k < j && j <= n ? t.cell(j - k - 1, k, w) : -1;
  };
  Ahead<decltype(ending)> fwd(ending, t, 1, 1);
  float win = k == 0 ? 0.f : NEG_INF;
  float a = 0.f;
  if (k == 0) alpha[0] = 0.f;
  for (int j = 1; j <= n; ++j) {
    float l;
    const int id = fwd.next(l);
    a = group_lse(id >= 0 ? win + l : NEG_INF, g.mask);
    if (k == 0) alpha[j] = a;
    win = shift_in(win, a, g);
  }
  __syncwarp(g.mask);
  const float norm = a;
  if (norm != NEG_INF) {
    // backward, with the posteriors of the pieces starting at j: lane k
    // holds beta[j + k + 1], where its piece starting at j ends
    const auto starting = [&](int j) {
      return live && j >= 0 && j + k + 1 <= n ? t.cell(j, k, w) : -1;
    };
    Ahead<decltype(starting)> bwd(starting, t, n - 1, -1);
    int s_next = out.slot_of(bwd.id);
    win = k == 0 ? 0.f : NEG_INF;
    for (int j = n - 1; j >= 0; --j) {
      float l;
      const int id = bwd.next(l);
      const int s = s_next;
      s_next = out.slot_of(bwd.id);
      const float aj = alpha[j];
      float c = NEG_INF;
      if (id >= 0) {
        c = win + l;
        float p = flush(flush(expf(((aj + l) + win) - norm)) * wc);
        if (!(p <= FLT_MAX)) p = wc;       // overflow: see the header
        if (p != 0.f) out.add(id, s, p);
      }
      win = shift_in(win, group_lse(c, g.mask), g);
    }
  }
  __syncwarp(g.mask);   // the next word reuses the group's alpha row
  return norm;
}

__global__ void __launch_bounds__(THREADS)
    fb_kernel(const int* __restrict__ ids, const float* __restrict__ lp,
              const int* __restrict__ wlen, const float* __restrict__ wcount,
              int K, int W, int n, const int* __restrict__ hot,
              const int* __restrict__ slot, int H,
              float* __restrict__ scratch, double* __restrict__ counts,
              double* __restrict__ ll) {
  __shared__ float alpha_s[WORDS][LOCAL + 1];
  __shared__ double acc[HOT_MAX];
  __shared__ double ll_acc;
  for (int i = threadIdx.x; i < H; i += THREADS) acc[i] = 0.0;
  if (threadIdx.x == 0) ll_acc = 0.0;
  __syncthreads();
  const Lane g = lane_of();
  const Lattice t{ids, lp, K, W};
  const Counts out{slot, acc, counts, H};
  for (int w = blockIdx.x * WORDS + g.word; w < W;
       w += gridDim.x * WORDS) {
    const int n = wlen[w];
    const float wc = wcount[w];
    const float norm =
        scratch == nullptr
            ? fb_word(t, w, n, wc, Column<float>{alpha_s[g.word], 1}, g, out)
            : fb_word(t, w, n, wc, Column<float>{scratch + w, W}, g, out);
    if (g.k == 0 && norm != NEG_INF && norm != 0.f)
      atomicAdd(&ll_acc, (double)(norm * wc));
  }
  // the block's sums: one global atomic per touched hot id, one for ll
  __syncthreads();
  for (int i = threadIdx.x; i < H; i += THREADS)
    if (acc[i] != 0.0 && (unsigned)hot[i] < (unsigned)n)
      atomicAdd(counts + hot[i], acc[i]);
  if (threadIdx.x == 0 && ll_acc != 0.0) atomicAdd(ll, ll_acc);
}

// U2 on word w of length n, by its group: the best score at every end, its
// piece length - 1 in back[j] when BACK; returns the score at n (0 for
// n == 0), in every lane
template <bool BACK, class B>
__device__ __forceinline__ float viterbi_word(const Lattice& t, int w, int n,
                                              B back, const Lane& g) {
  const int k = g.k;
  const bool live = k < t.K;
  const auto ending = [&](int j) {
    return live && k < j && j <= n ? t.cell(j - k - 1, k, w) : -1;
  };
  Ahead<decltype(ending)> fwd(ending, t, 1, 1);
  float win = k == 0 ? 0.f : NEG_INF;   // lane k: score[j - k - 1]
  float best = 0.f;
  for (int j = 1; j <= n; ++j) {
    float l;
    const int id = fwd.next(l);
    int bk = k;
    best = group_argmax(id >= 0 ? win + l : NEG_INF, bk, g.mask);
    if (BACK && k == 0) back[j] = (uint8_t)bk;
    win = shift_in(win, best, g);
  }
  return best;
}

// the best path's pieces in order into out (column w of [L, W]); returns
// their number.  One lane, the one that wrote back[].
template <class B>
__device__ __forceinline__ int backtrace(const Lattice& t, int w, int n,
                                         B back, int* __restrict__ out) {
  int m = 0;
  for (int j = n; j > 0; j -= back[j] + 1) ++m;
  int i = m;
  for (int j = n; j > 0;) {
    const int k = back[j];
    j -= k + 1;
    out[(size_t)(--i) * t.W + w] = t.cell(j, k, w);
  }
  return m;
}

__global__ void __launch_bounds__(THREADS)
    viterbi_kernel(const int* __restrict__ ids, const float* __restrict__ lp,
                   const int* __restrict__ wlen, int K, int W,
                   uint8_t* __restrict__ back_buf, int* __restrict__ out,
                   int* __restrict__ count, float* __restrict__ final) {
  __shared__ uint8_t back_s[WORDS][LOCAL + 1];
  const Lane g = lane_of();
  const Lattice t{ids, lp, K, W};
  for (int w = blockIdx.x * WORDS + g.word; w < W;
       w += gridDim.x * WORDS) {
    const int n = wlen[w];
    float s;
    int m = 0;
    if (out == nullptr) {
      s = viterbi_word<false>(t, w, n, (uint8_t*)nullptr, g);
    } else if (back_buf == nullptr) {
      const Column<uint8_t> b{back_s[g.word], 1};
      s = viterbi_word<true>(t, w, n, b, g);
      if (g.k == 0 && s != NEG_INF) m = backtrace(t, w, n, b, out);
    } else {
      const Column<uint8_t> b{back_buf + w, W};
      s = viterbi_word<true>(t, w, n, b, g);
      if (g.k == 0 && s != NEG_INF) m = backtrace(t, w, n, b, out);
    }
    if (g.k == 0) {
      final[w] = s;   // the JAX package's final score of an empty word is 0
      if (count != nullptr) count[w] = m;
    }
  }
}

// blocks of a persistent launch of `kernel`: as many as the card holds at
// once (cached per device), and no more than the words need
template <class F>
cudaError_t persistent_blocks(F kernel, int* cached, int W, int* blocks) {
  int dev, sms, per_sm;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  int full = dev < 64 ? cached[dev] : 0;
  if (!full) {
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, kernel, THREADS, 0)) != cudaSuccess)
      return err;
    full = sms * (per_sm > 0 ? per_sm : 1);
    if (dev < 64) cached[dev] = full;
  }
  const int need = (W + WORDS - 1) / WORDS;
  *blocks = need < full ? need : full;
  return cudaSuccess;
}

int fb_blocks[64], viterbi_blocks[64];

}  // namespace

extern "C" {

// U1 on `stream`: ids int32 [L, K, W] (K <= 15, every id < n, the length
// of lp; negative = absent), lp float32, wlen int32 [W] (<= L), wcount
// float32 [W].  hot int32 [H] (H <= 1024) names the ids that get a shared
// accumulator, and slot int32 [> every id of the table] maps an id to its
// place in hot, or -1 (both null when H == 0).  Any values are safe: a
// slot outside [0, H) counts as none, and a hot id outside [0, n) is never
// added; but a slot other than hot's place sends its counts to another
// piece.  counts (float64 [n]) and ll (float64 [1]) must be zeroed by the
// caller; the expected counts and the log-likelihood are added to them.
// scratch: null when L <= 64, else float32 [(L + 1) W].  Returns the
// launch's CUDA error, or 0.
int shred_unigram_fb(const int* ids, const float* lp, int n, const int* wlen,
                     const float* wcount, int L, int K, int W, const int* hot,
                     const int* slot, int H, float* scratch, double* counts,
                     double* ll, void* stream) {
  if (K < 1 || K > KMAX || H < 0 || H > HOT_MAX ||
      (H > 0 && (hot == nullptr || slot == nullptr)) ||
      (L > LOCAL && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  if (W < 1) return 0;
  int blocks;
  cudaError_t err = persistent_blocks(fb_kernel, fb_blocks, W, &blocks);
  if (err != cudaSuccess) return (int)err;
  fb_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      ids, lp, wlen, wcount, K, W, n, hot, H > 0 ? slot : nullptr, H,
      L > LOCAL ? scratch : nullptr, counts, ll);
  return (int)cudaGetLastError();
}

// U2 on `stream`, the same table: final float32 [W] gets each word's best
// score (-inf: unsegmentable; 0 for an empty word).  When out is not null,
// out int32 [L, W] gets each word's pieces in order down its column and
// count int32 [W] (unless null) their number (0 when unsegmentable);
// back_buf (uint8 [(L + 1) W]) is then needed when L > 64.  Returns
// the launch's CUDA error, or 0.
int shred_unigram_viterbi(const int* ids, const float* lp, const int* wlen,
                          int L, int K, int W, uint8_t* back_buf, int* out,
                          int* count, float* final, void* stream) {
  if (K < 1 || K > KMAX ||
      (out != nullptr && L > LOCAL && back_buf == nullptr))
    return (int)cudaErrorInvalidValue;
  if (W < 1) return 0;
  int blocks;
  cudaError_t err =
      persistent_blocks(viterbi_kernel, viterbi_blocks, W, &blocks);
  if (err != cudaSuccess) return (int)err;
  viterbi_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      ids, lp, wlen, K, W, out != nullptr && L > LOCAL ? back_buf : nullptr,
      out, count, final);
  return (int)cudaGetLastError();
}

}  // extern "C"
