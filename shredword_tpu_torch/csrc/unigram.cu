// Unigram lattice kernels for Hopper (sm_90a): one thread per word.
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
// The JAX package scans positions with lax.scan over an [L, W, K] table, W
// words in lockstep.  Here a word's DP is a serial chain that depends on no
// other word, so each thread runs its own word to its own length and stops:
// no work on the padding of short words, and the backward pass, the
// posteriors and the scatter are one loop.
//
// Layout: ids int32 [L, K, W], W innermost (cell (j, k) of word w is the
// piece that starts at j with length k + 1, -1 when absent), so the 32
// threads of a warp read 32 neighbouring ints of one (j, k).  The JAX
// table is [L, W, K] (ops/unigram_ops.device_table_from_jax maps it).  A
// thread reads only the cells inside its word (j + k + 1 <= len).
//
// What bounds it on the H100: the bytes of the cells inside the words
// (read twice, forward and backward; the second read mostly hits L2), the
// gathers of lp (at most 100,000 floats, L2-resident) and, for U1, the
// atomics of the expected counts: the marker and the single bytes sit in
// most words, so their addresses take one atomic per word in turn.
//
// Numbers: the DP and the posteriors are float32 as in the JAX package, in
// its order of operations (((alpha + lp) + beta) - norm); exp and log are
// the accurate expf/logf.  The expected counts and the log-likelihood are
// accumulated in float64 (atomicAdd(double*), native on sm_90): float32
// atomics sum in an order that changes from run to run, and a one-ulp
// change in an expected count can flip a prune near-tie (the stable argsort
// of the loss deltas, models/unigram.py).  The log-likelihood is reduced per
// block first, one atomic per block.
//
// Subnormals: XLA flushes float32 subnormals to zero on the CPU and the
// TPU, so a posterior whose exp (or its product with the count) falls below
// FLT_MIN counts 0 there; both versions here flush it the same way (and
// skip its atomic).  A piece whose every posterior underflows thus gets an
// expected count of 0 and logp -1e30, as in the JAX package.
//
// -inf semantics (the JAX package's _lse): a position with no finite
// contribution gets -inf, not NaN; beta[len] = 0; a word whose alpha[len] is
// -inf adds no counts and no log-likelihood.  Only id -1 (any negative id)
// is absent: a piece pruned to logp = -1e30 is finite.
//
// Memory: alpha and beta (U1) or scores and back-pointers (U2) live in
// thread-local arrays up to L = 64; a longer L uses a slice of a global
// scratch buffer, [L + 1, W] with W innermost, so one kernel takes every L.
//
// U2's tie-break is the JAX package's argmax (the first maximum): k scans
// upward with a strict >, so on an equal score the shortest piece ending at
// the position wins.

#include <cuda_runtime.h>
#include <float.h>
#include <math_constants.h>
#include <stdint.h>

// CUDART_INF_F is not a constant expression
#define NEG_INF (-CUDART_INF_F)

namespace {

constexpr int KMAX = 15;      // UnigramConfig's max_piece_len limit
constexpr int LOCAL = 64;     // the longest L kept in thread-local arrays
constexpr int THREADS = 128;

// a word's per-position values: thread-local (stride 1) or its column of
// a global [L + 1, W] buffer (stride W)
template <class T>
struct Column {
  T* p;
  int stride;
  __device__ __forceinline__ T& operator[](int j) const {
    return p[(size_t)j * stride];
  }
};

struct Lattice {
  const int* ids;   // [L, K, W]
  const float* lp;  // [n_pieces]
  int K, W, w;
  __device__ __forceinline__ int cell(int j, int k) const {
    return __ldg(ids + ((size_t)j * K + k) * W + w);
  }
};

// x, or 0 when it is a float32 subnormal (x >= 0)
__device__ __forceinline__ float flush(float x) {
  return x < FLT_MIN ? 0.f : x;
}

// log-sum-exp of c[0, KMAX) as the JAX package's _lse: -inf when no entry
// is finite
__device__ __forceinline__ float lse(const float (&c)[KMAX]) {
  float m = NEG_INF;
#pragma unroll
  for (int k = 0; k < KMAX; ++k) m = fmaxf(m, c[k]);
  if (m == NEG_INF) return NEG_INF;
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < KMAX; ++k) s += expf(c[k] - m);
  return m + logf(s);
}

// U1 on word w of length n: returns alpha[n] (-inf: unsegmentable)
template <class A>
__device__ __forceinline__ float fb_word(const Lattice& t, int n, float wc,
                                         A alpha, A beta,
                                         double* __restrict__ counts) {
  alpha[0] = 0.f;
  for (int j = 1; j <= n; ++j) {
    float c[KMAX];
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      float v = NEG_INF;
      if (k < t.K && k < j) {
        const int id = t.cell(j - k - 1, k);
        if (id >= 0) v = alpha[j - k - 1] + __ldg(t.lp + id);
      }
      c[k] = v;
    }
    alpha[j] = lse(c);
  }
  const float norm = alpha[n];
  if (norm == NEG_INF) return norm;
  // backward, with the posteriors of the pieces starting at j
  beta[n] = 0.f;
  for (int j = n - 1; j >= 0; --j) {
    const float a = alpha[j];
    float c[KMAX];
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      float v = NEG_INF;
      if (k < t.K && j + k + 1 <= n) {
        const int id = t.cell(j, k);
        if (id >= 0) {
          const float l = __ldg(t.lp + id);
          const float b = beta[j + k + 1];
          v = b + l;
          const float p = flush(flush(expf(((a + l) + b) - norm)) * wc);
          if (p != 0.f) atomicAdd(counts + id, (double)p);
        }
      }
      c[k] = v;
    }
    beta[j] = lse(c);
  }
  return norm;
}

__global__ void __launch_bounds__(THREADS)
    fb_kernel(const int* __restrict__ ids, const float* __restrict__ lp,
              const int* __restrict__ wlen, const float* __restrict__ wcount,
              int L, int K, int W, float* __restrict__ scratch,
              double* __restrict__ counts, double* __restrict__ ll) {
  const int w = blockIdx.x * THREADS + threadIdx.x;
  double term = 0.0;
  if (w < W) {
    const Lattice t{ids, lp, K, W, w};
    const int n = wlen[w];
    const float wc = wcount[w];
    float norm;
    if (scratch == nullptr) {
      float alpha[LOCAL + 1], beta[LOCAL + 1];
      norm = fb_word(t, n, wc, Column<float>{alpha, 1},
                     Column<float>{beta, 1}, counts);
    } else {
      const size_t col = (size_t)(L + 1) * W;
      norm = fb_word(t, n, wc, Column<float>{scratch + w, W},
                     Column<float>{scratch + col + w, W}, counts);
    }
    if (norm != NEG_INF) term = (double)(norm * wc);
  }
  // the block's log-likelihood, then one atomic
  for (int o = 16; o > 0; o >>= 1)
    term += __shfl_down_sync(0xffffffffu, term, o);
  __shared__ double part[THREADS / 32];
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = term;
  __syncthreads();
  if (threadIdx.x == 0) {
    double s = 0.0;
    for (int i = 0; i < THREADS / 32; ++i) s += part[i];
    if (s != 0.0) atomicAdd(ll, s);
  }
}

// U2 on word w of length n: the best score at every end, its piece length
// - 1 in back[j]; returns the score at n
template <class S, class B>
__device__ __forceinline__ float viterbi_word(const Lattice& t, int n,
                                              S score, B back) {
  score[0] = 0.f;
  for (int j = 1; j <= n; ++j) {
    float best = NEG_INF;
    int bk = 0;
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      if (k < t.K && k < j) {
        const int id = t.cell(j - k - 1, k);
        if (id >= 0) {
          const float v = score[j - k - 1] + __ldg(t.lp + id);
          if (v > best) {
            best = v;
            bk = k;
          }
        }
      }
    }
    score[j] = best;
    back[j] = (uint8_t)bk;
  }
  return score[n];
}

// the best path's pieces in order into out (column w of [L, W]); returns
// their number
template <class B>
__device__ __forceinline__ int backtrace(const Lattice& t, int n, B back,
                                         int* __restrict__ out) {
  int m = 0;
  for (int j = n; j > 0; j -= back[j] + 1) ++m;
  int i = m;
  for (int j = n; j > 0;) {
    const int k = back[j];
    j -= k + 1;
    out[(size_t)(--i) * t.W + t.w] = t.cell(j, k);
  }
  return m;
}

__global__ void __launch_bounds__(THREADS)
    viterbi_kernel(const int* __restrict__ ids, const float* __restrict__ lp,
                   const int* __restrict__ wlen, int K, int W,
                   float* __restrict__ score_buf,
                   uint8_t* __restrict__ back_buf, int* __restrict__ out,
                   int* __restrict__ count, float* __restrict__ final) {
  const int w = blockIdx.x * THREADS + threadIdx.x;
  if (w >= W) return;
  const Lattice t{ids, lp, K, W, w};
  const int n = wlen[w];
  float s;
  int m = 0;
  if (score_buf == nullptr) {
    float score[LOCAL + 1];
    uint8_t back[LOCAL + 1];
    const Column<uint8_t> b{back, 1};
    s = viterbi_word(t, n, Column<float>{score, 1}, b);
    if (out != nullptr && s != NEG_INF) m = backtrace(t, n, b, out);
  } else {
    const Column<uint8_t> b{back_buf + w, W};
    s = viterbi_word(t, n, Column<float>{score_buf + w, W}, b);
    if (out != nullptr && s != NEG_INF) m = backtrace(t, n, b, out);
  }
  // the JAX package's final score of an empty word is 0
  final[w] = n > 0 ? s : 0.f;
  if (count != nullptr) count[w] = m;
}

int blocks(int W) { return (W + THREADS - 1) / THREADS; }

}  // namespace

extern "C" {

// U1 on `stream`: ids int32 [L, K, W] (K <= 15, every id < the length of
// lp, negative = absent), lp float32, wlen int32 [W] (<= L), wcount float32
// [W].  counts (float64, one per piece) and ll (float64 [1]) must be zeroed
// by the caller; the expected counts and the log-likelihood are added to
// them.  scratch: null when L <= 64, else float32 [2 (L + 1) W].  Returns
// the launch's CUDA error, or 0.
int shred_unigram_fb(const int* ids, const float* lp, const int* wlen,
                     const float* wcount, int L, int K, int W, float* scratch,
                     double* counts, double* ll, void* stream) {
  if (K < 1 || K > KMAX || (L > LOCAL && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  if (W < 1) return 0;
  fb_kernel<<<blocks(W), THREADS, 0, (cudaStream_t)stream>>>(
      ids, lp, wlen, wcount, L, K, W, L > LOCAL ? scratch : nullptr, counts,
      ll);
  return (int)cudaGetLastError();
}

// U2 on `stream`, the same table: final float32 [W] gets each word's best
// score (-inf: unsegmentable; 0 for an empty word).  When out is not null,
// out int32 [L, W] gets each word's pieces in order down its column and
// count int32 [W] their number (0 when unsegmentable).  score_buf (float32
// [(L + 1) W]) and back_buf (uint8 [(L + 1) W]): null when L <= 64.
// Returns the launch's CUDA error, or 0.
int shred_unigram_viterbi(const int* ids, const float* lp, const int* wlen,
                          int L, int K, int W, float* score_buf,
                          uint8_t* back_buf, int* out, int* count,
                          float* final, void* stream) {
  if (K < 1 || K > KMAX ||
      (L > LOCAL && (score_buf == nullptr || back_buf == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (W < 1) return 0;
  const bool global = L > LOCAL;
  viterbi_kernel<<<blocks(W), THREADS, 0, (cudaStream_t)stream>>>(
      ids, lp, wlen, K, W, global ? score_buf : nullptr,
      global ? back_buf : nullptr, out, count, final);
  return (int)cudaGetLastError();
}

}  // extern "C"
