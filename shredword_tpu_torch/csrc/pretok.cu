// GPT pattern match-start mask for Hopper (sm_90a): P1.
//
// Replaces the JAX package's device splitter gpt_starts_mask_jnp
// (shredword_tpu/ops/pretok_ops.py:313), an XLA program: per position
// boolean algebra over the character classes and their neighbours, and
// five associative max-scans that broadcast run stats (digit-run start,
// whitespace-run start and end, the run's first non-newline and last
// newline), two of them then gathered at a run's start or end.
//
// Input int8 classes [n] (pretok_ops.class_table values; positions
// outside [0, n) count as class 16), output the uint8 mask [n] (1 = a
// match starts here).
//
// The formulation here needs no gather: every run stat that the JAX
// program gathers at the run's start or end is rewritten as a scan whose
// key a position computes from its own window of classes (the equality
// is tested against the plain version, pretok_ops.gpt_starts_mask_plain):
//   f0  last digit-run start <= p
//   f1  last whitespace-run start a <= p, as 2a + (the run absorbs its
//       newline prefix: a > 0, class a-1 punct and class a a newline)
//   f2  last newline <= p
//   f3  last non-newline whitespace <= p - 1
//   r0  first whitespace-run end + 1 >= p (the run's b)
//   r1  first newline >= p
// With them, at a whitespace position p of run [a, b):
//   - the run's first match: p == a, or, when the run absorbs its newline
//     prefix, the first non-newline: p not a newline and f3 < a;
//   - after the run's last newline: class p-1 a newline and r1 >= b;
//   - the leftover of a run that does not end the text, at p == b-1:
//     b - rem >= 2 with rem = f2 + 1 if f2 >= a else a.
// Every other mark is gathered from the classes at p-4 .. p+4.
//
// What bounds it on the H100: the bytes, one class in and one mask byte
// out per position (2.4 us at 4M positions), and the scans' three passes.
// Three launches: (1) each tile of 1024 positions (one thread each)
// scans its keys and writes the six tile totals; (2) one block turns the
// totals into each tile's carries (the maximum of the tiles before it,
// the minimum of those after it); (3) each tile scans again with its
// carries and writes the mask.  A run of any length (10k spaces, 5k
// digits) crosses tiles through the carries.  The classes are read
// twice, the tile totals and carries are 48 B per tile.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 1024;    // positions per block, one thread each
constexpr int HALO = 4;       // the marks read classes at p-4 .. p+4
constexpr int NONE = -1;      // identity of the forward (max) scans
constexpr int BIG = 0x7fffffff;  // identity of the reverse (min) scans
constexpr int NFWD = 4, NSCAN = 6;
constexpr unsigned FULL = 0xffffffffu;

enum {
  C_OTHER = 0, C_SPACE = 1, C_WS = 2, C_CR = 3, C_LF = 4, C_DIGIT = 5,
  C_LETTER = 6, C_APO = 7, C_S = 8, C_D = 9, C_M = 10, C_T = 11, C_L = 12,
  C_V = 13, C_R = 14, C_E = 15, C_OUT = 16
};

__device__ __forceinline__ bool letterish(int c) {
  return c == C_LETTER || (c >= C_S && c <= C_E);
}
__device__ __forceinline__ bool wsany(int c) {
  return c >= C_SPACE && c <= C_LF;
}
__device__ __forceinline__ bool newline(int c) {
  return c == C_CR || c == C_LF;
}
__device__ __forceinline__ bool punct(int c) {
  return c == C_OTHER || c == C_APO;
}

// the classes at p + k, k in [-HALO, HALO]; every call below uses
// constant offsets, so after inlining the window stays in registers
struct Win {
  int c[2 * HALO + 1];
  int p;
  __device__ __forceinline__ int operator()(int k) const { return c[k + HALO]; }
};

// alt 1: a contraction starts at the apostrophe (the JAX con1 / con2)
__device__ __forceinline__ bool con1(const Win& w, int k) {
  return w(k) == C_APO && !(punct(w(k - 1)) || w(k - 1) == C_SPACE) &&
         w(k + 1) >= C_S && w(k + 1) <= C_T;
}
__device__ __forceinline__ bool con2(const Win& w, int k) {
  const int a = w(k + 1), b = w(k + 2);
  return w(k) == C_APO && !(punct(w(k - 1)) || w(k - 1) == C_SPACE) &&
         !con1(w, k) &&
         ((a == C_L && b == C_L) || (a == C_V && b == C_E) ||
          (a == C_R && b == C_E));
}
__device__ __forceinline__ bool con(const Win& w, int k) {
  return con1(w, k) || con2(w, k);
}
// a letter eaten by a contraction's suffix
__device__ __forceinline__ bool consumed(const Win& w, int k) {
  return con1(w, k - 1) || con2(w, k - 1) || con2(w, k - 2);
}
// alt 2: a letter run's chunk, which may absorb one prefix character
__device__ __forceinline__ bool head(const Win& w, int k) {
  return letterish(w(k)) && !consumed(w, k) &&
         (!letterish(w(k - 1)) || consumed(w, k - 1));
}
__device__ __forceinline__ bool absorb(const Win& w, int k) {
  const bool lone_punct_p = punct(w(k - 1)) && !punct(w(k - 2)) &&
                            w(k - 2) != C_SPACE && !con(w, k - 1);
  const bool ws_prefix_p = w(k - 1) == C_SPACE || w(k - 1) == C_WS;
  return head(w, k) && (lone_punct_p || ws_prefix_p) && w.p + k > 0;
}
// alt 4: a punct run's chunk, which may absorb one preceding space
__device__ __forceinline__ bool prs(const Win& w, int k) {
  return punct(w(k)) && !punct(w(k - 1)) && !con(w, k);
}
__device__ __forceinline__ bool sp_absorb(const Win& w, int k) {
  return prs(w, k) && w(k - 1) == C_SPACE && w.p + k > 0;
}
__device__ __forceinline__ bool eaten(const Win& w, int k) {
  const bool lone = punct(w(k)) && !punct(w(k - 1)) && !punct(w(k + 1));
  return lone && letterish(w(k + 1)) && !con(w, k) && w(k - 1) != C_SPACE;
}

// the six scan keys of position w.p (identity past the text)
__device__ __forceinline__ void scan_keys(const Win& w, int n, int* key) {
  const int p = w.p;
  if (p >= n) {
    for (int s = 0; s < NSCAN; ++s) key[s] = s < NFWD ? NONE : BIG;
    return;
  }
  key[0] = w(0) == C_DIGIT && w(-1) != C_DIGIT ? p : NONE;
  key[1] = wsany(w(0)) && !wsany(w(-1))
               ? 2 * p + (p > 0 && punct(w(-1)) && newline(w(0)))
               : NONE;
  key[2] = newline(w(0)) ? p : NONE;
  key[3] = wsany(w(-1)) && !newline(w(-1)) ? p - 1 : NONE;
  key[4] = wsany(w(0)) && !wsany(w(1)) ? p + 1 : BIG;
  key[5] = newline(w(0)) ? p : BIG;
}

// Inclusive scan over the block's TILE threads, combined with `carry`:
// forward, the maximum over threads <= this one; reverse, the minimum
// over threads >= this one.  sh holds 32 ints.
template <bool FWD>
__device__ __forceinline__ int block_scan(int v, int carry, int* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 1; o < 32; o <<= 1) {
    const int u = FWD ? __shfl_up_sync(FULL, v, o)
                      : __shfl_down_sync(FULL, v, o);
    if (FWD ? lane >= o : lane + o < 32) v = FWD ? max(v, u) : min(v, u);
  }
  if (lane == (FWD ? 31 : 0)) sh[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int t = sh[lane];
    for (int o = 1; o < 32; o <<= 1) {
      const int u = FWD ? __shfl_up_sync(FULL, t, o)
                        : __shfl_down_sync(FULL, t, o);
      if (FWD ? lane >= o : lane + o < 32) t = FWD ? max(t, u) : min(t, u);
    }
    sh[lane] = t;
  }
  __syncthreads();
  const int pre = FWD ? (warp > 0 ? sh[warp - 1] : NONE)
                      : (warp < 31 ? sh[warp + 1] : BIG);
  v = FWD ? max(v, max(pre, carry)) : min(v, min(pre, carry));
  __syncthreads();  // sh is reused by the next scan
  return v;
}

__device__ __forceinline__ Win load_window(const int8_t* __restrict__ cls,
                                           int n, int8_t* tile) {
  const long long base = (long long)blockIdx.x * TILE - HALO;
  for (int i = threadIdx.x; i < TILE + 2 * HALO; i += TILE) {
    const long long q = base + i;
    tile[i] = q >= 0 && q < n ? cls[q] : (int8_t)C_OUT;
  }
  __syncthreads();
  Win w;
  w.p = blockIdx.x * TILE + threadIdx.x;
  for (int k = 0; k <= 2 * HALO; ++k) w.c[k] = tile[threadIdx.x + k];
  return w;
}

// Pass 1: each tile's six scan totals, into totals[s * nt + tile].
__global__ void __launch_bounds__(TILE)
    tile_totals_kernel(const int8_t* __restrict__ cls, int n,
                       int* __restrict__ totals) {
  __shared__ int8_t tile[TILE + 2 * HALO];
  __shared__ int sh[32];
  const Win w = load_window(cls, n, tile);
  int key[NSCAN];
  scan_keys(w, n, key);
  for (int s = 0; s < NSCAN; ++s) {
    const int v = s < NFWD ? block_scan<true>(key[s], NONE, sh)
                           : block_scan<false>(key[s], BIG, sh);
    if (threadIdx.x == (s < NFWD ? TILE - 1 : 0))
      totals[s * gridDim.x + blockIdx.x] = v;
  }
}

// Pass 2 (one block of TILE threads): carries[s * nt + t] is the maximum
// of the totals of the tiles before t (forward scans) or the minimum of
// those after t (reverse scans).  Thread i walks a run of `per` tiles.
__global__ void __launch_bounds__(TILE)
    carry_kernel(const int* __restrict__ totals, int nt,
                 int* __restrict__ carries) {
  __shared__ int sh[32];
  __shared__ int runs[TILE];   // inclusive scan over the threads' runs
  const int per = (nt + TILE - 1) / TILE;
  const int lo = min((int)threadIdx.x * per, nt), hi = min(lo + per, nt);
  for (int s = 0; s < NSCAN; ++s) {
    const bool fwd = s < NFWD;
    const int* t = totals + s * nt;
    int* c = carries + s * nt;
    int run = fwd ? NONE : BIG;
    for (int i = lo; i < hi; ++i) run = fwd ? max(run, t[i]) : min(run, t[i]);
    runs[threadIdx.x] = fwd ? block_scan<true>(run, NONE, sh)
                            : block_scan<false>(run, BIG, sh);
    __syncthreads();
    if (fwd) {
      int acc = threadIdx.x > 0 ? runs[threadIdx.x - 1] : NONE;
      for (int i = lo; i < hi; ++i) {
        c[i] = acc;
        acc = max(acc, t[i]);
      }
    } else {
      int acc = threadIdx.x < TILE - 1 ? runs[threadIdx.x + 1] : BIG;
      for (int i = hi - 1; i >= lo; --i) {
        c[i] = acc;
        acc = min(acc, t[i]);
      }
    }
    __syncthreads();
  }
}

// Pass 3: the six scans with the tile's carries, then the mark of every
// position of the tile.
__global__ void __launch_bounds__(TILE)
    mask_kernel(const int8_t* __restrict__ cls, int n,
                const int* __restrict__ carries, uint8_t* __restrict__ out) {
  __shared__ int8_t tile[TILE + 2 * HALO];
  __shared__ int sh[32];
  const Win w = load_window(cls, n, tile);
  int key[NSCAN], S[NSCAN];
  scan_keys(w, n, key);
  for (int s = 0; s < NSCAN; ++s) {
    const int carry = carries[s * gridDim.x + blockIdx.x];
    S[s] = s < NFWD ? block_scan<true>(key[s], carry, sh)
                    : block_scan<false>(key[s], carry, sh);
  }
  const int p = w.p;
  if (p >= n) return;
  bool m = p == 0 || con1(w, 0) || con1(w, -2) || con2(w, 0) ||
           con2(w, -3) ||                                   // alt 1
           (head(w, 0) && !absorb(w, 0)) || absorb(w, 1) ||  // alt 2
           (w(0) == C_DIGIT && (p - S[0]) % 3 == 0) ||      // alt 3
           (w(-1) == C_DIGIT && w(0) != C_DIGIT) ||
           (prs(w, 0) && !sp_absorb(w, 0) && !eaten(w, 0)) ||
           sp_absorb(w, 1);                                 // alt 4
  if (wsany(w(0))) {                                        // alts 5-7
    const int a = S[1] >> 1, b = S[4];
    const bool first = (S[1] & 1) ? !newline(w(0)) && S[3] < a : p == a;
    const bool after_nl = newline(w(-1)) && S[5] >= b;
    const int rem = S[2] >= a ? S[2] + 1 : a;
    const bool leftover = b == p + 1 && b < n && b - rem >= 2;
    m = m || first || after_nl || leftover;
  }
  out[p] = m;
}

}  // namespace

extern "C" {

// The match-start mask of cls (int8 [n], 0 < n < 2^30) into out (uint8
// [n]) on `stream`: three launches.  totals and carries are int32 scratch
// of 6 * ceil(n / 1024) each.  Returns the first launch's CUDA error, or 0.
int shred_gpt_starts_mask(const int8_t* cls, int n, int* totals,
                          int* carries, uint8_t* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n < 1) return 0;
  if (n >= (1 << 30)) return (int)cudaErrorInvalidValue;
  const int nt = (n + TILE - 1) / TILE;
  tile_totals_kernel<<<nt, TILE, 0, s>>>(cls, n, totals);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  carry_kernel<<<1, TILE, 0, s>>>(totals, nt, carries);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  mask_kernel<<<nt, TILE, 0, s>>>(cls, n, carries, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
