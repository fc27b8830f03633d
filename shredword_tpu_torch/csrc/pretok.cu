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
// Bit-parallel marks.  A thread takes 16 positions, and holds the classes
// of positions p0 - 4 .. p0 + 19 (its own and a halo of 4 each side, the
// reach of every mark) as 24-bit masks, one a predicate (digit, letter,
// newline, ...), built from the classes' five bit planes.  Each
// alternative of the pattern is then a few shifts and logic operations on
// those masks for all 16 positions at once (the plain version's per
// position algebra, with "class at p + k" read as the mask shifted by k).
// The marks of a whitespace run read run stats, rewritten so that only
// four scans are left (the equality is tested against the plain version,
// pretok_ops.gpt_starts_mask_plain):
//   - the run's last position p marks a leftover iff p and p - 1 are both
//     whitespace and not newlines (and p + 1 < n): local;
//   - the run's first match is its start a, or, when the run absorbs its
//     newline prefix (a > 0, class a-1 punct, class a a newline), the
//     first position after the newlines from a, if that is whitespace: an
//     add carries a's bit through the newline bits to it;
//   - the position after the run's last newline q marks iff it is in the
//     run: from p = q + 1, the first event at or after p is a run end that
//     is not a newline rather than a newline; an add on the bit-reversed
//     masks fills each such run end's bit down to the event before it.
// So the scans are: f0, the last digit-run start <= p (digit blocks of 3
// are counted from it); f1, the last whitespace-run start a <= p as
// 2a + (the run absorbs its newline prefix); f2, the last whitespace
// position <= p that is not a newline; r, the first event at or after p
// (a newline q as 2q, the last position q of a whitespace run, not a
// newline, as 2q + 1; a minimum from the right).  A thread reads them only
// at its first position, for a run or a digit run that it continues, and
// r after its last.
//
// What bounds it on the H100: the bytes, one class in and one mask byte
// out per position (2.4 us at 4M positions).  The first version took
// 96.6x that: one position a thread, six block-wide scans of 1024
// positions each (a __syncthreads apiece) run twice, once for the tile
// totals and once for the mask, with a single block walking the totals
// serially in between: three dependent launches, the classes read twice.
// Here a thread loads its 16 classes at once (16 bytes; the halo from the
// neighbouring lanes by shuffle) and marks them with a few hundred
// instructions, and a tile of 16,384 positions (1024 threads) pays one
// warp scan and one block scan per key.  The carries cross tiles with no
// pass between:
//   launch 1, tiles in the order of an atomic ticket: the four tile
//     totals, and the forward carries by decoupled look-back over a
//     tile-status array, 1024 tiles a step (a tile waits only on tiles
//     with an earlier ticket, which have all started); no output;
//   launch 2, tiles from the last: the reverse carry by look-ahead over
//     the tiles after it (their launch-2 results where published, else
//     their launch-1 totals: it never waits), the forward carries from
//     launch 1, and the mask, 16 bytes a thread.
// The flags are stores with release and loads with acquire semantics (9%
// faster than fences at 4M), and the tile is as wide as a block can be: at
// 4M characters all 245 tiles are resident at once, while tiles of 512 or
// 256 threads needed a second wave (by their register count) and were
// slower (PERF.md §6).
// Two launches, the classes read once in each; a run of any length (10k
// spaces, 5k digits) crosses tiles through the carries.  The status
// array (10 int32 a tile and the ticket) persists between calls: each
// launch clears the flags that the other one reads, and launch 2 the
// ticket.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 1024;  // a tile's threads
constexpr int NW = THREADS / 32;
constexpr int PER = 16;        // positions a thread
constexpr int TILE = THREADS * PER;
constexpr int HALO = 4;        // the marks read classes at p-4 .. p+4
constexpr int NONE = -1;       // identity of the forward (max) scans
constexpr int BIG = 0x7fffffff;  // identity of the reverse (min) scan
constexpr int NFWD = 3;
constexpr unsigned FULL = 0xffffffffu;
constexpr uint32_t OWN = 0xffffu << HALO;  // bits of the thread's positions

// the mask X read at position j + k (k in [-HALO, HALO]): bit j of the
// result is bit j + k of X
__device__ __forceinline__ uint32_t at(uint32_t x, int k) {
  return k >= 0 ? x >> k : x << -k;
}

// Bit j of each mask is position p0 - 4 + j (classes beyond the text
// count as 16, which no predicate names).
struct Masks {
  int p0;
  uint32_t in_text;   // own positions < n
  uint32_t nz;        // every position but the text's first
  uint32_t let, ws, nl, pu, sp, wso, d, apo, sdmt, cl, cv, cr, ce;
};

// The classes of positions p0 - 4 .. p0 + 19, one byte each in six words
// (word 0 the left halo, words 1-4 the thread's own, word 5 the right
// halo), into predicate masks.
__device__ __forceinline__ uint32_t word_at(const int8_t* __restrict__ cls,
                                            int n, long long q) {
  uint32_t x = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const long long r = q + b;
    const uint32_t c = r >= 0 && r < n ? (uint8_t)cls[r] : 16u;
    x |= c << (8 * b);
  }
  return x;
}

__device__ __forceinline__ Masks load_masks(const int8_t* __restrict__ cls,
                                            int n, int tile) {
  const int lane = threadIdx.x & 31;
  const int p0 = tile * TILE + threadIdx.x * PER;
  uint32_t w[6];
  if (p0 + PER <= n && ((uintptr_t)cls & 15) == 0) {
    const uint4 v = *reinterpret_cast<const uint4*>(cls + p0);
    w[1] = v.x, w[2] = v.y, w[3] = v.z, w[4] = v.w;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) w[1 + k] = word_at(cls, n, p0 + 4 * k);
  }
  w[0] = __shfl_up_sync(FULL, w[4], 1);
  w[5] = __shfl_down_sync(FULL, w[1], 1);
  if (lane == 0) w[0] = word_at(cls, n, (long long)p0 - HALO);
  if (lane == 31) w[5] = word_at(cls, n, p0 + PER);
  // bit plane b of the 24 classes: bit b of each byte to bit 28 + i by
  // one multiply (the other products fall below bit 24 or past bit 31)
  uint32_t B[5];
#pragma unroll
  for (int b = 0; b < 5; ++b) {
    B[b] = 0;
#pragma unroll
    for (int k = 0; k < 6; ++k)
      B[b] |= ((((w[k] >> b) & 0x01010101u) * 0x10204080u) >> 28) << (4 * k);
  }
  Masks m;
  m.p0 = p0;
  const int left = n - (p0 - HALO);           // positions of the mask < n
  m.in_text = OWN & (left >= 32 ? FULL : left > 0 ? (1u << left) - 1 : 0u);
  m.nz = p0 == 0 ? ~(1u << HALO) : FULL;
  // the classes of pretok_ops (0 other, 1 space, 2 other whitespace, 3 CR,
  // 4 LF, 5 digit, 6 letter, 7 apostrophe, 8-15 the contraction letters
  // s d m t l v r e, 16 out of text)
  const uint32_t lo = ~B[4] & ~B[3], hi = B[3] & ~B[4];   // 0-7, 8-15
  const uint32_t b0 = B[0], b1 = B[1], b2 = B[2];
  m.sp = lo & ~b2 & ~b1 & b0;
  m.wso = lo & ~b2 & b1 & ~b0;
  m.nl = lo & ((~b2 & b1 & b0) | (b2 & ~b1 & ~b0));
  m.ws = m.sp | m.wso | m.nl;
  m.d = lo & b2 & ~b1 & b0;
  m.apo = lo & b2 & b1 & b0;
  m.pu = (lo & ~b2 & ~b1 & ~b0) | m.apo;
  m.let = hi | (lo & b2 & b1 & ~b0);
  m.sdmt = hi & ~b2;
  m.cl = hi & b2 & ~b1 & ~b0;
  m.cv = hi & b2 & ~b1 & b0;
  m.cr = hi & b2 & b1 & ~b0;
  m.ce = hi & b2 & b1 & b0;
  return m;
}

// the scan keys as masks of the positions that carry one (own, in text)
struct KeyBits {
  uint32_t drs;    // f0: a digit-run start, key p
  uint32_t wrs;    // f1: a whitespace-run start, key 2p + absorb
  uint32_t absorb; //     the run absorbs its newline prefix
  uint32_t wsnn;   // f2: whitespace, not a newline, key p
  uint32_t wen;    // r: the run's last position, not a newline, key 2p+1
  uint32_t ev;     // r: wen or a newline (key 2p)
};

__device__ __forceinline__ KeyBits key_bits(const Masks& m) {
  KeyBits k;
  k.drs = m.d & ~at(m.d, -1) & m.in_text;
  k.wrs = m.ws & ~at(m.ws, -1) & m.in_text;
  k.absorb = k.wrs & at(m.pu, -1) & m.nl & m.nz;
  k.wsnn = m.ws & ~m.nl & m.in_text;
  k.wen = m.ws & ~at(m.ws, 1) & ~m.nl & m.in_text;
  k.ev = k.wen | (m.nl & m.in_text);
  return k;
}

__device__ __forceinline__ int pos(const Masks& m, int j) {
  return m.p0 - HALO + j;
}
__device__ __forceinline__ int top(uint32_t x) { return 31 - __clz(x); }

// the thread's totals: the forward keys' maxima (NONE if none) and the
// reverse key's minimum (BIG if none)
struct Keys {
  int f[NFWD];
  int r;
};
__device__ __forceinline__ Keys thread_totals(const Masks& m,
                                              const KeyBits& k) {
  Keys t;
  t.f[0] = k.drs ? pos(m, top(k.drs)) : NONE;
  t.f[1] = k.wrs ? 2 * pos(m, top(k.wrs)) + ((k.absorb >> top(k.wrs)) & 1)
                 : NONE;
  t.f[2] = k.wsnn ? pos(m, top(k.wsnn)) : NONE;
  const int low = __ffs(k.ev) - 1;
  t.r = k.ev ? 2 * pos(m, low) + ((k.wen >> low) & 1) : BIG;
  return t;
}

// Exclusive scans over the block's threads of the thread totals t: the
// maximum over the threads before this one (forward keys), the minimum
// over those after it (reverse key); *tile gets the block's totals.
// sh holds 4 x 32 ints.
__device__ __forceinline__ Keys block_scan(const Keys& t, int (*sh)[32],
                                           Keys* tile) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  Keys in = t, ex;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
#pragma unroll
    for (int s = 0; s < NFWD; ++s) {
      const int u = __shfl_up_sync(FULL, in.f[s], o);
      if (lane >= o) in.f[s] = max(in.f[s], u);
    }
    const int u = __shfl_down_sync(FULL, in.r, o);
    if (lane + o < 32) in.r = min(in.r, u);
  }
#pragma unroll
  for (int s = 0; s < NFWD; ++s) {
    ex.f[s] = __shfl_up_sync(FULL, in.f[s], 1);
    if (lane == 0) ex.f[s] = NONE;
  }
  ex.r = __shfl_down_sync(FULL, in.r, 1);
  if (lane == 31) ex.r = BIG;
  if (lane == 31)
#pragma unroll
    for (int s = 0; s < NFWD; ++s) sh[s][warp] = in.f[s];
  if (lane == 0) sh[NFWD][warp] = in.r;
  __syncthreads();
  if (warp == 0) {       // scan the NW warps' totals, inclusive
#pragma unroll
    for (int s = 0; s <= NFWD; ++s) {
      int v = lane < NW ? sh[s][lane] : s < NFWD ? NONE : BIG;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        if (s < NFWD) {
          const int u = __shfl_up_sync(FULL, v, o);
          if (lane >= o) v = max(v, u);
        } else {
          const int u = __shfl_down_sync(FULL, v, o);
          if (lane + o < 32) v = min(v, u);
        }
      }
      if (lane < NW) sh[s][lane] = v;
    }
  }
  __syncthreads();
#pragma unroll
  for (int s = 0; s < NFWD; ++s) {
    if (warp > 0) ex.f[s] = max(ex.f[s], sh[s][warp - 1]);
    tile->f[s] = sh[s][NW - 1];
  }
  if (warp < NW - 1) ex.r = min(ex.r, sh[NFWD][warp + 1]);
  tile->r = sh[NFWD][0];
  return ex;
}

// The tile-status array, int32: the ticket, then 10 ints a tile: its
// forward flag, its forward totals and inclusive prefix (3 each), its
// reverse total, its reverse flag and inclusive suffix.  The layout does
// not depend on the tile count, so a buffer sized for more tiles serves.
constexpr int STATUS_INTS = 2 * NFWD + 4;
struct Status {
  int* base;
  int nt;
  __device__ __forceinline__ int* ticket() const { return base; }
  __device__ __forceinline__ int* rec(int t) const {
    return base + 1 + STATUS_INTS * t;
  }
  __device__ __forceinline__ int* fflag(int t) const { return rec(t); }
  __device__ __forceinline__ int* fagg(int t) const { return rec(t) + 1; }
  __device__ __forceinline__ int* fincl(int t) const {
    return rec(t) + 1 + NFWD;
  }
  __device__ __forceinline__ int* ragg(int t) const {
    return rec(t) + 1 + 2 * NFWD;
  }
  __device__ __forceinline__ int* rflag(int t) const { return ragg(t) + 1; }
  __device__ __forceinline__ int* rincl(int t) const { return ragg(t) + 2; }
};

constexpr int AGG = 1, INCL = 2;   // the flags' states (0: nothing yet)

__device__ __forceinline__ int load_volatile(const int* p) {
  return *(const volatile int*)p;
}
__device__ __forceinline__ void store_volatile(int* p, int v) {
  *(volatile int*)p = v;
}
// a flag store that publishes the stores before it (release, gpu scope)
__device__ __forceinline__ void publish(int* flag, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;" ::"l"(flag), "r"(v)
               : "memory");
}
// a flag load after which what it published is seen (acquire)
__device__ __forceinline__ int read_flag(const int* flag) {
  int f;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];"
               : "=r"(f)
               : "l"(flag)
               : "memory");
  return f;
}
// the same, waiting until the flag is set
__device__ __forceinline__ int wait_flag(const int* flag) {
  int f;
  while ((f = read_flag(flag)) == 0) {
  }
  return f;
}

// One step of a look-back over THREADS tiles, thread i holding the flag
// and NV values of the i-th nearest tile: folds into acc (max if MAX,
// else min) the values of the tiles up to and including the nearest one
// whose inclusive result is published; returns whether there was one.
// sh holds (NV + 1) x 32 ints, res NV + 1.
template <int NV, bool MAX>
__device__ __forceinline__ bool look_step(bool incl, const int (&v)[NV],
                                          int (&acc)[NV], int (*sh)[32],
                                          int* res) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int id = MAX ? NONE : BIG;
  const uint32_t b = __ballot_sync(FULL, incl);
  const int first = b ? __ffs(b) - 1 : 31;
#pragma unroll
  for (int s = 0; s < NV; ++s) {
    const int x = lane <= first ? v[s] : id;
    const int r = MAX ? __reduce_max_sync(FULL, x) : __reduce_min_sync(FULL, x);
    if (lane == 0) sh[1 + s][warp] = r;
  }
  if (lane == 0) sh[0][warp] = b != 0;
  __syncthreads();
  if (warp == 0) {     // the same over the warps, in order
    const uint32_t h = __ballot_sync(FULL, lane < NW && sh[0][lane] != 0);
    const int wf = h ? __ffs(h) - 1 : NW - 1;
#pragma unroll
    for (int s = 0; s < NV; ++s) {
      const int x = lane <= wf ? sh[1 + s][lane] : id;
      const int r =
          MAX ? __reduce_max_sync(FULL, x) : __reduce_min_sync(FULL, x);
      if (lane == 0) res[1 + s] = r;
    }
    if (lane == 0) res[0] = h != 0;
  }
  __syncthreads();
#pragma unroll
  for (int s = 0; s < NV; ++s)
    acc[s] = MAX ? max(acc[s], res[1 + s]) : min(acc[s], res[1 + s]);
  const bool found = res[0] != 0;
  __syncthreads();     // res and sh are written again by the next step
  return found;
}

// Launch 1: the tile's totals and its forward carries by decoupled
// look-back; clears the reverse flag that launch 2 reads.
__global__ void __launch_bounds__(THREADS)
    totals_kernel(const int8_t* __restrict__ cls, int n, Status st) {
  __shared__ int sh[NFWD + 1][32];
  __shared__ int res[NFWD + 1];
  __shared__ int tile_sh;
  if (threadIdx.x == 0) tile_sh = atomicAdd(st.ticket(), 1);
  __syncthreads();
  const int t = tile_sh;
  const Masks m = load_masks(cls, n, t);
  Keys tile;
  block_scan(thread_totals(m, key_bits(m)), sh, &tile);
  __syncthreads();     // sh is the look-back's next
  if (threadIdx.x == 0) {
    *st.ragg(t) = tile.r;
    *st.rflag(t) = 0;
    int* dst = t == 0 ? st.fincl(t) : st.fagg(t);
#pragma unroll
    for (int s = 0; s < NFWD; ++s) store_volatile(dst + s, tile.f[s]);
    publish(st.fflag(t), t == 0 ? INCL : AGG);
  }
  if (t == 0) return;
  // the tiles before t, THREADS at a time, waiting for each to publish
  // at least its totals (its ticket is earlier, so it has started)
  int carry[NFWD] = {NONE, NONE, NONE};
  for (int base = t - 1;; base -= THREADS) {
    const int j = base - (int)threadIdx.x;
    int flag = INCL, v[NFWD] = {NONE, NONE, NONE};
    if (j >= 0) {
      flag = wait_flag(st.fflag(j));
      const int* src = flag == INCL ? st.fincl(j) : st.fagg(j);
#pragma unroll
      for (int s = 0; s < NFWD; ++s) v[s] = load_volatile(src + s);
    }
    if (look_step<NFWD, true>(flag == INCL, v, carry, sh, res)) break;
  }
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < NFWD; ++s)
      store_volatile(st.fincl(t) + s, max(carry[s], tile.f[s]));
    publish(st.fflag(t), INCL);
  }
}

// The mask of the thread's 16 positions, given the scans over every
// position before them (ex.f) and after them (ex.r).
__device__ __forceinline__ uint32_t marks(const Masks& m, const KeyBits& k,
                                          const Keys& ex, int n) {
  // alt 1: contractions ('s 't 're 've 'm 'll 'd) start at the apostrophe
  const uint32_t blocked = at(m.pu, -1) | at(m.sp, -1);
  const uint32_t con1 = m.apo & ~blocked & at(m.sdmt, 1);
  const uint32_t con2 =
      m.apo & ~blocked & ~con1 &
      ((at(m.cl, 1) & at(m.cl, 2)) | (at(m.cv, 1) & at(m.ce, 2)) |
       (at(m.cr, 1) & at(m.ce, 2)));
  const uint32_t con = con1 | con2;
  const uint32_t consumed = at(con1, -1) | at(con2, -1) | at(con2, -2);
  // alt 2: a letter run's chunk, which may absorb one prefix character
  const uint32_t head =
      m.let & ~consumed & (~at(m.let, -1) | at(consumed, -1));
  const uint32_t lone_punct_p = at(m.pu, -1) & ~at(m.pu, -2) &
                                ~at(m.sp, -2) & ~at(con, -1);
  const uint32_t ws_prefix_p = at(m.sp, -1) | at(m.wso, -1);
  const uint32_t absorb = head & (lone_punct_p | ws_prefix_p) & m.nz;
  // alt 4: a punct run's chunk, which may absorb one preceding space
  const uint32_t prs = m.pu & ~at(m.pu, -1) & ~con;
  const uint32_t sp_absorb = prs & at(m.sp, -1) & m.nz;
  const uint32_t lone = m.pu & ~at(m.pu, -1) & ~at(m.pu, 1);
  const uint32_t eaten = lone & at(m.let, 1) & ~con & ~at(m.sp, -1);
  uint32_t mk = ~m.nz | con1 | at(con1, -2) | con2 | at(con2, -3) |
                (head & ~absorb) | at(absorb, 1) | (at(m.d, -1) & ~m.d) |
                (prs & ~sp_absorb & ~eaten) | at(sp_absorb, 1);
  // alt 3: digit blocks of 3 from each run's start; a run continued from
  // before p0 started at ex.f[0], and its block start among p0-3 .. p0-1
  // seeds the halo
  uint32_t blocks = k.drs;
  if ((m.d >> (HALO - 1)) & 1)
    blocks |= 1u << (HALO - 1 - (m.p0 - 1 - ex.f[0]) % 3);
  const uint32_t d3 = m.d & at(m.d, -1) & at(m.d, -2);
#pragma unroll
  for (int i = 0; i < 6; ++i) blocks |= (blocks << 3) & d3;
  mk |= blocks & m.d;
  // alts 5-7, whitespace runs: the first match (a plain run's start, or
  // the first position after an absorbing run's leading newlines: carried
  // in from before p0 when that run continues and has had no other
  // whitespace yet)
  uint32_t nl_from = k.wrs & k.absorb;
  const int a = ex.f[1] >> 1;
  if (((m.ws >> HALO) & (m.ws >> (HALO - 1)) & 1) && (ex.f[1] & 1) &&
      ex.f[2] < a)
    nl_from |= 1u << HALO;
  const uint32_t first =
      (k.wrs & ~k.absorb) | ((m.nl + nl_from) & ~m.nl & k.wsnn);
  // after the run's last newline: the first event at or after the
  // position is a run end, not a newline (the events past the thread's
  // positions come in as ex.r, at bit 20); on the bit-reversed masks, the
  // positions from each such run end up to the next event
  uint32_t odd = k.wen, ev = k.ev;
  const uint32_t past = 1u << (HALO + PER);
  ev |= past;
  if (ex.r & 1) odd |= past;
  const uint32_t rodd = __brev(odd), free = ~__brev(ev);
  const uint32_t after_event =
      __brev(rodd | (free & ~(free + (rodd << 1))));
  const uint32_t after_nl = at(m.nl, -1) & m.ws & after_event;
  // the leftover of a run that does not end the text: the run's last two
  // positions are whitespace, not newlines
  const int left = n - (m.p0 - HALO) - 1;     // positions p with p + 1 < n
  const uint32_t before_end = left >= 32 ? FULL : left > 0 ? (1u << left) - 1
                                                           : 0u;
  const uint32_t wsnn = m.ws & ~m.nl;          // the halo's too
  const uint32_t leftover = wsnn & at(wsnn, -1) & ~at(m.ws, 1) & before_end;
  mk |= first | after_nl | leftover;
  return mk & m.in_text;
}

// Launch 2: the reverse carry by look-ahead, then the mask of every
// position of the tile with both carries; clears the forward flag of its
// tile and (block 0) the ticket for the next call.
__global__ void __launch_bounds__(THREADS)
    mask_kernel(const int8_t* __restrict__ cls, int n, Status st,
                uint8_t* __restrict__ out) {
  __shared__ int sh[NFWD + 1][32];
  __shared__ int res[NFWD + 1];
  const int t = st.nt - 1 - blockIdx.x;
  const Masks m = load_masks(cls, n, t);
  const KeyBits k = key_bits(m);
  Keys tile;
  Keys ex = block_scan(thread_totals(m, k), sh, &tile);
  __syncthreads();     // sh is the look-ahead's next
  // the tiles after t, THREADS at a time, to the nearest one with a
  // published inclusive suffix (else its launch-1 total): no waiting
  int carry[1] = {BIG};
  for (int base = t + 1;; base += THREADS) {
    const int j = base + (int)threadIdx.x;
    int flag = INCL, v[1] = {BIG};
    if (j < st.nt) {
      flag = read_flag(st.rflag(j));
      v[0] = load_volatile(flag == INCL ? st.rincl(j) : st.ragg(j));
    }
    if (look_step<1, false>(flag == INCL, v, carry, sh, res)) break;
  }
  if (threadIdx.x == 0) {
    store_volatile(st.rincl(t), min(carry[0], tile.r));
    publish(st.rflag(t), INCL);
    *st.fflag(t) = 0;
    if (blockIdx.x == 0) *st.ticket() = 0;
  }
#pragma unroll
  for (int s = 0; s < NFWD; ++s)
    ex.f[s] = max(ex.f[s], t > 0 ? st.fincl(t - 1)[s] : NONE);
  ex.r = min(ex.r, carry[0]);
  const uint32_t mk = marks(m, k, ex, n) >> HALO;
  // one byte a position: each nibble spread to the low bits of 4 bytes
  uint32_t o[4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
    o[q] = (((mk >> (4 * q)) & 0xfu) * 0x00204081u) & 0x01010101u;
  const int p0 = m.p0;
  if (p0 + PER <= n && ((uintptr_t)out & 15) == 0) {
    *reinterpret_cast<uint4*>(out + p0) = make_uint4(o[0], o[1], o[2], o[3]);
  } else {
#pragma unroll
    for (int i = 0; i < PER; ++i)
      if (p0 + i < n) out[p0 + i] = (mk >> i) & 1;
  }
}

}  // namespace

extern "C" {

// int32 entries of the tile-status array for n positions.
int shred_gpt_status_ints(int n) {
  return STATUS_INTS * ((n + TILE - 1) / TILE) + 1;
}

// The match-start mask of cls (int8 [n], 0 < n < 2^30) into out (uint8
// [n]) on `stream`: two launches.  status is int32
// [shred_gpt_status_ints(n)], zero before the first call; each call leaves
// it ready for the next on the same stream, so a caller keeps one per
// stream (and allocates a larger one zeroed).  Returns the first launch's
// CUDA error, or 0.
int shred_gpt_starts_mask(const int8_t* cls, int n, int* status, uint8_t* out,
                          void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n < 1) return 0;
  if (n >= (1 << 30)) return (int)cudaErrorInvalidValue;
  const int nt = (n + TILE - 1) / TILE;
  const Status st{status, nt};
  totals_kernel<<<nt, THREADS, 0, s>>>(cls, n, st);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  mask_kernel<<<nt, THREADS, 0, s>>>(cls, n, st, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
