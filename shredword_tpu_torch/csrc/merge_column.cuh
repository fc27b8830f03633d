// The per-column greedy merge shared by the hist and giant kernels
// (hist_fused.cu, hist_step.cu, giant.cu, giant_sharded.cu).
//
// One thread owns one word column of the [L, W] layout (tokens top-down,
// PAD after the word; int16, or int32 where ids pass 32767).
// merge_column applies the merge
// (a, b) -> nw to it exactly as the reference's non-advancing splice does
// (bpe.cpp:480-482): greedy left to right, so in a run "a a a a" with
// a == b the pairs at rows 0 and 2 merge.  It compacts the column over
// the consumed right halves, and adds the column's weight to the left
// and right neighbour vectors dl/dr with int32 atomics (exact and
// independent of order): the left neighbour is the token emitted just
// before the merged one (nw when the pair before it merged too), the
// right neighbour the token that followed b before the merge; PAD and
// unk neighbours are not counted.
//
// It replaces the two copies of this logic in the TPU kernels:
// shredword_tpu/ops/bpe_hist.py::_select_and_apply + _slot_delta_accum
// and shredword_tpu/ops/bpe_giant.py::_select_apply_dyn +
// _slot_deltas_mxu, which are log-depth closed forms of the same scan.
#pragma once

#include <stdint.h>

namespace shred {

constexpr int PAD = -3;

// bits of merge_column's result
constexpr int MC_MATCHED = 1;  // the column held the pair and was merged
constexpr int MC_HAS_A = 2;    // a occurs in the column after the merge
constexpr int MC_HAS_B = 4;    // b occurs in the column after the merge
constexpr int MC_COUNT_SHIFT = 8;  // bits 8 and up: the merges it made

// Merges (a, b) -> nw in column `col` of tw [L, W] (T int16_t or int32_t)
// in place.  Tokens live
// in registers; loads and stores of one row are coalesced across a warp
// whose threads hold neighbouring columns.  The column is rewritten only
// when it matched.  Returns the MC_ bits above, with the number of merges
// made in the column from bit MC_COUNT_SHIFT up.
template <int L, typename T>
__device__ __forceinline__ int merge_column(T* __restrict__ tw, int W,
                                            int col, int a, int b, int nw,
                                            int unk,
                                            const int* __restrict__ wcount,
                                            int* __restrict__ dl,
                                            int* __restrict__ dr) {
  int t[L];
#pragma unroll
  for (int r = 0; r < L; ++r) t[r] = tw[(size_t)r * W + col];
  bool any = false, has_a = false, has_b = false;
#pragma unroll
  for (int r = 0; r + 1 < L; ++r) any |= (t[r] == a) & (t[r + 1] == b);
  if (!any) {
#pragma unroll
    for (int r = 0; r < L; ++r) {
      has_a |= t[r] == a;
      has_b |= t[r] == b;
    }
    return (has_a ? MC_HAS_A : 0) | (has_b ? MC_HAS_B : 0);
  }
  const int w = wcount[col];
  int n = 0;          // merges made
  int o = 0;          // next output row
  int last = PAD;     // last token emitted (the post-merge left neighbour)
  bool skip = false;  // this row is the consumed right half of a merge
#pragma unroll
  for (int r = 0; r < L; ++r) {
    if (skip) {
      skip = false;
      continue;
    }
    const int nxt = r + 1 < L ? t[r + 1] : PAD;
    int x = t[r];
    if (t[r] == a && nxt == b) {
      const int rv = r + 2 < L ? t[r + 2] : PAD;  // pre-merge right neighbour
      if (last >= 0 && last != unk) atomicAdd(&dl[last], w);
      if (rv >= 0 && rv != unk) atomicAdd(&dr[rv], w);
      x = nw;
      skip = true;
      ++n;
    }
    has_a |= x == a;
    has_b |= x == b;
    tw[(size_t)o * W + col] = (T)x;
    ++o;
    last = x;
  }
  for (; o < L; ++o) tw[(size_t)o * W + col] = (T)PAD;
  return MC_MATCHED | (has_a ? MC_HAS_A : 0) | (has_b ? MC_HAS_B : 0) |
         (n << MC_COUNT_SHIFT);
}

}  // namespace shred
