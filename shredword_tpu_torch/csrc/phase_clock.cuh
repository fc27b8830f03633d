// SM cycles spent in each phase of a persistent kernel, for diagnosis
// (chip_smoke.py builds the library a second time with
// -DSHRED_PHASE_CLOCKS, checks that build against the plain one and
// prints the counts).  Without the define mark() compiles to nothing.
//
// At each mark the block synchronises, then its thread 0 adds the cycles
// since its previous mark to the block's own slot of the phase: the time
// the block's slowest warp spent in a phase's work, then in the grid
// barrier that ends it.  A barrier is where a block waits for the slowest
// one, so the blocks' rows together show both the work and the imbalance.
// Every block writes only its own row, so counting adds no contention.
// Marks stand where the whole block passes.
#pragma once

#include <cuda_runtime.h>

namespace shred {

constexpr int PHASES = 16;
constexpr int CLOCKED_BLOCKS = 1024;  // blocks beyond these are not counted

#ifdef SHRED_PHASE_CLOCKS
static __device__ unsigned long long phase_cycles[CLOCKED_BLOCKS * PHASES];

struct PhaseClock {
  long long last;
  __device__ PhaseClock() { last = clock64(); }
  __device__ void mark(int k) {
    __syncthreads();
    if (threadIdx.x != 0 || blockIdx.x >= CLOCKED_BLOCKS) return;
    const long long t = clock64();
    phase_cycles[blockIdx.x * PHASES + k] += t - last;
    last = t;
  }
};

// The cycles counted since the previous read, [CLOCKED_BLOCKS, PHASES],
// then zeroed.
#define SHRED_PHASE_READER(name)                                  \
  extern "C" int name(unsigned long long* out) {                  \
    const size_t bytes = sizeof(unsigned long long) *             \
                         shred::CLOCKED_BLOCKS * shred::PHASES;   \
    void* dev = nullptr;                                          \
    cudaError_t err =                                             \
        cudaMemcpyFromSymbol(out, shred::phase_cycles, bytes);    \
    if (err == cudaSuccess)                                       \
      err = cudaGetSymbolAddress(&dev, shred::phase_cycles);      \
    if (err == cudaSuccess) err = cudaMemset(dev, 0, bytes);      \
    if (err == cudaSuccess) err = cudaDeviceSynchronize();        \
    return (int)err;                                              \
  }
#else
struct PhaseClock {
  __device__ void mark(int) {}
};
#define SHRED_PHASE_READER(name)
#endif

}  // namespace shred
