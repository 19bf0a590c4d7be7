// Launch plumbing shared by the kernel sources (recover.cu, verify.cu):
// the block size, the one-row-per-thread guard, row loads and stores,
// the grid size, the lane groups of the lane kernels and their split
// stores, and the upload of the Consts block of field.cuh.
//
// Each source is its own translation unit with its own copy of the
// __constant__ block K (field.cuh declares it static), so each exports
// an init entry point that calls eg_upload_consts; ops/kernels.py calls
// every one of them once when it loads the library.
#pragma once

#include <cuda_runtime.h>

#include "field.cuh"

#define EG_THREADS 128

#define EG_ROW(n)                                      \
  const int b = blockIdx.x * blockDim.x + threadIdx.x; \
  if (b >= (n)) return;

#define EG_STREAM(s) ((cudaStream_t)(s))

static __device__ __forceinline__ void load16(eg::u32* o, const eg::u32* p) {
#pragma unroll
  for (int k = 0; k < 16; ++k) o[k] = p[k];
}

static __device__ __forceinline__ void store16(eg::u32* p,
                                               const eg::u32* v) {
#pragma unroll
  for (int k = 0; k < 16; ++k) p[k] = v[k];
}

static inline dim3 eg_grid(int n) {
  return dim3((unsigned)((n + EG_THREADS - 1) / EG_THREADS));
}

// T lanes a row (the prelude, pow, u1u2, ladder, point-table, GLV, fp_mul
// and finish kernels): blocks of 64, 128 or 256 threads, T = 1, 2, 4 or
// 8.  A block is whole warps and T divides 32,
// so a group never straddles two warps.  Every group runs, the groups
// past the last row on a clamped row, because no lane may leave before
// the group's shuffles; only the store is skipped.
#define EG_LANES_MAX_THREADS 256

struct EgGroup {
  int row;   // the group's row, maybe past the last
  int in;    // the row clamped into the rows
  eg::u32 rank;  // the lane's place in its group
  eg::u32 mask;  // the group's lanes in the warp
};

template <int T>
static __device__ __forceinline__ EgGroup eg_group(int rows) {
  EgGroup g;
  g.row = (int)((blockIdx.x * blockDim.x + threadIdx.x) / T);
  g.in = g.row < rows ? g.row : rows - 1;
  g.rank = threadIdx.x % T;
  const eg::u32 lane = threadIdx.x & 31u;
  g.mask = ((1u << T) - 1u) << (lane & ~(eg::u32)(T - 1));
  return g;
}

// Lane `rank` of a group stores limbs rank, rank + T, ... of v (picked
// by grp_pick), so a warp's stores cover whole 64-byte rows.
template <int T>
static __device__ __forceinline__ void store_split(eg::u32* o,
                                                   const eg::u32* v,
                                                   eg::u32 rank) {
  eg::u32 w[16 / T];
  eg::grp_pick<T>(w, v, rank);
#pragma unroll
  for (int m = 0; m < 16 / T; ++m) o[T * m + rank] = w[m];
}

// 1 when the launch shape is one the lane kernels take.
static inline int eg_lanes_ok(int lanes, int threads) {
  return (lanes == 1 || lanes == 2 || lanes == 4 || lanes == 8) &&
         (threads == 64 || threads == 128 || threads == 256);
}

static inline dim3 eg_lanes_grid(int rows, int lanes, int threads) {
  const long long n = (long long)rows * lanes;
  return dim3((unsigned)((n + threads - 1) / threads));
}

// Copy the packed constants into this translation unit's K.
static inline int eg_upload_consts(const eg::u32* host_consts, int count) {
  if (count != (int)(sizeof(eg::Consts) / sizeof(eg::u32))) return -1;
  if (cudaMemcpyToSymbol(eg::K, host_consts, sizeof(eg::Consts)) !=
      cudaSuccess)
    return (int)cudaGetLastError();
  return (int)cudaDeviceSynchronize();
}
