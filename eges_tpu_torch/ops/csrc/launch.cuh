// Launch plumbing shared by the kernel sources (recover.cu, verify.cu):
// the block size, the one-row-per-thread guard, row loads and stores,
// the grid size, and the upload of the Consts block of field.cuh.
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

// Copy the packed constants into this translation unit's K.
static inline int eg_upload_consts(const eg::u32* host_consts, int count) {
  if (count != (int)(sizeof(eg::Consts) / sizeof(eg::u32))) return -1;
  if (cudaMemcpyToSymbol(eg::K, host_consts, sizeof(eg::Consts)) !=
      cudaSuccess)
    return (int)cudaGetLastError();
  return (int)cudaDeviceSynchronize();
}
