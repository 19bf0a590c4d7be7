// The four micro-benchmark kernels of the profiling harness
// (eges_tpu_torch/harness/), and the analysis fixture's scalar multiply
// (#21), for sm_90a.
//
// Each __global__ replaces one Pallas kernel of the reference's harness or
// of its analysis fixtures (named beside it).  Three of them time F_P
// multiplies in the two value layouts the port has: k_fp_mul_chain runs 64
// chained multiplies on [16, B] limb-major columns (the reference's 1-D
// rows), and k_fp_mul_chain_rows8 / k_fp_mul_rows8 run 64 or one on rows8
// tiles ([nb, 128, 128], field.cuh rows8_at).  Each is one thread per row
// over field.cuh's fp_mul, so its results are bit-identical to the
// reference's _k_mul on the same relaxed limbs; a fixed b multiplies a again
// and again, a strict chain of dependent products in registers.  The fourth,
// k_add_one_f32, is the reference's copy kernel (x + 1.0 on one (8, 128)
// float32 tile): the cost of launching a hand-written kernel through the
// ctypes wrapper, against one ATen launch.  The fifth, k_mul_scalar_f32, is
// the launch-purity fixture's kernel (x * s on float32, any size): the same
// one-thread-per-element shape as the copy kernel, with the scalar an
// argument.
//
// What bounds them on the H100 (about ten u32 operations issue in the
// time one byte of device memory moves): a 64-multiply chain does some
// 63,800 counted operations a row against 192 bytes, so integer
// operations bound it by far; one multiply (997 operations a row) and
// the two float32 kernels are bound by bytes, and at the harness's shapes
// (4096 rows, one tile of 1024 floats) by the launch itself
// (ops/opcount.py counts them).  The chain loop stays rolled
// (#pragma unroll 1): 64 inlined multiplies would grow the code 64-fold,
// and nvcc's front end has crashed on large inlined bodies (field.cuh
// EG_CALL).
//
// Its own translation unit with its own copy of the constants block
// (field.cuh declares it static), filled by eg_init_profile.  Each
// launcher has a plain C interface for ctypes, like recover.cu's.

#include "launch.cuh"

using namespace eg;

// The widest block of the 1-D chain: the reference's lane block of 1024
// columns is one block of 1024 threads, so the kernel must fit 64
// registers a thread.
#define EG_CHAIN_THREADS 1024

// #20a _chain_kernel_1d (harness/profile_mulchain.py): `chain` products
// a = a * b on the columns of [16, wide] limb-major values; limb k of
// column c at k * wide + c, so a warp's 32 columns read and write 128
// contiguous bytes of each limb.  A block is the reference's lane block
// (its width is the launch's), and the grid walks wide / lane blocks.
extern "C" __global__ void __launch_bounds__(EG_CHAIN_THREADS)
k_fp_mul_chain(const u32* a, const u32* bv, int wide, int chain, u32* out) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= wide) return;
  u32 A[16], Bv[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    A[k] = a[(size_t)k * wide + c];
    Bv[k] = bv[(size_t)k * wide + c];
  }
#pragma unroll 1
  for (int i = 0; i < chain; ++i) fp_mul(A, A, Bv);
#pragma unroll
  for (int k = 0; k < 16; ++k) out[(size_t)k * wide + c] = A[k];
}

// CHAIN products a = a * b on row b of rows8 tiles.
template <int CHAIN>
EG_FD void mul_chain_rows8(const u32* at, const u32* bt, u32* out, int b) {
  u32 A[16], Bv[16];
  load_rows8(A, at, b);
  load_rows8(Bv, bt, b);
#pragma unroll 1
  for (int i = 0; i < CHAIN; ++i) fp_mul(A, A, Bv);
  store_rows8(out, b, A);
}

// #20b _chain_kernel_8x (harness/profile_mulchain.py): the 64-multiply
// chain on [nb, 128, 128] tiles, one thread per row of nb * 1024.
extern "C" __global__ void __launch_bounds__(EG_THREADS)
k_fp_mul_chain_rows8(const u32* at, const u32* bt, int rows, u32* out) {
  EG_ROW(rows)
  mul_chain_rows8<64>(at, bt, out, b);
}

// #20c _fp_mul8b_kernel (harness/profile_mul8b.py): one F_P multiply on
// the same tiles.
extern "C" __global__ void __launch_bounds__(EG_THREADS)
k_fp_mul_rows8(const u32* at, const u32* bt, int rows, u32* out) {
  EG_ROW(rows)
  mul_chain_rows8<1>(at, bt, out, b);
}

// #20d the pallasnop copy kernel (harness/profile_floor.py _kern): one
// IEEE single-precision add per element.
extern "C" __global__ void __launch_bounds__(EG_THREADS)
k_add_one_f32(const float* x, int n, float* out) {
  EG_ROW(n)
  out[b] = x[b] + 1.0f;
}

// #21 _impure_kernel (tests/analysis_fixtures/jit/eges_tpu/ops/
// impure_kernel.py, launched at :16): o = x * t, where the reference
// burns the host clock read at trace time into the kernel as a float32
// constant.  Here the scalar is an argument that the wrapper casts to
// float32 on the host, so each element is one IEEE single-precision
// multiply (nothing to contract into an FMA), bit-identical to the
// plain version's.  Bound by bytes: 8 bytes an element against one
// operation.
extern "C" __global__ void __launch_bounds__(EG_THREADS)
k_mul_scalar_f32(const float* x, float s, int n, float* out) {
  EG_ROW(n)
  out[b] = x[b] * s;
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

extern "C" int eg_init_profile(const u32* host_consts, int count) {
  return eg_upload_consts(host_consts, count);
}

// lane: threads a block, 1..1024, dividing wide (the wrapper checks).
extern "C" int eg_fp_mul_chain(const void* a, const void* b, int wide,
                               int chain, int lane, void* out,
                               void* stream) {
  if (wide <= 0) return 0;
  if (lane <= 0 || lane > EG_CHAIN_THREADS || wide % lane || chain < 0)
    return -1;
  k_fp_mul_chain<<<wide / lane, lane, 0, EG_STREAM(stream)>>>(
      (const u32*)a, (const u32*)b, wide, chain, (u32*)out);
  return (int)cudaGetLastError();
}

extern "C" int eg_fp_mul_chain_rows8(const void* at, const void* bt, int nb,
                                     void* out, void* stream) {
  if (nb <= 0) return 0;
  k_fp_mul_chain_rows8<<<eg_grid(nb * 1024), EG_THREADS, 0,
                         EG_STREAM(stream)>>>(
      (const u32*)at, (const u32*)bt, nb * 1024, (u32*)out);
  return (int)cudaGetLastError();
}

extern "C" int eg_fp_mul_rows8(const void* at, const void* bt, int nb,
                               void* out, void* stream) {
  if (nb <= 0) return 0;
  k_fp_mul_rows8<<<eg_grid(nb * 1024), EG_THREADS, 0, EG_STREAM(stream)>>>(
      (const u32*)at, (const u32*)bt, nb * 1024, (u32*)out);
  return (int)cudaGetLastError();
}

extern "C" int eg_add_one_f32(const void* x, int n, void* out,
                              void* stream) {
  if (n <= 0) return 0;
  k_add_one_f32<<<eg_grid(n), EG_THREADS, 0, EG_STREAM(stream)>>>(
      (const float*)x, n, (float*)out);
  return (int)cudaGetLastError();
}

extern "C" int eg_mul_scalar_f32(const void* x, float s, int n, void* out,
                                 void* stream) {
  if (n <= 0) return 0;
  k_mul_scalar_f32<<<eg_grid(n), EG_THREADS, 0, EG_STREAM(stream)>>>(
      (const float*)x, s, n, (float*)out);
  return (int)cudaGetLastError();
}
