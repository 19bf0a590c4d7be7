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
// the launch-purity fixture's kernel (x * s on float32, any size, the
// scalar an argument): a stream of 16-byte accesses.
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
// #21's block and its float4s in flight a thread, from a sweep of 128 to
// 1024 threads x 1, 2 or 4 float4s at 2^24 elements (PERF.md)
#define EG_STREAM_THREADS 256
#define EG_STREAM_VEC 4

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
// multiply (__fmul_rn: never contracted into an FMA), bit-identical to
// the plain version's.  Bound by bytes: 8 bytes an element against one
// operation.  So it streams 16-byte accesses (float4), read through the
// non-coherent path (ld.global.nc) and written evict-first (__stcs:
// every byte is touched once).  Block b takes EG_STREAM_VEC float4s a
// thread from float4 b * EG_STREAM_THREADS * EG_STREAM_VEC on, thread t
// those t, t + EG_STREAM_THREADS, ..., all loaded before any is stored;
// one pass of blocks covers the tensor.  The elements before x's first
// 16-byte boundary (`head`, up to 3) and after its last whole float4 (up
// to 3) are scalar, one a thread; the wrapper gives `out` the offset of
// `x` mod 16 bytes, so the same elements of both are aligned.
extern "C" __global__ void __launch_bounds__(EG_STREAM_THREADS)
k_mul_scalar_f32(const float* x, float s, int n, int head, float* out) {
  const int tid = blockIdx.x * EG_STREAM_THREADS + threadIdx.x;
  const int nv = (n - head) >> 2;
  const int tail = head + 4 * nv;
  if (tid < head) out[tid] = __fmul_rn(x[tid], s);
  if (tid < n - tail) out[tail + tid] = __fmul_rn(x[tail + tid], s);
  const float4* xv = reinterpret_cast<const float4*>(x + head);
  float4* ov = reinterpret_cast<float4*>(out + head);
  const int base = blockIdx.x * EG_STREAM_THREADS * EG_STREAM_VEC +
                   threadIdx.x;
  float4 v[EG_STREAM_VEC];
#pragma unroll
  for (int j = 0; j < EG_STREAM_VEC; ++j) {
    const int i = base + j * EG_STREAM_THREADS;
    if (i < nv) v[j] = __ldg(xv + i);
  }
#pragma unroll
  for (int j = 0; j < EG_STREAM_VEC; ++j) {
    const int i = base + j * EG_STREAM_THREADS;
    if (i < nv) {
      v[j].x = __fmul_rn(v[j].x, s);
      v[j].y = __fmul_rn(v[j].y, s);
      v[j].z = __fmul_rn(v[j].z, s);
      v[j].w = __fmul_rn(v[j].w, s);
      __stcs(ov + i, v[j]);
    }
  }
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

// x and out must be float-aligned and share their offset mod 16 bytes.
extern "C" int eg_mul_scalar_f32(const void* x, float s, int n, void* out,
                                 void* stream) {
  if (n <= 0) return 0;
  const size_t ax = (size_t)x, ao = (size_t)out;
  if (ax % 4 || ax % 16 != ao % 16) return (int)cudaErrorInvalidValue;
  const int lead = (int)((16 - ax % 16) % 16 / 4);  // to x's first float4
  const int head = lead < n ? lead : n;
  const int per_block = EG_STREAM_THREADS * EG_STREAM_VEC;
  const int blocks = ((n - head) / 4 + per_block - 1) / per_block;
  k_mul_scalar_f32<<<blocks < 1 ? 1 : blocks, EG_STREAM_THREADS, 0,
                     EG_STREAM(stream)>>>((const float*)x, s, n, head,
                                          (float*)out);
  return (int)cudaGetLastError();
}
