// The six one-row glue kernels of the un-fused recovery and verify path
// (stacked [K, N, 65] batches and single rows), for sm_90a.
//
// Each __global__ replaces one Pallas glue kernel of
// eges_tpu/ops/pallas_kernels.py (named beside it) and runs one thread
// per row of [M, 16] limbs over the field library of field.cuh, so its
// results are bit-identical to the reference's numpy twins.  The
// reference launched them from FieldP/OrderN (eges_tpu/ops/bigint.py)
// for every batched operand of the XLA point formulas and the GLV split;
// the port's ops/bigint.py does the same, so one stacked batch launches
// them about 4,500 times.
//
// What bounds them on the H100 (about ten u32 operations issue in the
// time one byte of device memory moves): fp_sub, fp_neg, fp_mul_small
// (under one counted operation per byte they read and write), fn_sub
// (about 1.7), fn_neg (about 2.8) and mulhi8 (about 9.9, only just) are
// bound by bytes (ops/opcount.py counts them).  Each
// reads its inputs once, writes its outputs once and keeps every
// intermediate in registers.  At the path's shapes (a few thousand rows)
// their work is microseconds: the host's time to launch them, not the
// card, sets their pace.
//
// Its own translation unit with its own copy of the constants block
// (field.cuh declares it static), filled by eg_init_glue.  Each launcher
// has a plain C interface for ctypes, like recover.cu's.

#include <string.h>

#include "launch.cuh"

using namespace eg;

// #16b fp_sub_pallas: relaxed F_P a - b.
extern "C" __global__ void __launch_bounds__(EG_THREADS)
k_fp_sub(const u32* a, const u32* bv, int M, u32* out) {
  EG_ROW(M)
  u32 A[16], Bv[16], O[16];
  load16(A, a + (size_t)16 * b);
  load16(Bv, bv + (size_t)16 * b);
  fp_sub(O, A, Bv);
  store16(out + (size_t)16 * b, O);
}

// #16b fp_neg_pallas: relaxed F_P -a.
extern "C" __global__ void __launch_bounds__(EG_THREADS)
k_fp_neg(const u32* a, int M, u32* out) {
  EG_ROW(M)
  u32 A[16], O[16];
  load16(A, a + (size_t)16 * b);
  fp_neg(O, A);
  store16(out + (size_t)16 * b, O);
}

// #16b fp_mul_small_pallas: relaxed F_P k * a, 0 <= k < 16 (the wrapper
// checks k; the reference compiled one kernel per k, here k is an
// argument of the launch).
extern "C" __global__ void __launch_bounds__(EG_THREADS)
k_fp_mul_small(const u32* a, u32 k, int M, u32* out) {
  EG_ROW(M)
  u32 A[16], O[16];
  load16(A, a + (size_t)16 * b);
  fp_mul_small(O, A, k);
  store16(out + (size_t)16 * b, O);
}

// #17 fn_sub_pallas: canonical a - b mod N.
extern "C" __global__ void __launch_bounds__(EG_THREADS)
k_fn_sub(const u32* a, const u32* bv, int M, u32* out) {
  EG_ROW(M)
  u32 A[16], Bv[16], O[16];
  load16(A, a + (size_t)16 * b);
  load16(Bv, bv + (size_t)16 * b);
  fn_sub(O, A, Bv);
  store16(out + (size_t)16 * b, O);
}

// #17 fn_neg_pallas: canonical -a mod N (0 -> 0).
extern "C" __global__ void __launch_bounds__(EG_THREADS)
k_fn_neg(const u32* a, int M, u32* out) {
  EG_ROW(M)
  u32 A[16], O[16];
  load16(A, a + (size_t)16 * b);
  fn_neg(O, A);
  store16(out + (size_t)16 * b, O);
}

// The 16 limbs of mulhi8's constant, passed with the launch (kernel
// parameters sit in the constant bank, read alike by every thread).
struct Limbs16 {
  u32 v[16];
};

// #18 mulhi8_pallas: [M, 16] -> [M, 8], limbs 24..31 of a * g (the GLV
// rounding (k * g) >> 384; g is g1 or g2 of the lattice).
extern "C" __global__ void __launch_bounds__(EG_THREADS)
k_mulhi8(const u32* a, Limbs16 g, int M, u32* out) {
  EG_ROW(M)
  u32 A[16], cols[32], lim[32];
  load16(A, a + (size_t)16 * b);
  mul_cols<16, 16>(A, g.v, cols);
  carry<32, 32>(cols, lim);
  u32* o = out + (size_t)8 * b;
#pragma unroll
  for (int k = 0; k < 8; ++k) o[k] = lim[24 + k];
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

extern "C" int eg_init_glue(const u32* host_consts, int count) {
  return eg_upload_consts(host_consts, count);
}

extern "C" int eg_fp_sub(const void* a, const void* b, int M, void* out,
                         void* stream) {
  if (M <= 0) return 0;
  k_fp_sub<<<eg_grid(M), EG_THREADS, 0, EG_STREAM(stream)>>>(
      (const u32*)a, (const u32*)b, M, (u32*)out);
  return (int)cudaGetLastError();
}

extern "C" int eg_fp_neg(const void* a, int M, void* out, void* stream) {
  if (M <= 0) return 0;
  k_fp_neg<<<eg_grid(M), EG_THREADS, 0, EG_STREAM(stream)>>>(
      (const u32*)a, M, (u32*)out);
  return (int)cudaGetLastError();
}

extern "C" int eg_fp_mul_small(const void* a, int k, int M, void* out,
                               void* stream) {
  if (M <= 0) return 0;
  if (k < 0 || k >= 16) return -1;
  k_fp_mul_small<<<eg_grid(M), EG_THREADS, 0, EG_STREAM(stream)>>>(
      (const u32*)a, (u32)k, M, (u32*)out);
  return (int)cudaGetLastError();
}

extern "C" int eg_fn_sub(const void* a, const void* b, int M, void* out,
                         void* stream) {
  if (M <= 0) return 0;
  k_fn_sub<<<eg_grid(M), EG_THREADS, 0, EG_STREAM(stream)>>>(
      (const u32*)a, (const u32*)b, M, (u32*)out);
  return (int)cudaGetLastError();
}

extern "C" int eg_fn_neg(const void* a, int M, void* out, void* stream) {
  if (M <= 0) return 0;
  k_fn_neg<<<eg_grid(M), EG_THREADS, 0, EG_STREAM(stream)>>>(
      (const u32*)a, M, (u32*)out);
  return (int)cudaGetLastError();
}

// g: 16 host-side limbs of the constant, copied into the launch.
extern "C" int eg_mulhi8(const void* a, const u32* g, int M, void* out,
                         void* stream) {
  if (M <= 0) return 0;
  Limbs16 gl;
  memcpy(gl.v, g, sizeof(gl.v));
  k_mulhi8<<<eg_grid(M), EG_THREADS, 0, EG_STREAM(stream)>>>(
      (const u32*)a, gl, M, (u32*)out);
  return (int)cudaGetLastError();
}
