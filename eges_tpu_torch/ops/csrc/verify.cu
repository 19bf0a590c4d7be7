// The four kernels that classic ECDSA verify (verify_batch) and the
// one-block keccak256 path add to those of recover.cu, for sm_90a.
//
// Each __global__ replaces one Pallas kernel of
// eges_tpu/ops/pallas_kernels.py (named beside it) and runs one thread
// per batch row over the field library of field.cuh, so its results are
// bit-identical to the reference's numpy twins.  The three field kernels
// are thin entries over existing device functions; the reference ran
// them as one-launch glue ops on [16, LANE_BLOCK] tiles.
//
// What bounds them on the H100 (about ten u32 operations issue in the
// time one byte of device memory moves): fp_add (about 0.5 counted
// operations per byte it reads and writes) and fn_red17 (about 2.8) are
// bound by bytes, fn_mul (about 12) and keccak_block (about 26) by
// integer operations (ops/opcount.py counts them).  Each reads its
// inputs once, writes its outputs once and keeps every intermediate in
// registers.
// keccak_block reads [B, 34] row-major words: a block first copies its
// rows' words into shared memory with neighbouring threads on
// neighbouring addresses, so the loads are coalesced, and each thread
// then reads its own row from there.
//
// Each launcher has a plain C interface for ctypes, like recover.cu's.

#include "launch.cuh"

using namespace eg;

// #14 fn_mul_pallas: [M, 16] x [M, 16] -> [M, 16] canonical mod N.
extern "C" __global__ void __launch_bounds__(EG_THREADS)
k_fn_mul(const u32* a, const u32* bv, int M, u32* out) {
  EG_ROW(M)
  u32 A[16], Bv[16], O[16];
  load16(A, a + (size_t)16 * b);
  load16(Bv, bv + (size_t)16 * b);
  fn_mul(O, A, Bv);
  store16(out + (size_t)16 * b, O);
}

// #15 fn_red17_pallas: [M, 17] small columns -> [M, 16] canonical mod N.
extern "C" __global__ void __launch_bounds__(EG_THREADS)
k_fn_red17(const u32* a, int M, u32* out) {
  EG_ROW(M)
  u32 C[17], O[16];
  const u32* row = a + (size_t)17 * b;
#pragma unroll
  for (int k = 0; k < 17; ++k) C[k] = row[k];
  fn_red_cols<17>(C, O);
  store16(out + (size_t)16 * b, O);
}

// #16a fp_add_pallas: relaxed F_P sum.
extern "C" __global__ void __launch_bounds__(EG_THREADS)
k_fp_add(const u32* a, const u32* bv, int M, u32* out) {
  EG_ROW(M)
  u32 A[16], Bv[16], O[16];
  load16(A, a + (size_t)16 * b);
  load16(Bv, bv + (size_t)16 * b);
  fp_add(O, A, Bv);
  store16(out + (size_t)16 * b, O);
}

// #13 keccak_block_pallas: [B, 34] words of one padded block per row ->
// [B, 8] digest words.  The block's rows are contiguous in memory, so
// the copy into shared memory walks them word by word across threads.
extern "C" __global__ void __launch_bounds__(EG_THREADS)
k_keccak_block(const u32* words, int B, u32* out) {
  __shared__ u32 tile[EG_THREADS * 34];
  const int row0 = blockIdx.x * EG_THREADS;
  const int rows = min(EG_THREADS, B - row0);
  const u32* src = words + (size_t)34 * row0;
  for (int i = threadIdx.x; i < 34 * rows; i += EG_THREADS) tile[i] = src[i];
  __syncthreads();
  if ((int)threadIdx.x >= rows) return;
  u32 w[34], o[8];
#pragma unroll
  for (int k = 0; k < 34; ++k) w[k] = tile[34 * threadIdx.x + k];
  keccak_words(w, o);
  u32* dst = out + (size_t)8 * (row0 + threadIdx.x);
#pragma unroll
  for (int k = 0; k < 8; ++k) dst[k] = o[k];
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

extern "C" int eg_init_verify(const u32* host_consts, int count) {
  return eg_upload_consts(host_consts, count);
}

extern "C" int eg_fn_mul(const void* a, const void* b, int M, void* out,
                         void* stream) {
  if (M <= 0) return 0;
  k_fn_mul<<<eg_grid(M), EG_THREADS, 0, EG_STREAM(stream)>>>(
      (const u32*)a, (const u32*)b, M, (u32*)out);
  return (int)cudaGetLastError();
}

extern "C" int eg_fn_red17(const void* a, int M, void* out, void* stream) {
  if (M <= 0) return 0;
  k_fn_red17<<<eg_grid(M), EG_THREADS, 0, EG_STREAM(stream)>>>(
      (const u32*)a, M, (u32*)out);
  return (int)cudaGetLastError();
}

extern "C" int eg_fp_add(const void* a, const void* b, int M, void* out,
                         void* stream) {
  if (M <= 0) return 0;
  k_fp_add<<<eg_grid(M), EG_THREADS, 0, EG_STREAM(stream)>>>(
      (const u32*)a, (const u32*)b, M, (u32*)out);
  return (int)cudaGetLastError();
}

extern "C" int eg_keccak_block(const void* words, int B, void* out,
                               void* stream) {
  if (B <= 0) return 0;
  k_keccak_block<<<eg_grid(B), EG_THREADS, 0, EG_STREAM(stream)>>>(
      (const u32*)words, B, (u32*)out);
  return (int)cudaGetLastError();
}
