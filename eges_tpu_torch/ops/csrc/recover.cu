// The eleven kernels of batched sender recovery (ecrecover) for sm_90a.
//
// Each __global__ replaces one Pallas kernel of
// eges_tpu/ops/pallas_kernels.py (named beside it) and runs one thread
// per batch row over the field library of field.cuh, so its results are
// bit-identical to the reference's numpy twins.  The TPU kernels walked
// windows, table entries and pow digits on a sequential grid axis with
// the running state in VMEM; blocks on Hopper run in no order, so each
// of those walks is a loop inside the thread here.
//
// Layouts are the reference wrappers': [rows, 16] for values, limb-major
// [rows, Bpad] for the GLV digits, the strauss R tables and the keccak
// block words, where Bpad is the batch rounded up to the lane block (256
// unless EGES_TPU_LANE_BLOCK sets another).  Every kernel takes its row
// count and masks the ragged edge itself.
//
// What bounds each kernel on the H100 (about ten u32 operations issue in
// the time one byte of device memory moves): fp_mul, fp_canon,
// recover_prelude, y_fix and recover_finish issue fewer than that per
// byte and are bound by bytes; the other six by integer operations.  All of
// them read each input once, write each output once and keep every
// intermediate in registers (the pow table in a per-thread 1 KB local
// array), which is all the design does about either bound so far.
//
// Each launcher has a plain C interface for ctypes: device pointers and
// the stream arrive as void*, the kernel is queued on that stream, and
// the launcher returns cudaGetLastError() so a refused launch is seen.

#include <string.h>

#include "launch.cuh"

using namespace eg;

// #1 recover_prelude_pallas: wire bytes -> r, s, z, v, the x candidate,
// y^2 and the range checks.
extern "C" __global__ void __launch_bounds__(EG_THREADS)
k_recover_prelude(const uint8_t* sigs, const uint8_t* hashes, int B, u32* x,
                  u32* y_sq, u32* ok, u32* r, u32* s, u32* z, u32* v) {
  EG_ROW(B)
  const uint8_t* sg = sigs + (size_t)65 * b;
  u32 R[16], S[16], Zh[16], X[16], YS[16];
  unpack_be(R, sg);
  unpack_be(S, sg + 32);
  unpack_be(Zh, hashes + (size_t)32 * b);
  const u32 V = sg[64];
  const u32 OK = recover_prelude(X, YS, R, S, V);
  const size_t o = (size_t)16 * b;
  store16(x + o, X);
  store16(y_sq + o, YS);
  store16(r + o, R);
  store16(s + o, S);
  store16(z + o, Zh);
  ok[b] = OK;
  v[b] = V;
}

// #2 pow_mod_pallas: a^e for a constant e (64 four-bit digits, MSD
// first), relaxed mod P or canonical mod N.  The per-thread table
// a^0..a^15 (1 KB) is indexed by the digit directly.
struct PowDigits {
  unsigned char d[64];
};

template <bool MODN>
static __device__ __forceinline__ void modmul(u32* o, const u32* a,
                                              const u32* b) {
  if constexpr (MODN)
    fn_mul(o, a, b);
  else
    fp_mul(o, a, b);
}

template <bool MODN>
static __device__ __forceinline__ void pow_row(const u32* a, u32* out,
                                               const PowDigits& e) {
  u32 A[16], tab[16][16], acc[16];
  load16(A, a);
  one16(tab[0]);
  copy16(tab[1], A);
  copy16(acc, A);
#pragma unroll 1
  for (int i = 2; i < 16; ++i) {
    modmul<MODN>(acc, acc, A);
    copy16(tab[i], acc);
  }
  one16(acc);
#pragma unroll 1
  for (int w = 0; w < 64; ++w) {
#pragma unroll 1
    for (int i = 0; i < 4; ++i) modmul<MODN>(acc, acc, acc);
    modmul<MODN>(acc, acc, tab[e.d[w] & 15]);
  }
  store16(out, acc);
}

extern "C" __global__ void __launch_bounds__(EG_THREADS)
k_pow_p(const u32* a, u32* out, int M, PowDigits e) {
  EG_ROW(M)
  pow_row<false>(a + (size_t)16 * b, out + (size_t)16 * b, e);
}

extern "C" __global__ void __launch_bounds__(EG_THREADS)
k_pow_n(const u32* a, u32* out, int M, PowDigits e) {
  EG_ROW(M)
  pow_row<true>(a + (size_t)16 * b, out + (size_t)16 * b, e);
}

// #3 y_fix_pallas
extern "C" __global__ void __launch_bounds__(EG_THREADS)
k_y_fix(const u32* root, const u32* y_sq, const u32* v, int B, u32* y,
        u32* y_ok) {
  EG_ROW(B)
  u32 R[16], A[16], Y[16];
  load16(R, root + (size_t)16 * b);
  load16(A, y_sq + (size_t)16 * b);
  y_ok[b] = y_fix(Y, R, A, v[b]);
  store16(y + (size_t)16 * b, Y);
}

// #4 u1u2_pallas
extern "C" __global__ void __launch_bounds__(EG_THREADS)
k_u1u2(const u32* z, const u32* s, const u32* r_inv, int B, u32* u1,
       u32* u2) {
  EG_ROW(B)
  const size_t o = (size_t)16 * b;
  u32 Zv[16], S[16], RI[16], U1[16], U2[16];
  load16(Zv, z + o);
  load16(S, s + o);
  load16(RI, r_inv + o);
  u1u2(U1, U2, Zv, S, RI);
  store16(u1 + o, U1);
  store16(u2 + o, U2);
}

// #5 glv_digits_pallas: dig [33, 8, Bpad] (rows 0-3: k1, k2 of u1, k1,
// k2 of u2; rows 4-7 zero), neg [8, Bpad].  Threads cover Bpad; the
// rows past B split a zero scalar, as the reference's padded lanes do.
extern "C" __global__ void __launch_bounds__(EG_THREADS)
k_glv_digits(const u32* u1, const u32* u2, int B, int Bpad, u32* dig,
             u32* neg) {
  EG_ROW(Bpad)
#pragma unroll 1
  for (int half = 0; half < 2; ++half) {
    const u32* src = half ? u2 : u1;
    u32 U[16], d1[GLV_WINDOWS], d2[GLV_WINDOWS], n1, n2;
    if (b < B)
      load16(U, src + (size_t)16 * b);
    else
      zero16(U);
    glv_track(d1, &n1, d2, &n2, U);
    for (int w = 0; w < GLV_WINDOWS; ++w) {
      dig[((size_t)w * 8 + 2 * half) * Bpad + b] = d1[w];
      dig[((size_t)w * 8 + 2 * half + 1) * Bpad + b] = d2[w];
    }
    neg[(size_t)(2 * half) * Bpad + b] = n1;
    neg[(size_t)(2 * half + 1) * Bpad + b] = n2;
  }
  for (int w = 0; w < GLV_WINDOWS; ++w)
    for (int t = 4; t < 8; ++t) dig[((size_t)w * 8 + t) * Bpad + b] = 0;
  for (int t = 4; t < 8; ++t) neg[(size_t)t * Bpad + b] = 0;
}

// #6 point_table_pallas: Jacobian d*R for d = 2..15 by 14 chained mixed
// adds; outputs [14, B, 16] each.
extern "C" __global__ void __launch_bounds__(EG_THREADS)
k_point_table(const u32* px, const u32* py, int B, u32* X, u32* Y, u32* Z) {
  EG_ROW(B)
  u32 PX[16], PY[16], x[16], y[16], z[16];
  load16(PX, px + (size_t)16 * b);
  load16(PY, py + (size_t)16 * b);
  copy16(x, PX);
  copy16(y, PY);
  one16(z);
#pragma unroll 1
  for (int d = 0; d < 14; ++d) {
    jac_add_mixed(x, y, z, x, y, z, PX, PY);
    const size_t o = ((size_t)d * B + b) * 16;
    store16(X + o, x);
    store16(Y + o, y);
    store16(Z + o, z);
  }
}

// #7 fp_mul_pallas
extern "C" __global__ void __launch_bounds__(EG_THREADS)
k_fp_mul(const u32* a, const u32* bv, int M, u32* out) {
  EG_ROW(M)
  u32 A[16], Bv[16], O[16];
  load16(A, a + (size_t)16 * b);
  load16(Bv, bv + (size_t)16 * b);
  fp_mul(O, A, Bv);
  store16(out + (size_t)16 * b, O);
}

// #8 fp_canon_pallas
extern "C" __global__ void __launch_bounds__(EG_THREADS)
k_fp_canon(const u32* a, int M, u32* out) {
  EG_ROW(M)
  u32 A[16];
  load16(A, a + (size_t)16 * b);
  cond_sub_p(A, A);
  store16(out + (size_t)16 * b, A);
}

// #9 strauss_tab: the 33-window GLV/Strauss ladder u1*G + u2*R.  Per
// window: 4 doublings, then 4 conditional mixed adds of +-G, +-lambda*G
// (tables in __constant__ memory) and +-R, +-lambda*R (per-row tables,
// row 16*d + k of [256, Bpad] = limb k of entry d, loaded directly where
// the TPU kernel ran one-hot selects).  A zero digit discards its add.
extern "C" __global__ void __launch_bounds__(EG_THREADS)
k_strauss(const u32* dig, const u32* neg, const u32* trx, const u32* tlrx,
          const u32* try_, int B, int Bpad, int W, u32* X, u32* Y, u32* Z) {
  EG_ROW(B)
  u32 x[16], y[16], z[16], ng[4];
  zero16(x);
  one16(y);
  zero16(z);
  for (int t = 0; t < 4; ++t) ng[t] = neg[(size_t)t * Bpad + b];
#pragma unroll 1
  for (int w = 0; w < W; ++w) {
#pragma unroll 1
    for (int i = 0; i < 4; ++i) jac_double(x, y, z, x, y, z);
#pragma unroll 1
    for (int t = 0; t < 4; ++t) {
      const u32 d = dig[((size_t)w * 8 + t) * Bpad + b] & 15u;
      u32 px[16], py[16];
      if (t < 2) {
#pragma unroll
        for (int k = 0; k < 16; ++k) {
          px[k] = t == 0 ? K.gx[d][k] : K.lx[d][k];
          py[k] = K.gy[d][k];
        }
      } else {
        const u32* tx = t == 2 ? trx : tlrx;
#pragma unroll
        for (int k = 0; k < 16; ++k) {
          const size_t row = ((size_t)16 * d + k) * Bpad + b;
          px[k] = tx[row];
          py[k] = try_[row];
        }
      }
      if (ng[t]) fp_neg(py, py);
      u32 ax[16], ay[16], az[16];
      jac_add_mixed(ax, ay, az, x, y, z, px, py);
      if (d != 0) {
        copy16(x, ax);
        copy16(y, ay);
        copy16(z, az);
      }
    }
  }
  const size_t o = (size_t)16 * b;
  store16(X + o, x);
  store16(Y + o, y);
  store16(Z + o, z);
}

// #10 recover_finish_pallas: qx, qy [B, 16], ok [B], and the keccak
// block words [34, Bpad] (threads cover Bpad; rows past B finish a zero
// point, as the reference's padded lanes do).
extern "C" __global__ void __launch_bounds__(EG_THREADS)
k_recover_finish(const u32* X, const u32* Y, const u32* Z, const u32* zi,
                 const u32* ok_in, int B, int Bpad, u32* qx, u32* qy,
                 u32* ok, u32* words) {
  EG_ROW(Bpad)
  u32 Xv[16], Yv[16], Zv[16], ZI[16], QX[16], QY[16], Wd[34];
  u32 oki = 0;
  if (b < B) {
    const size_t o = (size_t)16 * b;
    load16(Xv, X + o);
    load16(Yv, Y + o);
    load16(Zv, Z + o);
    load16(ZI, zi + o);
    oki = ok_in[b];
  } else {
    zero16(Xv);
    zero16(Yv);
    zero16(Zv);
    zero16(ZI);
  }
  const u32 OK = recover_finish(QX, QY, Wd, Xv, Yv, Zv, ZI, oki);
  if (b < B) {
    store16(qx + (size_t)16 * b, QX);
    store16(qy + (size_t)16 * b, QY);
    ok[b] = OK;
  }
#pragma unroll
  for (int k = 0; k < 34; ++k) words[(size_t)k * Bpad + b] = Wd[k];
}

// #11 keccak_rows_pallas: one Keccak-f[1600] per column of [34, wide].
extern "C" __global__ void __launch_bounds__(EG_THREADS)
k_keccak_rows(const u32* words, int wide, u32* out) {
  EG_ROW(wide)
  u32 w[34], o[8];
#pragma unroll
  for (int k = 0; k < 34; ++k) w[k] = words[(size_t)k * wide + b];
  keccak_words(w, o);
#pragma unroll
  for (int k = 0; k < 8; ++k) out[(size_t)k * wide + b] = o[k];
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

extern "C" int eg_init(const u32* host_consts, int count) {
  return eg_upload_consts(host_consts, count);
}

extern "C" int eg_recover_prelude(const void* sigs, const void* hashes, int B,
                                  void* x, void* y_sq, void* ok, void* r,
                                  void* s, void* z, void* v, void* stream) {
  if (B <= 0) return 0;
  k_recover_prelude<<<eg_grid(B), EG_THREADS, 0, EG_STREAM(stream)>>>(
      (const uint8_t*)sigs, (const uint8_t*)hashes, B, (u32*)x, (u32*)y_sq,
      (u32*)ok, (u32*)r, (u32*)s, (u32*)z, (u32*)v);
  return (int)cudaGetLastError();
}

extern "C" int eg_pow_mod(const void* a, void* out, int M,
                          const unsigned char* digits, int mod_n,
                          void* stream) {
  if (M <= 0) return 0;
  PowDigits e;
  memcpy(e.d, digits, sizeof(e.d));
  if (mod_n)
    k_pow_n<<<eg_grid(M), EG_THREADS, 0, EG_STREAM(stream)>>>(
        (const u32*)a, (u32*)out, M, e);
  else
    k_pow_p<<<eg_grid(M), EG_THREADS, 0, EG_STREAM(stream)>>>(
        (const u32*)a, (u32*)out, M, e);
  return (int)cudaGetLastError();
}

extern "C" int eg_y_fix(const void* root, const void* y_sq, const void* v,
                        int B, void* y, void* y_ok, void* stream) {
  if (B <= 0) return 0;
  k_y_fix<<<eg_grid(B), EG_THREADS, 0, EG_STREAM(stream)>>>(
      (const u32*)root, (const u32*)y_sq, (const u32*)v, B, (u32*)y,
      (u32*)y_ok);
  return (int)cudaGetLastError();
}

extern "C" int eg_u1u2(const void* z, const void* s, const void* r_inv, int B,
                       void* u1, void* u2, void* stream) {
  if (B <= 0) return 0;
  k_u1u2<<<eg_grid(B), EG_THREADS, 0, EG_STREAM(stream)>>>(
      (const u32*)z, (const u32*)s, (const u32*)r_inv, B, (u32*)u1,
      (u32*)u2);
  return (int)cudaGetLastError();
}

extern "C" int eg_glv_digits(const void* u1, const void* u2, int B, int Bpad,
                             void* dig, void* neg, void* stream) {
  if (Bpad <= 0) return 0;
  k_glv_digits<<<eg_grid(Bpad), EG_THREADS, 0, EG_STREAM(stream)>>>(
      (const u32*)u1, (const u32*)u2, B, Bpad, (u32*)dig, (u32*)neg);
  return (int)cudaGetLastError();
}

extern "C" int eg_point_table(const void* px, const void* py, int B, void* X,
                              void* Y, void* Z, void* stream) {
  if (B <= 0) return 0;
  k_point_table<<<eg_grid(B), EG_THREADS, 0, EG_STREAM(stream)>>>(
      (const u32*)px, (const u32*)py, B, (u32*)X, (u32*)Y, (u32*)Z);
  return (int)cudaGetLastError();
}

extern "C" int eg_fp_mul(const void* a, const void* b, int M, void* out,
                         void* stream) {
  if (M <= 0) return 0;
  k_fp_mul<<<eg_grid(M), EG_THREADS, 0, EG_STREAM(stream)>>>(
      (const u32*)a, (const u32*)b, M, (u32*)out);
  return (int)cudaGetLastError();
}

extern "C" int eg_fp_canon(const void* a, int M, void* out, void* stream) {
  if (M <= 0) return 0;
  k_fp_canon<<<eg_grid(M), EG_THREADS, 0, EG_STREAM(stream)>>>(
      (const u32*)a, M, (u32*)out);
  return (int)cudaGetLastError();
}

extern "C" int eg_strauss(const void* dig, const void* neg, const void* trx,
                          const void* tlrx, const void* try_, int B, int Bpad,
                          int W, void* X, void* Y, void* Z, void* stream) {
  if (B <= 0) return 0;
  k_strauss<<<eg_grid(B), EG_THREADS, 0, EG_STREAM(stream)>>>(
      (const u32*)dig, (const u32*)neg, (const u32*)trx, (const u32*)tlrx,
      (const u32*)try_, B, Bpad, W, (u32*)X, (u32*)Y, (u32*)Z);
  return (int)cudaGetLastError();
}

extern "C" int eg_recover_finish(const void* X, const void* Y, const void* Z,
                                 const void* zi, const void* ok_in, int B,
                                 int Bpad, void* qx, void* qy, void* ok,
                                 void* words, void* stream) {
  if (Bpad <= 0) return 0;
  k_recover_finish<<<eg_grid(Bpad), EG_THREADS, 0, EG_STREAM(stream)>>>(
      (const u32*)X, (const u32*)Y, (const u32*)Z, (const u32*)zi,
      (const u32*)ok_in, B, Bpad, (u32*)qx, (u32*)qy, (u32*)ok, (u32*)words);
  return (int)cudaGetLastError();
}

extern "C" int eg_keccak_rows(const void* words, int wide, void* out,
                              void* stream) {
  if (wide <= 0) return 0;
  k_keccak_rows<<<eg_grid(wide), EG_THREADS, 0, EG_STREAM(stream)>>>(
      (const u32*)words, wide, (u32*)out);
  return (int)cudaGetLastError();
}
