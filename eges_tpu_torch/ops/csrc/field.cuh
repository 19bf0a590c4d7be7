// Field library of the recovery kernels: secp256k1 arithmetic mod P and
// mod N, the Jacobian group law, Keccak-f[1600] and the pipeline stages,
// as __device__ functions on uint32_t[16] values.
//
// Each function is the CUDA twin of the `_k_<name>` helper of
// eges_tpu/ops/pallas_kernels.py and of the function of the same name in
// ops/field.py, and gives bit-identical results: 16-bit limbs held in
// uint32_t, least significant first; the same fold constants and fold
// order; the same relaxed F_P representation (any value in [0, 2^256)).
// Every partial sum stays below 2^32, so uint32_t arithmetic never wraps
// outside keccak, which uses native 64-bit lanes.
//
// The one thread per batch row that runs these functions keeps a value
// in registers (arrays indexed only by unrolled constants); the compiler
// spills what does not fit.  The prelude, pow, u1u2, ladder, point-table,
// fp_mul, finish and GLV kernels run the T-lane forms (grp_*<T>, below
// the one-thread ones): a group of T lanes a row.  Constants live in
// __constant__ memory and are uploaded once per translation unit from Python
// (ops/kernels.py pack_constants), so the limb values have one source.
#pragma once

#include <stddef.h>
#include <stdint.h>

namespace eg {

typedef uint32_t u32;

#define EG_FD __device__ __forceinline__
// The one-thread point formulas are real calls: each is some thousands
// of instructions, and the kernel that takes them one thread a row (the
// rows8 ladder) need not grow by a copy of each.
#define EG_CALL static __device__ __noinline__

constexpr u32 MASK = 0xFFFFu;

// Layout shared with ops/kernels.py pack_constants (992 words).
struct Consts {
  u32 p[16];        // field prime P
  u32 subc[16];     // 2^256 - 2*(2^256 - P) + 1: a - b == a + (0xFFFF - b) + subc
  u32 n[16];        // group order N
  u32 ndelta[16];   // 2^256 - N, 9 limbs used
  u32 fnsubc[16];   // 2N - 2^256 + 1: a - b == a + (0xFFFF - b) + fnsubc (mod N)
  u32 glv[6][16];   // GLV lattice: g1, g2, a1, a2, -b1, b2
  u32 gx[16][16];   // x of d*G, d = 0..15 (entry 0 zero)
  u32 gy[16][16];   // y of d*G
  u32 lx[16][16];   // x of d*(lambda*G) = beta * x of d*G
  u32 rc[24][2];    // keccak round constants, (lo, hi)
};

// static: every translation unit that includes this header has its own
// copy, which its init entry point (launch.cuh eg_upload_consts) fills.
static __constant__ Consts K;

// ---------------------------------------------------------------------------
// helpers
// ---------------------------------------------------------------------------

EG_FD void copy16(u32* o, const u32* a) {
#pragma unroll
  for (int k = 0; k < 16; ++k) o[k] = a[k];
}

EG_FD void zero16(u32* o) {
#pragma unroll
  for (int k = 0; k < 16; ++k) o[k] = 0;
}

EG_FD void one16(u32* o) {
  zero16(o);
  o[0] = 1;
}

// The rows8 layout of the tiling configuration: an [R, M] limb-major
// array (M a multiple of 1024) cut into tiles of 1024 columns, each tile
// [R * 8, 128] with row r * 8 + sublane; column b = tile * 1024 +
// sublane * 128 + lane.  Element (r, b) sits at (tile * R + r) * 1024 +
// (b % 1024), so the 32 threads of a warp (consecutive b) read 128
// contiguous bytes of each row.
EG_FD size_t rows8_at(int R, int r, int b) {
  return ((size_t)(b >> 10) * R + r) * 1024 + (b & 1023);
}

// Limb k of row b of a [nb, 128, 128] value tile (R = 16 limbs).
EG_FD void load_rows8(u32* o, const u32* tile, int b) {
#pragma unroll
  for (int k = 0; k < 16; ++k) o[k] = tile[rows8_at(16, k, b)];
}

EG_FD void store_rows8(u32* tile, int b, const u32* v) {
#pragma unroll
  for (int k = 0; k < 16; ++k) tile[rows8_at(16, k, b)] = v[k];
}

// o = flag ? a : b (o may alias a or b)
EG_FD void select16(u32* o, u32 flag, const u32* a, const u32* b) {
#pragma unroll
  for (int k = 0; k < 16; ++k) o[k] = flag ? a[k] : b[k];
}

// ---------------------------------------------------------------------------
// mod P (relaxed)
// ---------------------------------------------------------------------------

// 16 columns (each < 2^31), in place -> relaxed 16-limb value: two full
// carry chains with the 2^256 = 2^32 + 977 fold after each, then the
// closing 5-step chain.
EG_FD void carry_tail(u32* o) {
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
    u32 c = 0;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      u32 t = o[k] + c;
      o[k] = t & MASK;
      c = t >> 16;
    }
    o[0] += c * 977u;
    o[2] += c;
  }
  u32 c = 0;
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    u32 t = o[k] + c;
    o[k] = t & MASK;
    c = t >> 16;
  }
}

// Uncarried schoolbook columns of a (NA limbs) x b (NB limbs).
template <int NA, int NB>
EG_FD void mul_cols(const u32* a, const u32* b, u32* cols) {
#pragma unroll
  for (int k = 0; k < NA + NB; ++k) cols[k] = 0;
#pragma unroll
  for (int i = 0; i < NA; ++i) {
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      u32 p = a[i] * b[j];
      cols[i + j] += p & MASK;
      cols[i + j + 1] += p >> 16;
    }
  }
}

// 32 product columns -> 16: fold columns 16..31 (2^256 = 2^32 + 977),
// 32 -> 18 columns, then columns 16 and 17.  Linear: the fold of a sum of
// column sets is the sum of their folds.
EG_FD void fold32(const u32* c, u32* r) {
  u32 lo[18];
#pragma unroll
  for (int j = 0; j < 16; ++j) lo[j] = c[j];
  lo[16] = 0;
  lo[17] = 0;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    lo[j] += c[16 + j] * 977u;
    lo[j + 2] += c[16 + j];
  }
#pragma unroll
  for (int j = 0; j < 16; ++j) r[j] = lo[j];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    r[j] += lo[16 + j] * 977u;
    r[j + 2] += lo[16 + j];
  }
}

EG_FD void fp_mul(u32* o, const u32* a, const u32* b) {
  u32 c[32], r[16];
  mul_cols<16, 16>(a, b, c);
  fold32(c, r);
  carry_tail(r);
  copy16(o, r);
}

EG_FD void fp_sqr(u32* o, const u32* a) { fp_mul(o, a, a); }

EG_FD void fp_add(u32* o, const u32* a, const u32* b) {
  u32 r[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) r[k] = a[k] + b[k];
  carry_tail(r);
  copy16(o, r);
}

// Branchless a - b: a + (0xFFFF - b) + subc, columns never borrow.
EG_FD void fp_sub(u32* o, const u32* a, const u32* b) {
  u32 r[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) r[k] = a[k] + (MASK - b[k]) + K.subc[k];
  carry_tail(r);
  copy16(o, r);
}

EG_FD void fp_neg(u32* o, const u32* a) {
  u32 z[16];
  zero16(z);
  fp_sub(o, z, a);
}

EG_FD void fp_mul_small(u32* o, const u32* a, u32 k) {
  u32 r[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) r[i] = a[i] * k;
  carry_tail(r);
  copy16(o, r);
}

// Relaxed a == 0 (mod P): exactly 0 or exactly P.
EG_FD u32 is_zero_mod(const u32* a) {
  u32 z = 1, p = 1;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    z &= (a[k] == 0);
    p &= (a[k] == K.p[k]);
  }
  return z | p;
}

// ---------------------------------------------------------------------------
// T lanes a row
// ---------------------------------------------------------------------------
//
// The lane kernels run a row on a group of T consecutive lanes
// of a warp (T = 1, 2, 4 or 8; launch.cuh eg_group gives a lane its rank
// in the group and the group's mask).  Every lane holds the row's values
// and takes the same branches.  A product shares its 256 partial
// products out: lane `rank` multiplies the limbs a[T*m + rank] of the
// first operand (grp_pick) by the second operand shifted up by `rank`
// limbs (grp_shift), so that each of its products lands in a column known
// at compile time.  Each lane folds its own columns (the fold is linear)
// and the group sums the folded columns with __shfl_xor_sync over its own
// mask (integer sums below 2^32, whatever their order); then every lane
// runs the same carry chain.  So every lane ends with the bits of the
// one-thread product, and T = 1 is the one-thread form itself.  All of it
// inlines, arrays indexed only by unrolled constants: the state stays in
// registers.

// as[m] = a[T*m + rank], m < N/T: a tree of selects on the bits of rank.
template <int T, int N = 16>
EG_FD void grp_pick(u32* as, const u32* a, u32 rank) {
#pragma unroll
  for (int m = 0; m < N / T; ++m) {
    u32 v[T];
#pragma unroll
    for (int q = 0; q < T; ++q) v[q] = a[T * m + q];
#pragma unroll
    for (int s = 1; s < T; s <<= 1) {
#pragma unroll
      for (int q = 0; q < T; q += 2 * s) v[q] = (rank & s) ? v[q + s] : v[q];
    }
    as[m] = v[0];
  }
}

// b[j - rank], zero outside b (j < 16 + T - 1): a tree of selects on the
// bits of rank.  One limb at a time, just before its products, so that no
// shifted copy of b stays live.
template <int T>
EG_FD u32 grp_shift(const u32* b, int j, u32 rank) {
  u32 v[T];
#pragma unroll
  for (int q = 0; q < T; ++q) v[q] = (j - q >= 0 && j - q < 16) ? b[j - q] : 0u;
#pragma unroll
  for (int s = 1; s < T; s <<= 1) {
#pragma unroll
    for (int q = 0; q < T; q += 2 * s) v[q] = (rank & s) ? v[q + s] : v[q];
  }
  return v[0];
}

// This lane's share of the uncarried schoolbook columns of a (NA limbs)
// x b (16 limbs), NA + 16 columns: the products of a's limbs T*m + rank,
// each column's sums below its whole sum.  T = 1: all of mul_cols<NA, 16>.
template <int T, int NA = 16>
EG_FD void grp_cols(const u32* a, const u32* b, u32* cols, u32 rank) {
  if constexpr (T == 1) {
    mul_cols<NA, 16>(a, b, cols);
  } else {
    constexpr int S = NA / T, W = 16 + T - 1;
    u32 as[S];
    grp_pick<T, NA>(as, a, rank);
#pragma unroll
    for (int k = 0; k < NA + 16; ++k) cols[k] = 0;
#pragma unroll
    for (int j = 0; j < W; ++j) {
      const u32 bj = grp_shift<T>(b, j, rank);
#pragma unroll
      for (int m = 0; m < S; ++m) {
        // a[T*m + rank] * b[j - rank] belongs to column T*m + j
        u32 p = as[m] * bj;
        cols[T * m + j] += p & MASK;
        cols[T * m + j + 1] += p >> 16;
      }
    }
  }
}

// Each of the group's lanes holds NC partial columns: every lane gets
// their sums.
template <int T, int NC>
EG_FD void grp_sum(u32* c, u32 mask) {
#pragma unroll
  for (int s = 1; s < T; s <<= 1) {
#pragma unroll
    for (int k = 0; k < NC; ++k) c[k] += __shfl_xor_sync(mask, c[k], s);
  }
}

// This lane's share of a x b folded to 16 columns: fold32 of its
// grp_cols, with the products of columns 15..31 taken and folded first
// and the others added after, so that the lane never holds 32 columns
// (the sums are the same integers).  T = 1: mul_cols and fold32.
template <int T>
EG_FD void grp_fold_cols(const u32* a, const u32* b, u32* r, u32 rank) {
  if constexpr (T == 1) {
    u32 c[32];
    mul_cols<16, 16>(a, b, c);
    fold32(c, r);
  } else {
    constexpr int S = 16 / T, W = 16 + T - 1;
    u32 as[S], c[32];
    grp_pick<T>(as, a, rank);
#pragma unroll
    for (int k = 15; k < 32; ++k) c[k] = 0;
#pragma unroll
    for (int j = 0; j < W; ++j) {
      const u32 bj = grp_shift<T>(b, j, rank);
#pragma unroll
      for (int m = 0; m < S; ++m) {
        if (T * m + j >= 15) {
          u32 p = as[m] * bj;
          c[T * m + j] += p & MASK;
          c[T * m + j + 1] += p >> 16;
        }
      }
    }
#pragma unroll
    for (int k = 0; k < 15; ++k) c[k] = 0;
    fold32(c, r);
#pragma unroll
    for (int j = 0; j < W; ++j) {
      const u32 bj = grp_shift<T>(b, j, rank);
#pragma unroll
      for (int m = 0; m < S; ++m) {
        if (T * m + j < 15) {
          u32 p = as[m] * bj;
          r[T * m + j] += p & MASK;
          r[T * m + j + 1] += p >> 16;
        }
      }
    }
  }
}

template <int T>
EG_FD void grp_fp_mul(u32* o, const u32* a, const u32* b, u32 rank,
                      u32 mask) {
  u32 r[16];
  grp_fold_cols<T>(a, b, r, rank);
  grp_sum<T, 16>(r, mask);
  carry_tail(r);
  copy16(o, r);
}

template <int T>
EG_FD void grp_fp_sqr(u32* o, const u32* a, u32 rank, u32 mask) {
  grp_fp_mul<T>(o, a, a, rank, mask);
}

// Jacobian doubling, a = 0 (dbl-2009-l), z3 first so that Y1 and Z1 die
// early (the same products of the same values).  Outputs may alias
// inputs.
template <int T>
EG_FD void grp_jac_double(u32* X3, u32* Y3, u32* Z3, const u32* X1,
                          const u32* Y1, const u32* Z1, u32 rank, u32 mask) {
  u32 A[16], B[16], C[16], t[16], D[16], E[16], F[16];
  u32 x3[16], y3[16], z3[16];
  grp_fp_mul<T>(z3, Y1, Z1, rank, mask);
  fp_mul_small(z3, z3, 2);
  grp_fp_sqr<T>(A, X1, rank, mask);
  grp_fp_sqr<T>(B, Y1, rank, mask);
  grp_fp_sqr<T>(C, B, rank, mask);
  fp_add(t, X1, B);
  grp_fp_sqr<T>(t, t, rank, mask);
  fp_sub(D, t, A);
  fp_sub(D, D, C);
  fp_mul_small(D, D, 2);
  fp_mul_small(E, A, 3);
  grp_fp_sqr<T>(F, E, rank, mask);
  fp_mul_small(t, D, 2);
  fp_sub(x3, F, t);
  fp_sub(t, D, x3);
  grp_fp_mul<T>(y3, E, t, rank, mask);
  fp_mul_small(t, C, 8);
  fp_sub(y3, y3, t);
  copy16(X3, x3);
  copy16(Y3, y3);
  copy16(Z3, z3);
}

// Jacobian + affine (madd-2007-bl) with the exceptional cases of the
// reference: P1 at infinity, equal points (the doubling path), opposite
// points (infinity).  The reference computes both the sum and the
// doubling on every row and selects; here each runs only where it is
// taken, which gives the same bits: in the ladder and the point table
// only when the running point equals the added one (the table's first
// entry, R + R, calls the doubling itself).  The lanes of a group hold
// one row, so they take the branch together.  The sum's products are in
// an order that lets each input die at its last use (the same products
// of the same values).  Outputs may alias the Jacobian inputs.
template <int T>
EG_FD void grp_jac_add_mixed(u32* X, u32* Y, u32* Z, const u32* X1,
                             const u32* Y1, const u32* Z1, const u32* x2,
                             const u32* y2, u32 rank, u32 mask) {
  u32 Z1Z1[16], U2[16], S2[16], H[16], r[16];
  grp_fp_sqr<T>(Z1Z1, Z1, rank, mask);
  grp_fp_mul<T>(U2, x2, Z1Z1, rank, mask);
  grp_fp_mul<T>(S2, y2, Z1, rank, mask);
  grp_fp_mul<T>(S2, S2, Z1Z1, rank, mask);
  fp_sub(H, U2, X1);
  fp_sub(r, S2, Y1);
  const u32 h0 = is_zero_mod(H);
  const u32 r0 = is_zero_mod(r);
  const u32 p1_inf = is_zero_mod(Z1);
  const u32 dbl = h0 & r0;
  const u32 opp = h0 & (1u - r0);

  u32 X3[16], Y3[16], Z3[16];
  if (dbl) {
    grp_jac_double<T>(X3, Y3, Z3, X1, Y1, Z1, rank, mask);
  } else {
    u32 I[16], J[16], rr[16], V[16], t[16], w[16];
    grp_fp_sqr<T>(I, H, rank, mask);
    fp_mul_small(I, I, 4);
    grp_fp_mul<T>(J, H, I, rank, mask);
    fp_mul_small(t, Z1, 2);
    grp_fp_mul<T>(Z3, t, H, rank, mask);
    grp_fp_mul<T>(w, Y1, J, rank, mask);
    fp_mul_small(w, w, 2);
    fp_mul_small(rr, r, 2);
    grp_fp_mul<T>(V, X1, I, rank, mask);
    grp_fp_sqr<T>(X3, rr, rank, mask);
    fp_sub(X3, X3, J);
    fp_mul_small(t, V, 2);
    fp_sub(X3, X3, t);
    fp_sub(t, V, X3);
    grp_fp_mul<T>(Y3, rr, t, rank, mask);
    fp_sub(Y3, Y3, w);
    u32 one[16], zero[16];
    one16(one);
    zero16(zero);
    select16(Z3, opp, zero, Z3);
    select16(Y3, opp, one, Y3);
  }
  u32 one[16];
  one16(one);
  select16(X, p1_inf, x2, X3);
  select16(Y, p1_inf, y2, Y3);
  select16(Z, p1_inf, one, Z3);
}

// The one-thread formulas (the rows8 ladder).
EG_CALL void jac_double(u32* X3, u32* Y3, u32* Z3, const u32* X1,
                        const u32* Y1, const u32* Z1) {
  grp_jac_double<1>(X3, Y3, Z3, X1, Y1, Z1, 0u, 1u);
}

EG_CALL void jac_add_mixed(u32* X, u32* Y, u32* Z, const u32* X1,
                           const u32* Y1, const u32* Z1, const u32* x2,
                           const u32* y2) {
  grp_jac_add_mixed<1>(X, Y, Z, X1, Y1, Z1, x2, y2, 0u, 1u);
}

// ---------------------------------------------------------------------------
// mod N (canonical)
// ---------------------------------------------------------------------------

// Carry chain over NC small (< 2^31) columns -> NOUT limbs.
template <int NC, int NOUT>
EG_FD void carry(const u32* cols, u32* out) {
  u32 c = 0;
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    u32 t = cols[k] + c;
    if (k < NOUT) out[k] = t & MASK;
    c = t >> 16;
  }
#pragma unroll
  for (int k = NC; k < NOUT; ++k) {
    out[k] = c & MASK;
    c >>= 16;
  }
}

// Borrow chain a - m: difference into o, returns 1 iff a < m.
EG_FD u32 sub_const_chain(u32* o, const u32* a, const u32* m) {
  u32 borrow = 0;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    u32 t = a[k] + 0x10000u - m[k] - borrow;
    o[k] = t & MASK;
    borrow = 1u - (t >> 16);
  }
  return borrow;
}

EG_FD u32 lt_const(const u32* a, const u32* m) {
  u32 d[16];
  return sub_const_chain(d, a, m);
}

// One conditional subtract of the constant m (o may alias a).
EG_FD void cond_sub(u32* o, const u32* a, const u32* m) {
  u32 d[16];
  const u32 borrow = sub_const_chain(d, a, m);
  select16(o, borrow, a, d);
}

EG_FD void cond_sub_p(u32* o, const u32* a) { cond_sub(o, a, K.p); }
EG_FD void cond_sub_n(u32* o, const u32* a) { cond_sub(o, a, K.n); }

// W small columns (16 <= W <= 32) -> canonical mod N: delta folds
// (32 -> 26 -> 20 -> 16 columns for a product), two top-limb folds and
// two conditional subtracts.
template <int W>
EG_FD void fn_red_cols(const u32* cols, u32* o) {
  if constexpr (W > 16) {
    constexpr int NH = W - 16 + 1;
    constexpr int NP = NH + 9;
    constexpr int W2 = NP > 16 ? NP : 16;
    u32 hi[NH];
    carry<W - 16, NH>(cols + 16, hi);
    u32 prod[NP];
    mul_cols<NH, 9>(hi, K.ndelta, prod);
    u32 nc[W2];
#pragma unroll
    for (int k = 0; k < W2; ++k)
      nc[k] = (k < 16 ? cols[k] : 0u) + (k < NP ? prod[k] : 0u);
    fn_red_cols<W2>(nc, o);
  } else {
    static_assert(W == 16, "fn_red_cols takes 16..32 columns");
    u32 a17[17];
    carry<16, 17>(cols, a17);
#pragma unroll
    for (int it = 0; it < 2; ++it) {
      u32 fold[10];
      mul_cols<1, 9>(&a17[16], K.ndelta, fold);
      u32 s[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) s[k] = a17[k] + (k < 10 ? fold[k] : 0u);
      carry<16, 17>(s, a17);
    }
    u32 r[16];
    cond_sub_n(r, a17);
    cond_sub_n(o, r);
  }
}

EG_FD void fn_mul(u32* o, const u32* a, const u32* b) {
  u32 c[32];
  mul_cols<16, 16>(a, b, c);
  fn_red_cols<32>(c, o);
}

// T lanes a row: the shared product columns are summed before the
// reduction, which every lane runs (its carries are not linear).
template <int T>
EG_FD void grp_fn_mul(u32* o, const u32* a, const u32* b, u32 rank,
                      u32 mask) {
  u32 c[32];
  grp_cols<T>(a, b, c, rank);
  grp_sum<T, 32>(c, mask);
  fn_red_cols<32>(c, o);
}

// Canonical a - b mod N (both canonical).
EG_FD void fn_sub(u32* o, const u32* a, const u32* b) {
  u32 c[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) c[k] = a[k] + (MASK - b[k]) + K.fnsubc[k];
  fn_red_cols<16>(c, o);
}

EG_FD u32 is_zero(const u32* a) {
  u32 z = 1;
#pragma unroll
  for (int k = 0; k < 16; ++k) z &= (a[k] == 0);
  return z;
}

// Canonical -a mod N (0 -> 0).
EG_FD void fn_neg(u32* o, const u32* a) {
  u32 z[16], t[16];
  zero16(z);
  const u32 a0 = is_zero(a);
  fn_sub(t, z, a);
  select16(o, a0, z, t);
}

// ---------------------------------------------------------------------------
// keccak-f[1600] over one padded 136-byte block, native 64-bit lanes
// ---------------------------------------------------------------------------

EG_FD uint64_t rotl64(uint64_t x, int r) {
  return r ? (x << r) | (x >> (64 - r)) : x;
}

// 34 little-endian words of the block -> 8 digest words.
EG_FD void keccak_words(const u32* w, u32* out) {
  const int ROT[25] = {0,  1,  62, 28, 27, 36, 44, 6,  55, 20, 3,  10, 43,
                       25, 39, 41, 45, 15, 21, 8,  18, 2,  61, 56, 14};
  uint64_t a[25];
#pragma unroll
  for (int l = 0; l < 25; ++l)
    a[l] = l < 17 ? ((uint64_t)w[2 * l] | ((uint64_t)w[2 * l + 1] << 32)) : 0;
#pragma unroll 1
  for (int rnd = 0; rnd < 24; ++rnd) {
    uint64_t c[5];
#pragma unroll
    for (int x = 0; x < 5; ++x)
      c[x] = a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20];
#pragma unroll
    for (int x = 0; x < 5; ++x) {
      const uint64_t d = c[(x + 4) % 5] ^ rotl64(c[(x + 1) % 5], 1);
#pragma unroll
      for (int y = 0; y < 5; ++y) a[x + 5 * y] ^= d;
    }
    uint64_t bb[25];
#pragma unroll
    for (int x = 0; x < 5; ++x) {
#pragma unroll
      for (int y = 0; y < 5; ++y)
        bb[y + 5 * ((2 * x + 3 * y) % 5)] = rotl64(a[x + 5 * y], ROT[x + 5 * y]);
    }
#pragma unroll
    for (int y = 0; y < 5; ++y) {
#pragma unroll
      for (int x = 0; x < 5; ++x)
        a[x + 5 * y] = bb[x + 5 * y] ^
                       (~bb[(x + 1) % 5 + 5 * y] & bb[(x + 2) % 5 + 5 * y]);
    }
    a[0] ^= (uint64_t)K.rc[rnd][0] | ((uint64_t)K.rc[rnd][1] << 32);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = (u32)a[i];
    out[2 * i + 1] = (u32)(a[i] >> 32);
  }
}

// Keccak-f[1600] of one padded block on a group of T >= 2 lanes (#11's
// kernels; T = 1 is keccak_words).  Lane `rank` holds half h = rank & 1
// of each 64-bit lane (h = 0 its low 32 bits): in[l] that half of block
// lane l < 17, out[i] that half of digest lane i < 4.  Its partner, lane
// rank ^ 1, holds the other half, and both halves of a rotated lane are
// the same function of (mine, other), so a rotation is one shuffle and
// one funnel shift in either lane: the pair issues a one-thread round's
// logic once between them, each lane 119 operations a round (29 of them
// shuffles) against the one thread's 180.  At T = 4 the lanes past the
// first pair hold the same halves again (the 25 lanes do not split four
// or eight ways without moving most of the state between lanes each
// round).  Every lane of the warp must call it
// together: the shuffles name the whole warp (with the group's own mask
// the compiler wrapped each round in a convergence loop, which ran
// slower on the H100), and the rounds go four to a loop trip.
template <int T>
EG_FD void grp_keccak_words(const u32* in, u32* out, u32 rank) {
  static_assert(T >= 2, "T = 1 is keccak_words");
  constexpr u32 WARP = 0xffffffffu;
  const int ROT[25] = {0,  1,  62, 28, 27, 36, 44, 6,  55, 20, 3,  10, 43,
                       25, 39, 41, 45, 15, 21, 8,  18, 2,  61, 56, 14};
  // this lane's half of a lane rotated left by r (0 < r < 64), from its
  // own half and the partner's
  auto rot = [](u32 mine, u32 other, int r) {
    return r < 32 ? __funnelshift_l(other, mine, r)
                  : __funnelshift_l(mine, other, r - 32);
  };
  const u32 h = rank & 1u;
  u32 a[25];
#pragma unroll
  for (int l = 0; l < 25; ++l) a[l] = l < 17 ? in[l] : 0u;
#pragma unroll 4
  for (int rnd = 0; rnd < 24; ++rnd) {
    u32 c[5], r1[5];
#pragma unroll
    for (int x = 0; x < 5; ++x)
      c[x] = a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20];
#pragma unroll
    for (int x = 0; x < 5; ++x)
      r1[x] = rot(c[x], __shfl_xor_sync(WARP, c[x], 1), 1);
#pragma unroll
    for (int x = 0; x < 5; ++x) {
#pragma unroll
      for (int y = 0; y < 5; ++y)
        a[x + 5 * y] ^= c[(x + 4) % 5] ^ r1[(x + 1) % 5];
    }
    u32 b[25];
#pragma unroll
    for (int x = 0; x < 5; ++x) {
#pragma unroll
      for (int y = 0; y < 5; ++y) {
        const int l = x + 5 * y;
        b[y + 5 * ((2 * x + 3 * y) % 5)] =
            ROT[l] ? rot(a[l], __shfl_xor_sync(WARP, a[l], 1), ROT[l]) : a[l];
      }
    }
#pragma unroll
    for (int y = 0; y < 5; ++y) {
#pragma unroll
      for (int x = 0; x < 5; ++x)
        a[x + 5 * y] = b[x + 5 * y] ^
                       (~b[(x + 1) % 5 + 5 * y] & b[(x + 2) % 5 + 5 * y]);
    }
    a[0] ^= K.rc[rnd][h];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) out[i] = a[i];
}

// ---------------------------------------------------------------------------
// pipeline stages
// ---------------------------------------------------------------------------

// 32 big-endian bytes -> 16 limbs.
EG_FD void unpack_be(u32* o, const uint8_t* bytes) {
#pragma unroll
  for (int k = 0; k < 16; ++k)
    o[k] = (u32)bytes[31 - 2 * k] | ((u32)bytes[30 - 2 * k] << 8);
}

// Range checks, the x candidate and y^2 = x^3 + 7 (relaxed) of a row, on
// a group of T lanes (#1's kernels): the square and the product shared
// out (grp_fp_sqr, grp_fp_mul), the checks and x's carry chain whole in
// every lane.  v is the raw recovery byte.  Returns ok.  T = 1 is the
// one-thread prelude.
template <int T>
EG_FD u32 grp_recover_prelude(u32* x, u32* y_sq, const u32* r, const u32* s,
                              u32 v, u32 rank, u32 mask) {
  const u32 r_ok = (1u - is_zero(r)) * lt_const(r, K.n);
  const u32 s_ok = (1u - is_zero(s)) * lt_const(s, K.n);
  const u32 v_ok = v < 4;
  const u32 hi = v >= 2;
  // x = r + (v >= 2 ? N : 0), 17-limb carry chain
  u32 c = 0;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    u32 t = r[k] + hi * K.n[k] + c;
    x[k] = t & MASK;
    c = t >> 16;
  }
  const u32 x_ok = (c == 0) * lt_const(x, K.p);
  u32 t[16];
  grp_fp_sqr<T>(t, x, rank, mask);
  grp_fp_mul<T>(t, t, x, rank, mask);
  t[0] += 7;
  carry_tail(t);
  copy16(y_sq, t);
  return r_ok * s_ok * v_ok * x_ok;
}

// After the sqrt pow: canonicalise the root, check root^2 == y^2, flip
// y to the parity v & 1.  Returns y_ok.  On a group of T lanes (#3's
// kernels): the square shared out (grp_fp_sqr), the canonicalisations,
// the compare, the negation and the select whole in every lane, so every
// lane returns the row's y and y_ok.  T = 1 is the one-thread y_fix.
template <int T>
EG_FD u32 grp_y_fix(u32* y, const u32* root, const u32* y_sq, u32 v,
                    u32 rank, u32 mask) {
  u32 rc[16], ac[16];
  grp_fp_sqr<T>(rc, root, rank, mask);
  cond_sub_p(rc, rc);
  cond_sub_p(ac, y_sq);
  u32 ok = 1;
#pragma unroll
  for (int k = 0; k < 16; ++k) ok &= (rc[k] == ac[k]);
  u32 y0[16], ny[16];
  cond_sub_p(y0, root);
  fp_neg(ny, y0);
  const u32 flip = (v & 1u) ^ (y0[0] & 1u);
  select16(y, flip, ny, y0);
  return ok;
}

// u1 = -(z mod N) * r^-1 and u2 = s * r^-1 (canonical mod N) of a row, on
// a group of T lanes (#4's kernels).  T = 1: one lane computes both, one
// after the other (the selects on h = 0 fold away).  T >= 2: the lanes of
// half h = rank / H (H = T / 2) compute u1 (h = 0) or u2 (h = 1), each
// half sharing its product over its own H lanes (grp_fn_mul<H> with the
// half's rank and mask); every lane returns its half's value in both u1
// and u2.  Both halves run the same instructions: the reduction of z and
// the negation also run in u2's lanes, whose results the selects drop, so
// the group stays converged (halves that branched apart in one warp would
// run one after the other).  z is read only by the reduction, so u2's
// lanes may pass any row there.
template <int T>
EG_FD void grp_u1u2(u32* u1, u32* u2, const u32* z, const u32* s,
                    const u32* r_inv, u32 rank, u32 mask) {
  constexpr int H = T > 1 ? T / 2 : 1;  // lanes a product
  const u32 h = rank / H;               // 0 at T = 1
  // the half's lanes: the group's lowest H lanes, moved up h * H
  const u32 hmask = ((mask & (0u - mask)) * ((1u << H) - 1u)) << (h * H);
  u32 z17[17];
#pragma unroll
  for (int k = 0; k < 16; ++k) z17[k] = z[k];
  z17[16] = 0;
  u32 zm[16], a[16], t[16];
  fn_red_cols<17>(z17, zm);
  select16(a, h, s, zm);
  grp_fn_mul<H>(t, a, r_inv, rank % H, hmask);
  fn_neg(u1, t);
  select16(u1, h, t, u1);
  if constexpr (T == 1)
    grp_fn_mul<H>(u2, s, r_inv, rank, mask);
  else
    copy16(u2, u1);
}

constexpr int GLV_WINDOWS = 33;

// Negative residues are recognised by size: |k| < 2^140 always.
EG_FD u32 glv_sign_split(u32* mag, const u32* v) {
  u32 hi = v[8] >> 12;
#pragma unroll
  for (int k = 9; k < 16; ++k) hi |= v[k];
  const u32 n = hi != 0;
  u32 nv[16];
  fn_neg(nv, v);
  select16(mag, n, nv, v);
  return n;
}

// Limbs 24..31 of 32 carried columns (the lower limbs are not kept).
EG_FD void carry_top8(const u32* cols, u32* top) {
  u32 c = 0;
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    const u32 t = cols[k] + c;
    if (k >= 24) top[k - 24] = t & MASK;
    c = t >> 16;
  }
}

// One scalar's GLV split on a group of T lanes: canonical mod-N u -> the
// magnitudes |k1|, |k2| with their signs, u = +-k1 + lambda * (+-k2)
// (mod N).  The six products are shared out (grp_cols) and summed before
// their carries and reductions (as grp_fn_mul), which, with the
// subtractions and the sign splits, run whole in every lane.  c1 and c2
// have 8 limbs, so their four products have 24 columns: fn_red_cols<24>
// gives the bits that the reference's 32 columns, the top 8 zero, give.
// T = 1 is the one-thread split; the kernel takes the digits from the
// magnitudes as it stores them (#5's kernels).
template <int T>
EG_FD void grp_glv_track(u32* k1, u32* n1, u32* k2, u32* n2, const u32* u,
                         u32 rank, u32 mask) {
  u32 cols[32], c1[8], c2[8], t[16];
  // c_i = (u * g_i) >> 384: limbs 24..31 of the product
  grp_cols<T>(u, K.glv[0], cols, rank);
  grp_sum<T, 32>(cols, mask);
  carry_top8(cols, c1);
  grp_cols<T>(u, K.glv[1], cols, rank);
  grp_sum<T, 32>(cols, mask);
  carry_top8(cols, c2);
  // k1 = u - c1*a1 - c2*a2;  k2 = c1*(-b1) - c2*b2  (mod N)
  grp_cols<T, 8>(c1, K.glv[2], cols, rank);
  grp_sum<T, 24>(cols, mask);
  fn_red_cols<24>(cols, t);
  fn_sub(k1, u, t);
  grp_cols<T, 8>(c2, K.glv[3], cols, rank);
  grp_sum<T, 24>(cols, mask);
  fn_red_cols<24>(cols, t);
  fn_sub(k1, k1, t);
  grp_cols<T, 8>(c1, K.glv[4], cols, rank);
  grp_sum<T, 24>(cols, mask);
  fn_red_cols<24>(cols, k2);
  grp_cols<T, 8>(c2, K.glv[5], cols, rank);
  grp_sum<T, 24>(cols, mask);
  fn_red_cols<24>(cols, t);
  fn_sub(k2, k2, t);
  *n1 = glv_sign_split(k1, k1);
  *n2 = glv_sign_split(k2, k2);
}

// 16 limbs -> 8 little-endian words of the big-endian byte string.
EG_FD void limbs_to_words_be(u32* w, const u32* a) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const u32 hi = a[15 - 2 * i], lo = a[14 - 2 * i];
    w[i] = (hi >> 8) | ((hi & 0xFFu) << 8) | ((lo >> 8) << 16) |
           ((lo & 0xFFu) << 24);
  }
}

// Jacobian result + raw Z^-1 + accumulated validity -> affine (qx, qy)
// masked by the final ok, and the 34 padded keccak block words of
// qx || qy, on a group of T lanes a row (#10's kernels): the four
// products shared out (grp_fp_mul), the canonicalisations, selects and
// words run whole in every lane.  Returns ok.
template <int T>
EG_FD u32 grp_recover_finish(u32* qx, u32* qy, u32* words, const u32* X,
                             const u32* Y, const u32* Z, const u32* zi_raw,
                             u32 ok_in, u32 rank, u32 mask) {
  const u32 inf = is_zero_mod(Z);
  u32 zi[16], zi2[16], x[16], y[16], t[16];
  cond_sub_p(zi, zi_raw);
  grp_fp_sqr<T>(zi2, zi, rank, mask);
  grp_fp_mul<T>(x, X, zi2, rank, mask);
  cond_sub_p(x, x);
  grp_fp_mul<T>(t, zi, zi2, rank, mask);
  grp_fp_mul<T>(y, Y, t, rank, mask);
  cond_sub_p(y, y);
  const u32 ok = ok_in * (1u - inf);
  u32 zero[16];
  zero16(zero);
  select16(x, inf, zero, x);
  select16(y, inf, zero, y);
  select16(qx, ok, x, zero);
  select16(qy, ok, y, zero);
  limbs_to_words_be(words, qx);
  limbs_to_words_be(words + 8, qy);
  // keccak padding of a 64-byte message: byte 64 = 0x01, byte 135 = 0x80
  words[16] = 1;
#pragma unroll
  for (int k = 17; k < 33; ++k) words[k] = 0;
  words[33] = 0x80000000u;
  return ok;
}

}  // namespace eg
