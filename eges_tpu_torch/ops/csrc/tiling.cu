// The three kernels of the reference's TPU-tiling configuration
// (EGES_TPU_LANE_BLOCK=1024 EGES_TPU_ROWS8=1 EGES_TPU_KECCAK_GRID=1), for
// sm_90a.
//
// Each __global__ replaces one Pallas kernel of
// eges_tpu/ops/pallas_kernels.py (named beside it).  The two rows8
// kernels are the TPU's (8, 128)-tile variants of the pow and ladder
// kernels: one thread per row over the field library of field.cuh, as in
// recover.cu's k_pow_p/k_pow_n and k_strauss, so their results are the
// same bits; only the layout differs.  Their values are [nb, 128, 128]
// tiles of 1024 rows (field.cuh rows8_at): limb k of row b is 1024
// words after limb k - 1, so a warp's 32 rows read and write 128
// contiguous bytes of each limb where the [rows, 16] layout puts them 64
// bytes apart.  The round kernel is the TPU's rounds-on-the-grid keccak
// in Hopper's terms: a warp per column shares the state in shared memory.
//
// What bounds them on the H100 (about ten u32 operations issue in the
// time one byte of device memory moves): all three do more than ten
// operations a byte and are bound by integer operations (ops/opcount.py
// counts them).  The tile layout changes only the operand loads and the
// result stores, a small share of an operation-bound kernel.
//
// Its own translation unit with its own copy of the constants block
// (field.cuh declares it static), filled by eg_init_tiling.  Each
// launcher has a plain C interface for ctypes, like recover.cu's.

#include <string.h>

#include "launch.cuh"

using namespace eg;

// The 64 four-bit digits of a constant exponent, MSD first (recover.cu's
// layout of the same launch argument).
struct PowDigits {
  unsigned char d[64];
};

// The rows8 kernels run one thread per row of whole tiles (nb * 1024
// rows, nb * 8 blocks) and compute the first `rows` of them; a thread of
// the last tile's padding stores zeros and ends.
#define EG_TILE_ROW(rows, zero_outs)                   \
  const int b = blockIdx.x * blockDim.x + threadIdx.x; \
  if (b >= (rows)) {                                   \
    u32 zero[16];                                      \
    zero16(zero);                                      \
    zero_outs;                                         \
    return;                                            \
  }

// #19a pow_mod_rows8 (_pow_kernel_rows8): a^e for a constant e over the
// first `rows` rows of rows8 tiles, relaxed mod P.  The TPU kernel walked
// the 64 windows on its grid with the a^0..a^15 table in VMEM scratch;
// here the walk is a loop in the thread and the table a per-thread array
// (1 KB of local memory, as in k_pow_p), indexed by the digit.
extern "C" __global__ void __launch_bounds__(EG_THREADS)
k_pow_rows8_p(const u32* a, u32* out, int rows, PowDigits e) {
  EG_TILE_ROW(rows, store_rows8(out, b, zero))
  u32 A[16], tab[16][16], acc[16];
  load_rows8(A, a, b);
  one16(tab[0]);
  copy16(tab[1], A);
#pragma unroll 1
  for (int i = 2; i < 16; ++i) fp_mul(tab[i], tab[i - 1], A);
  one16(acc);
#pragma unroll 1
  for (int w = 0; w < 64; ++w) {
#pragma unroll 1
    for (int i = 0; i < 4; ++i) fp_mul(acc, acc, acc);
    fp_mul(acc, acc, tab[e.d[w] & 15]);
  }
  store_rows8(out, b, acc);
}

// #19a pow_mod_rows8, canonical mod N.
extern "C" __global__ void __launch_bounds__(EG_THREADS)
k_pow_rows8_n(const u32* a, u32* out, int rows, PowDigits e) {
  EG_TILE_ROW(rows, store_rows8(out, b, zero))
  u32 A[16], tab[16][16], acc[16];
  load_rows8(A, a, b);
  one16(tab[0]);
  copy16(tab[1], A);
#pragma unroll 1
  for (int i = 2; i < 16; ++i) fn_mul(tab[i], tab[i - 1], A);
  one16(acc);
#pragma unroll 1
  for (int w = 0; w < 64; ++w) {
#pragma unroll 1
    for (int i = 0; i < 4; ++i) fn_mul(acc, acc, acc);
    fn_mul(acc, acc, tab[e.d[w] & 15]);
  }
  store_rows8(out, b, acc);
}

// #19b strauss_tab_rows8 (_strauss_tab_kernel_rows8): the GLV/Strauss
// ladder u1*G + u2*R over rows8-laid inputs, for the first `rows` rows.
// Digits [nb, W, 64, 128] (an [8W, M] array: digit t of window w at row
// 8w + t), signs [nb, 64, 128] ([8, M]), R and lambda*R x and the shared
// y [nb, 2048, 128] ([256, M], row 16d + k = limb k of entry d).  The
// ladder is k_strauss's: W windows walked in the thread, each four
// doublings then four mixed adds of +-G, +-lambda*G (tables in
// __constant__ memory), +-R, +-lambda*R, a zero digit discarding its
// add; X, Y, Z leave as tiles.
extern "C" __global__ void __launch_bounds__(EG_THREADS)
k_strauss_rows8(const u32* dig, const u32* neg, const u32* trx,
                const u32* tlrx, const u32* try_, int rows, int W, u32* X,
                u32* Y, u32* Z) {
  EG_TILE_ROW(rows, store_rows8(X, b, zero); store_rows8(Y, b, zero);
              store_rows8(Z, b, zero))
  u32 x[16], y[16], z[16], ng[4];
  zero16(x);
  one16(y);
  zero16(z);
  for (int t = 0; t < 4; ++t) ng[t] = neg[rows8_at(8, t, b)];
#pragma unroll 1
  for (int w = 0; w < W; ++w) {
#pragma unroll 1
    for (int i = 0; i < 4; ++i) jac_double(x, y, z, x, y, z);
#pragma unroll 1
    for (int t = 0; t < 4; ++t) {
      const u32 d = dig[rows8_at(8 * W, 8 * w + t, b)] & 15u;
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
          const size_t row = rows8_at(256, 16 * d + k, b);
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
  store_rows8(X, b, x);
  store_rows8(Y, b, y);
  store_rows8(Z, b, z);
}

// #12 keccak_rows_pallas, grid branch (_keccak_round_kernel): Keccak-f
// [1600] of each column of [34, wide] block words, leaving the whole
// state [50, wide] (lo halves of lanes 0-24 in rows 0-24, hi halves in
// rows 25-49).  The TPU kernel put the 24 rounds on its grid with the
// state resident in its output block; here a warp holds one column's
// state in shared memory, lane l < 25 owning 64-bit lane l as two u32
// halves, and walks the rounds in a loop, __syncwarp() between theta,
// rho-pi and chi.  Rotations are funnel shifts of the halves.
constexpr int KR_COLS = EG_THREADS / 32;  // columns per block

// (lo, hi) rotated left by r, 0 <= r < 64.
static __device__ __forceinline__ void rotl_halves(u32* lo, u32* hi, int r) {
  u32 l = *lo, h = *hi;
  if (r & 32) {
    const u32 t = l;
    l = h;
    h = t;
  }
  *hi = __funnelshift_l(l, h, r);
  *lo = __funnelshift_l(h, l, r);
}

extern "C" __global__ void __launch_bounds__(EG_THREADS)
k_keccak_round(const u32* words, int wide, u32* state) {
  // rho's rotation of lane x + 5y
  const int ROT[25] = {0,  1,  62, 28, 27, 36, 44, 6,  55, 20, 3,  10, 43,
                       25, 39, 41, 45, 15, 21, 8,  18, 2,  61, 56, 14};
  __shared__ u32 s_lo[KR_COLS][25], s_hi[KR_COLS][25];
  __shared__ u32 c_lo[KR_COLS][5], c_hi[KR_COLS][5];
  const int wp = threadIdx.x >> 5, l = threadIdx.x & 31;
  const int col = blockIdx.x * KR_COLS + wp;
  if (col >= wide) return;  // the whole warp: col is the warp's
  const bool on = l < 25;
  const int x = l % 5, y = l / 5;
  const int dst = y + 5 * ((2 * x + 3 * y) % 5);  // pi's destination
  const int rot = on ? ROT[l] : 0;
  u32* slo = s_lo[wp];
  u32* shi = s_hi[wp];
  u32* clo = c_lo[wp];
  u32* chi = c_hi[wp];
  u32 lo = 0, hi = 0;
  if (l < 17) {
    lo = words[(size_t)(2 * l) * wide + col];
    hi = words[(size_t)(2 * l + 1) * wide + col];
  }
#pragma unroll 1
  for (int rnd = 0; rnd < 24; ++rnd) {
    // theta: column parities C[x], then A ^= C[x-1] ^ rot(C[x+1], 1)
    if (on) {
      slo[l] = lo;
      shi[l] = hi;
    }
    __syncwarp();
    if (l < 5) {
      clo[l] = slo[l] ^ slo[l + 5] ^ slo[l + 10] ^ slo[l + 15] ^ slo[l + 20];
      chi[l] = shi[l] ^ shi[l + 5] ^ shi[l + 10] ^ shi[l + 15] ^ shi[l + 20];
    }
    __syncwarp();
    if (on) {
      const int x1 = (x + 1) % 5, x4 = (x + 4) % 5;
      lo ^= clo[x4] ^ __funnelshift_l(chi[x1], clo[x1], 1);
      hi ^= chi[x4] ^ __funnelshift_l(clo[x1], chi[x1], 1);
      // rho and pi: B[dst] = rot(A[l], ROT[l])
      rotl_halves(&lo, &hi, rot);
      slo[dst] = lo;
      shi[dst] = hi;
    }
    __syncwarp();
    // chi along each row of 5, then iota on lane 0
    if (on) {
      const int r1 = (x + 1) % 5 + 5 * y, r2 = (x + 2) % 5 + 5 * y;
      lo = slo[l] ^ (~slo[r1] & slo[r2]);
      hi = shi[l] ^ (~shi[r1] & shi[r2]);
      if (l == 0) {
        lo ^= K.rc[rnd][0];
        hi ^= K.rc[rnd][1];
      }
    }
    __syncwarp();
  }
  if (on) {
    state[(size_t)l * wide + col] = lo;
    state[(size_t)(25 + l) * wide + col] = hi;
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

extern "C" int eg_init_tiling(const u32* host_consts, int count) {
  return eg_upload_consts(host_consts, count);
}

extern "C" int eg_pow_rows8(const void* a, void* out, int rows, int nb,
                            const unsigned char* digits, int mod_n,
                            void* stream) {
  if (nb <= 0) return 0;
  PowDigits e;
  memcpy(e.d, digits, sizeof(e.d));
  if (mod_n)
    k_pow_rows8_n<<<eg_grid(nb * 1024), EG_THREADS, 0, EG_STREAM(stream)>>>(
        (const u32*)a, (u32*)out, rows, e);
  else
    k_pow_rows8_p<<<eg_grid(nb * 1024), EG_THREADS, 0, EG_STREAM(stream)>>>(
        (const u32*)a, (u32*)out, rows, e);
  return (int)cudaGetLastError();
}

extern "C" int eg_strauss_rows8(const void* dig, const void* neg,
                                const void* trx, const void* tlrx,
                                const void* try_, int rows, int nb, int W,
                                void* X, void* Y, void* Z, void* stream) {
  if (nb <= 0) return 0;
  k_strauss_rows8<<<eg_grid(nb * 1024), EG_THREADS, 0, EG_STREAM(stream)>>>(
      (const u32*)dig, (const u32*)neg, (const u32*)trx, (const u32*)tlrx,
      (const u32*)try_, rows, W, (u32*)X, (u32*)Y, (u32*)Z);
  return (int)cudaGetLastError();
}

extern "C" int eg_keccak_round(const void* words, int wide, void* state,
                               void* stream) {
  if (wide <= 0) return 0;
  const dim3 grid((unsigned)((wide + KR_COLS - 1) / KR_COLS));
  k_keccak_round<<<grid, EG_THREADS, 0, EG_STREAM(stream)>>>(
      (const u32*)words, wide, (u32*)state);
  return (int)cudaGetLastError();
}
