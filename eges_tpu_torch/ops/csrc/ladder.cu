// #9 strauss_tab, the GLV/Strauss ladder of batched sender recovery and
// classic verify, and #6 point_table, the per-row table d*R it reads, for
// sm_90a: one instance of each kernel of T lanes a row for each build of
// this file (-DEG_LANES=1, 2, 4 or 8; ops/build.py builds all four side
// by side, since each ladder is one function of some thousands of
// inlined products and the slowest thing to build).  Each build has its
// own constants block, its init entry point and its launchers, all
// named by T.
//
// What bounds them on the H100: integer operations, some 2.4 million a
// row for the ladder and 161,000 for the table (ops/opcount.py), in one
// dependent chain; one thread a row leaves most SMs and issue slots idle
// at the batch sizes the node runs, so a group of T lanes shares each
// row's products (field.cuh grp_*) and a batch puts T times the warps on
// the card.

#include "launch.cuh"

#ifndef EG_LANES
#error "ladder.cu is built with -DEG_LANES=1, 2, 4 or 8"
#endif

#define EG_CAT2(a, b) a##b
#define EG_CAT(a, b) EG_CAT2(a, b)
#define EG_NAMED(stem) EG_CAT(stem, EG_LANES)

using namespace eg;

constexpr int LADDER_KEEP_WORDS = 48;  // a row's accumulator copy

extern __shared__ u32 eg_smem[];

// #9 strauss_tab: the 33-window GLV/Strauss ladder u1*G + u2*R on a
// group of T lanes a row (field.cuh grp_jac_double / grp_jac_add_mixed,
// inlined, so the accumulator, the looked-up point and the formulas'
// temporaries stay in registers).  Per window: 4 doublings, then 4
// conditional mixed adds of +-G, +-lambda*G (tables in __constant__
// memory) and +-R, +-lambda*R (per-row tables, row 16*d + k of [256,
// Bpad] = limb k of entry d, loaded directly where the TPU kernel ran
// one-hot selects).  A zero digit discards its add: the add is computed
// all the same, so that no digit parts the groups of a warp (a warp
// whose groups part over the adds runs the rest of the ladder up to
// twice as long), and the accumulator comes back from a copy in shared
// memory (48 words a row), which beside the add in registers would
// spill.  The lanes of a
// group hold one row and take its branches together; groups of one warp
// may part, and their shuffles name only their own lanes.
template <int T>
static __device__ __forceinline__ void strauss_rows(
    const u32* dig, const u32* neg, const u32* trx, const u32* tlrx,
    const u32* try_, int B, int Bpad, int W, u32* X, u32* Y, u32* Z) {
  const EgGroup g = eg_group<T>(B);
  const int b = g.in;
  const int rows = blockDim.x / T;
  u32* keep = eg_smem + threadIdx.x / T;  // word k of the row's copy at
                                          // keep[k * rows]
  u32 x[16], y[16], z[16];
  zero16(x);
  one16(y);
  zero16(z);
#pragma unroll 1
  for (int w = 0; w < W; ++w) {
#pragma unroll 1
    for (int i = 0; i < 4; ++i)
      grp_jac_double<T>(x, y, z, x, y, z, g.rank, g.mask);
#pragma unroll 1
    for (int t = 0; t < 4; ++t) {
      const u32 d = dig[(u32)(w * 8 + t) * (u32)Bpad + b] & 15u;
      if (d == 0) {
#pragma unroll
        for (int k = 0; k < 16; ++k) {
          keep[k * rows] = x[k];
          keep[(16 + k) * rows] = y[k];
          keep[(32 + k) * rows] = z[k];
        }
      }
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
          const u32 row = (16 * d + k) * (u32)Bpad + b;
          px[k] = tx[row];
          py[k] = try_[row];
        }
      }
      if (neg[(u32)t * (u32)Bpad + b]) fp_neg(py, py);
      grp_jac_add_mixed<T>(x, y, z, x, y, z, px, py, g.rank, g.mask);
      if (d == 0) {
#pragma unroll
        for (int k = 0; k < 16; ++k) {
          x[k] = keep[k * rows];
          y[k] = keep[(16 + k) * rows];
          z[k] = keep[(32 + k) * rows];
        }
      }
    }
  }
  if (g.row < B && g.rank == 0) {
    const size_t o = (size_t)16 * g.row;
    store16(X + o, x);
    store16(Y + o, y);
    store16(Z + o, z);
  }
}

extern "C" __global__ void __launch_bounds__(EG_LANES_MAX_THREADS)
EG_NAMED(k_strauss_t)(const u32* dig, const u32* neg, const u32* trx,
                      const u32* tlrx, const u32* try_, int B, int Bpad,
                      int W, u32* X, u32* Y, u32* Z) {
  strauss_rows<EG_LANES>(dig, neg, trx, tlrx, try_, B, Bpad, W, X, Y, Z);
}

extern "C" int EG_NAMED(eg_init_ladder_t)(const u32* host_consts, int count) {
  return eg_upload_consts(host_consts, count);
}

extern "C" int EG_NAMED(eg_strauss_t)(const void* dig, const void* neg,
                                      const void* trx, const void* tlrx,
                                      const void* try_, int B, int Bpad,
                                      int W, void* X, void* Y, void* Z,
                                      int threads, void* stream) {
  if (B <= 0) return 0;
  // the kernel indexes its inputs in 32 bits
  if (!eg_lanes_ok(EG_LANES, threads) || (long long)W * 8 * Bpad >= (1ll << 32) ||
      256ll * Bpad >= (1ll << 32))
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(threads / EG_LANES) * LADDER_KEEP_WORDS * 4;
  EG_NAMED(k_strauss_t)<<<eg_lanes_grid(B, EG_LANES, threads), threads, smem,
                          EG_STREAM(stream)>>>(
      (const u32*)dig, (const u32*)neg, (const u32*)trx, (const u32*)tlrx,
      (const u32*)try_, B, Bpad, W, (u32*)X, (u32*)Y, (u32*)Z);
  return (int)cudaGetLastError();
}

// #6 point_table_pallas: Jacobian d*R for d = 2..15, each of X, Y, Z
// [14, B, 16], on a group of T lanes a row (field.cuh grp_*, inlined: R,
// the running point and the formulas' temporaries stay in registers).
// The TPU kernel walked the 14 entries on a grid axis with the running
// point in VMEM; here they are a loop in the group.  Entry 2R is R + R,
// where the mixed add takes its doubling branch on every row: Z = 1 gives
// x2 * Z^2 and y2 * Z^3 back bit for bit, so H and r are the same
// difference of equal limbs, zero mod P, whatever the relaxed R.  So the
// doubling runs directly.  Entries 3R..15R are 13 mixed adds, each
// group taking its branch as the ladder's adds do (a row meets its own
// point only where it is degenerate: x = 0 rows at some entries).
// Lane `rank` of a group stores limbs rank, rank + T, ... of each value
// (launch.cuh store_split), so a warp's stores cover whole 64-byte rows.
template <int T>
static __device__ __forceinline__ void point_table_rows(
    const u32* px, const u32* py, int B, u32* X, u32* Y, u32* Z) {
  const EgGroup g = eg_group<T>(B);
  u32 PX[16], PY[16], x[16], y[16], z[16];
  load16(PX, px + (size_t)16 * g.in);
  load16(PY, py + (size_t)16 * g.in);
  one16(z);
  grp_jac_double<T>(x, y, z, PX, PY, z, g.rank, g.mask);
#pragma unroll 1
  for (int d = 0; d < 14; ++d) {
    if (d > 0)
      grp_jac_add_mixed<T>(x, y, z, x, y, z, PX, PY, g.rank, g.mask);
    if (g.row < B) {
      const size_t o = ((size_t)d * B + g.row) * 16;
      store_split<T>(X + o, x, g.rank);
      store_split<T>(Y + o, y, g.rank);
      store_split<T>(Z + o, z, g.rank);
    }
  }
}

extern "C" __global__ void __launch_bounds__(EG_LANES_MAX_THREADS)
EG_NAMED(k_point_table_t)(const u32* px, const u32* py, int B, u32* X,
                          u32* Y, u32* Z) {
  point_table_rows<EG_LANES>(px, py, B, X, Y, Z);
}

extern "C" int EG_NAMED(eg_point_table_t)(const void* px, const void* py,
                                          int B, void* X, void* Y, void* Z,
                                          int threads, void* stream) {
  if (B <= 0) return 0;
  if (!eg_lanes_ok(EG_LANES, threads)) return (int)cudaErrorInvalidValue;
  EG_NAMED(k_point_table_t)<<<eg_lanes_grid(B, EG_LANES, threads), threads,
                              0, EG_STREAM(stream)>>>(
      (const u32*)px, (const u32*)py, B, (u32*)X, (u32*)Y, (u32*)Z);
  return (int)cudaGetLastError();
}
