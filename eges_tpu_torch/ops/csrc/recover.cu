// Nine of the eleven kernels of batched sender recovery (ecrecover) for
// sm_90a; the point table (#6) and the ladder (#9) are in ladder.cu.
//
// Each __global__ replaces one Pallas kernel of
// eges_tpu/ops/pallas_kernels.py (named beside it) over the field
// library of field.cuh, so its results are bit-identical to the
// reference's numpy twins.  fp_canon runs one thread per batch row; the
// prelude, the pow, y_fix, u1u2, the GLV split, fp_mul, the finish and
// keccak_rows (and the point table and the ladder in ladder.cu) run a
// group of T lanes a row (or a column) instead (one instance each for T
// = 1, 2, 4 and 8; ops/kernels.py lanes_for picks T and the block size
// from the row count).  The TPU kernels walked
// windows, table entries and pow digits on a sequential grid axis with
// the running state in VMEM; blocks on Hopper run in no order, so each
// of those walks is a loop inside the thread (or group) here.
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
// byte and are bound by bytes; the other five by integer operations.  All of
// them read each input once, write each output once and keep every
// intermediate in registers (the pow table and the row tiles of the
// prelude, y_fix, u1u2, fp_mul and fp_canon in shared memory).  Those five
// read and write 16-byte vectors through their tiles; against the latency
// of a row's dependent chains, the lane groups put more warps on more SMs.
//
// Each launcher has a plain C interface for ctypes: device pointers and
// the stream arrive as void*, the kernel is queued on that stream, and
// the launcher returns cudaGetLastError() so a refused launch is seen.

#include "launch.cuh"

using namespace eg;

// ---------------------------------------------------------------------------
// row tiles in shared memory
// ---------------------------------------------------------------------------
//
// One thread a row reading its own 16 words at a 64-byte stride made each
// load of a warp touch 32 separate sectors.  The tiled kernels (the
// prelude, y_fix, u1u2, fp_mul, fp_canon) move a block's rows through
// shared memory instead, so device memory is read and written as 16-byte
// vectors, neighbouring threads on neighbouring addresses (ld.global.nc
// in, evict-first out: each byte is touched once).  A block of `threads`
// holds threads / T rows, each row a group of T lanes.  A tile is
// [rows][4] uint4 with chunk c of row r at slot 4r + (c ^ ((r >> 1) & 3)):
// the copy's 8 neighbouring uint4s (two rows) and a row's reads by 8
// neighbouring rows each cover all 32 banks once.  An operand whose
// address is not 16-byte aligned (a view of any contiguous [M, 16]
// tensor; `vec` is 0) is copied a word a thread, still neighbour to
// neighbour; outputs are allocated aligned.

// 16-byte aligned: the tiles are read and written as uint4
extern __shared__ __align__(16) u32 eg_smem[];

static __device__ __forceinline__ int tile_slot(int r, int c) {
  return 4 * r + (c ^ ((r >> 1) & 3));
}

// Rows [0, n) of `a` into the tile ta and, for NOP >= 2, of `b` into tb
// and, for NOP = 3, of `c` into tc (the operands past NOP are not read),
// all loads issued before any is stored.  4 * rows / blockDim.x = 4 / T
// uint4s of each operand a thread (half the threads at T = 8).
template <int T, int NOP>
static __device__ __forceinline__ void tile_in(uint4* ta, uint4* tb,
                                               uint4* tc, const u32* a,
                                               const u32* b, const u32* c,
                                               int n, int vec) {
  static_assert(NOP >= 1 && NOP <= 3, "one to three operands");
  if (vec) {
    constexpr int V = (4 + T - 1) / T;
    const uint4* a4 = reinterpret_cast<const uint4*>(a);
    const uint4* b4 = reinterpret_cast<const uint4*>(b);
    const uint4* c4 = reinterpret_cast<const uint4*>(c);
    uint4 va[V], vb[V], vc[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int i = threadIdx.x + k * blockDim.x;
      if (i < 4 * n) {
        va[k] = __ldg(a4 + i);
        if constexpr (NOP >= 2) vb[k] = __ldg(b4 + i);
        if constexpr (NOP == 3) vc[k] = __ldg(c4 + i);
      }
    }
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int i = threadIdx.x + k * blockDim.x;
      if (i < 4 * n) {
        const int t = tile_slot(i >> 2, i & 3);
        ta[t] = va[k];
        if constexpr (NOP >= 2) tb[t] = vb[k];
        if constexpr (NOP == 3) tc[t] = vc[k];
      }
    }
  } else {
    constexpr int W = 16 / T;
    u32* wa = reinterpret_cast<u32*>(ta);
    u32* wb = reinterpret_cast<u32*>(tb);
    u32* wc = reinterpret_cast<u32*>(tc);
    u32 va[W], vb[W], vc[W];
#pragma unroll
    for (int k = 0; k < W; ++k) {
      const int i = threadIdx.x + k * blockDim.x;
      if (i < 16 * n) {
        va[k] = __ldg(a + i);
        if constexpr (NOP >= 2) vb[k] = __ldg(b + i);
        if constexpr (NOP == 3) vc[k] = __ldg(c + i);
      }
    }
#pragma unroll
    for (int k = 0; k < W; ++k) {
      const int i = threadIdx.x + k * blockDim.x;
      if (i < 16 * n) {
        const int w = 4 * tile_slot(i >> 4, (i >> 2) & 3) + (i & 3);
        wa[w] = va[k];
        if constexpr (NOP >= 2) wb[w] = vb[k];
        if constexpr (NOP == 3) wc[w] = vc[k];
      }
    }
  }
}

static __device__ __forceinline__ void tile_row(u32* o, const uint4* t,
                                                int r) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const uint4 v = t[tile_slot(r, c)];
    o[4 * c] = v.x;
    o[4 * c + 1] = v.y;
    o[4 * c + 2] = v.z;
    o[4 * c + 3] = v.w;
  }
}

// A row's result over its row r of the tile: lane `rank` of its group
// writes chunks rank, rank + T, ... (every lane of the group has read the
// row by then).
template <int T>
static __device__ __forceinline__ void tile_put(uint4* t, int r,
                                                const u32* v, u32 rank) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if (c % T == (int)rank)
      t[tile_slot(r, c)] =
          make_uint4(v[4 * c], v[4 * c + 1], v[4 * c + 2], v[4 * c + 3]);
  }
}

// Rows [0, n) of the tile to `out` (16-byte aligned), evict-first.
template <int T>
static __device__ __forceinline__ void tile_out(u32* out, const uint4* t,
                                                int n) {
  uint4* o4 = reinterpret_cast<uint4*>(out);
  constexpr int V = (4 + T - 1) / T;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int i = threadIdx.x + k * blockDim.x;
    if (i < 4 * n) __stcs(o4 + i, t[tile_slot(i >> 2, i & 3)]);
  }
}

// Bytes [0, len) of `src` into `dst` (shared memory at the same offset
// from a 16-byte boundary as src): the aligned middle in 16-byte
// ld.global.nc loads, a uint4 a thread, four a thread in flight; the head
// before the first boundary and the tail after the last (under 16 bytes
// each) a byte a thread, threads 0-15 and 16-31.  Every byte is loaded
// once (tests/test_torch_lanes.py models it).
static __device__ __forceinline__ void bytes_in(uint8_t* dst,
                                                const uint8_t* src,
                                                int len) {
  const int lead = (int)((16u - (unsigned)((size_t)src & 15u)) & 15u);
  const int head = lead < len ? lead : len;
  const int mid = (len - head) >> 4;  // whole uint4s
  const int tail = len - head - 16 * mid;
  const uint4* s4 = reinterpret_cast<const uint4*>(src + head);
  uint4* d4 = reinterpret_cast<uint4*>(dst + head);
  for (int i0 = threadIdx.x; i0 < mid; i0 += 4 * blockDim.x) {
    uint4 v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = i0 + k * blockDim.x;
      if (i < mid) v[k] = __ldg(s4 + i);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = i0 + k * blockDim.x;
      if (i < mid) d4[i] = v[k];
    }
  }
  const int t = threadIdx.x;
  if (t < head) {
    dst[t] = __ldg(src + t);
  } else if (t >= 16 && t < 16 + tail) {
    const int i = head + 16 * mid + t - 16;
    dst[i] = __ldg(src + i);
  }
}

// #1 recover_prelude_pallas: wire bytes -> r, s, z, v, the x candidate,
// y^2 and the range checks, bound by bytes (425 a row against 2,070
// operations), on a group of T lanes a row (field.cuh
// grp_recover_prelude: y^2's square and product shared).  One thread a
// row read its 97 bytes one at a time at a 65-byte stride and wrote five
// rows of 16 words at a 64-byte stride.  Here the block's signature span,
// bytes [r0 * pitch, r0 * pitch + (n - 1) * pitch + 65) (contiguous for
// any pitch, so rows wider than 65 bytes are read in place), and its hash
// span [32 * r0, 32 * (r0 + n)) come into shared memory (bytes_in: with
// a pitch of 65 a block starts on a 16-byte boundary only when its first
// row is a multiple of 16, so the byte head and tail are the normal
// case); each lane unpacks its row from there.  The five [B, 16] outputs
// leave through tiles laid over the spans (after every lane has unpacked):
// r, s and z before the products, x and y^2 after.  ok and v [B] are
// stored by the group's first lane.  A group past B reads the block's last
// row again and stores its ok and v there, the same words, so no branch
// skips its chain.
constexpr int EG_PRELUDE_MAX_PITCH = 256;  // bytes from one row to the next

// Where the hash span lies in shared memory: past the signature span,
// which starts at most 15 bytes into the tile.
static __host__ __device__ __forceinline__ int prelude_hash_at(int rows,
                                                               int pitch) {
  return ((rows - 1) * pitch + 65 + 15 + 15) & ~15;
}

template <int T>
static __device__ __forceinline__ void prelude_rows(
    const uint8_t* sigs, int pitch, const uint8_t* hashes, int B, u32* x,
    u32* y_sq, u32* ok, u32* r, u32* s, u32* z, u32* v) {
  const EgGroup g = eg_group<T>(B);
  const int rows = blockDim.x / T, lr = threadIdx.x / T;
  const int r0 = blockIdx.x * rows;
  const int n = B - r0 < rows ? B - r0 : rows;
  const int li = lr < n ? lr : n - 1;
  const uint8_t* sg = sigs + (size_t)r0 * pitch;
  const uint8_t* hs = hashes + (size_t)32 * r0;
  uint8_t* smem = reinterpret_cast<uint8_t*>(eg_smem);
  uint8_t* tsig = smem + ((size_t)sg & 15u);
  uint8_t* thash = smem + prelude_hash_at(rows, pitch) + ((size_t)hs & 15u);
  bytes_in(tsig, sg, (n - 1) * pitch + 65);
  bytes_in(thash, hs, 32 * n);
  __syncthreads();
  const uint8_t* row = tsig + li * pitch;
  u32 R[16], S[16], Zh[16];
  unpack_be(R, row);
  unpack_be(S, row + 32);
  unpack_be(Zh, thash + 32 * li);
  const u32 V = row[64];
  __syncthreads();  // the output tiles lie over the spans
  uint4* t = reinterpret_cast<uint4*>(eg_smem);
  const int tw = 4 * rows;  // uint4s a tile
  const size_t o = (size_t)16 * r0;
  tile_put<T>(t, lr, R, g.rank);
  tile_put<T>(t + tw, lr, S, g.rank);
  tile_put<T>(t + 2 * tw, lr, Zh, g.rank);
  __syncthreads();
  tile_out<T>(r + o, t, n);
  tile_out<T>(s + o, t + tw, n);
  tile_out<T>(z + o, t + 2 * tw, n);
  u32 X[16], YS[16];
  const u32 OK = grp_recover_prelude<T>(X, YS, R, S, V, g.rank, g.mask);
  tile_put<T>(t + 3 * tw, lr, X, g.rank);
  tile_put<T>(t + 4 * tw, lr, YS, g.rank);
  if (g.rank == 0) {
    ok[g.in] = OK;
    v[g.in] = V;
  }
  __syncthreads();
  tile_out<T>(x + o, t + 3 * tw, n);
  tile_out<T>(y_sq + o, t + 4 * tw, n);
}

#define EG_PRELUDE_KERNEL(T)                                                \
  extern "C" __global__ void __launch_bounds__(EG_LANES_MAX_THREADS)        \
      k_recover_prelude_t##T(const uint8_t* sigs, int pitch,                \
                             const uint8_t* hashes, int B, u32* x,          \
                             u32* y_sq, u32* ok, u32* r, u32* s, u32* z,    \
                             u32* v) {                                      \
    prelude_rows<T>(sigs, pitch, hashes, B, x, y_sq, ok, r, s, z, v);       \
  }

EG_PRELUDE_KERNEL(1)
EG_PRELUDE_KERNEL(2)
EG_PRELUDE_KERNEL(4)
EG_PRELUDE_KERNEL(8)

// #2 pow_mod_pallas: a^e for a constant e (64 four-bit digits, MSD
// first), relaxed mod P or canonical mod N, on a group of T lanes a row
// (field.cuh grp_fp_mul / grp_fn_mul).  The table a^2..a^15 lives in
// shared memory as [entry][limb pair][row of the block] (two 16-bit
// limbs a word: every product's limbs are below 2^16), written by the
// group's first lane and read by all of its lanes at one address; a^0
// and a^1 come from registers.  The digit is the same on every row, so
// every branch on it is uniform.  The digits come packed into eight
// words, picked by constant index: an array indexed by the window would
// put a copy of them on the stack.
struct PowDigits {
  u32 w[8];  // digit i is bits 28 - 4 * (i % 8) of word i / 8
};

constexpr int POW_TAB_WORDS = 14 * 8;  // a row's table, entries 2..15

static __device__ __forceinline__ u32 pow_digit(const PowDigits& e, int i) {
  const int q = i >> 3;
  u32 word = e.w[0];
#pragma unroll
  for (int k = 1; k < 8; ++k) word = q == k ? e.w[k] : word;
  return (word >> (28 - 4 * (i & 7))) & 15u;
}

template <int T, bool MODN>
static __device__ __forceinline__ void modmul(u32* o, const u32* a,
                                              const u32* b, u32 rank,
                                              u32 mask) {
  if constexpr (MODN)
    grp_fn_mul<T>(o, a, b, rank, mask);
  else
    grp_fp_mul<T>(o, a, b, rank, mask);
}

template <int T, bool MODN>
static __device__ __forceinline__ void pow_rows(const u32* a, u32* out, int M,
                                                const PowDigits& e) {
  const EgGroup g = eg_group<T>(M);
  const int rows = blockDim.x / T, lr = threadIdx.x / T;
  u32* tab = eg_smem + lr;  // word k of the row's table at tab[k * rows]
  u32 A[16], acc[16], t[16];
  load16(A, a + (size_t)16 * g.in);
  copy16(acc, A);
#pragma unroll 1
  for (int i = 0; i < 14; ++i) {
    modmul<T, MODN>(acc, acc, A, g.rank, g.mask);
    if (g.rank == 0) {
#pragma unroll
      for (int k = 0; k < 8; ++k)
        tab[(i * 8 + k) * rows] = acc[2 * k] | (acc[2 * k + 1] << 16);
    }
  }
  __syncwarp(g.mask);
  one16(acc);
#pragma unroll 1
  for (int w = 0; w < 64; ++w) {
#pragma unroll 1
    for (int i = 0; i < 4; ++i) modmul<T, MODN>(acc, acc, acc, g.rank, g.mask);
    const u32 d = pow_digit(e, w);
    if (d == 0) {
      one16(t);
    } else if (d == 1) {
      copy16(t, A);
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const u32 v = tab[((d - 2) * 8 + k) * rows];
        t[2 * k] = v & MASK;
        t[2 * k + 1] = v >> 16;
      }
    }
    modmul<T, MODN>(acc, acc, t, g.rank, g.mask);
  }
  if (g.row < M && g.rank == 0) store16(out + (size_t)16 * g.row, acc);
}

#define EG_POW_KERNELS(T)                                               \
  extern "C" __global__ void __launch_bounds__(EG_LANES_MAX_THREADS)    \
      k_pow_p_t##T(const u32* a, u32* out, int M, PowDigits e) {        \
    pow_rows<T, false>(a, out, M, e);                                   \
  }                                                                     \
  extern "C" __global__ void __launch_bounds__(EG_LANES_MAX_THREADS)    \
      k_pow_n_t##T(const u32* a, u32* out, int M, PowDigits e) {        \
    pow_rows<T, true>(a, out, M, e);                                    \
  }

EG_POW_KERNELS(1)
EG_POW_KERNELS(2)
EG_POW_KERNELS(4)
EG_POW_KERNELS(8)

// #3 y_fix_pallas: after the sqrt pow, root and y^2 [B, 16] (relaxed) and
// v [B] -> y [B, 16], the canonical root with its parity flipped to v & 1,
// and y_ok [B], whether root^2 == y^2; bound by bytes (200 a row against
// 1,094 operations).  One thread a row read its rows at a 64-byte stride
// (32 sectors a warp load) and ran the square alone, on 64 blocks at 8192
// rows.  Here the block's rows of root and y^2 come in through #7's tiles
// and y leaves through one (16-byte accesses; the word path for views off
// 16 bytes), and the square runs on a group of T lanes (field.cuh
// grp_y_fix), the rest whole in every lane.  Every lane stores y_ok, the
// same word; a group past B takes the block's last row again and stores
// the same y_ok there, so no branch skips its chain.  The tile is written
// only after every group has read its rows (those groups read another's).
template <int T>
static __device__ __forceinline__ void y_fix_rows(const u32* root,
                                                  const u32* y_sq,
                                                  const u32* v, int B,
                                                  int vec, u32* y,
                                                  u32* y_ok) {
  const EgGroup g = eg_group<T>(B);
  const int rows = blockDim.x / T, lr = threadIdx.x / T;
  const int r0 = blockIdx.x * rows;
  const int n = B - r0 < rows ? B - r0 : rows;
  const int li = lr < n ? lr : n - 1;
  const size_t o = (size_t)16 * r0;
  uint4* tr = reinterpret_cast<uint4*>(eg_smem);
  uint4* ta = tr + 4 * rows;
  tile_in<T, 2>(tr, ta, nullptr, root + o, y_sq + o, nullptr, n, vec);
  __syncthreads();
  u32 R[16], A[16], Y[16];
  tile_row(R, tr, li);
  tile_row(A, ta, li);
  y_ok[g.in] = grp_y_fix<T>(Y, R, A, v[g.in], g.rank, g.mask);
  __syncthreads();
  tile_put<T>(tr, lr, Y, g.rank);
  __syncthreads();
  tile_out<T>(y + o, tr, n);
}

#define EG_Y_FIX_KERNEL(T)                                                 \
  extern "C" __global__ void __launch_bounds__(EG_LANES_MAX_THREADS)       \
      k_y_fix_t##T(const u32* root, const u32* y_sq, const u32* v, int B,  \
                   int vec, u32* y, u32* y_ok) {                           \
    y_fix_rows<T>(root, y_sq, v, B, vec, y, y_ok);                         \
  }

EG_Y_FIX_KERNEL(1)
EG_Y_FIX_KERNEL(2)
EG_Y_FIX_KERNEL(4)
EG_Y_FIX_KERNEL(8)

// #4 u1u2_pallas: u1 = -(z mod N) * r^-1, u2 = s * r^-1 (canonical mod
// N), bound by operations (5,369 a row against 320 bytes), on a group of
// T lanes a row (field.cuh grp_u1u2): at T >= 2 the first half of the
// group computes u1 and the second u2, each half sharing its product
// over T / 2 lanes; at T = 1 one lane computes both.  One thread a row
// left an 8192-row batch on half the SMs and a 1024-row one on 8 blocks,
// the row's chain alone, and read its rows at a 64-byte stride.  The
// block's rows of z, s and r^-1 come in through a tile each; u1's lanes
// read z and write u1 over it, u2's read s and write u2 over it (no lane
// reads a row another half writes), and both go out 16 bytes a thread.
template <int T>
static __device__ __forceinline__ void u1u2_rows(const u32* z, const u32* s,
                                                 const u32* r_inv, int B,
                                                 int vec, u32* u1, u32* u2) {
  constexpr int H = T > 1 ? T / 2 : 1;  // lanes a product
  const EgGroup g = eg_group<T>(B);
  const int rows = blockDim.x / T, lr = threadIdx.x / T;
  const int r0 = blockIdx.x * rows;
  const int n = B - r0 < rows ? B - r0 : rows;
  const u32 h = g.rank / H;  // the lane's half: 0 u1, 1 u2
  const size_t o = (size_t)16 * r0;
  uint4* tz = reinterpret_cast<uint4*>(eg_smem);
  uint4* ts = tz + 4 * rows;
  uint4* tr = ts + 4 * rows;
  tile_in<T, 3>(tz, ts, tr, z + o, s + o, r_inv + o, n, vec);
  __syncthreads();
  u32 A[16], S[16], RI[16], U1[16], U2[16];
  tile_row(A, h ? ts : tz, lr);  // z, or s in u2's lanes
  tile_row(RI, tr, lr);
  if constexpr (T == 1) tile_row(S, ts, lr);
  grp_u1u2<T>(U1, U2, A, T == 1 ? S : A, RI, g.rank, g.mask);
  if constexpr (T == 1) tile_put<1>(ts, lr, U2, 0u);
  tile_put<H>(h ? ts : tz, lr, U1, g.rank % H);
  __syncthreads();
  tile_out<T>(u1 + o, tz, n);
  tile_out<T>(u2 + o, ts, n);
}

#define EG_U1U2_KERNEL(T)                                                  \
  extern "C" __global__ void __launch_bounds__(EG_LANES_MAX_THREADS)       \
      k_u1u2_t##T(const u32* z, const u32* s, const u32* r_inv, int B,     \
                  int vec, u32* u1, u32* u2) {                             \
    u1u2_rows<T>(z, s, r_inv, B, vec, u1, u2);                             \
  }

EG_U1U2_KERNEL(1)
EG_U1U2_KERNEL(2)
EG_U1U2_KERNEL(4)
EG_U1U2_KERNEL(8)

// #5 glv_digits_pallas: dig [33, 8, Bpad] (rows 0-3: k1, k2 of u1, k1,
// k2 of u2; rows 4-7 zero), neg [8, Bpad].  Groups cover Bpad; the rows
// past B split a zero scalar, as the reference's padded lanes do.  A
// row's two splits are independent dependent chains (six products, four
// reductions, three subtractions and two sign splits each, bound by
// operations), so on a group of T >= 2 lanes the first half of the group
// splits u1 and the second u2, each half sharing its scalar's products
// over its H = T / 2 lanes (field.cuh grp_glv_track<H>); at T = 1 one
// lane splits both, one after the other.  The digits are taken from the
// magnitudes as they are stored, not held in arrays.  The stores are
// split across the lanes, each word's address the same function of the
// row in every group, so they stay coalesced across groups: lane s of a
// half stores magnitude s % 2 (both at H = 1) at the windows w = s / 2
// (mod H / 2), the half's two signs from lanes 0 and 1, and the group's
// lanes share the 136 zero words of rows 4-7, lane `rank` taking the
// words z = rank (mod T).  A group past Bpad (launch.cuh eg_group) splits
// the last row's scalars again and stores the same words there: with no
// branch around the stores, the compiler has no branch to sink the sign
// splits into, and every group issues the whole row.
static __device__ __forceinline__ u32 glv_digit(const u32* v, int w) {
  const int j = GLV_WINDOWS - 1 - w;  // LSD window index
  return (v[j / 4] >> (4 * (j % 4))) & 0xFu;
}

// The words of half h (rows 2h, 2h + 1 and their signs) that its lane s
// stores, row b.
template <int H>
static __device__ __forceinline__ void glv_store(u32* dig, u32* neg,
                                                 int Bpad, int b, int h,
                                                 u32 s, const u32* k1, u32 n1,
                                                 const u32* k2, u32 n2) {
  const size_t win = (size_t)8 * Bpad;  // from one window to the next
  u32* d = dig + (size_t)(2 * h) * Bpad + b;
  u32* ng = neg + (size_t)(2 * h) * Bpad + b;
  if constexpr (H == 1) {
#pragma unroll
    for (int w = 0; w < GLV_WINDOWS; ++w) {
      d[w * win] = glv_digit(k1, w);
      d[w * win + Bpad] = glv_digit(k2, w);
    }
    ng[0] = n1;
    ng[Bpad] = n2;
  } else {
    constexpr int R = H / 2;  // lanes a magnitude
    const u32 i = s & 1u, r = s >> 1;
    u32 v[9];  // |k| < 2^140: the digits are in limbs 0..8
#pragma unroll
    for (int k = 0; k < 9; ++k) v[k] = i ? k2[k] : k1[k];
    d += i * Bpad;
#pragma unroll
    for (int m = 0; R * m < GLV_WINDOWS; ++m) {
      u32 x = glv_digit(v, R * m);
#pragma unroll
      for (int q = 1; q < R; ++q) {
        if (R * m + q < GLV_WINDOWS)
          x = r == (u32)q ? glv_digit(v, R * m + q) : x;
      }
      const int w = R * m + (int)r;
      if (w < GLV_WINDOWS) d[w * win] = x;
    }
    if (r == 0) ng[i * Bpad] = i ? n2 : n1;
  }
}

// Scalar h of the group's row (h ? u2 : u1): its split, shared over the
// H lanes of mask `hmask`, and this lane's share of its words.
template <int H>
static __device__ __forceinline__ void glv_half(const u32* src, int h,
                                                const EgGroup& g, bool live,
                                                u32 s, u32 hmask, int Bpad,
                                                u32* dig, u32* neg) {
  const size_t o = (size_t)16 * (live ? g.in : 0);
  u32 U[16], k1[16], k2[16], n1, n2;
#pragma unroll
  for (int k = 0; k < 16; ++k) U[k] = live ? src[o + k] : 0u;
  grp_glv_track<H>(k1, &n1, k2, &n2, U, s, hmask);
  glv_store<H>(dig, neg, Bpad, g.in, h, s, k1, n1, k2, n2);
}

template <int T>
static __device__ __forceinline__ void glv_rows(const u32* u1, const u32* u2,
                                                int B, int Bpad, u32* dig,
                                                u32* neg) {
  constexpr int H = T > 1 ? T / 2 : 1;  // lanes sharing one scalar
  const EgGroup g = eg_group<T>(Bpad);
  const bool live = g.in < B;
  const u32 s = g.rank % H;
  const u32 lane = threadIdx.x & 31u;
  const u32 hmask = ((1u << H) - 1u) << (lane & ~(u32)(H - 1));
  if constexpr (T == 1) {
    // one after the other, written out: a loop of two this long is not
    // unrolled, and its shortest path would count one split
    glv_half<1>(u1, 0, g, live, s, hmask, Bpad, dig, neg);
    glv_half<1>(u2, 1, g, live, s, hmask, Bpad, dig, neg);
  } else {
    const int h = (int)(g.rank / H);
    glv_half<H>(h ? u2 : u1, h, g, live, s, hmask, Bpad, dig, neg);
  }
  constexpr int Z = 4 * GLV_WINDOWS + 4;  // rows 4-7 of dig, then of neg
#pragma unroll
  for (int m = 0; m < (Z + T - 1) / T; ++m) {
    const int z = T * m + (int)g.rank;
    if (z < 4 * GLV_WINDOWS)
      dig[((size_t)(z >> 2) * 8 + 4 + (z & 3)) * Bpad + g.in] = 0;
    else if (z < Z)
      neg[(size_t)(z - 4 * GLV_WINDOWS + 4) * Bpad + g.in] = 0;
  }
}

#define EG_GLV_KERNEL(T)                                                 \
  extern "C" __global__ void __launch_bounds__(EG_LANES_MAX_THREADS)     \
      k_glv_digits_t##T(const u32* u1, const u32* u2, int B, int Bpad,   \
                        u32* dig, u32* neg) {                            \
    glv_rows<T>(u1, u2, B, Bpad, dig, neg);                              \
  }

EG_GLV_KERNEL(1)
EG_GLV_KERNEL(2)
EG_GLV_KERNEL(4)
EG_GLV_KERNEL(8)

// #7 fp_mul_pallas: the relaxed F_P product of [M, 16] rows, bound by
// bytes (192 a row against 997 operations), through two row tiles (the
// tile section above), each row a group of T lanes (field.cuh
// grp_fp_mul; T = 1 is fp_mul itself).
template <int T>
static __device__ __forceinline__ void fp_mul_rows(const u32* a,
                                                   const u32* b, int M,
                                                   int vec, u32* out) {
  const EgGroup g = eg_group<T>(M);
  const int rows = blockDim.x / T, lr = threadIdx.x / T;
  const int r0 = blockIdx.x * rows;
  const int n = M - r0 < rows ? M - r0 : rows;
  const size_t o = (size_t)16 * r0;
  uint4* ta = reinterpret_cast<uint4*>(eg_smem);
  uint4* tb = ta + 4 * rows;
  tile_in<T, 2>(ta, tb, nullptr, a + o, b + o, nullptr, n, vec);
  __syncthreads();
  u32 A[16], Bv[16], O[16];
  tile_row(A, ta, lr);
  tile_row(Bv, tb, lr);
  grp_fp_mul<T>(O, A, Bv, g.rank, g.mask);
  tile_put<T>(ta, lr, O, g.rank);
  __syncthreads();
  tile_out<T>(out + o, ta, n);
}

#define EG_FP_MUL_KERNEL(T)                                              \
  extern "C" __global__ void __launch_bounds__(EG_LANES_MAX_THREADS)     \
      k_fp_mul_t##T(const u32* a, const u32* b, int M, int vec,          \
                    u32* out) {                                          \
    fp_mul_rows<T>(a, b, M, vec, out);                                   \
  }

EG_FP_MUL_KERNEL(1)
EG_FP_MUL_KERNEL(2)
EG_FP_MUL_KERNEL(4)
EG_FP_MUL_KERNEL(8)

// #8 fp_canon_pallas: relaxed F_P [M, 16] rows -> canonical [0, P), bound
// by bytes (128 a row against 65 operations).  One thread a row reading
// its own 16 words at a 64-byte stride touched 32 sectors a warp load, as
// #7 did; the rows go through #7's tile instead (16-byte ld.global.nc
// in, evict-first out, the word path for a view off 16 bytes), one
// thread a row in blocks of `threads`: the borrow chain is too short to
// share.
extern "C" __global__ void __launch_bounds__(EG_LANES_MAX_THREADS)
k_fp_canon(const u32* a, int M, int vec, u32* out) {
  const int rows = blockDim.x;
  const int r0 = blockIdx.x * rows;
  const int n = M - r0 < rows ? M - r0 : rows;
  const size_t o = (size_t)16 * r0;
  uint4* ta = reinterpret_cast<uint4*>(eg_smem);
  tile_in<1, 1>(ta, nullptr, nullptr, a + o, nullptr, nullptr, n, vec);
  __syncthreads();
  u32 A[16];
  tile_row(A, ta, threadIdx.x);
  cond_sub_p(A, A);
  tile_put<1>(ta, threadIdx.x, A, 0u);
  __syncthreads();
  tile_out<1>(out + o, ta, n);
}

// #10 recover_finish_pallas: qx, qy [B, 16], ok [B], and the keccak
// block words [34, Bpad] (groups cover Bpad; rows past B finish a zero
// point, as the reference's padded lanes do).  Four dependent products
// and three canonicalisations a row: one thread a row left most SMs idle
// and nothing to hide the chain's latency, so a group of T lanes shares
// each product (field.cuh grp_recover_finish).  Lane `rank` stores limbs
// rank, rank + T, ... of qx and qy and the words k = rank (mod T): the
// words are limb-major, so those stores stay coalesced across groups.
template <int T>
static __device__ __forceinline__ void finish_rows(
    const u32* X, const u32* Y, const u32* Z, const u32* zi,
    const u32* ok_in, int B, int Bpad, u32* qx, u32* qy, u32* ok,
    u32* words) {
  const EgGroup g = eg_group<T>(Bpad);
  const bool live = g.in < B;
  const size_t o = (size_t)16 * (live ? g.in : 0);
  u32 Xv[16], Yv[16], Zv[16], ZI[16], QX[16], QY[16], Wd[34];
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    Xv[k] = live ? X[o + k] : 0u;
    Yv[k] = live ? Y[o + k] : 0u;
    Zv[k] = live ? Z[o + k] : 0u;
    ZI[k] = live ? zi[o + k] : 0u;
  }
  const u32 oki = live ? ok_in[g.in] : 0u;
  const u32 OK = grp_recover_finish<T>(QX, QY, Wd, Xv, Yv, Zv, ZI, oki,
                                       g.rank, g.mask);
  const int b = g.row;
  if (b < B) {
    store_split<T>(qx + (size_t)16 * b, QX, g.rank);
    store_split<T>(qy + (size_t)16 * b, QY, g.rank);
    if (g.rank == 0) ok[b] = OK;
  }
  if (b < Bpad) {
#pragma unroll
    for (int k = 0; k < 34; ++k)
      if (k % T == (int)g.rank) words[(size_t)k * Bpad + b] = Wd[k];
  }
}

#define EG_FINISH_KERNEL(T)                                                \
  extern "C" __global__ void __launch_bounds__(EG_LANES_MAX_THREADS)       \
      k_recover_finish_t##T(const u32* X, const u32* Y, const u32* Z,      \
                            const u32* zi, const u32* ok_in, int B,        \
                            int Bpad, u32* qx, u32* qy, u32* ok,           \
                            u32* words) {                                  \
    finish_rows<T>(X, Y, Z, zi, ok_in, B, Bpad, qx, qy, ok, words);        \
  }

EG_FINISH_KERNEL(1)
EG_FINISH_KERNEL(2)
EG_FINISH_KERNEL(4)
EG_FINISH_KERNEL(8)

// #11 keccak_rows_pallas: one Keccak-f[1600] per column of the block
// words [34, wide] -> the digest words [8, wide], bound by operations
// (4,320 a column against 168 bytes), on a group of T lanes a column
// (field.cuh grp_keccak_words; T = 1: keccak_words).  One thread a
// column ran the 24-round chain alone: an 8192-column batch had 256 warps
// (one a scheduler on half the SMs) and a 1024-column one 32, and each
// took about the chain's issue time.  At T >= 2 a pair of lanes shares a
// column's rounds, each holding one half of every lane (lanes past the
// pair repeat it); lane `rank` loads the block words of its half and
// stores the digest words k = rank (mod T).  The words are limb-major, so
// the accesses stay coalesced across groups.  A group past `wide` hashes
// the last column again and stores the same words there, so no branch
// skips its chain and every lane of a warp runs the rounds' shuffles
// together.
template <int T>
static __device__ __forceinline__ void keccak_cols(const u32* words,
                                                   int wide, u32* out) {
  const EgGroup g = eg_group<T>(wide);
  const u32* w = words + g.in;
  u32* o = out + g.in;
  if constexpr (T == 1) {
    u32 in[34], dg[8];
#pragma unroll
    for (int k = 0; k < 34; ++k) in[k] = w[(size_t)k * wide];
    keccak_words(in, dg);
#pragma unroll
    for (int k = 0; k < 8; ++k) o[(size_t)k * wide] = dg[k];
  } else {
    const u32 h = g.rank & 1u;
    u32 in[17], dg[4];
#pragma unroll
    for (int l = 0; l < 17; ++l) in[l] = w[(size_t)(2 * l + h) * wide];
    grp_keccak_words<T>(in, dg, g.rank);  // the whole warp together
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (k % T == (int)g.rank) o[(size_t)k * wide] = dg[k / 2];
  }
}

#define EG_KECCAK_ROWS_KERNEL(T)                                          \
  extern "C" __global__ void __launch_bounds__(EG_LANES_MAX_THREADS)      \
      k_keccak_rows_t##T(const u32* words, int wide, u32* out) {          \
    keccak_cols<T>(words, wide, out);                                     \
  }

EG_KECCAK_ROWS_KERNEL(1)
EG_KECCAK_ROWS_KERNEL(2)
EG_KECCAK_ROWS_KERNEL(4)
EG_KECCAK_ROWS_KERNEL(8)

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

typedef void (*PowKernel)(const u32*, u32*, int, PowDigits);
// instances by lanes: index 0, 1, 2, 3 for T = 1, 2, 4, 8
static const PowKernel POW_P[] = {k_pow_p_t1, k_pow_p_t2, k_pow_p_t4,
                                  k_pow_p_t8};
static const PowKernel POW_N[] = {k_pow_n_t1, k_pow_n_t2, k_pow_n_t4,
                                  k_pow_n_t8};

static int lanes_index(int lanes) {
  return lanes == 1 ? 0 : lanes == 2 ? 1 : lanes == 4 ? 2 : 3;
}

typedef void (*PreludeKernel)(const uint8_t*, int, const uint8_t*, int,
                              u32*, u32*, u32*, u32*, u32*, u32*, u32*);
static const PreludeKernel PRELUDE[] = {
    k_recover_prelude_t1, k_recover_prelude_t2, k_recover_prelude_t4,
    k_recover_prelude_t8};

// The prelude's shared memory: its two spans, then five output tiles over
// them (at most 80 KB, for 256 rows).
static size_t prelude_smem(int rows, int pitch) {
  const size_t in = (size_t)prelude_hash_at(rows, pitch) + 32 * rows + 16;
  const size_t out = (size_t)5 * rows * 64;
  return in > out ? in : out;
}

extern "C" int eg_init(const u32* host_consts, int count) {
  // the pow table of a 256-thread block at one lane a row is 112 KB, and
  // the prelude's tiles of 256 rows 80 KB, past the 48 KB a block gets
  // without asking
  const int most = EG_LANES_MAX_THREADS * POW_TAB_WORDS * 4;
  const int prelude_most = (int)prelude_smem(EG_LANES_MAX_THREADS,
                                             EG_PRELUDE_MAX_PITCH);
  for (int i = 0; i < 4; ++i) {
    if (cudaFuncSetAttribute((const void*)POW_P[i],
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             most) != cudaSuccess ||
        cudaFuncSetAttribute((const void*)POW_N[i],
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             most) != cudaSuccess ||
        cudaFuncSetAttribute((const void*)PRELUDE[i],
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             prelude_most) != cudaSuccess)
      return (int)cudaGetLastError();
  }
  return eg_upload_consts(host_consts, count);
}

// pitch: bytes from one signature row to the next, 65..256; the five
// value outputs must be 16-byte aligned.
extern "C" int eg_recover_prelude(const void* sigs, int pitch,
                                  const void* hashes, int B, void* x,
                                  void* y_sq, void* ok, void* r, void* s,
                                  void* z, void* v, int lanes, int threads,
                                  void* stream) {
  if (B <= 0) return 0;
  if (!eg_lanes_ok(lanes, threads) || pitch < 65 ||
      pitch > EG_PRELUDE_MAX_PITCH ||
      ((size_t)x | (size_t)y_sq | (size_t)r | (size_t)s | (size_t)z) % 16)
    return (int)cudaErrorInvalidValue;
  PRELUDE[lanes_index(lanes)]<<<eg_lanes_grid(B, lanes, threads), threads,
                                prelude_smem(threads / lanes, pitch),
                                EG_STREAM(stream)>>>(
      (const uint8_t*)sigs, pitch, (const uint8_t*)hashes, B, (u32*)x,
      (u32*)y_sq, (u32*)ok, (u32*)r, (u32*)s, (u32*)z, (u32*)v);
  return (int)cudaGetLastError();
}

extern "C" int eg_pow_mod(const void* a, void* out, int M,
                          const unsigned char* digits, int mod_n, int lanes,
                          int threads, void* stream) {
  if (M <= 0) return 0;
  if (!eg_lanes_ok(lanes, threads)) return (int)cudaErrorInvalidValue;
  PowDigits e;
  for (int q = 0; q < 8; ++q) {
    e.w[q] = 0;
    for (int i = 0; i < 8; ++i)
      e.w[q] |= (u32)(digits[8 * q + i] & 15) << (28 - 4 * i);
  }
  const size_t smem = (size_t)(threads / lanes) * POW_TAB_WORDS * 4;
  const PowKernel k = (mod_n ? POW_N : POW_P)[lanes_index(lanes)];
  k<<<eg_lanes_grid(M, lanes, threads), threads, smem, EG_STREAM(stream)>>>(
      (const u32*)a, (u32*)out, M, e);
  return (int)cudaGetLastError();
}

typedef void (*YFixKernel)(const u32*, const u32*, const u32*, int, int,
                           u32*, u32*);
static const YFixKernel Y_FIX[] = {k_y_fix_t1, k_y_fix_t2, k_y_fix_t4,
                                   k_y_fix_t8};

// vec: 1 when root and y_sq are 16-byte aligned; y must be.
extern "C" int eg_y_fix(const void* root, const void* y_sq, const void* v,
                        int B, void* y, void* y_ok, int vec, int lanes,
                        int threads, void* stream) {
  if (B <= 0) return 0;
  if (!eg_lanes_ok(lanes, threads) || (size_t)y % 16 ||
      (vec && ((size_t)root | (size_t)y_sq) % 16))
    return (int)cudaErrorInvalidValue;
  // two tiles of threads / lanes rows: at most 32 KB
  const size_t smem = (size_t)(threads / lanes) * 2 * 64;
  Y_FIX[lanes_index(lanes)]<<<eg_lanes_grid(B, lanes, threads), threads,
                              smem, EG_STREAM(stream)>>>(
      (const u32*)root, (const u32*)y_sq, (const u32*)v, B, vec, (u32*)y,
      (u32*)y_ok);
  return (int)cudaGetLastError();
}

typedef void (*U1u2Kernel)(const u32*, const u32*, const u32*, int, int,
                           u32*, u32*);
static const U1u2Kernel U1U2[] = {k_u1u2_t1, k_u1u2_t2, k_u1u2_t4,
                                  k_u1u2_t8};

// vec: 1 when z, s and r_inv are 16-byte aligned; u1 and u2 must be.
extern "C" int eg_u1u2(const void* z, const void* s, const void* r_inv, int B,
                       void* u1, void* u2, int vec, int lanes, int threads,
                       void* stream) {
  if (B <= 0) return 0;
  if (!eg_lanes_ok(lanes, threads) || ((size_t)u1 | (size_t)u2) % 16 ||
      (vec && ((size_t)z | (size_t)s | (size_t)r_inv) % 16))
    return (int)cudaErrorInvalidValue;
  // three tiles of threads / lanes rows: at most 48 KB
  const size_t smem = (size_t)(threads / lanes) * 3 * 64;
  U1U2[lanes_index(lanes)]<<<eg_lanes_grid(B, lanes, threads), threads, smem,
                             EG_STREAM(stream)>>>(
      (const u32*)z, (const u32*)s, (const u32*)r_inv, B, vec, (u32*)u1,
      (u32*)u2);
  return (int)cudaGetLastError();
}

typedef void (*GlvKernel)(const u32*, const u32*, int, int, u32*, u32*);
static const GlvKernel GLV[] = {k_glv_digits_t1, k_glv_digits_t2,
                                k_glv_digits_t4, k_glv_digits_t8};

extern "C" int eg_glv_digits(const void* u1, const void* u2, int B, int Bpad,
                             void* dig, void* neg, int lanes, int threads,
                             void* stream) {
  if (Bpad <= 0) return 0;
  if (!eg_lanes_ok(lanes, threads) || B <= 0 || B > Bpad)
    return (int)cudaErrorInvalidValue;
  GLV[lanes_index(lanes)]<<<eg_lanes_grid(Bpad, lanes, threads), threads, 0,
                            EG_STREAM(stream)>>>(
      (const u32*)u1, (const u32*)u2, B, Bpad, (u32*)dig, (u32*)neg);
  return (int)cudaGetLastError();
}

typedef void (*FpMulKernel)(const u32*, const u32*, int, int, u32*);
static const FpMulKernel FP_MUL[] = {k_fp_mul_t1, k_fp_mul_t2, k_fp_mul_t4,
                                     k_fp_mul_t8};

// vec: 1 when a and b are 16-byte aligned; out must be.
extern "C" int eg_fp_mul(const void* a, const void* b, int M, void* out,
                         int vec, int lanes, int threads, void* stream) {
  if (M <= 0) return 0;
  if (!eg_lanes_ok(lanes, threads) || (size_t)out % 16 ||
      (vec && ((size_t)a % 16 || (size_t)b % 16)))
    return (int)cudaErrorInvalidValue;
  // two tiles of threads / lanes rows: at most 32 KB
  const size_t smem = (size_t)(threads / lanes) * 2 * 64;
  FP_MUL[lanes_index(lanes)]<<<eg_lanes_grid(M, lanes, threads), threads,
                               smem, EG_STREAM(stream)>>>(
      (const u32*)a, (const u32*)b, M, vec, (u32*)out);
  return (int)cudaGetLastError();
}

// vec: 1 when a is 16-byte aligned; out must be.  One lane a row.
extern "C" int eg_fp_canon(const void* a, int M, void* out, int vec,
                           int threads, void* stream) {
  if (M <= 0) return 0;
  if (!eg_lanes_ok(1, threads) || (size_t)out % 16 || (vec && (size_t)a % 16))
    return (int)cudaErrorInvalidValue;
  // one tile of `threads` rows: at most 16 KB
  k_fp_canon<<<eg_lanes_grid(M, 1, threads), threads, (size_t)threads * 64,
               EG_STREAM(stream)>>>((const u32*)a, M, vec, (u32*)out);
  return (int)cudaGetLastError();
}

typedef void (*FinishKernel)(const u32*, const u32*, const u32*,
                             const u32*, const u32*, int, int, u32*, u32*,
                             u32*, u32*);
static const FinishKernel FINISH[] = {k_recover_finish_t1,
                                      k_recover_finish_t2,
                                      k_recover_finish_t4,
                                      k_recover_finish_t8};

extern "C" int eg_recover_finish(const void* X, const void* Y, const void* Z,
                                 const void* zi, const void* ok_in, int B,
                                 int Bpad, void* qx, void* qy, void* ok,
                                 void* words, int lanes, int threads,
                                 void* stream) {
  if (Bpad <= 0) return 0;
  if (!eg_lanes_ok(lanes, threads) || B <= 0 || B > Bpad)
    return (int)cudaErrorInvalidValue;
  FINISH[lanes_index(lanes)]<<<eg_lanes_grid(Bpad, lanes, threads), threads,
                               0, EG_STREAM(stream)>>>(
      (const u32*)X, (const u32*)Y, (const u32*)Z, (const u32*)zi,
      (const u32*)ok_in, B, Bpad, (u32*)qx, (u32*)qy, (u32*)ok, (u32*)words);
  return (int)cudaGetLastError();
}

typedef void (*KeccakRowsKernel)(const u32*, int, u32*);
static const KeccakRowsKernel KECCAK_ROWS[] = {
    k_keccak_rows_t1, k_keccak_rows_t2, k_keccak_rows_t4, k_keccak_rows_t8};

extern "C" int eg_keccak_rows(const void* words, int wide, void* out,
                              int lanes, int threads, void* stream) {
  if (wide <= 0) return 0;
  if (!eg_lanes_ok(lanes, threads)) return (int)cudaErrorInvalidValue;
  KECCAK_ROWS[lanes_index(lanes)]<<<eg_lanes_grid(wide, lanes, threads),
                                    threads, 0, EG_STREAM(stream)>>>(
      (const u32*)words, wide, (u32*)out);
  return (int)cudaGetLastError();
}
