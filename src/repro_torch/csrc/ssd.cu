// Mamba-2 SSD chunked scan for Hopper (sm_90a): K7.
//
// Replaces repro/kernels/ssd.py `_ssd_body` + `ssd` (the pallas_call at
// line 77) together with the pre-fusion of its wrapper (repro/kernels/
// ops.py:115-116).  For each (b, h) and chunk of L tokens it computes
//   y_i   = sum_{j<=i} exp(cum_i - cum_j) (C_i . B_j) dtx_j
//           + exp(cum_i) (C_i . s_in)
//   s_out = exp(cum_last) s_in + sum_j exp(cum_last - cum_j) B_j (x) dtx_j
// with dtx = x * dt, cum the inclusive cumsum of dt * A over the chunk and
// s_in the (N, P) state entering the chunk, and also writes the final
// state, which the model's prefill keeps in its cache (the Pallas kernel
// leaves it in VMEM scratch).
//
// Operands, read through their strides (in elements), so the model's
// views into its (B, S, d_inner + 2N) conv output are read in place:
//   x (B, S, H, P) bf16, unit stride along P;   dt (B, S, H) f32;
//   A (H,) f32;   B, C (B, S, N) bf16, unit stride along N.
// Outputs: y (B, S, H, P) bf16 contiguous; state (B, H, N, P) f32
// contiguous.  Only P = 64, N = 128 (mamba2-2.7b) is instantiated; the
// chunk L is SSD_CHUNK (64, 128 or 256), defined by the wrapper
// (kernels/ssd.py CHUNK) in front of this text.
//
// Bound on an H100, at one prompt of S tokens (B = 1, H = 80): the bytes
// are x and y (2 * S*H*P*2), dt (S*H*4), B and C (2 * S*N*2) and the
// final state (H*N*P*4), about 43 MB at S = 1918, 13 us at 3.35 TB/s.
// The products are, per head and chunk, L(L+1)/2 * P multiply-adds inside
// the chunk, L*N*P for C . s_in and L*N*P for the state, plus L(L+1)/2 * N
// per chunk for C B^T (shared by the heads): about 7.5 GFLOP at S = 1918
// and L = 256, 7.6 us at 989 TFLOP/s (bf16).  So the bytes bound it, as
// long as the products run on the tensor cores.
//
// Design.  The TPU grid walks the chunk axis in order and carries the
// state in VMEM scratch.  Here the scan is cut into the four stages of the
// SSD algorithm (Dao & Gu 2024, "Transformers are SSMs"), so that only the
// small state pass (c) walks the chunks in order and every other stage has
// a block per chunk; one call of `ssd_scan` makes three launches on the
// caller's stream.  Scratch (allocated by the wrapper, never here):
// `states` (B, H, nc, N, P) f32, `cums` (B, H, nc*L) f32, `cb` (B, nc,
// T(T+1)/2, 256) f32 and `cfrag` (B, nc, T, N*8) words, T = L / 16.
//   (a) cb_pair, run by the blocks of the (b) launch past its head pairs:
//       C B^T once per chunk (ngroups = 1: every head shares it), only its
//       16 x 16 blocks on or below the diagonal, each stored in the order
//       of the mma.sync accumulator fragments, which is the order of the A
//       fragments that (d) multiplies it in; and the C rows themselves as
//       (d)'s A fragments.  A lane of (d) reads its share of either as
//       16-byte loads, so C needs no room in (d)'s shared memory.
//   (b) ssd_state_kernel, grid (nc, H/2 + pairs of (a), B), 8 warps, two
//       heads a block (they share the chunk's B rows): the cumsum of dt * A
//       over the chunk (log2 units, a block scan; written to `cums`), and
//       each head's own chunk state B^T . (x dt exp(cum_last - cum_j)), the
//       (N, P) f32 sum on the tensor cores, written to `states`.  B and x
//       come in slabs of 64 keys through a ring of two slots, the next
//       slab's copy running under this one's products.
//   (c) ssd_pass_kernel, grid (N*P / 1024, H, B): each thread owns 4
//       state entries and walks the chunks in order, s_in(c+1) =
//       exp(cum_last(c)) s_in(c) + local(c), overwriting local(c) with
//       s_in(c) in place; it loads 8 chunks' states before it chains them,
//       so the loads overlap.  The last s_in is the final state.
//   (d) ssd_out_kernel, grid (nc, H, B), min(L, 128) / 64 warpgroups:
//       x dt, the cumsum and s_in (bf16 hi + lo) once in shared memory;
//       warpgroup w takes the 64-row tiles w and 3 - w at L = 256 (so each
//       multiplies as many key blocks), its warp v the tile's 16 rows v.
//       y = exp(cum_i) (C . s_in) + the decayed scores (from `cb` and
//       `cums`) times x dt, over the key blocks up to the tile's diagonal
//       (a warp's scores above its own rows are zeros).  Below the diagonal
//       block the decay is exp(cum_i - cum_l) exp(cum_l - cum_j), l the key
//       block's last key, both factors <= 1 and the second one per key
//       from shared memory (a quarter of the exps); the diagonal block is
//       masked above the diagonal before the exp.  Both products are
//       wgmma m64n64k16 with A in registers (C's fragments, the scores,
//       made for the next key block while this one's runs) and B (the
//       state's hi and lo parts, x dt) read transposed from shared memory.
//       y leaves through eight staging rows per warp, 16 bytes a lane.
// Loads into shared memory are cp.async (rows past S zero-filled; x up to
// whole 64-row tiles, which the warpgroups multiply whole).  Rows there
// are 64 or 128 bf16 wide without padding, each 16-byte piece k of row r
// stored at k ^ (r % 8): the 128-byte swizzle that wgmma reads, and free
// of bank conflicts for ldmatrix; (b) and (d) fit three blocks an SM (68
// and 75 KB), whose loads run under each other's products.  (b)'s
// products are mma.sync m16n8k16 fed by ldmatrix (.trans where the tile
// lies key-major): its 64 sums a thread spill a few registers at the 85
// that three blocks allow and still ran faster than at two, and as wgmma
// they spilled far more (0.11 ms against 0.031).  Every stage is bound by
// the bytes it moves, at about the card's 3 TB/s (chip_smoke.py phase 5
// prints each stage's time).  Measured and dropped: a state pass chained
// through the (b) blocks (each waiting on a flag of the chunk before) made
// (b) 2.5 times slower; (d) with two heads a block, sharing the C and
// C B^T reads through L1 at one block an SM, was slower than one head at
// three.
// S need not divide by L: tokens past S load as zero with dt = 0, so cum
// stays flat and they add nothing; their y rows are not written, and the
// row blocks of (a) and tiles of (d) that lie past S are skipped (the JAX
// kernel asserts S % chunk == 0 instead).  No stage sums across blocks with atomics: two
// calls give the same bytes.
//
// Rounding.  The products take bf16 operands and sum in f32.  x, B and C
// arrive in bf16 and enter every product unrounded; x * dt, x * dt * w and
// the decayed scores are rounded to bf16, each error a fraction (2^-9) of
// its own term of y.  The state enters C . s_in as hi + lo (~16 bits): a
// state rounded once to bf16, or B * w in place of dtx * w, gives errors
// that do not shrink with C_i . B_j, and a row of y in which those dot
// products cancel then loses several percent of its size (a version that
// did so failed chip_smoke.py's per-row gate at its phase-3 shapes).  C B^T,
// the chunk states, the cumsum and the decays stay f32.  cum_i - cum_j is a
// difference of two f32 numbers that may reach -1e3 inside a chunk (A down
// to -16, dt up to a few units); its absolute error (~1e-4) is a relative
// error of exp's result, as in the JAX formula, and is left so.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

#ifndef SSD_CHUNK
#define SSD_CHUNK 256
#endif
#define CH SSD_CHUNK          // tokens per chunk, L
#define NS 128                // state size N
#define PH 64                 // head dim P
#define LOG2E 1.4426950408889634f
#define PAD 8                 // bf16 of padding per staged row
#define LDN (NS + PAD)        // rows of B and C in shared memory
#define T16 (CH / 16)
#define CB_BLOCKS (T16 * (T16 + 1) / 2)   // 16 x 16 blocks of C B^T kept
#define ST_WARPS 8            // (b): one warp per 16 state rows
#define ST_THREADS (ST_WARPS * 32)
#define PASS_THREADS 256      // (c)
#define D_WARPS (CH < 128 ? CH / 16 : 8)  // (d): warps, in warpgroups of 4
#define NWG (D_WARPS / 4)                 // (d): warpgroups
#define NT64 (CH / 64)                    // (d): 64-row tiles a chunk
#define D_THREADS (D_WARPS * 32)
#define ST_HEADS 2            // (b): heads per block, sharing the B rows
#define SLAB 64               // (b): keys per slot of its ring
#define NSLAB (CH / SLAB)
#define ST_SLOT (SLAB * NS + ST_HEADS * SLAB * PH)   // bf16 per ring slot
#define NSLOT 2               // (b): ring slots (3, or 32-key slabs, ran slower)
#define ST_SMEM (NSLOT * ST_SLOT * (int)sizeof(bf16) \
                 + (2 * ST_HEADS * CH + ST_WARPS * ST_HEADS) * (int)sizeof(float))
#define D_SMEM ((CH * PH + 2 * NS * PH + D_WARPS * 8 * PH) * (int)sizeof(bf16) \
                + 2 * CH * (int)sizeof(float) + 1024)

static_assert(CH == 64 || CH == 128 || CH == 256, "chunks of 64, 128 or 256");
static_assert(ST_WARPS * 16 == NS, "(b): one warp per 16 state rows");
static_assert(ST_THREADS >= CH, "(b): one thread per token of the scan");
static_assert(NS * PH % (4 * PASS_THREADS) == 0, "(c): whole float4 slices");
static_assert(NT64 % NWG == 0 && NT64 / NWG <= 2, "(d): 1 or 2 tiles a warpgroup");
static_assert(NS / 16 == ST_WARPS, "(a): one warp per k-step of C's fragments");
static_assert(144 * LDN * (int)sizeof(bf16) <= ST_SMEM, "(a) fits (b)'s smem");

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, zeros where !valid (src-size 0 reads nothing)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// all but the N newest commit groups of this thread have landed
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 4 bytes global -> shared, zero where !valid
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// Four 8 x 8 bf16 matrices; lane l gives the address of row l % 8 of
// matrix l / 8.  Without .trans register i holds matrix i's (row g,
// columns 2t, 2t+1); with .trans its (rows 2t, 2t+1, column g).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// A fragment of rows r0.., k-step k0.. of a row-major [row][k] tile
__device__ __forceinline__ void ldsm_a_rowmajor(uint32_t (&a)[4], const bf16* s,
                                                int ld, int r0, int k0,
                                                int lane) {
  const int mi = lane >> 3;
  ldsm_x4(a, s + (r0 + (mi & 1) * 8 + (lane & 7)) * ld + k0 + (mi >> 1) * 8);
}

// Rows of W bf16 in shared memory without padding: the 16-byte piece k of
// row r is stored at piece k ^ (r % 8), so that ldmatrix's 8 rows of a
// matrix hit 32 distinct banks.
template <int W>
__device__ __forceinline__ int swz(int row, int col) {
  return row * W + ((((col >> 3) ^ (row & 7)) << 3) | (col & 7));
}

// B fragments of two 8-column tiles (columns c0.., c0 + 8..) of a 16-row
// k-step (rows k0..) of a swizzled row-major [k][column] tile: {b0, b1}
// of the first tile in r[0], r[1], of the second in r[2], r[3]
template <int W>
__device__ __forceinline__ void ldsm_b_swz(uint32_t (&r)[4], const bf16* s,
                                           int k0, int c0, int lane) {
  const int mi = lane >> 3;
  ldsm_x4_t(r, s + swz<W>(k0 + (mi & 1) * 8 + (lane & 7), c0 + (mi >> 1) * 8));
}

// The A fragment of rows m0.., k-step k0.. where A[m][k] = tile[k][m], from
// a swizzled row-major [k][W] tile (B^T from B's rows)
template <int W>
__device__ __forceinline__ void ldsm_a_swz(uint32_t (&a)[4], const bf16* s,
                                           int k0, int m0, int lane) {
  const int mi = lane >> 3;
  ldsm_x4_t(a, s + swz<W>(k0 + (mi >> 1) * 8 + (lane & 7), m0 + (mi & 1) * 8));
}

// wgmma shared-memory descriptor, 128-byte swizzle (the swz<64> layout,
// 1024-byte aligned): start address, leading and stride byte offsets
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// B of k-step k0.. from a swizzled [k][64] tile, read MN-major (transposed)
__device__ __forceinline__ uint64_t desc_b(const bf16* tile, int k0) {
  return desc_sw128(smem_u32(tile + k0 * PH), 8192, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>  // until at most N committed groups are pending
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma
__device__ __forceinline__ void fence_regs(float (&d)[PH / 8][4]) {
#pragma unroll
  for (int j = 0; j < PH / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
}

// d (64 x 64, f32) += A (64 x 16, bf16 registers, the mma.sync A fragment
// of the warp's 16 rows) B (16 x 64, shared, MN-major)
__device__ __forceinline__ void wgmma_rs64(float (&d)[8][4],
                                           const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// ------------------------------------------------------------ (a) C B^T
// Pair (rb, q): rows 16 rb.. of chunk c against keys 128 q.. (warp w the
// 16 keys 128 q + 16 w..), the pairs with q <= rb / 8; run by the blocks
// of the (b) launch past its heads.  smem: 16 + 128 rows of LDN.
__device__ __forceinline__ void cb_pair(const bf16* __restrict__ Bm,
                                        const bf16* __restrict__ Cm,
                                        float* __restrict__ cb,
                                        uint32_t* __restrict__ cfrag, bf16* sC,
                                        int idx, int c, int b, int S, int nc,
                                        int bsb, int bss, int csb, int css) {
  int rb = 0;
  while (idx > rb / 8) idx -= rb / 8 + 1, ++rb;
  const int q = idx;
  const int s0 = c * CH, valid = min(CH, S - s0);
  if (16 * rb >= valid) return;      // rows past S: no (d) block reads them
  bf16* sB = sC + 16 * LDN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bf16* cp = Cm + (size_t)b * csb + (size_t)(s0 + 16 * rb) * css;
  const bf16* bp = Bm + (size_t)b * bsb + (size_t)(s0 + 128 * q) * bss;
  for (int v = tid; v < 16 * NS / 8; v += ST_THREADS) {
    const int r = v / (NS / 8), col = (v % (NS / 8)) * 8;
    const bool ok = 16 * rb + r < valid;
    cp_async16(sC + r * LDN + col, ok ? cp + (size_t)r * css + col : Cm, ok);
  }
  for (int v = tid; v < 128 * NS / 8; v += ST_THREADS) {
    const int r = v / (NS / 8), col = (v % (NS / 8)) * 8;
    const bool ok = 128 * q + r < valid;
    cp_async16(sB + r * LDN + col, ok ? bp + (size_t)r * bss + col : Bm, ok);
  }
  cp_async_wait_all();
  __syncthreads();
  if (q == 0) {   // the C rows as (d)'s A fragments, warp w the k-step w
    uint32_t a[4];
    ldsm_a_rowmajor(a, sC, LDN, 0, 16 * warp, lane);
    *reinterpret_cast<uint4*>(cfrag + (((size_t)b * nc + c) * T16 + rb) * (NS * 8)
                              + (warp * 32 + lane) * 4) = make_uint4(a[0], a[1], a[2], a[3]);
  }
  const int kb = 8 * q + warp;
  if (kb > rb) return;
  float acc0[4] = {0.f, 0.f, 0.f, 0.f}, acc1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int kk = 0; kk < NS / 16; ++kk) {
    uint32_t a[4], bq[4];
    ldsm_a_rowmajor(a, sC, LDN, 0, 16 * kk, lane);
    // keys as the columns of B: [key][n] rows, not transposed
    const int mi = lane >> 3;
    ldsm_x4(bq, sB + (16 * warp + (mi >> 1) * 8 + (lane & 7)) * LDN + 16 * kk
                    + (mi & 1) * 8);
    mma_bf16(acc0, a, bq[0], bq[1]);
    mma_bf16(acc1, a, bq[2], bq[3]);
  }
  float* out = cb + (((size_t)b * nc + c) * CB_BLOCKS + rb * (rb + 1) / 2 + kb)
               * 256 + lane * 8;
  *reinterpret_cast<float4*>(out) = make_float4(acc0[0], acc0[1], acc0[2], acc0[3]);
  *reinterpret_cast<float4*>(out + 4) = make_float4(acc1[0], acc1[1], acc1[2], acc1[3]);
}

// ------------------------------------------- (b) cumsum and chunk states
// Block (c, heads 2 y, 2 y + 1): the two heads share the chunk's B rows,
// which come in slabs of 64 keys through a ring of two slots.
__global__ void __launch_bounds__(ST_THREADS, 3)
ssd_state_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const bf16* __restrict__ Bm,
                 const bf16* __restrict__ Cm, float* __restrict__ states,
                 float* __restrict__ cums, float* __restrict__ cb,
                 uint32_t* __restrict__ cfrag, int S,
                 int H, int nc, int xsb, int xss, int xsh, int dsb, int dss,
                 int dsh, int bsb, int bss, int csb, int css) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int hp = (H + ST_HEADS - 1) / ST_HEADS;
  if ((int)blockIdx.y >= hp) {   // a block of stage (a)
    cb_pair(Bm, Cm, cb, cfrag, reinterpret_cast<bf16*>(smem), blockIdx.y - hp,
            blockIdx.x, blockIdx.z, S, nc, bsb, bss, csb, css);
    return;
  }
  // a slot: [SLAB][NS] B rows, then ST_HEADS x [SLAB][PH] x rows, swizzled
  bf16* ring = reinterpret_cast<bf16*>(smem);
  float* sCum = reinterpret_cast<float*>(ring + NSLOT * ST_SLOT);  // [ST_HEADS][CH]
  float* sD = sCum + ST_HEADS * CH;                            // [ST_HEADS][CH]
  float* sWarp = sD + ST_HEADS * CH;                 // [ST_WARPS][ST_HEADS]
  const int c = blockIdx.x, h0 = blockIdx.y * ST_HEADS, b = blockIdx.z;
  const int nh = min(ST_HEADS, H - h0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int s0 = c * CH, valid = min(CH, S - s0);
  const bf16* bp = Bm + (size_t)b * bsb + (size_t)s0 * bss;
  const bf16* xp = x + (size_t)b * xsb + (size_t)s0 * xss + (size_t)h0 * xsh;
  // one commit group per slab, an empty one past the last
  auto issue = [&](int slab) {
    if (slab < NSLAB) {
      bf16* slot = ring + (slab % NSLOT) * ST_SLOT;
      const int r0 = slab * SLAB;
      for (int v = tid; v < SLAB * NS / 8; v += ST_THREADS) {
        const int r = v / (NS / 8), col = (v % (NS / 8)) * 8;
        const bool ok = r0 + r < valid;
        cp_async16(slot + swz<NS>(r, col), ok ? bp + (size_t)(r0 + r) * bss + col : Bm,
                   ok);
      }
      for (int v = tid; v < ST_HEADS * SLAB * PH / 8; v += ST_THREADS) {
        const int hh = v / (SLAB * PH / 8), u = v % (SLAB * PH / 8);
        const int r = u / (PH / 8), col = (u % (PH / 8)) * 8;
        const bool ok = r0 + r < valid && hh < nh;
        cp_async16(slot + SLAB * NS + swz<PH>(hh * SLAB + r, col),
                   ok ? xp + (size_t)hh * xsh + (size_t)(r0 + r) * xss + col : x, ok);
      }
    }
    cp_async_commit();
  };
  for (int i = 0; i < NSLOT - 1; ++i) issue(i);
  // the cumsum of dt * A over the chunk, thread i on token i: a scan in
  // the warps, then the earlier warps' totals added in order
  float d[ST_HEADS], cum[ST_HEADS];
#pragma unroll
  for (int hh = 0; hh < ST_HEADS; ++hh) {
    d[hh] = tid < valid && hh < nh
                ? dt[(size_t)b * dsb + (size_t)(s0 + tid) * dss + (size_t)(h0 + hh) * dsh]
                : 0.f;
    cum[hh] = d[hh] * (hh < nh ? A[h0 + hh] : 0.f) * LOG2E;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, cum[hh], off);
      if (lane >= off) cum[hh] += u;
    }
    if (lane == 31) sWarp[warp * ST_HEADS + hh] = cum[hh];
  }
  __syncthreads();
#pragma unroll
  for (int hh = 0; hh < ST_HEADS; ++hh) {
    float pre = 0.f;
    for (int w = 0; w < warp; ++w) pre += sWarp[w * ST_HEADS + hh];
    cum[hh] += pre;
    if (tid < CH) {
      sCum[hh * CH + tid] = cum[hh];
      sD[hh * CH + tid] = d[hh];
      if (hh < nh) cums[((size_t)b * H + h0 + hh) * nc * CH + s0 + tid] = cum[hh];
    }
  }
  // local state rows 16 warp.. of each head = B^T . (x dt w), slab by slab
  float acc[ST_HEADS][PH / 8][4];
#pragma unroll
  for (int hh = 0; hh < ST_HEADS; ++hh)
#pragma unroll
    for (int j = 0; j < PH / 8; ++j)
      acc[hh][j][0] = acc[hh][j][1] = acc[hh][j][2] = acc[hh][j][3] = 0.f;
  for (int slab = 0; slab < NSLAB; ++slab) {
    cp_async_wait<NSLOT - 2>();   // slab landed, NSLOT - 2 newer in flight
    __syncthreads();    // ... for every thread, and slab - 1's slot is free
    issue(slab + NSLOT - 1);
    bf16* slot = ring + (slab % NSLOT) * ST_SLOT;
    // x -> x dt w, w = exp(cum_last - cum_j), rounded to bf16
    for (int v = tid; v < ST_HEADS * SLAB * PH / 8; v += ST_THREADS) {
      const int hh = v / (SLAB * PH / 8), u = v % (SLAB * PH / 8);
      const int r = u / (PH / 8), col = (u % (PH / 8)) * 8, j = slab * SLAB + r;
      const float dw = sD[hh * CH + j] * exp2f(sCum[hh * CH + CH - 1] - sCum[hh * CH + j]);
      uint4* q = reinterpret_cast<uint4*>(slot + SLAB * NS + swz<PH>(hh * SLAB + r, col));
      uint4 w4 = *q;
      uint32_t* e = reinterpret_cast<uint32_t*>(&w4);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const __nv_bfloat162 w = *reinterpret_cast<const __nv_bfloat162*>(&e[i]);
        e[i] = pack_bf16(__low2float(w) * dw, __high2float(w) * dw);
      }
      *q = w4;
    }
    __syncthreads();
    if (slab * SLAB < valid) {   // slabs past S are zero
#pragma unroll
      for (int kk = 0; kk < SLAB / 16; ++kk) {
        uint32_t a[4];
        ldsm_a_swz<NS>(a, slot, 16 * kk, 16 * warp, lane);
#pragma unroll
        for (int hh = 0; hh < ST_HEADS; ++hh) {
#pragma unroll
          for (int pj = 0; pj < PH / 16; ++pj) {
            uint32_t bq[4];
            ldsm_b_swz<PH>(bq, slot + SLAB * NS + hh * SLAB * PH, 16 * kk, 16 * pj,
                           lane);
            mma_bf16(acc[hh][2 * pj], a, bq[0], bq[1]);
            mma_bf16(acc[hh][2 * pj + 1], a, bq[2], bq[3]);
          }
        }
      }
    }
  }
  const int n0 = 16 * warp + g;
#pragma unroll
  for (int hh = 0; hh < ST_HEADS; ++hh) {
    if (hh >= nh) break;
    float* so = states + (((size_t)b * H + h0 + hh) * nc + c) * NS * PH;
#pragma unroll
    for (int j = 0; j < PH / 8; ++j) {
      const int p = 8 * j + 2 * t;
      *reinterpret_cast<float2*>(so + n0 * PH + p) = make_float2(acc[hh][j][0], acc[hh][j][1]);
      *reinterpret_cast<float2*>(so + (n0 + 8) * PH + p) =
          make_float2(acc[hh][j][2], acc[hh][j][3]);
    }
  }
}

// -------------------------------------------------------- (c) state pass
#define PASS_BATCH 8
__global__ void __launch_bounds__(PASS_THREADS)
ssd_pass_kernel(float* __restrict__ states, const float* __restrict__ cums,
                float* __restrict__ state_out, int H, int nc) {
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t e = ((size_t)blockIdx.x * PASS_THREADS + threadIdx.x) * 4;
  float* base = states + ((size_t)b * H + h) * nc * NS * PH + e;
  const float* last = cums + ((size_t)b * H + h) * nc * CH + CH - 1;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < nc; c0 += PASS_BATCH) {
    float4 loc[PASS_BATCH];
    float dec[PASS_BATCH];
#pragma unroll
    for (int u = 0; u < PASS_BATCH; ++u) {
      if (c0 + u < nc) {
        loc[u] = *reinterpret_cast<const float4*>(base + (size_t)(c0 + u) * NS * PH);
        dec[u] = exp2f(last[(size_t)(c0 + u) * CH]);
      }
    }
#pragma unroll
    for (int u = 0; u < PASS_BATCH; ++u) {
      if (c0 + u < nc) {
        if (c0 + u > 0)   // chunk 0's (zero) entering state is not read
          *reinterpret_cast<float4*>(base + (size_t)(c0 + u) * NS * PH) = s;
        s.x = dec[u] * s.x + loc[u].x;
        s.y = dec[u] * s.y + loc[u].y;
        s.z = dec[u] * s.z + loc[u].z;
        s.w = dec[u] * s.w + loc[u].w;
      }
    }
  }
  *reinterpret_cast<float4*>(state_out + ((size_t)b * H + h) * NS * PH + e) = s;
}

// ------------------------------------------------------ (d) chunk outputs
// Block (c, h): x, s_in and the cumsum once; warp w then takes the 16-row
// blocks w and 2 D_WARPS - 1 - w (L = 256; w alone for L <= 128), so that
// every warp multiplies as many key blocks.  C's A fragments come from (a)
// in global memory, y goes out from the registers: no barrier after the
// prologue.
__global__ void __launch_bounds__(D_THREADS, 3)
ssd_out_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
               const uint32_t* __restrict__ cfrag,
               const float* __restrict__ states,
               const float* __restrict__ cums, const float* __restrict__ cb,
               bf16* __restrict__ y, int S, int H, int nc, int xsb, int xss,
               int xsh, int dsb, int dss, int dsh) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the swizzled tiles start on 1024 bytes, as wgmma's descriptors ask
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  bf16* sX = reinterpret_cast<bf16*>(smem);   // [CH][PH] x, then x dt
  bf16* sHi = sX + CH * PH;                   // [NS][PH] s_in, bf16 hi
  bf16* sLo = sHi + NS * PH;                  // [NS][PH] and lo parts
  bf16* sY = sLo + NS * PH;                   // [D_WARPS][8][PH] y rows out
  float* sCum = reinterpret_cast<float*>(sY + D_WARPS * 8 * PH);   // [CH]
  float* sDt = sCum + CH;   // [CH] dt, then w_j = exp(cum_(j|15) - cum_j)
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int s0 = c * CH, valid = min(CH, S - s0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // s_in's loads first (registers), then every copy into shared memory
  constexpr int NV = NS * PH / 4 / D_THREADS;   // s_in float4s a thread
  float4 f[NV];
  if (c > 0) {   // chunk 0 enters with a zero state
    const float4* sp = reinterpret_cast<const float4*>(
        states + (((size_t)b * H + h) * nc + c) * NS * PH);
#pragma unroll
    for (int k = 0; k < NV; ++k) f[k] = sp[tid + k * D_THREADS];
  }
  // whole 64-row tiles: a warpgroup multiplies every key block of its tile
  const int nkeys = (valid + 63) / 64 * 64;
  const bf16* xp = x + (size_t)b * xsb + (size_t)s0 * xss + (size_t)h * xsh;
  for (int v = tid; v < nkeys * PH / 8; v += D_THREADS) {
    const int r = v / (PH / 8), col = (v % (PH / 8)) * 8;
    const bool ok = r < valid;
    cp_async16(sX + swz<PH>(r, col), ok ? xp + (size_t)r * xss + col : x, ok);
  }
  const float* cum_p = cums + ((size_t)b * H + h) * nc * CH + s0;
  for (int i = tid; i < CH / 4; i += D_THREADS) cp_async16(sCum + 4 * i, cum_p + 4 * i, true);
  const float* dp = dt + (size_t)b * dsb + (size_t)s0 * dss + (size_t)h * dsh;
  for (int i = tid; i < CH; i += D_THREADS)
    cp_async4(sDt + i, i < valid ? dp + (size_t)i * dss : dt, i < valid);
  if (c > 0) {   // s_in as bf16 hi + lo
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int e = 4 * (tid + k * D_THREADS), n = e / PH, p = e % PH;
      const float h0 = __bfloat162float(__float2bfloat16(f[k].x));
      const float h1 = __bfloat162float(__float2bfloat16(f[k].y));
      const float h2 = __bfloat162float(__float2bfloat16(f[k].z));
      const float h3 = __bfloat162float(__float2bfloat16(f[k].w));
      *reinterpret_cast<uint2*>(sHi + swz<PH>(n, p)) =
          make_uint2(pack_bf16(h0, h1), pack_bf16(h2, h3));
      *reinterpret_cast<uint2*>(sLo + swz<PH>(n, p)) =
          make_uint2(pack_bf16(f[k].x - h0, f[k].y - h1),
                     pack_bf16(f[k].z - h2, f[k].w - h3));
    }
  }
  cp_async_wait_all();
  __syncthreads();
  // x -> x dt, rounded to bf16
  for (int v = tid; v < nkeys * PH / 8; v += D_THREADS) {
    const int r = v / (PH / 8), col = (v % (PH / 8)) * 8;
    const float d = sDt[r];
    uint4* q = reinterpret_cast<uint4*>(sX + swz<PH>(r, col));
    uint4 u = *q;
    uint32_t* e = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 w = *reinterpret_cast<const __nv_bfloat162*>(&e[i]);
      e[i] = pack_bf16(__low2float(w) * d, __high2float(w) * d);
    }
    *q = u;
  }
  __syncthreads();
  // each key's decay to the last key of its 16-key block (<= 1)
  for (int i = tid; i < CH; i += D_THREADS) sDt[i] = exp2f(sCum[i | 15] - sCum[i]);
  __syncthreads();
  const float* sW = sDt;

  bf16* yp = y + (((size_t)b * S + s0) * H + h) * PH;
  bf16* sy = sY + warp * 8 * PH;
  // warpgroup wg takes the 64-row tiles wg and 2 NWG - 1 - wg (L = 256;
  // wg alone for L <= 128); warp wig of it the tile's 16-row block wig
  const int wg = warp >> 2, wig = warp & 3;
#pragma unroll 1
  for (int k = 0; k < NT64 / NWG; ++k) {
    const int tile = k % 2 == 0 ? k * NWG + wg : (k + 1) * NWG - 1 - wg;
    if (64 * tile >= valid) continue;   // the same in the whole warpgroup
    const int rb = 4 * tile + wig, i0 = 16 * rb;
    float acc[PH / 8][4];
#pragma unroll
    for (int j = 0; j < PH / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    const int ia = i0 + g, ib = ia + 8;
    const float ca = sCum[ia], cbv = sCum[ib];
    if (c > 0) {   // exp(cum_i) (C . (hi + lo)); rows past S read garbage C
      const uint4* cf = reinterpret_cast<const uint4*>(
          cfrag + (((size_t)b * nc + c) * T16 + rb) * (NS * 8)) + lane;
      uint32_t cq[NS / 16][4];
#pragma unroll
      for (int kk = 0; kk < NS / 16; ++kk) {
        const uint4 u = cf[kk * 32];
        cq[kk][0] = u.x;
        cq[kk][1] = u.y;
        cq[kk][2] = u.z;
        cq[kk][3] = u.w;
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < NS / 16; ++kk) {
        wgmma_rs64(acc, cq[kk], desc_b(sHi, 16 * kk));
        wgmma_rs64(acc, cq[kk], desc_b(sLo, 16 * kk));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      const float ea = exp2f(ca), eb = exp2f(cbv);
#pragma unroll
      for (int j = 0; j < PH / 8; ++j) {
        acc[j][0] *= ea;
        acc[j][1] *= ea;
        acc[j][2] *= eb;
        acc[j][3] *= eb;
      }
    }
    // + (C B^T exp(cum_i - cum_j), j <= i) . x dt over the key blocks up
    // to the tile's diagonal (zeros above a warp's own); the C B^T
    // fragments come from (a), one block ahead; two A buffers, so the
    // next block's scores are made while this one's wgmma runs
    const float* cbp = cb + (((size_t)b * nc + c) * CB_BLOCKS + rb * (rb + 1) / 2) * 256
                       + lane * 8;
    float4 u0 = *reinterpret_cast<const float4*>(cbp);
    float4 u1 = *reinterpret_cast<const float4*>(cbp + 4);
    auto step = [&](uint32_t (&a)[4], int kb) {
      const float4 f0 = u0, f1 = u1;
      if (kb < rb) {
        u0 = *reinterpret_cast<const float4*>(cbp + (kb + 1) * 256);
        u1 = *reinterpret_cast<const float4*>(cbp + (kb + 1) * 256 + 4);
      }
      wgmma_wait<1>();   // the wgmma that read a, two blocks back
      const int ja = 16 * kb + 2 * t, jb = ja + 1, jc = ja + 8, jd = ja + 9;
      if (kb < rb) {   // exp(cum_i - cum_j) = exp(cum_i - cum_l) exp(cum_l - cum_j),
                       // l the block's last key: both factors <= 1
        const float cl = sCum[16 * kb + 15];
        const float ra = exp2f(ca - cl), rbb = exp2f(cbv - cl);
        const float wa = sW[ja], wb = sW[jb], wc = sW[jc], wd = sW[jd];
        a[0] = pack_bf16(f0.x * ra * wa, f0.y * ra * wb);
        a[1] = pack_bf16(f0.z * rbb * wa, f0.w * rbb * wb);
        a[2] = pack_bf16(f1.x * ra * wc, f1.y * ra * wd);
        a[3] = pack_bf16(f1.z * rbb * wc, f1.w * rbb * wd);
      } else if (kb == rb) {   // the diagonal block: masked before the exp
        const float cja = sCum[ja], cjb = sCum[jb], cjc = sCum[jc], cjd = sCum[jd];
        a[0] = pack_bf16(ja <= ia ? f0.x * exp2f(ca - cja) : 0.f,
                         jb <= ia ? f0.y * exp2f(ca - cjb) : 0.f);
        a[1] = pack_bf16(ja <= ib ? f0.z * exp2f(cbv - cja) : 0.f,
                         jb <= ib ? f0.w * exp2f(cbv - cjb) : 0.f);
        a[2] = pack_bf16(jc <= ia ? f1.x * exp2f(ca - cjc) : 0.f,
                         jd <= ia ? f1.y * exp2f(ca - cjd) : 0.f);
        a[3] = pack_bf16(jc <= ib ? f1.z * exp2f(cbv - cjc) : 0.f,
                         jd <= ib ? f1.w * exp2f(cbv - cjd) : 0.f);
      } else {         // keys past the warp's rows
        a[0] = a[1] = a[2] = a[3] = 0u;
      }
      wgmma_fence();
      wgmma_rs64(acc, a, desc_b(sX, 16 * kb));
      wgmma_commit();
    };
    uint32_t a0[4], a1[4];
    const int kend = 4 * tile + 3;   // the tile's last key block
    int kb = 0;
    for (; kb < kend; kb += 2) {
      step(a0, kb);
      step(a1, kb + 1);
    }
    if (kb == kend) step(a0, kb);
    wgmma_wait<0>();
    fence_regs(acc);
    // y out through the warp's 8 staging rows (piece k of row r at k ^ r),
    // 16 bytes a lane: rows ia, then rows ib
#pragma unroll
    for (int half = 0; half < 2; ++half) {
#pragma unroll
      for (int j = 0; j < PH / 8; ++j)
        *reinterpret_cast<uint32_t*>(sy + swz<PH>(g, 8 * j + 2 * t)) =
            pack_bf16(acc[j][2 * half], acc[j][2 * half + 1]);
      __syncwarp();
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int r = 4 * k + (lane >> 3), col = 8 * (lane & 7);
        const int i = i0 + 8 * half + r;
        if (i < valid)
          *reinterpret_cast<uint4*>(yp + (size_t)i * H * PH + col) =
              *reinterpret_cast<const uint4*>(sy + swz<PH>(r, col));
      }
      __syncwarp();
    }
  }
}

extern "C" const char* sg_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// The chunk L this library was built for.
extern "C" int ssd_chunk() { return CH; }

// y: contiguous (B, S, H, P) bf16; state: contiguous (B, H, N, P) f32;
// states, cums, cb: the scratch of the header note, for nc = ceil(S / L)
// chunks of L = `chunk` (which must be this build's).  Strides in
// elements; x, B and C need unit stride along P or N and 16-byte aligned
// rows.
extern "C" int ssd_scan(const void* x, const void* dt, const void* A,
                        const void* Bm, const void* Cm, void* y, void* state,
                        void* states, void* cums, void* cb, void* cfrag,
                        int Bsz, int S,
                        int H, int P, int N, int chunk, int xsb, int xss,
                        int xsh, int dsb, int dss, int dsh, int bsb, int bss,
                        int csb, int css, void* stream) {
  cudaGetLastError();
  if (P != PH || N != NS || chunk != CH || S < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)ssd_state_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      ST_SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute((const void*)ssd_out_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, D_SMEM);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  const cudaStream_t st = (cudaStream_t)stream;
  const int nc = (S + CH - 1) / CH;
  int pairs = 0;   // (16-row block, 128-key group) pairs of (a)
  for (int rb = 0; rb < T16; ++rb) pairs += rb / 8 + 1;
  const int hp = (H + ST_HEADS - 1) / ST_HEADS;
  ssd_state_kernel<<<dim3(nc, hp + pairs, Bsz), ST_THREADS, ST_SMEM, st>>>(
      (const bf16*)x, (const float*)dt, (const float*)A, (const bf16*)Bm,
      (const bf16*)Cm, (float*)states, (float*)cums, (float*)cb,
      (uint32_t*)cfrag, S, H, nc, xsb, xss, xsh, dsb, dss, dsh, bsb, bss, csb,
      css);
  ssd_pass_kernel<<<dim3(NS * PH / (4 * PASS_THREADS), H, Bsz), PASS_THREADS, 0,
                    st>>>((float*)states, (const float*)cums, (float*)state, H,
                          nc);
  ssd_out_kernel<<<dim3(nc, H, Bsz), D_THREADS, D_SMEM, st>>>(
      (const bf16*)x, (const float*)dt, (const uint32_t*)cfrag,
      (const float*)states, (const float*)cums, (const float*)cb, (bf16*)y, S,
      H, nc, xsb, xss, xsh, dsb, dss, dsh);
  return (int)cudaGetLastError();
}
