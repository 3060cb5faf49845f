// Flash attention for Hopper (sm_90a): prefill (K5) and one-token decode (K6).
//
// Layouts are the JAX package's: q (B, Hq, S, D) and k, v (B, Hkv, S, D) for
// prefill; q (B, Hq, D), k, v (B, Hkv, S, D) and kv_len (B,) int32 for
// decode.  GQA maps query head h to KV head h / group.  Every operand is
// bf16 with unit stride along D; the other strides (in elements) are
// arguments, so the decode kernel reads the serving engine's
// (B, Smax, Hkv, D) cache in place.  Sums and the softmax run in f32.
//
// --- K5, flash_prefill_kernel -----------------------------------------------
// Replaces repro/kernels/flash_attention.py `_flash_body` + `flash_attention`
// (the pallas_call at line 128): causal, sliding-window or unmasked
// (encoder) attention with an online softmax.
//
// Bound on an H100: a causal prompt of S tokens does 4*Hq*D*S*(S+1)/2
// operations on (2*Hq + 2*Hkv)*S*D*2 bytes, about S/2 operations per byte
// at Hq/Hkv = 8, so from a few hundred tokens on the tensor cores bound it
// (989 TFLOP/s bf16: 0.0152 ms at Hq 16, D 128, S 1918); shorter prompts
// are bound by the bytes.
//
// Design.  The TPU grid walks the key blocks in sequence and carries the
// running max, sum and output in VMEM scratch; on Hopper the blocks run in
// parallel, so a block owns 128 queries of one (b, h) and loops over the
// key tiles itself.  Only Hopper's asynchronous paths reach the tensor
// cores' rate, so the block is warp-specialised.  Its last warp (the
// producer) has one thread that brings Q once, and K and V tiles of 64 keys
// into a ring of 4 slots, by TMA (cp.async.bulk.tensor) with a full
// mbarrier per slot for K and one for V and an empty one that the
// consumers release; the 4-d maps over (D, S, H, B) are built on the host
// for each call from the strides given, so the model's transposed views
// are read in place, and rows past S arrive as zeros.  Two consumer
// warpgroups own 64 query rows each.  S = Q K^T is wgmma m64n64k16 with Q
// and K read from shared memory through descriptors in the 128-byte
// swizzle that TMA wrote (a 128-wide bf16 row is two 64-wide boxes); its
// f32 accumulator stays in registers in the layout of the mma.sync
// fragments (rows g and g + 8, column pairs).  The probabilities, rounded
// to bf16, are the register A operand of O += P V (wgmma m64n128k16); V
// is the B operand read in place through a descriptor with the transpose
// bit (MN-major), so no thread transposes it.  Inside a warpgroup, tile
// i + 1's Q K^T is issued before tile i's P V and its softmax runs while
// that product is in flight (O's rescale waits for it), and the two
// warpgroups take turns to issue their products (two named barriers), so
// that one's softmax runs under the other's wgmmas.  The softmax takes
// raw scores: the max stays in raw units and a probability is
// exp2(s * sl2 - max * sl2), one FFMA and one ex2.  The running max moves
// only when a tile's exceeds it by more than 8 in log2 units, so a
// probability stays below 256 and O is rescaled on a few tiles, not on
// every one.  The row sum adds the rounded probabilities, so the output
// is an exactly normalised mean of V.  The causal, window and `kpos < S`
// masks are evaluated only on the tiles that straddle them (the diagonal,
// the window's first tile, the ragged last one); interior tiles are not
// masked.  Key tiles that no query of the block sees are not loaded
// (`flash_attention.py:56-62`; `k_begin` rounds down to 64), and the
// first warpgroup skips the tile above its own diagonal.  TMA's zero rows
// past S score 0, not -inf, so keys >= S stay masked.  The grid puts
// (b, h) on x and the query tile on y, reversed, so that every head's
// heaviest tiles start first.  The output is staged through the
// warpgroup's own Q rows in shared memory and written 16 bytes a thread.
// Rows that see no key stay zero through the NEG_INF guards
// (`flash_attention.py:81-83`).  Why these sizes: with 288 threads ptxas
// caps a thread at 168 registers (a producer warpgroup with setmaxnreg did
// not lift the cap), and 128-key tiles (64 registers of scores, 32 of P
// and 64 of O) spilled and serialised the wgmmas, so the tiles are 64
// keys; a 64-query block with one consumer warpgroup was slower at 1,918
// tokens and no faster at 245.  Not done yet: no persistent grid, no TMA
// store, no cluster multicast of K and V to the 8 heads of a group, only
// D = 128 instantiated.

// --- K6, flash_decode_kernel + flash_decode_merge_kernel ---------------------
// Replaces repro/kernels/flash_attention.py `_decode_body` +
// `decode_attention` (the pallas_call at line 232): one new token per row
// against a KV cache of which the first kv_len[b] positions are valid.
//
// Bound on an H100: every valid K and V row is read once and each is used
// for 4*group*D operations, 2*group operations per byte, so the bytes
// bound it: sum_b min(kv_len[b], S) * Hkv * D * 4 bytes over 3.35 TB/s.
//
// Design (flash-decoding).  As on the TPU, the GQA group (group <= 16
// query heads sharing one KV head) forms the rows of the product.  One
// block per (b, hkv) would give 16 blocks to 132 SMs at the served batch,
// so the keys are split as well: the grid is (B * Hkv) x ceil(S / split),
// sized from the cache's S and not from kv_len, which lives on the card
// and would cost the host a sync to read.  A block loads its own
// kv_len[b], clamps it to [0, S] (an idle serving slot can count past S,
// and then every position is valid), and takes keys [i * split,
// min((i + 1) * split, len)); a block whose split starts at or past len
// writes an empty partial (max NEG_INF, sum 0) and returns.  Its 4 warps
// take 32-key tiles in turn; each warp issues the cp.async loads of all
// its K and V tiles at once (one commit group per tile, rows past len
// zero-filled), so its loads stay in flight while it multiplies the tiles
// that have arrived.  Q K^T and P V are mma.sync m16n8k16 with K and V
// read by ldmatrix from their [key][D] rows (V with .trans), rows padded
// by 8 bf16 so that ldmatrix hits 32 distinct banks.  The softmax is K5's
// softmax_raw (raw scores, the max moved lazily) and rescale_rows, so the
// file keeps one softmax rule.  The warps' (max, sum, output) are merged
// through shared memory into the block's partial: f32 output rows, their
// max (raw units) and sum, in scratch that the wrapper allocates.  A
// second kernel, launched by the same fa_decode call on the same stream,
// merges each query row's partials in split order (no atomics: two calls
// give the same bytes) and normalises; kv_len = 0 leaves every partial
// empty and gives zeros, as the Pallas kernel does.

#include <cuda.h>  // CUtensorMap and its enums; no libcuda call is linked
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

#define NEG_INF (-1e30f)
#define LOG2E 1.4426950408889634f
#define PAD 8            // bf16 of padding per staged row (bank spread)
#define DEC_WARPS 4
#define DEC_THREADS (DEC_WARPS * 32)
#define DK 32                // decode keys per warp tile
#define DEC_MAX_SPLIT 256    // decode keys per block at most (shared memory)
#define DEC_MAX_SPLITS 1024  // blocks along one cache row at most (merge)


__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats as one bf16x2 register, the lower column in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

#define RESCALE_LOG2 8.f  // K5 moves its running max by more than this only

// K5's online softmax step.  `s` holds raw scores (NEG_INF where masked,
// which only an EDGE tile has) and the max is kept in raw units; a
// probability is exp2(s * sl2 - max * sl2), one FFMA and one MUFU.  The
// running max moves only when a tile's exceeds it by more than
// RESCALE_LOG2 (in log2 units), so a probability is at most
// 2^RESCALE_LOG2, well inside bf16's range, and O is rescaled (a0, a1 not
// 1) only on those few tiles; the result is the same normalised mean.
// Each pair of probabilities is rounded to bf16 once, and the row sum
// adds the rounded values.
template <int NT, bool EDGE>
__device__ __forceinline__ void softmax_raw(float (&s)[NT][4], float sl2,
                                            float& m0, float& m1, float& l0,
                                            float& l1, float& a0, float& a1) {
  float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
    mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
  }
  mx0 = quad_max(mx0);
  mx1 = quad_max(mx1);
  a0 = a1 = 1.f;
  if ((mx0 - m0) * sl2 > RESCALE_LOG2) {
    a0 = m0 <= NEG_INF / 2 ? 0.f : fast_exp2((m0 - mx0) * sl2);
    m0 = mx0;
    l0 *= a0;
  }
  if ((mx1 - m1) * sl2 > RESCALE_LOG2) {
    a1 = m1 <= NEG_INF / 2 ? 0.f : fast_exp2((m1 - mx1) * sl2);
    m1 = mx1;
    l1 *= a1;
  }
  const float b0 = -m0 * sl2, b1 = -m1 * sl2;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; e += 2) {
      const float b = e < 2 ? b0 : b1;
      float x = fast_exp2(fmaf(s[j][e], sl2, b));
      float y = fast_exp2(fmaf(s[j][e + 1], sl2, b));
      if (EDGE) {
        x = s[j][e] <= NEG_INF / 2 ? 0.f : x;
        y = s[j][e + 1] <= NEG_INF / 2 ? 0.f : y;
      }
      const uint32_t xy = pack_bf16(x, y);
      s[j][e] = __uint_as_float(xy << 16);
      s[j][e + 1] = __uint_as_float(xy & 0xffff0000u);
      if (e < 2) l0 += s[j][e] + s[j][e + 1]; else l1 += s[j][e] + s[j][e + 1];
    }
  }
}

template <int NO>
__device__ __forceinline__ void rescale_rows(float (&o)[NO][4], float a0,
                                             float a1) {
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    o[n][0] *= a0;
    o[n][1] *= a0;
    o[n][2] *= a1;
    o[n][3] *= a1;
  }
}

// ------------------------------------------------------- K5: Hopper pieces
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ uint32_t mbar_try_wait(uint32_t bar,
                                                  uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done;
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Wait for the completion of the barrier's phase of this parity.  A wait
// that lasts over a second by the global timer (a lost TMA, a parity slip;
// a real wait lasts microseconds) traps instead of hanging the card, so
// the caller sees a CUDA error.
constexpr uint64_t MBAR_TIMEOUT_NS = 1000000000ull;

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const uint64_t start = global_ns();
  while (!mbar_try_wait(bar, parity)) {
    if (global_ns() - start > MBAR_TIMEOUT_NS) __trap();
  }
}

// One box of a 4-d tensor map (D, S, H, B) into shared memory; the bytes
// are counted on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int d, int s, int h,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d), "r"(s), "r"(h),
      "r"(b)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (all >> 4).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
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
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
}

// d (64 x N, f32) = or += A (64 x 16, shared) B (16 x N, shared, K-major)
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 8][4], uint64_t da,
                                         uint64_t db, int accumulate);
// d (64 x N, f32) += A (64 x 16, bf16 registers) B (16 x N, shared,
// MN-major)
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 8][4],
                                         const uint32_t (&a)[4], uint64_t db);

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[8][4], uint64_t da,
                                          uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[16][4],
                                          const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int D>
struct Prefill {
  static constexpr int NC = 2;                     // consumer warpgroups
  static constexpr int BK = 64;                    // keys per tile
  static constexpr int STAGES = 4;                 // slots of the K/V ring
  static constexpr int BQ = 64 * NC;               // queries per block
  static constexpr int THREADS = 128 * NC + 32;    // + the producer warp
  static constexpr int ROW = 128;                  // bytes of a swizzled row
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;      // one K or V tile
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;
  // q_full, k_full[STAGES], v_full[STAGES], empty[STAGES]; + 1 KB to align
  static constexpr int SMEM = BAR_OFF + 8 * (1 + 3 * STAGES) + 1024;
  static_assert(D % 64 == 0, "a row is whole 64-wide swizzle boxes");
  static_assert(BK == 64, "wgmma_ss is instantiated at N = 64");
  static_assert(SMEM <= 232448, "shared memory of one block");
};

template <int D>
__global__ void __launch_bounds__(Prefill<D>::THREADS, 1)
flash_prefill_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     bf16* __restrict__ o, int S, int Hq, int group,
                     int causal, int window, float scale) {
  using P = Prefill<D>;
  constexpr int NC = P::NC, BK = P::BK, STAGES = P::STAGES, BQ = P::BQ;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // the swizzle's 1 KB atoms
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t sQ = base, sK = base + P::K_OFF, sV = base + P::V_OFF;
  const uint32_t q_full = base + P::BAR_OFF;
  const uint32_t k_full = q_full + 8, v_full = k_full + 8 * STAGES;
  const uint32_t empty = v_full + 8 * STAGES;

  const int h = blockIdx.x % Hq, b = blockIdx.x / Hq, hk = h / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest tiles first
  int k_begin = 0, k_end = S;
  if (causal) k_end = min(S, q0 + BQ);
  if (window > 0) k_begin = max(0, q0 - window + 1) / BK * BK;
  const int n_tiles = (k_end - k_begin + BK - 1) / BK;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(empty + 8 * s, 128 * NC);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == NC) {
    // ------------------------------------------------------------ producer
    if (threadIdx.x == 128 * NC) {
      mbar_expect_tx(q_full, P::Q_BYTES);
      for (int c = 0; c < D / 64; ++c)
        tma_load(sQ + c * BQ * P::ROW, &tq, q_full, c * 64, q0, h, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % STAGES, k0 = k_begin + it * BK;
        mbar_wait(empty + 8 * st, ((it / STAGES) & 1) ^ 1);
        mbar_expect_tx(k_full + 8 * st, P::KV_BYTES);
        for (int c = 0; c < D / 64; ++c)
          tma_load(sK + st * P::KV_BYTES + c * BK * P::ROW, &tk,
                   k_full + 8 * st, c * 64, k0, hk, b);
        mbar_expect_tx(v_full + 8 * st, P::KV_BYTES);
        for (int c = 0; c < D / 64; ++c)
          tma_load(sV + st * P::KV_BYTES + c * BK * P::ROW, &tv,
                   v_full + 8 * st, c * 64, k0, hk, b);
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    const int tid = threadIdx.x % 128, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int q0w = q0 + 64 * wg;
    const int qpos0 = q0w + warp * 16 + g, qpos1 = qpos0 + 8;
    const float sl2 = scale * LOG2E;  // exp(x * scale) = exp2(x * sl2)
    const uint32_t qrows = sQ + wg * 64 * P::ROW;  // this warpgroup's Q rows
    // Q and K are K-major (SBO: 8 rows of 128 bytes; LBO unused); V is
    // MN-major (LBO: from one 64-wide half of D to the next; SBO: 8 keys)
    constexpr uint32_t V_LBO = BK * P::ROW, V_SBO = 1024;

    float acc[D / 8][4];
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;

    // S = Q K^T of one tile into `s`, issued and committed, not waited
    auto qk = [&](float (&s)[BK / 8][4], int it) {
      const uint32_t kt = sK + (it % STAGES) * P::KV_BYTES;
      mbar_wait(k_full + 8 * (it % STAGES), (it / STAGES) & 1);
      wgmma_fence();
      fence_regs(s);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {  // 16 of D at a time
        const uint32_t off = (kk % 4) * 32;  // 16 bf16 inside the swizzled row
        const uint32_t q_at = qrows + (kk / 4) * BQ * P::ROW + off;
        const uint32_t k_at = kt + (kk / 4) * BK * P::ROW + off;
        wgmma_ss<BK>(s, desc_sw128(q_at, 16, 1024), desc_sw128(k_at, 16, 1024),
                     kk > 0);
      }
      wgmma_commit();
    };
    // O += P V of one tile, issued and committed, not waited
    auto pv = [&](const uint32_t (&p)[BK / 16][4], int it) {
      const uint32_t vt = sV + (it % STAGES) * P::KV_BYTES;
      mbar_wait(v_full + 8 * (it % STAGES), (it / STAGES) & 1);
      wgmma_fence();
      fence_regs(acc);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)  // 16 keys at a time
        wgmma_rs<D>(acc, p[kk],
                    desc_sw128(vt + kk * 16 * P::ROW, V_LBO, V_SBO));
      wgmma_commit();
    };
    // the online softmax of one tile's scores, masked only where the tile
    // straddles a mask; returns O's rescale factors in a0, a1
    auto softmax = [&](float (&s)[BK / 8][4], int it, float& a0, float& a1) {
      fence_regs(s);
      const int k0 = k_begin + it * BK;
      const bool edge = (causal && k0 + BK - 1 > q0w) ||
                        (window > 0 && k0 <= q0w + 63 - window) || k0 + BK > S;
      if (edge) {
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kpos = k0 + j * 8 + 2 * t + (e & 1);
            const int qpos = e < 2 ? qpos0 : qpos1;
            const bool ok = kpos < S && (!causal || kpos <= qpos) &&
                            (window <= 0 || kpos > qpos - window);
            if (!ok) s[j][e] = NEG_INF;
          }
        }
        softmax_raw<BK / 8, true>(s, sl2, m0, m1, l0, l1, a0, a1);
      } else {
        softmax_raw<BK / 8, false>(s, sl2, m0, m1, l0, l1, a0, a1);
      }
    };
    auto pack = [&](const float (&s)[BK / 8][4], uint32_t (&p)[BK / 16][4]) {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        p[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
        p[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
        p[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        p[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      }
    };

    // Tile it's P V runs while tile it + 1's scores go through the
    // softmax; O's rescale for tile it + 1 waits for that product.  Under
    // a causal mask a warpgroup's tiles end at its own diagonal.
    auto own_tiles = [&](int w) {
      return causal ? (min(S, q0 + 64 * w + 64) - k_begin + BK - 1) / BK
                    : n_tiles;
    };
    const int n_own = own_tiles(wg);
    // The two warpgroups take turns to issue their products (named
    // barriers 3 and 4, warpgroup 0 first), so that one's softmax runs
    // under the other's wgmmas.  A turn is one issue point: the first
    // Q K^T, each step of the loop, the last P V.  Both take the same
    // number of turns, warpgroup 0 idle ones where it has a tile less, so
    // that every arrival on a barrier meets the other's wait.
    static_assert(NC == 2, "the turns are for two consumer warpgroups");
    int turn = 0;
    const int turns = own_tiles(1) + 1;
    auto begin_turn = [&]() {
      asm volatile("bar.sync %0, 256;\n" ::"r"(3 + wg) : "memory");
    };
    auto end_turn = [&]() {
      if (++turn < turns || wg == 0)
        asm volatile("bar.arrive %0, 256;\n" ::"r"(4 - wg) : "memory");
    };
    if (wg == 1) asm volatile("bar.arrive 3, 256;\n" ::: "memory");
    float s[BK / 8][4], a0, a1;
    uint32_t p[BK / 16][4];
    mbar_wait(q_full, 0);
    begin_turn();
    qk(s, 0);
    end_turn();
    wgmma_wait<0>();
    softmax(s, 0, a0, a1);
    pack(s, p);
    for (int it = 0; it + 1 < n_own; ++it) {
      begin_turn();
      qk(s, it + 1);
      if (__any_sync(0xffffffffu, a0 != 1.f || a1 != 1.f))
        rescale_rows(acc, a0, a1);
      pv(p, it);
      end_turn();
      wgmma_wait<1>();  // the scores of tile it + 1
      softmax(s, it + 1, a0, a1);
      wgmma_wait<0>();  // P V of tile it: its slot is free
      fence_regs(acc);
      mbar_arrive(empty + 8 * (it % STAGES));
      pack(s, p);
    }
    rescale_rows(acc, a0, a1);
    begin_turn();
    pv(p, n_own - 1);
    end_turn();
    while (turn < turns) {
      begin_turn();
      end_turn();
    }
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(empty + 8 * ((n_own - 1) % STAGES));
    // key tiles above this warpgroup's diagonal: nothing to compute, but
    // each slot is released once the producer has filled it
    for (int it = n_own; it < n_tiles; ++it) {
      mbar_wait(v_full + 8 * (it % STAGES), (it / STAGES) & 1);
      mbar_arrive(empty + 8 * (it % STAGES));
    }

    // Normalise and stage the rows in this warpgroup's Q rows (its last
    // wgmma has completed), in the same 128-byte swizzle, then write them
    // out 16 bytes a thread.
    l0 = quad_sum(l0);
    l1 = quad_sum(l1);
    const float inv0 = 1.f / (l0 == 0.f ? 1.f : l0);
    const float inv1 = 1.f / (l1 == 0.f ? 1.f : l1);
    unsigned char* stage = smem + wg * 64 * P::ROW;
    const int r0 = warp * 16 + g;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      unsigned char* box = stage + (n / 8) * BQ * P::ROW;
      const int c = (n % 8) ^ g;  // rows r0 and r0 + 8 are both g mod 8
      *reinterpret_cast<uint32_t*>(box + r0 * P::ROW + c * 16 + 4 * t) =
          pack_bf16(acc[n][0] * inv0, acc[n][1] * inv0);
      *reinterpret_cast<uint32_t*>(box + (r0 + 8) * P::ROW + c * 16 + 4 * t) =
          pack_bf16(acc[n][2] * inv1, acc[n][3] * inv1);
    }
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    bf16* op = o + ((size_t)b * Hq + h) * S * D;
    for (int i = tid; i < 64 * (D / 8); i += 128) {
      const int r = i / (D / 8), n = i % (D / 8);
      if (q0w + r < S) {
        const unsigned char* box = stage + (n / 8) * BQ * P::ROW;
        *reinterpret_cast<uint4*>(op + (size_t)(q0w + r) * D + n * 8) =
            *reinterpret_cast<const uint4*>(box + r * P::ROW +
                                            ((n % 8) ^ (r & 7)) * 16);
      }
    }
  }
}

// ------------------------------------------------------- K6: decode pieces
// 16 bytes global -> shared, zeros where !valid (src-size 0 reads nothing)
__device__ __forceinline__ void cp_async16(const bf16* dst, const bf16* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

// One 32-key tile of a warp: s = Q K^T (raw), masked past `k_hi` when EDGE,
// K5's softmax step, and o += P V.  tk, tv: [DK][LD] K and V rows.
template <int D, bool EDGE>
__device__ __forceinline__ void decode_tile(const uint32_t (&qf)[D / 16][4],
                                            const bf16* tk, const bf16* tv,
                                            int k0, int k_hi, float sl2,
                                            int lane, float& m0, float& m1,
                                            float& l0, float& l1,
                                            float (&o)[D / 8][4]) {
  constexpr int LD = D + PAD;
  const int t = lane & 3, mi = lane >> 3;
  float s[DK / 8][4];
#pragma unroll
  for (int j = 0; j < DK / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int jp = 0; jp < DK / 16; ++jp) {   // keys as B's columns
      uint32_t kf[4];
      ldsm_x4(kf, tk + (16 * jp + (mi >> 1) * 8 + (lane & 7)) * LD + 16 * kk
                      + (mi & 1) * 8);
      mma_bf16(s[2 * jp], qf[kk], kf[0], kf[1]);
      mma_bf16(s[2 * jp + 1], qf[kk], kf[2], kf[3]);
    }
  }
  if (EDGE) {
#pragma unroll
    for (int j = 0; j < DK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (k0 + j * 8 + 2 * t + (e & 1) >= k_hi) s[j][e] = NEG_INF;
  }
  float a0, a1;
  softmax_raw<DK / 8, EDGE>(s, sl2, m0, m1, l0, l1, a0, a1);
  rescale_rows(o, a0, a1);
#pragma unroll
  for (int kk = 0; kk < DK / 16; ++kk) {
    const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                           pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                           pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                           pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {   // V's [key][D] rows, transposed
      uint32_t vf[4];
      ldsm_x4_t(vf, tv + (16 * kk + (mi & 1) * 8 + (lane & 7)) * LD + 16 * dp
                        + (mi >> 1) * 8);
      mma_bf16(o[2 * dp], a, vf[0], vf[1]);
      mma_bf16(o[2 * dp + 1], a, vf[2], vf[3]);
    }
  }
}

// Block (b * Hkv + hkv, i): keys [i * split, min((i + 1) * split, len)) ->
// the partial of split i: part_o (B*Hkv, nsplit, group, D) f32 unnormalised
// rows, part_ml (B*Hkv, nsplit, group, 2) their max (raw units) and sum.
template <int D>
__global__ void __launch_bounds__(DEC_THREADS)
flash_decode_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v,
                    const int* __restrict__ kv_len, float* __restrict__ part_o,
                    float* __restrict__ part_ml, int S, int Hkv, int group,
                    int split, int qsb, int qsh, int ksb, int ksh, int kss,
                    int vsb, int vsh, int vss, float scale) {
  constexpr int LD = D + PAD;
  constexpr int TILE = DK * LD;   // bf16 of one K or V tile
  extern __shared__ __align__(16) unsigned char smem[];
  const int bh = blockIdx.x, sp = blockIdx.y, nsplit = gridDim.y;
  const int b = bh / Hkv, hk = bh % Hkv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int len = min(max(kv_len[b], 0), S);
  const int k_lo = sp * split, k_hi = min(k_lo + split, len);
  float* po = part_o + ((size_t)bh * nsplit + sp) * group * D;
  float* pml = part_ml + ((size_t)bh * nsplit + sp) * group * 2;
  if (k_lo >= k_hi) {   // an empty split
    for (int r = tid; r < group; r += DEC_THREADS) {
      pml[2 * r] = NEG_INF;
      pml[2 * r + 1] = 0.f;
    }
    return;
  }

  // warp w takes tiles w, w + 4, ... of the split: all its loads at once,
  // one commit group per tile
  const int per_warp = split / (DK * DEC_WARPS);
  bf16* sw = reinterpret_cast<bf16*>(smem) + warp * per_warp * 2 * TILE;
  const bf16* kp = k + (size_t)b * ksb + (size_t)hk * ksh;
  const bf16* vp = v + (size_t)b * vsb + (size_t)hk * vsh;
  int ntiles = 0;
  for (int i = 0; i < per_warp; ++i) {
    const int k0 = k_lo + (i * DEC_WARPS + warp) * DK;
    if (k0 >= k_hi) break;
    bf16* tk = sw + i * 2 * TILE;
    for (int u = lane; u < DK * (D / 8); u += 32) {
      const int r = u / (D / 8), c = (u % (D / 8)) * 8;
      const bool ok = k0 + r < k_hi;
      cp_async16(tk + r * LD + c, ok ? kp + (size_t)(k0 + r) * kss + c : k, ok);
      cp_async16(tk + TILE + r * LD + c, ok ? vp + (size_t)(k0 + r) * vss + c : v,
                 ok);
    }
    cp_async_commit();
    ++ntiles;
  }

  // rows g and g + 8 of the A fragment are query heads hk*group + g (+ 8);
  // rows past the group are zero
  const bf16* qp = q + (size_t)b * qsb + (size_t)hk * group * qsh;
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + 2 * t;
    qf[kk][0] = g < group ? ld32(qp + (size_t)g * qsh + c) : 0u;
    qf[kk][1] = g + 8 < group ? ld32(qp + (size_t)(g + 8) * qsh + c) : 0u;
    qf[kk][2] = g < group ? ld32(qp + (size_t)g * qsh + c + 8) : 0u;
    qf[kk][3] = g + 8 < group ? ld32(qp + (size_t)(g + 8) * qsh + c + 8) : 0u;
  }
  const float sl2 = scale * LOG2E;
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
  for (int i = 0; i < ntiles; ++i) {
    if (i + 1 < ntiles) cp_async_wait<1>(); else cp_async_wait<0>();
    __syncwarp();
    const bf16* tk = sw + i * 2 * TILE;
    const int k0 = k_lo + (i * DEC_WARPS + warp) * DK;
    if (k0 + DK > k_hi)
      decode_tile<D, true>(qf, tk, tk + TILE, k0, k_hi, sl2, lane, m0, m1, l0,
                           l1, acc);
    else
      decode_tile<D, false>(qf, tk, tk + TILE, k0, k_hi, sl2, lane, m0, m1, l0,
                            l1, acc);
  }

  // merge the warps' partial softmaxes: smem now holds, per warp and row,
  // its max, its sum and its unnormalised output row
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  __syncthreads();
  float* sm = reinterpret_cast<float*>(smem);  // [DEC_WARPS][16]
  float* sl = sm + DEC_WARPS * 16;             // [DEC_WARPS][16]
  float* so = sl + DEC_WARPS * 16;             // [DEC_WARPS][16][D]
  if (t == 0) {
    sm[warp * 16 + g] = m0;
    sm[warp * 16 + g + 8] = m1;
    sl[warp * 16 + g] = l0;
    sl[warp * 16 + g + 8] = l1;
  }
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    float* r = so + (warp * 16 + g) * D + n * 8 + 2 * t;
    r[0] = acc[n][0];
    r[1] = acc[n][1];
    r[8 * D] = acc[n][2];
    r[8 * D + 1] = acc[n][3];
  }
  __syncthreads();
  for (int i = tid; i < group * D; i += DEC_THREADS) {
    const int r = i / D, d = i % D;
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < DEC_WARPS; ++w) mx = fmaxf(mx, sm[w * 16 + r]);
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int w = 0; w < DEC_WARPS; ++w) {
      const float mw = sm[w * 16 + r];
      if (mw <= NEG_INF / 2) continue;  // this warp saw no key
      const float c = exp2f((mw - mx) * sl2);
      num += so[(w * 16 + r) * D + d] * c;
      den += sl[w * 16 + r] * c;
    }
    po[(size_t)r * D + d] = num;
    if (d == 0) {
      pml[2 * r] = mx;
      pml[2 * r + 1] = den;
    }
  }
}

// One block per query row (b, hq), one thread per column: the row's
// partials summed in split order, then normalised.  o: (B, Hq, D) bf16.
// The splits' (max, sum) are read at once, one split a thread, so that no
// load waits on another.
template <int D>
__global__ void __launch_bounds__(D)
flash_decode_merge_kernel(const float* __restrict__ part_o,
                          const float* __restrict__ part_ml,
                          bf16* __restrict__ o, int Hq, int Hkv, int group,
                          int nsplit, float scale) {
  __shared__ float sw[DEC_MAX_SPLITS];   // weight of each split, 0 if empty
  __shared__ float red[D / 32];
  const int row = blockIdx.x, b = row / Hq, hq = row % Hq;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t first = ((size_t)b * Hkv + hq / group) * nsplit * group + hq % group;
  const float* ml = part_ml + first * 2;              // split i at + i*group*2
  const float* po = part_o + first * D + tid;         // split i at + i*group*D
  const float sl2 = scale * LOG2E;
  float mx = NEG_INF;   // an empty split's max is NEG_INF
  for (int i = tid; i < nsplit; i += D) mx = fmaxf(mx, ml[(size_t)i * group * 2]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  if (lane == 0) red[warp] = mx;
  __syncthreads();
  mx = red[0];
#pragma unroll
  for (int w = 1; w < D / 32; ++w) mx = fmaxf(mx, red[w]);
  for (int i = tid; i < nsplit; i += D) {
    const float l = ml[(size_t)i * group * 2 + 1];
    // an empty split (its rows were not written) weighs 0
    sw[i] = l == 0.f ? 0.f : exp2f((ml[(size_t)i * group * 2] - mx) * sl2);
  }
  __syncthreads();
  float num = 0.f, den = 0.f;
  for (int i = 0; i < nsplit; ++i) {
    const float c = sw[i];
    if (c == 0.f) continue;
    num += po[(size_t)i * group * D] * c;
    den += ml[(size_t)i * group * 2 + 1] * c;
  }
  o[(size_t)row * D + tid] = __float2bfloat16(den > 0.f ? num / den : 0.f);
}

extern "C" const char* sg_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

static int set_smem(const void* fn, int bytes) {
  const cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) cudaGetLastError();  // not sticky: clear it
  return (int)err;
}

// cuTensorMapEncodeTiled, looked up through the runtime so that the library
// links no libcuda of its own
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

static EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = (EncodeTiledFn)p;
    else
      cudaGetLastError();
  }
  return fn;
}

// A (B, H, S, D) bf16 operand with unit stride along D and the other
// strides (in elements) given, as a 4-d map (D, S, H, B) whose box is 64
// of D by `rows` of S in the 128-byte swizzle; rows past S read as zeros.
static bool make_map(CUtensorMap* map, const void* ptr, int B, int H, int S,
                     int D, int sb, int sh, int ss, int rows) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)ss * 2, (cuuint64_t)sh * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
static int launch_prefill(const void* q, const void* k, const void* v, void* o,
                          int B, int Hq, int Hkv, int S, int causal,
                          int window, int qsb, int qsh, int qss, int ksb,
                          int ksh, int kss, int vsb, int vsh, int vss,
                          float scale, cudaStream_t stream) {
  using P = Prefill<D>;
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, B, Hq, S, D, qsb, qsh, qss, P::BQ) ||
      !make_map(&tk, k, B, Hkv, S, D, ksb, ksh, kss, P::BK) ||
      !make_map(&tv, v, B, Hkv, S, D, vsb, vsh, vss, P::BK))
    return (int)cudaErrorInvalidPitchValue;
  const int err = set_smem((const void*)flash_prefill_kernel<D>, P::SMEM);
  if (err) return err;
  const dim3 grid(B * Hq, (S + P::BQ - 1) / P::BQ);
  flash_prefill_kernel<D><<<grid, P::THREADS, P::SMEM, stream>>>(
      tq, tk, tv, (bf16*)o, S, Hq, Hq / Hkv, causal, window, scale);
  return (int)cudaGetLastError();
}

template <int D>
static int launch_decode(const void* q, const void* k, const void* v,
                         const void* kv_len, void* o, void* part_o,
                         void* part_ml, int B, int Hq, int Hkv, int S,
                         int split, int qsb, int qsh, int ksb, int ksh,
                         int kss, int vsb, int vsh, int vss, float scale,
                         cudaStream_t stream) {
  const int group = Hq / Hkv, nsplit = (S + split - 1) / split;
  if (split <= 0 || split % (DK * DEC_WARPS) || split > DEC_MAX_SPLIT ||
      group > 16 || nsplit > DEC_MAX_SPLITS)
    return (int)cudaErrorInvalidValue;
  const int tiles = split * 2 * (D + PAD) * (int)sizeof(bf16);
  const int merge = DEC_WARPS * 16 * (D + 2) * (int)sizeof(float);
  const int bytes = tiles > merge ? tiles : merge;
  const int err = set_smem((const void*)flash_decode_kernel<D>, bytes);
  if (err) return err;
  flash_decode_kernel<D><<<dim3(B * Hkv, nsplit), DEC_THREADS, bytes, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const int*)kv_len,
      (float*)part_o, (float*)part_ml, S, Hkv, group, split, qsb, qsh, ksb,
      ksh, kss, vsb, vsh, vss, scale);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  flash_decode_merge_kernel<D><<<B * Hq, D, 0, stream>>>(
      (const float*)part_o, (const float*)part_ml, (bf16*)o, Hq, Hkv, group,
      nsplit, scale);
  return (int)cudaGetLastError();
}

// o: contiguous (B, Hq, S, D) bf16.  window <= 0 means no window.  Only
// D = 128, the head dim of the dense configs served, is instantiated.
extern "C" int fa_prefill(const void* q, const void* k, const void* v, void* o,
                          int B, int Hq, int Hkv, int S, int D, int causal,
                          int window, int qsb, int qsh, int qss, int ksb,
                          int ksh, int kss, int vsb, int vsh, int vss,
                          float scale, void* stream) {
  cudaGetLastError();
  const cudaStream_t st = (cudaStream_t)stream;
  if (D == 128)
    return launch_prefill<128>(q, k, v, o, B, Hq, Hkv, S, causal, window, qsb,
                               qsh, qss, ksb, ksh, kss, vsb, vsh, vss, scale,
                               st);
  return (int)cudaErrorInvalidValue;
}

// o: contiguous (B, Hq, D) bf16; kv_len: (B,) int32 on the card; part_o
// (B*Hkv, ceil(S / split), Hq / Hkv, D) and part_ml (..., 2) f32 scratch.
// `split` keys per block: a multiple of 128 up to 256.
extern "C" int fa_decode(const void* q, const void* k, const void* v,
                         const void* kv_len, void* o, void* part_o,
                         void* part_ml, int B, int Hq, int Hkv, int S, int D,
                         int split, int qsb, int qsh, int ksb, int ksh,
                         int kss, int vsb, int vsh, int vss, float scale,
                         void* stream) {
  cudaGetLastError();
  const cudaStream_t st = (cudaStream_t)stream;
  if (D == 128)
    return launch_decode<128>(q, k, v, kv_len, o, part_o, part_ml, B, Hq, Hkv,
                              S, split, qsb, qsh, ksb, ksh, kss, vsb, vsh, vss,
                              scale, st);
  return (int)cudaErrorInvalidValue;
}
