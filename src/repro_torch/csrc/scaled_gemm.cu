// Block-scaled GEMM for Hopper (sm_90a): C = dequant(A) @ dequant(B).
//
// A (M, K) and B (K, N) hold fp8 e4m3 (or int8) values, row-major; a_scale
// (M, K/128) has one f32 scale per (row, 128-K block), b_scale (K/128,
// ceil(N/128)) one per 128x128 block; the sum is kept in f32.
//
// Replaces these TPU kernels of the JAX package:
//   blocked_kernel  <- repro/core/codegen.py `_BLOCKED_BODY` (both pallas_calls,
//                      split-K and not) and repro/kernels/scaled_gemm.py
//                      `scaled_gemm` (`_kernel_body`);
//   monolith_kernel <- repro/core/codegen.py `_MONOLITH_BODY` and
//                      repro/kernels/scaled_gemm.py `naive_scaled_gemm`.
//
// Bound on an H100: at the challenge shapes (M >= 1024, K up to 7168) the
// product does 2*M*N*K operations on (M*K + K*N) bytes of input, far above
// the card's ~590 operations per byte at the fp8 rate, so the tensor cores
// bound it.  fp8 e4m3 and int8 values are exact inputs of the fp8 and int8
// tensor cores, so under `scale_acc` the least time is 2MNK / 1979 TFLOP/s
// (TOP/s for int8): 0.0912 ms at 6144x7168x2048.  `dequant_inputs` in bf16
// multiplies rounded bf16 values (989 TFLOP/s); the f32 compute type runs
// on the FMA units (67 TFLOP/s).
//
// Two blocked kernels live here.  The caller picks one with the WGMMA_PATH
// define and, on the wgmma path, sets the ring's depth with RING_STAGES:
// kernels/scaled_gemm.py `blocked_defines` owns the rule and the shared-
// memory formula.  This text only refuses, with static_asserts, a wgmma
// build that it cannot run; nothing falls back from one kernel to the other.
//
// --- The wgmma path (WGMMA_PATH 1) -------------------------------------------
// The genome family the campaign evolves: bf16 compute type, `scale_acc`,
// a tile of one, two or four 64x128 sub-tiles (64x128, 128x128, 256x128,
// 64x256, 128x256), fp8 or int8 storage, any BLOCK_K, k_split, grid order
// and output type.
//
// Design.  The TPU grid walks K in sequence and carries the sum in VMEM
// scratch; here a persistent grid of at most one block per SM walks the
// work units (output tile, split-K slice) in the genome's order (mn: N
// fastest, as the TPU grid; nm: M fastest) and loops over the slice's K
// itself, keeping its f32 sums in registers, so that one tile's epilogue
// overlaps the next tile's loads.  Each block is warp-specialised:
// * Producer: one thread of warp 0 brings each 128-K block of the tile by
//   TMA into a ring of RING_STAGES stages guarded by mbarriers: A as
//   BLOCK_M rows of 128 bytes in the 128-byte swizzle (one swizzle row is
//   exactly one scale block of one row), B as it lies, 128 rows of K by 128
//   bytes of N per box.  N need not divide by BLOCK_N (only by 16): TMA
//   reads B past N as zeros and the epilogue writes no column past N.
// * Transposers: wgmma reads 8-bit operands from shared memory only
//   K-major, and B arrives N-major (the JAX contract), so warps 1-3 turn
//   each stage's B into K-major rows in the 128-byte swizzle: a thread
//   reads 16 rows of 4 bytes, transposes four 4x4 byte blocks with byte
//   permutes (prmt) and writes 4 rows of 16 bytes; the lane-to-block map
//   keeps both the reads and the writes free of bank conflicts.  No byte of
//   A or B is read from device memory twice for that, and nothing derived
//   from the operands outlives a call.
// * Consumers: one or two warpgroups; the tile's 64x128 sub-tiles are dealt
//   to them in turn.  Per 128-K block a consumer issues four wgmma
//   m64n128k32 (e4m3 x e4m3 -> f32, or s8 x s8 -> exact s32) per sub-tile
//   into a partial accumulator, waits for them, and adds partial *
//   a_scale[row, kb] * b_scale[kb, col / 128] to its f32 totals in K order:
//   `scale_acc` exactly, and the sum is promoted out of the tensor cores'
//   short internal accumulation every 128 K.  The accumulator layout is
//   mma.sync's m16n8 per 8 columns, so each register's row is known; a
//   thread reads its two rows' scales and the sub-tile's column-block scale
//   through L1/L2.  Registers: the producer warpgroup gives its registers
//   away (setmaxnreg 40) so that a consumer may hold 232: two sub-tiles of
//   totals and one partial.
// * Serialised wgmmas: ptxas serialises them (warning C7518) around control
//   flow it cannot prove uniform.  So every mbarrier wait is one asm block
//   with its 1 s global-timer trap inside (a lost TMA or a parity slip
//   becomes a CUDA error instead of a hung card), and the sub-tiles always
//   divide evenly between the consumers (1, 2 or 4 of them), so no consumer
//   tests whether it has one.
// * Epilogue: each 64x128 sub-tile goes through the consumer's 16 KB of
//   shared memory (16-byte chunks XOR-swizzled by row) and out in 16-byte
//   stores.  Under split-K each slice writes its f32 partial (ks, M, N) and
//   the caller sums them in slice order (no atomics, so every verdict is
//   reproducible).
// Shared memory: RING_STAGES stages of 128 * (BLOCK_M + 2 * BLOCK_N) bytes
// (A, B as it came, B transposed) with three mbarriers each, 16 KB of
// output staging per consumer and 1 KB to align to the swizzle's atoms; the
// caller makes the ring as deep as fits in 227 KB (at most 8 stages), so
// BLOCK_K sets only the split-K slicing and the padding of K.
//
// --- The mma.sync path (WGMMA_PATH 0) ----------------------------------------
// Every other blocked genome: the f32 compute type (the naive seed, which
// stays naive on purpose), `dequant_inputs`, and every other tile (192x128
// among them).  Each block owns one (BLOCK_M, BLOCK_N) output tile and loops
// over K itself.  Per BLOCK_K slab the block stages A and B in shared
// memory, converted once from the storage type to the compute type (raw
// values for scale_acc, value*scale for dequant_inputs, rounded to the
// compute type as the JAX kernel rounds them); B is stored transposed, and
// each row is padded so that the fragment loads hit 32 distinct banks.
// bf16 products go through the tensor cores with mma.sync m16n8k16 (bf16
// in, f32 out), whose register layout is fixed, so scale_acc can scale each
// 128-K partial by its row and column-block scale in registers.  Split-K
// runs `ks` slices of the K loop as grid z, with the same f32 partials as
// above.  grid_order picks whether blockIdx.x walks N (mn) or M (nm).  A
// tile that needs more shared memory than a block may have is refused at
// launch, which the platform reports as a compile error.
//
// monolith_kernel.  The TPU kernel is one grid step that holds all of A,
// B and their scales in VMEM, dequantizes both to f32 and takes one f32
// dot over the whole K; where the problem does not fit VMEM the compiler
// refuses it.  Its Hopper form keeps that function and that refusal but
// not the single block: sg_monolith computes the footprint one block would
// need to hold the problem, 4*(M*K/128 + K/128*ceil(N/128)) + M*K + K*N
// bytes, and returns cudaErrorInvalidValue before any launch where it
// exceeds the card's opt-in shared memory per block (the stand-in for the
// VMEM limit, which the platform reports as a compile error).  What fits
// is at most ~227 KB of operands, a few tens of MFLOP: 256^3 is 33.6
// MFLOP on 0.26 MB in and out, bound by the f32 FMA rate (67 TFLOP/s:
// 0.0005 ms), so a launch's few microseconds are the floor.  So the
// output is spread over the card in MONO_TILE x MONO_TILE tiles, one block
// each (64 blocks at 256^3); per 128-deep K slab a block dequantizes its
// rows of A and its columns of B into shared memory once (to_f32(x) *
// scale in f32, rounded as the one block rounded it), and each of its
// threads sums a 4 x 4 micro-tile with f32 FMAs in K order.  Each A
// element is dequantized once per tile column and each B element once per
// tile row, not once per output.  Not done: no double buffering (there
// are at most a few slabs).

#include <cuda.h>  // CUtensorMap and its enums; no libcuda call is linked
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <stdint.h>

#ifndef BLOCK_M
#define BLOCK_M 128
#endif
#ifndef BLOCK_N
#define BLOCK_N 128
#endif
#ifndef BLOCK_K
#define BLOCK_K 128
#endif
#ifndef STORAGE_INT8
#define STORAGE_INT8 0
#endif
#ifndef COMPUTE_BF16
#define COMPUTE_BF16 1
#endif
#ifndef SCALE_ACC
#define SCALE_ACC 1
#endif
#ifndef GRID_NM
#define GRID_NM 0
#endif
#ifndef OUT_F32
#define OUT_F32 0
#endif
#ifndef WGMMA_PATH
#error "WGMMA_PATH (which blocked kernel) comes from the caller"
#endif

#define SCALE_BLOCK 128
#define SMEM_OPTIN 232448  // what one H100 block may opt into (227 KB)

#define MONO_TILE 32     // monolith: output rows and columns per block
#define MONO_SLAB 128    // K staged per step
#define MONO_THREADS (MONO_TILE * MONO_TILE / 16)  // 4 x 4 outputs each

static_assert(BLOCK_N % SCALE_BLOCK == 0, "BLOCK_N must divide by 128");
static_assert(BLOCK_K % SCALE_BLOCK == 0, "BLOCK_K must divide by 128");

__device__ __forceinline__ float to_f32(uint8_t x) {
#if STORAGE_INT8
  return (float)(int8_t)x;
#else
  __half_raw h = __nv_cvt_fp8_to_halfraw((__nv_fp8_storage_t)x, __NV_E4M3);
  return __half2float(__half(h));
#endif
}

#if WGMMA_PATH
// ------------------------------------------------------------ the wgmma path
#ifndef RING_STAGES
#error "RING_STAGES (the ring's depth) comes with WGMMA_PATH from the caller"
#endif
#define WG_TM (BLOCK_M / 64)                  // 64-row strips of a tile
#define WG_SUBS (WG_TM * (BLOCK_N / 128))     // 64x128 sub-tiles
#define WG_NC (WG_SUBS == 1 ? 1 : 2)          // consumer warpgroups
#define WG_SPW (WG_SUBS / WG_NC)              // sub-tiles per consumer
#define WG_THREADS (128 * (WG_NC + 1))
#define TRANSPOSE_WARPS 3                     // warps 1-3 of warpgroup 0
#define A_BYTES (BLOCK_M * 128)               // one 128-K block of A
#define B_BYTES (BLOCK_N * 128)               // one 128-K block of B
#define STAGE_BYTES (A_BYTES + 2 * B_BYTES)   // A, B as it came, B transposed
#define OUT_BYTES (64 * 256)                  // a consumer's output staging
// stages with three mbarriers each, the consumers' output staging, 1 KB to
// align to the swizzle's atoms
#define SMEM_BYTES (RING_STAGES * (STAGE_BYTES + 24) + WG_NC * OUT_BYTES + 1024)

// what this kernel can run
static_assert(COMPUTE_BF16 && SCALE_ACC,
              "the wgmma path multiplies the stored 8-bit values: bf16 "
              "compute type and scale_acc only");
static_assert(BLOCK_M % 64 == 0 && (BLOCK_N == 128 || BLOCK_N == 256),
              "the wgmma path's tile is made of 64x128 sub-tiles");
static_assert(WG_SUBS == 1 || WG_SUBS == 2 || WG_SUBS == 4,
              "the sub-tiles must divide evenly between the consumers, at "
              "most two each");
static_assert(RING_STAGES >= 2, "the ring needs two stages");
static_assert(SMEM_BYTES <= SMEM_OPTIN, "the ring does not fit one block");

#if STORAGE_INT8
typedef int acc_t;  // s8 x s8 sums are exact in s32
#else
typedef float acc_t;
#endif

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

// Wait for the completion of the barrier's phase of this parity.  A wait
// that lasts over a second by the global timer (a real one lasts
// microseconds) traps.  The whole loop is one asm block: a loop in C++ is
// control flow that ptxas cannot prove uniform, and a consumer waits here
// while its previous products are in flight.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .u64 t0, t1;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "mov.u64 t0, %%globaltimer;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "mov.u64 t1, %%globaltimer;\n"
      "sub.u64 t1, t1, t0;\n"
      "setp.gt.u64 p, t1, 1000000000;\n"
      "@p trap;\n"
      "bra WAIT;\n"
      "DONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// One box of a 2-d tensor map into shared memory; the bytes are counted
// on `bar`.  c0 is the inner (contiguous) coordinate.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
      "r"(c1)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major operand in the 128-byte
// swizzle: start address, 8 rows of 128 bytes between row groups
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma
__device__ __forceinline__ void fence_regs(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void fence_regs(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

#define WG_R8(c, d, i)                                                  \
  c(d[i]), c(d[i + 1]), c(d[i + 2]), c(d[i + 3]), c(d[i + 4]),          \
      c(d[i + 5]), c(d[i + 6]), c(d[i + 7])
#define WG_R64(c, d)                                                    \
  WG_R8(c, d, 0), WG_R8(c, d, 8), WG_R8(c, d, 16), WG_R8(c, d, 24),     \
      WG_R8(c, d, 32), WG_R8(c, d, 40), WG_R8(c, d, 48), WG_R8(c, d, 56)
#define WG_D64                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "  \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "   \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "   \
  "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "   \
  "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// d (64 x 128) = or += A (64 x 32, shared) B (32 x 128, shared), both
// K-major 8-bit
__device__ __forceinline__ void wgmma_k32(float (&d)[64], uint64_t da,
                                          uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.f32.e4m3.e4m3 " WG_D64
      ", %64, %65, p, 1, 1;\n}\n"
      : WG_R64("+f", d)
      : "l"(da), "l"(db), "r"(accumulate));
}
__device__ __forceinline__ void wgmma_k32(int (&d)[64], uint64_t da,
                                          uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " WG_D64
      ", %64, %65, p;\n}\n"
      : WG_R64("+r", d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// unit u -> output tile (bi, bj) and split-K slice; consecutive units walk
// N fastest (mn, as the TPU grid) or M fastest (nm)
__device__ __forceinline__ void unit_coords(int u, int tm, int tn, int& bi,
                                            int& bj, int& slice) {
  const int t = u % (tm * tn);
  slice = u / (tm * tn);
#if GRID_NM
  bi = t % tm;
  bj = t / tm;
#else
  bj = t % tn;
  bi = t / tn;
#endif
}

__global__ void __launch_bounds__(WG_THREADS, 1)
blocked_kernel(const __grid_constant__ CUtensorMap ta,
               const __grid_constant__ CUtensorMap tb,
               const float* __restrict__ As, const float* __restrict__ Bs,
               void* __restrict__ out, int M, int N, int K, int kbs, int ks) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t out_stage = base + RING_STAGES * STAGE_BYTES;
  const uint32_t full = out_stage + WG_NC * OUT_BYTES;   // TMA landed
  const uint32_t tfull = full + 8 * RING_STAGES;         // B transposed
  const uint32_t empty = tfull + 8 * RING_STAGES;        // stage consumed
  const int tm = M / BLOCK_M, tn = (N + BLOCK_N - 1) / BLOCK_N;
  const int units = tm * tn * ks;

  if (threadIdx.x == 0) {
    for (int s = 0; s < RING_STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(tfull + 8 * s, TRANSPOSE_WARPS);
      mbar_init(empty + 8 * s, 128 * WG_NC);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  if (wg == 0) {
#if WG_NC == 2
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
#endif
    if (warp == 0) {
      // ---------------------------------------------------------- producer
      if (lane != 0) return;
      int it = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        int bi, bj, slice;
        unit_coords(u, tm, tn, bi, bj, slice);
        for (int kb = slice * kbs; kb < (slice + 1) * kbs; ++kb, ++it) {
          const int s = it % RING_STAGES;
          mbar_wait(empty + 8 * s, ((it / RING_STAGES) & 1) ^ 1);
          const uint32_t st = base + s * STAGE_BYTES;
          mbar_expect_tx(full + 8 * s, A_BYTES + B_BYTES);
          tma_load_2d(st, &ta, full + 8 * s, kb * SCALE_BLOCK, bi * BLOCK_M);
#pragma unroll
          for (int h = 0; h < BLOCK_N / 128; ++h)
            tma_load_2d(st + A_BYTES + h * 128 * 128, &tb, full + 8 * s,
                        bj * BLOCK_N + h * 128, kb * SCALE_BLOCK);
        }
      }
      return;
    }
    // ------------------------------------------------------- transposers
    // B arrives as 128 rows of K by 128 bytes of N per box (no swizzle);
    // wgmma wants it K-major: row n of 128 bytes of K, 16-byte chunk c at
    // c ^ (n & 7) (the 128-byte swizzle).  Lane l takes the columns
    // n = 4l .. 4l + 3 of a box and, in turn w, the rows k = 16 i .. 16 i
    // + 15 with i = (l ^ w) & 7: its 4-byte reads of a row hit bank l, and
    // the eight lanes of each quarter warp write eight distinct chunks.
    int it = 0;
    const uint32_t swz = 4 * (lane & 1);  // (n & 7) = swz + j
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      int bi, bj, slice;
      unit_coords(u, tm, tn, bi, bj, slice);
      for (int kb = slice * kbs; kb < (slice + 1) * kbs; ++kb, ++it) {
        const int s = it % RING_STAGES;
        mbar_wait(full + 8 * s, (it / RING_STAGES) & 1);
        const uint32_t rawb = base + s * STAGE_BYTES + A_BYTES;
        const uint32_t bt = rawb + B_BYTES;
        for (int w = warp - 1; w < 8 * (BLOCK_N / 128); w += TRANSPOSE_WARPS) {
          const int h = w / 8, i = (lane ^ w) & 7;
          const uint32_t src = rawb + h * 128 * 128 + i * 16 * 128 + 4 * lane;
          uint32_t v[16], o[4][4];  // o[j][b]: column 4l + j, rows 16 i + 4b..
#pragma unroll
          for (int r = 0; r < 16; ++r)
            asm volatile("ld.shared.b32 %0, [%1];\n"
                         : "=r"(v[r])
                         : "r"(src + r * 128));
#pragma unroll
          for (int b = 0; b < 4; ++b) {  // a 4x4 byte transpose
            const uint32_t* x = v + 4 * b;
            const uint32_t t0 = __byte_perm(x[0], x[1], 0x5140);
            const uint32_t t1 = __byte_perm(x[0], x[1], 0x7362);
            const uint32_t t2 = __byte_perm(x[2], x[3], 0x5140);
            const uint32_t t3 = __byte_perm(x[2], x[3], 0x7362);
            o[0][b] = __byte_perm(t0, t2, 0x5410);
            o[1][b] = __byte_perm(t0, t2, 0x7632);
            o[2][b] = __byte_perm(t1, t3, 0x5410);
            o[3][b] = __byte_perm(t1, t3, 0x7632);
          }
          const uint32_t row = bt + (h * 128 + 4 * lane) * 128;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            asm volatile(
                "st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                    row + j * 128 + ((i ^ swz ^ j) << 4)),
                "r"(o[j][0]), "r"(o[j][1]), "r"(o[j][2]), "r"(o[j][3])
                : "memory");
        }
        // the wgmmas read this stage through the async proxy
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        __syncwarp();
        if (lane == 0) mbar_arrive(tfull + 8 * s);
      }
    }
    return;
  }

  // ------------------------------------------------------------ consumers
#if WG_NC == 2
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
#endif
  const int c = wg - 1, g = lane >> 2, t = lane & 3;
  const int kbt = K / SCALE_BLOCK, nbt = (N + SCALE_BLOCK - 1) / SCALE_BLOCK;
  float acc[WG_SPW][64];
  acc_t part[64];
  int it = 0;
  // this thread's rows g and g + 8 of sub-tile j, their scales for k-block
  // kb times the sub-tile's column-block scale, read through L1/L2
  auto scales = [&](int j, int m0, int n0, int kb, float (&sc)[2]) {
    const int r0 = m0 + (j % WG_TM) * 64 + warp * 16 + g;
    // a column block wholly past N (its B is zeros) reads the last scale
    const float bs = __ldg(Bs + (size_t)kb * nbt
                           + min(n0 / 128 + j / WG_TM, nbt - 1));
    sc[0] = __ldg(As + (size_t)r0 * kbt + kb) * bs;
    sc[1] = __ldg(As + (size_t)(r0 + 8) * kbt + kb) * bs;
  };
  // the products of sub-tile j on stage `itx` into `part`, issued and
  // committed
  auto issue = [&](int j, int itx) {
    const int s = itx % RING_STAGES;
    mbar_wait(full + 8 * s, (itx / RING_STAGES) & 1);
    mbar_wait(tfull + 8 * s, (itx / RING_STAGES) & 1);
    const uint32_t st = base + s * STAGE_BYTES;
    const uint32_t a_at = st + (j % WG_TM) * 64 * 128;
    const uint32_t b_at = st + A_BYTES + B_BYTES + (j / WG_TM) * 128 * 128;
    wgmma_fence();
    fence_regs(part);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)  // 32 bytes of K inside the row
      wgmma_k32(part, desc_sw128(a_at + 32 * kk), desc_sw128(b_at + 32 * kk),
                kk > 0);
    wgmma_commit();
  };
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    int bi, bj, slice;
    unit_coords(u, tm, tn, bi, bj, slice);
    const int m0 = bi * BLOCK_M, n0 = bj * BLOCK_N;
#pragma unroll
    for (int i = 0; i < WG_SPW; ++i)
#pragma unroll
      for (int e = 0; e < 64; ++e) acc[i][e] = 0.f;
    for (int kb = slice * kbs; kb < (slice + 1) * kbs; ++kb, ++it) {
      float sc[WG_SPW][2];
#pragma unroll
      for (int i = 0; i < WG_SPW; ++i) scales(c + WG_NC * i, m0, n0, kb, sc[i]);
#pragma unroll
      for (int i = 0; i < WG_SPW; ++i) {
        issue(c + WG_NC * i, it);
        wgmma_wait_all();
        fence_regs(part);
        // totals += partial x scales: scale_acc, in K order
#pragma unroll
        for (int e = 0; e < 64; ++e)
          acc[i][e] = fmaf((float)part[e], sc[i][(e >> 1) & 1], acc[i][e]);
      }
      mbar_arrive(empty + 8 * (it % RING_STAGES));
    }
    // Epilogue, one sub-tile at a time through the consumer's 16 KB of
    // staging: its rows g and g + 8 of the warp's 16, column pairs 2t and
    // 2t + 1 of each 8, go into 256-byte rows with the 16-byte chunks
    // XOR-swizzled by the row (no bank conflicts), then each thread stores
    // 16 contiguous bytes (256 bytes of a row per 16 threads).  bf16 goes
    // out in one pass, f32 (the output or a split-K slice's partial) in two
    // halves of 64 columns.
    const int tid = threadIdx.x % 128, rl = warp * 16 + g;
    const uint32_t stg = out_stage + c * OUT_BYTES;
    auto sync_wg = [&]() {
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + c) : "memory");
    };
#pragma unroll
    for (int i = 0; i < WG_SPW; ++i) {
      const int j = c + WG_NC * i;
      const size_t r0 = m0 + (j % WG_TM) * 64;
      const int c0 = n0 + (j / WG_TM) * 128;
      if (ks > 1 || OUT_F32) {
        float* dst = (float*)out + (size_t)slice * M * N;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          sync_wg();  // the staging's last reads are done
#pragma unroll
          for (int n = 0; n < 8; ++n) {
            const float* a = &acc[i][4 * (8 * h + n)];
            const uint32_t at = (((2 * n + (t >> 1)) ^ ((2 * g) & 7)) << 4)
                                + (t & 1) * 8;
            asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n"
                         ::"r"(stg + rl * 256 + at), "f"(a[0]), "f"(a[1])
                         : "memory");
            asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n"
                         ::"r"(stg + (rl + 8) * 256 + at), "f"(a[2]),
                         "f"(a[3])
                         : "memory");
          }
          sync_wg();
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            const int id = tid + 128 * q, row = id >> 4, cc = id & 15;
            uint4 v;
            asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                         : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                         : "r"(stg + row * 256
                               + ((cc ^ ((2 * row) & 7)) << 4)));
            if (c0 + 64 * h + 4 * cc < N)
              *(uint4*)&dst[(r0 + row) * N + c0 + 64 * h + 4 * cc] = v;
          }
        }
      } else {
        sync_wg();
#pragma unroll
        for (int n = 0; n < 16; ++n) {
          const uint32_t at = ((n ^ g) << 4) + 4 * t;
          const __nv_bfloat162 lo = __floats2bfloat162_rn(
              acc[i][4 * n], acc[i][4 * n + 1]);
          const __nv_bfloat162 hi = __floats2bfloat162_rn(
              acc[i][4 * n + 2], acc[i][4 * n + 3]);
          asm volatile("st.shared.b32 [%0], %1;\n"
                       ::"r"(stg + rl * 256 + at),
                       "r"(*(const uint32_t*)&lo)
                       : "memory");
          asm volatile("st.shared.b32 [%0], %1;\n"
                       ::"r"(stg + (rl + 8) * 256 + at),
                       "r"(*(const uint32_t*)&hi)
                       : "memory");
        }
        sync_wg();
        __nv_bfloat16* dst = (__nv_bfloat16*)out;
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int id = tid + 128 * q, row = id >> 4, cc = id & 15;
          uint4 v;
          asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                       : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                       : "r"(stg + row * 256 + ((cc ^ (row & 7)) << 4)));
          if (c0 + 8 * cc < N) *(uint4*)&dst[(r0 + row) * N + c0 + 8 * cc] = v;
        }
      }
    }
  }
}

#else
// --------------------------------------------------------- the mma.sync path
#define THREADS 256
#define N_SUB (BLOCK_K / SCALE_BLOCK)
#define NB_BLK (BLOCK_N / SCALE_BLOCK)

#if COMPUTE_BF16
typedef __nv_bfloat16 tile_t;
#define PAD 8
#else
typedef float tile_t;
#define PAD 1
#endif
#define LDT (BLOCK_K + PAD)
#define SMEM_BYTES ((BLOCK_M + BLOCK_N) * LDT * (int)sizeof(tile_t) \
                    + BLOCK_M * N_SUB * 4 + N_SUB * NB_BLK * 4)

static_assert(BLOCK_M % 16 == 0, "BLOCK_M must divide by 16");

__device__ __forceinline__ tile_t to_tile(float v) {
#if COMPUTE_BF16
  return __float2bfloat16(v);
#else
  return v;
#endif
}

__device__ __forceinline__ void mma_bf16(float& d0, float& d1, float& d2,
                                         float& d3, uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d0), "+f"(d1), "+f"(d2), "+f"(d3)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(THREADS)
blocked_kernel(const uint8_t* __restrict__ A, const uint8_t* __restrict__ B,
               const float* __restrict__ As, const float* __restrict__ Bs,
               void* __restrict__ out, int M, int N, int K, int k_steps,
               int split) {
  extern __shared__ __align__(16) unsigned char smem[];
  tile_t* sA = (tile_t*)smem;                 // [BLOCK_M][LDT]
  tile_t* sBt = sA + BLOCK_M * LDT;           // [BLOCK_N][LDT], B transposed
  float* sAs = (float*)(sBt + BLOCK_N * LDT); // [BLOCK_M][N_SUB]
  float* sBs = sAs + BLOCK_M * N_SUB;         // [N_SUB][NB_BLK]

#if GRID_NM
  const int bi = blockIdx.x, bj = blockIdx.y;
#else
  const int bj = blockIdx.x, bi = blockIdx.y;
#endif
  const int slice = blockIdx.z;
  const int m0 = bi * BLOCK_M, n0 = bj * BLOCK_N;
  const int kb_total = K / SCALE_BLOCK;
  const int nb_total = N / SCALE_BLOCK;
  const int tid = threadIdx.x;

#if COMPUTE_BF16
  // warp w owns the m16n8 output tiles w, w + 8, ...; lane (g, t) holds
  // rows g and g + 8, columns 2t and 2t + 1 of each (the mma.sync layout)
  const int warp = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;
  constexpr int TILES = (BLOCK_M / 16) * (BLOCK_N / 8);
  constexpr int TPW = TILES / (THREADS / 32);
  float acc[TPW][4];
#pragma unroll
  for (int i = 0; i < TPW; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
#else
  constexpr int EPT = BLOCK_M * BLOCK_N / THREADS;
  float acc[EPT];
#pragma unroll
  for (int i = 0; i < EPT; ++i) acc[i] = 0.f;
#endif

  for (int step = 0; step < k_steps; ++step) {
    const int k0 = (slice * k_steps + step) * BLOCK_K;
    const int kb0 = k0 / SCALE_BLOCK;
    for (int i = tid; i < BLOCK_M * N_SUB; i += THREADS)
      sAs[i] = As[(size_t)(m0 + i / N_SUB) * kb_total + kb0 + i % N_SUB];
    for (int i = tid; i < N_SUB * NB_BLK; i += THREADS)
      sBs[i] = Bs[(size_t)(kb0 + i / NB_BLK) * nb_total + n0 / SCALE_BLOCK
                  + i % NB_BLK];
    __syncthreads();

    for (int i = tid; i < BLOCK_M * BLOCK_K / 16; i += THREADS) {
      const int r = i / (BLOCK_K / 16), c = (i % (BLOCK_K / 16)) * 16;
      const uint4 v = *(const uint4*)(A + (size_t)(m0 + r) * K + k0 + c);
      const uint8_t* p = (const uint8_t*)&v;
#if SCALE_ACC
      const float s = 1.f;  // raw values: exact in bf16, scaled later
#else
      const float s = sAs[r * N_SUB + c / SCALE_BLOCK];
#endif
#pragma unroll
      for (int e = 0; e < 16; ++e)
        sA[r * LDT + c + e] = to_tile(to_f32(p[e]) * s);
    }
    for (int i = tid; i < BLOCK_K * BLOCK_N / 16; i += THREADS) {
      const int kk = i / (BLOCK_N / 16), c = (i % (BLOCK_N / 16)) * 16;
      const uint4 v = *(const uint4*)(B + (size_t)(k0 + kk) * N + n0 + c);
      const uint8_t* p = (const uint8_t*)&v;
#if SCALE_ACC
      const float s = 1.f;
#else
      const float s = sBs[(kk / SCALE_BLOCK) * NB_BLK + c / SCALE_BLOCK];
#endif
#pragma unroll
      for (int e = 0; e < 16; ++e)
        sBt[(c + e) * LDT + kk] = to_tile(to_f32(p[e]) * s);
    }
    __syncthreads();

    for (int s = 0; s < N_SUB; ++s) {
#if COMPUTE_BF16
#pragma unroll
      for (int i = 0; i < TPW; ++i) {
        const int tile = warp + i * (THREADS / 32);
        const int tm = tile / (BLOCK_N / 8), tn = tile % (BLOCK_N / 8);
        const int r0 = tm * 16 + g, bn = tn * 8 + g;
        float p0 = 0.f, p1 = 0.f, p2 = 0.f, p3 = 0.f;
#pragma unroll
        for (int kk = 0; kk < SCALE_BLOCK; kk += 16) {
          const int kc = s * SCALE_BLOCK + kk + 2 * t;
          const uint32_t a0 = *(const uint32_t*)&sA[r0 * LDT + kc];
          const uint32_t a1 = *(const uint32_t*)&sA[(r0 + 8) * LDT + kc];
          const uint32_t a2 = *(const uint32_t*)&sA[r0 * LDT + kc + 8];
          const uint32_t a3 = *(const uint32_t*)&sA[(r0 + 8) * LDT + kc + 8];
          const uint32_t b0 = *(const uint32_t*)&sBt[bn * LDT + kc];
          const uint32_t b1 = *(const uint32_t*)&sBt[bn * LDT + kc + 8];
          mma_bf16(p0, p1, p2, p3, a0, a1, a2, a3, b0, b1);
        }
#if SCALE_ACC
        const int cc = tn * 8 + 2 * t;
        const float bsv = sBs[s * NB_BLK + cc / SCALE_BLOCK];
        const float as0 = sAs[r0 * N_SUB + s], as1 = sAs[(r0 + 8) * N_SUB + s];
        acc[i][0] += p0 * as0 * bsv;
        acc[i][1] += p1 * as0 * bsv;
        acc[i][2] += p2 * as1 * bsv;
        acc[i][3] += p3 * as1 * bsv;
#else
        acc[i][0] += p0;
        acc[i][1] += p1;
        acc[i][2] += p2;
        acc[i][3] += p3;
#endif
      }
#else
#pragma unroll
      for (int i = 0; i < EPT; ++i) {
        const int e = tid + i * THREADS;
        const int r = e / BLOCK_N, c = e % BLOCK_N;
        const float* ar = sA + r * LDT + s * SCALE_BLOCK;
        const float* bc = sBt + c * LDT + s * SCALE_BLOCK;
        float p = 0.f;
#pragma unroll 8
        for (int kk = 0; kk < SCALE_BLOCK; ++kk) p += ar[kk] * bc[kk];
#if SCALE_ACC
        acc[i] += p * sAs[r * N_SUB + s] * sBs[s * NB_BLK + c / SCALE_BLOCK];
#else
        acc[i] += p;
#endif
      }
#endif
    }
    __syncthreads();
  }

  float* partial = (float*)out + (size_t)slice * M * N;
#if COMPUTE_BF16
#pragma unroll
  for (int i = 0; i < TPW; ++i) {
    const int tile = warp + i * (THREADS / 32);
    const int tm = tile / (BLOCK_N / 8), tn = tile % (BLOCK_N / 8);
    const size_t r0 = m0 + tm * 16 + g;
    const size_t c = n0 + tn * 8 + 2 * t;
    if (split || OUT_F32) {
      *(float2*)&partial[r0 * N + c] = make_float2(acc[i][0], acc[i][1]);
      *(float2*)&partial[(r0 + 8) * N + c] = make_float2(acc[i][2], acc[i][3]);
    } else {
      __nv_bfloat162* o = (__nv_bfloat162*)out;
      o[(r0 * N + c) / 2] = __floats2bfloat162_rn(acc[i][0], acc[i][1]);
      o[((r0 + 8) * N + c) / 2] = __floats2bfloat162_rn(acc[i][2], acc[i][3]);
    }
  }
#else
#pragma unroll
  for (int i = 0; i < EPT; ++i) {
    const int e = tid + i * THREADS;
    const size_t idx = (size_t)(m0 + e / BLOCK_N) * N + n0 + e % BLOCK_N;
    if (split || OUT_F32)
      partial[idx] = acc[i];
    else
      ((__nv_bfloat16*)out)[idx] = __float2bfloat16(acc[i]);
  }
#endif
}
#endif  // WGMMA_PATH

// The single-block seed's function over the whole card (see the header).
__global__ void __launch_bounds__(MONO_THREADS)
monolith_kernel(const uint8_t* __restrict__ A, const uint8_t* __restrict__ B,
                const float* __restrict__ As, const float* __restrict__ Bs,
                __nv_bfloat16* __restrict__ C, int M, int N, int K) {
  __shared__ float sA[MONO_TILE][MONO_SLAB + 1];  // dequantized A rows
  __shared__ __align__(16) float sB[MONO_SLAB][MONO_TILE];  // and B rows
  const int kb = K / SCALE_BLOCK, nb = (N + SCALE_BLOCK - 1) / SCALE_BLOCK;
  const int m0 = blockIdx.y * MONO_TILE, n0 = blockIdx.x * MONO_TILE;
  const int tx = threadIdx.x % (MONO_TILE / 4);  // columns tx*4 .. tx*4+3
  const int ty = threadIdx.x / (MONO_TILE / 4);  // rows ty*4 .. ty*4+3
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += MONO_SLAB) {
    const int kblk = k0 / SCALE_BLOCK;
    for (int i = threadIdx.x; i < MONO_TILE * MONO_SLAB; i += MONO_THREADS) {
      const int r = i / MONO_SLAB, kk = i % MONO_SLAB, m = m0 + r;
      sA[r][kk] = m < M ? to_f32(A[(size_t)m * K + k0 + kk])
                              * As[(size_t)m * kb + kblk]
                        : 0.f;
    }
    // the tile's columns lie in one 128-column scale block
    const float bs = n0 < N ? Bs[(size_t)kblk * nb + n0 / SCALE_BLOCK] : 0.f;
    for (int i = threadIdx.x; i < MONO_SLAB * MONO_TILE; i += MONO_THREADS) {
      const int kk = i / MONO_TILE, c = i % MONO_TILE, n = n0 + c;
      sB[kk][c] = n < N ? to_f32(B[(size_t)(k0 + kk) * N + n]) * bs : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < MONO_SLAB; ++kk) {
      const float4 b = *reinterpret_cast<const float4*>(&sB[kk][tx * 4]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float a = sA[ty * 4 + i][kk];
        acc[i][0] = fmaf(a, b.x, acc[i][0]);
        acc[i][1] = fmaf(a, b.y, acc[i][1]);
        acc[i][2] = fmaf(a, b.z, acc[i][2]);
        acc[i][3] = fmaf(a, b.w, acc[i][3]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (m < M && n < N) C[(size_t)m * N + n] = __float2bfloat16(acc[i][j]);
    }
  }
}

extern "C" const char* sg_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// which blocked kernel this library holds (1 wgmma, 0 mma.sync) and the
// dynamic shared memory its launch asks for (KernelGenome.smem_bytes)
extern "C" int sg_blocked_path() { return WGMMA_PATH; }
extern "C" int sg_blocked_smem() { return (int)(SMEM_BYTES); }

static int set_smem(const void* fn, size_t bytes) {
  if (bytes > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) cudaGetLastError();  // not sticky: clear it
  return (int)err;
}

#if WGMMA_PATH
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

// A row-major (rows, cols) byte matrix as a 2-d map whose box is
// box_cols x box_rows, in the given swizzle; reads past its edge give zeros.
static bool make_map(CUtensorMap* map, const void* ptr, int rows, int cols,
                     int box_cols, int box_rows, CUtensorMapSwizzle swizzle) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(ptr),
                dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

#define MAX_DEVICES 64
#endif

// out: bf16 (M, N) when ks == 1 (f32 with OUT_F32), else f32 (ks, M, N).
// M and K divide by the block sizes, and so does N on the mma.sync path;
// the wgmma path takes any N that divides by 16.  The K loop has
// ks * k_steps slabs of BLOCK_K.
extern "C" int sg_blocked(const void* A, const void* B, const void* As,
                          const void* Bs, void* out, int M, int N, int K,
                          int k_steps, int ks, void* stream) {
  cudaGetLastError();
#if WGMMA_PATH
  // the shared-memory opt-in and the SM count, once per device
  static int sms_of[MAX_DEVICES];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (sms_of[dev] == 0) {
    const int err = set_smem((const void*)blocked_kernel, SMEM_BYTES);
    if (err) return err;
    int sms = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    sms_of[dev] = sms;
  }
  CUtensorMap ta, tb;
  if (!make_map(&ta, A, M, K, 128, BLOCK_M, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map(&tb, B, K, N, 128, 128, CU_TENSOR_MAP_SWIZZLE_NONE))
    return (int)cudaErrorInvalidPitchValue;
  const int units = (M / BLOCK_M) * ((N + BLOCK_N - 1) / BLOCK_N) * ks;
  const int grid = units < sms_of[dev] ? units : sms_of[dev];
  blocked_kernel<<<grid > 0 ? grid : 1, WG_THREADS, SMEM_BYTES,
                   (cudaStream_t)stream>>>(
      ta, tb, (const float*)As, (const float*)Bs, out, M, N, K,
      k_steps * (BLOCK_K / SCALE_BLOCK), ks);
#else
  const int err = set_smem((const void*)blocked_kernel, SMEM_BYTES);
  if (err) return err;
#if GRID_NM
  const dim3 grid(M / BLOCK_M, N / BLOCK_N, ks);
#else
  const dim3 grid(N / BLOCK_N, M / BLOCK_M, ks);
#endif
  blocked_kernel<<<grid, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      (const uint8_t*)A, (const uint8_t*)B, (const float*)As,
      (const float*)Bs, out, M, N, K, k_steps, ks > 1);
#endif
  return (int)cudaGetLastError();
}

// The footprint is that of the whole problem held by one block, as the
// TPU kernel holds it in VMEM: refused, before any launch, where it exceeds
// one block's opt-in shared memory.
extern "C" int sg_monolith(const void* A, const void* B, const void* As,
                           const void* Bs, void* C, int M, int N, int K,
                           void* stream) {
  cudaGetLastError();
  const size_t kb = K / SCALE_BLOCK, nb = (N + SCALE_BLOCK - 1) / SCALE_BLOCK;
  const size_t bytes = 4 * ((size_t)M * kb + kb * nb) + (size_t)M * K
                       + (size_t)K * N;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  if (bytes > (size_t)optin) return (int)cudaErrorInvalidValue;
  const int gx = (N + MONO_TILE - 1) / MONO_TILE;
  const int gy = (M + MONO_TILE - 1) / MONO_TILE;
  const dim3 grid(gx > 0 ? gx : 1, gy > 0 ? gy : 1);
  monolith_kernel<<<grid, MONO_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)A, (const uint8_t*)B, (const float*)As,
      (const float*)Bs, (__nv_bfloat16*)C, M, N, K);
  return (int)cudaGetLastError();
}
