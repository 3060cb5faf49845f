// Block-scaled GEMM for Hopper (sm_90a): C = dequant(A) @ dequant(B).
//
// A (M, K) and B (K, N) hold fp8 e4m3 (or int8) values; a_scale (M, K/128)
// has one f32 scale per (row, 128-K block), b_scale (K/128, N/128) one per
// 128x128 block; the sum is kept in f32.
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
// the card's ~295 operations per byte in bf16, so the tensor cores bound
// it: with bf16 inputs the least time is 2MNK / 989 TFLOP/s.  The f32
// compute path runs on the FMA units (67 TFLOP/s).
//
// Design.  The TPU grid walks K in sequence and carries the sum in VMEM
// scratch; on Hopper the blocks run in parallel, so each block owns one
// (BLOCK_M, BLOCK_N) output tile and loops over K itself, keeping its f32
// sums in registers.  Per BLOCK_K slab the block stages A and B in shared
// memory, converted once from the storage type to the compute type (raw
// values for scale_acc, value*scale for dequant_inputs, rounded to the
// compute type as the JAX kernel rounds them); B is stored transposed, and
// each row is padded so that the fragment loads hit 32 distinct banks.
// bf16 products go through the tensor cores with mma.sync m16n8k16
// (bf16 in, f32 out), whose register layout is fixed, so scale_acc can
// scale each 128-K partial by its row and column-block scale in registers.
// Split-K runs `ks` slices of the K loop as grid z and writes f32 partials
// (ks, M, N); the caller sums them in a fixed order (no atomics, so every
// verdict is reproducible).  grid_order picks whether blockIdx.x walks N
// (mn: M outermost, as the TPU grid) or M (nm).  A tile that needs more
// shared memory than a block may have is refused at launch, which the
// platform reports as a compile error.  Kept simple on purpose: no wgmma,
// TMA or pipelining yet.
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

#define SCALE_BLOCK 128
#define THREADS 256
#define MONO_TILE 32     // monolith: output rows and columns per block
#define MONO_SLAB 128    // K staged per step
#define MONO_THREADS (MONO_TILE * MONO_TILE / 16)  // 4 x 4 outputs each
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

static int set_smem(const void* fn, size_t bytes) {
  if (bytes > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) cudaGetLastError();  // not sticky: clear it
  return (int)err;
}

// out: bf16 (M, N) when ks == 1 (f32 with OUT_F32), else f32 (ks, M, N).
// M, N, K divide by the block sizes; the K loop has ks * k_steps slabs.
extern "C" int sg_blocked(const void* A, const void* B, const void* As,
                          const void* Bs, void* out, int M, int N, int K,
                          int k_steps, int ks, void* stream) {
  cudaGetLastError();
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
