// Mamba-2 SSD chunked scan for Hopper (sm_90a): K7.
//
// Replaces repro/kernels/ssd.py `_ssd_body` + `ssd` (the pallas_call at
// line 77) together with the pre-fusion of its wrapper (repro/kernels/
// ops.py:115-116).  For each (b, h) it computes, chunk by chunk,
//   y_i   = sum_{j<=i} exp(cum_i - cum_j) (C_i . B_j) dtx_j
//           + exp(cum_i) (C_i . state)
//   state = exp(cum_last) state + sum_j exp(cum_last - cum_j) B_j (x) dtx_j
// with dtx = x * dt and cum the inclusive cumsum of dt * A over the chunk,
// and also writes the final state, which the model's prefill keeps in its
// cache (the Pallas kernel leaves it in VMEM scratch).
//
// Operands, read through their strides (in elements), so the model's
// views into its (B, S, d_inner + 2N) conv output are read in place:
//   x (B, S, H, P) bf16, unit stride along P;   dt (B, S, H) f32;
//   A (H,) f32;   B, C (B, S, N) bf16, unit stride along N.
// Outputs: y (B, S, H, P) bf16 contiguous; state (B, H, N, P) f32
// contiguous.  Only P = 64, N = 128 (mamba2-2.7b) is instantiated.
//
// Bound on an H100, at one prompt of S tokens (B = 1, H = 80): the bytes
// are x and y (2 * S*H*P*2), dt (S*H*4), B and C (2 * S*N*2) and the
// final state (H*N*P*4), about 43 MB at S = 1918, 13 us at 3.35 TB/s.
// The products of the chunked form are, per head and chunk of L tokens,
// L(L+1)/2 * (N + P) multiply-adds inside the chunk and 2*L*N*P for the
// state: about 6 GFLOP at S = 1918, 6 us at 989 TFLOP/s (bf16).  So the
// bytes bound it, as long as the products run on the tensor cores; in f32
// FMA (67 TFLOP/s) they would take ~0.1 ms and bound it instead.  (This
// kernel does L*L*N for C B^T, not the causal half, and L*N*P more for the
// low half of the state below: about 1.5x the count above.)
//
// Design.  The TPU grid walks the chunk axis in order and carries the
// (N, P) f32 state in VMEM scratch.  Hopper blocks run in no order, so one
// block of 8 warps owns one (b, h) and loops over its chunks itself (64
// tokens each), with the state in registers: warp w holds rows
// [16w, 16w + 16) of N by all 64 columns of P as mma.sync accumulator
// fragments, 32 f32 a thread.  At B = 1 this gives 80 blocks for 132 SMs;
// splitting P across two blocks (and computing C B^T twice) is left for
// later.  Per chunk:
//   1. x, B and C rows are loaded with 16-byte loads; B and C are staged
//      row by row, x is kept in registers; warp 0 loads dt and takes the
//      cumsum of dt * A (log2 units) with shuffles; the state entering the
//      chunk is written to shared memory transposed (P x N) as two bf16
//      parts, hi = bf16(state) and lo = bf16(state - hi).
//   2. B, x * dt and x * dt * exp(cum_last - cum_j) are written transposed
//      (the TPU wrapper's f32 (B, H, S, P) copy of x * dt is never made;
//      neighbouring lanes on neighbouring tokens, so the scattered stores
//      do not collide).
//   3. C B^T on the tensor cores (mma.sync m16n8k16, bf16 in, f32 out),
//      for the 20 of 32 (16 x 8) tiles on or below the diagonal; each value
//      is multiplied by exp(cum_i - cum_j), masked to 0 above the diagonal
//      before the exp (no exp of a positive number), rounded to bf16.
//   4. y = scores . dtx + exp(cum_i) (C . (hi + lo)): warp w takes 16 rows
//      and 32 columns of P; only key blocks up to the diagonal are
//      multiplied.
//   5. state = exp(cum_last) state + B^T . (dtx w), in the registers.
// Rows of shared memory are padded by 8 bf16 so that fragment loads hit 32
// distinct banks.  S need not divide the chunk: tokens past S load as zero
// (dt = 0, so cum stays flat, and B = C = x = 0), which leaves y's valid
// rows and the state as they were, and their y rows are not written (the
// JAX kernel asserts S % chunk == 0 instead).
//
// Rounding.  The products take bf16 operands and sum in f32.  x, B and C
// arrive in bf16 and enter every product unrounded; x * dt, x * dt * w and
// the decayed scores are rounded to bf16, each error a fraction (2^-9) of
// its own term of y.  The state enters C . state as hi + lo (~16 bits): a
// state rounded once to bf16, or B * w in place of dtx * w, gives errors
// that do not shrink with C_i . B_j, and a row of y in which those dot
// products cancel then loses several percent of its size (a version that
// did so failed chip_smoke.py's per-row gate at its phase-3 shapes).  The carried state, the cumsum and the
// decays stay f32.  cum_i - cum_j is a difference of two f32
// numbers that may reach -1e3 inside a chunk (A down to -16, dt up to a
// few units); its absolute error (~1e-4) is a relative error of exp's
// result, as in the JAX formula, and is left so.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

#define LOG2E 1.4426950408889634f
#define CH 64                 // tokens per chunk
#define NS 128                // state size N
#define PH 64                 // head dim P
#define WARPS 8
#define THREADS (WARPS * 32)
#define PAD 8                 // bf16 of padding per staged row
#define LDN (NS + PAD)        // Cs, Bs (CH rows), stHi, stLo (PH rows)
#define LDL (CH + PAD)        // BT (NS rows), dxT, dxwT (PH rows), sc (CH rows)
#define XV (CH * PH / 8 / THREADS)   // 16-byte x vectors per thread
#define BV (CH * NS / 8 / THREADS)   // 16-byte B (or C) vectors per thread
#define SMEM_BYTES ((2 * CH * LDN + 2 * PH * LDN + NS * LDL + 2 * PH * LDL + CH * LDL) \
                    * (int)sizeof(bf16) + 2 * CH * (int)sizeof(float))

static_assert(WARPS * 16 == NS, "one warp per 16 state rows");
static_assert(XV * THREADS * 8 == CH * PH && BV * THREADS * 8 == CH * NS,
              "whole vectors per thread");

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

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The A fragment of a 16 x 16 tile at p (row g, column 2t of the tile),
// rows ld apart.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* p, int ld) {
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * ld);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * ld + 8);
}

__global__ void __launch_bounds__(THREADS, 1)
ssd_scan_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const bf16* __restrict__ Bm,
                const bf16* __restrict__ Cm, bf16* __restrict__ y,
                float* __restrict__ state_out, int S, int H, int xsb, int xss,
                int xsh, int dsb, int dss, int dsh, int bsb, int bss, int csb,
                int css) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Cs = reinterpret_cast<bf16*>(smem);  // [CH][LDN]
  bf16* Bs = Cs + CH * LDN;                  // [CH][LDN]
  bf16* stHi = Bs + CH * LDN;                // [PH][LDN] state^T entering,
  bf16* stLo = stHi + PH * LDN;              // [PH][LDN] as bf16 hi + lo
  bf16* BT = stLo + PH * LDN;                // [NS][LDL] B^T
  bf16* dxT = BT + NS * LDL;                 // [PH][LDL] (x dt)^T
  bf16* dxwT = dxT + PH * LDL;               // [PH][LDL] (x dt w)^T
  bf16* sc = dxwT + PH * LDL;                // [CH][LDL] decayed C B^T
  float* cum = reinterpret_cast<float*>(sc + CH * LDL);  // [CH], log2 units
  float* dts = cum + CH;                                 // [CH]

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const float a2 = A[h] * LOG2E;
  const bf16* xp = x + (size_t)b * xsb + (size_t)h * xsh;
  const float* dp = dt + (size_t)b * dsb + (size_t)h * dsh;
  const bf16* bp = Bm + (size_t)b * bsb;
  const bf16* cp = Cm + (size_t)b * csb;
  bf16* yp = y + ((size_t)b * S * H + h) * PH;

  float st[PH / 8][4];
#pragma unroll
  for (int n = 0; n < PH / 8; ++n) st[n][0] = st[n][1] = st[n][2] = st[n][3] = 0.f;

  for (int s0 = 0; s0 < S; s0 += CH) {
    const int valid = min(CH, S - s0);
    // ---- 1. loads; cumsum; the entering state as bf16, transposed
    uint4 xr[XV], br[BV], cr[BV];
#pragma unroll
    for (int k = 0; k < XV; ++k) {
      const int v = tid + k * THREADS, r = v % CH, c = (v / CH) * 8;
      xr[k] = r < valid ? *reinterpret_cast<const uint4*>(xp + (size_t)(s0 + r) * xss + c)
                        : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int k = 0; k < BV; ++k) {
      const int v = tid + k * THREADS, r = v % CH, c = (v / CH) * 8;
      br[k] = r < valid ? *reinterpret_cast<const uint4*>(bp + (size_t)(s0 + r) * bss + c)
                        : make_uint4(0, 0, 0, 0);
      cr[k] = r < valid ? *reinterpret_cast<const uint4*>(cp + (size_t)(s0 + r) * css + c)
                        : make_uint4(0, 0, 0, 0);
    }
    if (warp == 0) {  // lane holds tokens 2 lane, 2 lane + 1
      const int r = 2 * lane;
      const float d0 = r < valid ? dp[(size_t)(s0 + r) * dss] : 0.f;
      const float d1 = r + 1 < valid ? dp[(size_t)(s0 + r + 1) * dss] : 0.f;
      const float l0 = d0 * a2, l1 = d1 * a2;
      float sum = l0 + l1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, sum, off);
        if (lane >= off) sum += u;
      }
      float excl = __shfl_up_sync(0xffffffffu, sum, 1);
      if (lane == 0) excl = 0.f;
      dts[r] = d0;
      dts[r + 1] = d1;
      cum[r] = excl + l0;
      cum[r + 1] = excl + l0 + l1;
    }
#pragma unroll
    for (int k = 0; k < BV; ++k) {
      const int v = tid + k * THREADS, r = v % CH, c = (v / CH) * 8;
      *reinterpret_cast<uint4*>(Bs + r * LDN + c) = br[k];
      *reinterpret_cast<uint4*>(Cs + r * LDN + c) = cr[k];
    }
    {
      const int n0 = 16 * warp + g;
#pragma unroll
      for (int n = 0; n < PH / 8; ++n) {
        const int p0 = 8 * n + 2 * t;
        const int at[4] = {p0 * LDN + n0, (p0 + 1) * LDN + n0,
                           p0 * LDN + n0 + 8, (p0 + 1) * LDN + n0 + 8};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bf16 hi = __float2bfloat16(st[n][e]);
          stHi[at[e]] = hi;
          stLo[at[e]] = __float2bfloat16(st[n][e] - __bfloat162float(hi));
        }
      }
    }
    __syncthreads();

    // ---- 2. B^T, (x dt)^T and (x dt w)^T, w = exp(cum_last - cum_j)
    const float cl = cum[CH - 1];
#pragma unroll
    for (int k = 0; k < XV; ++k) {
      const int v = tid + k * THREADS, r = v % CH, c = (v / CH) * 8;
      const float d = dts[r], dw = d * exp2f(cl - cum[r]);
      const bf16* e = reinterpret_cast<const bf16*>(&xr[k]);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float xv = __bfloat162float(e[i]);
        dxT[(c + i) * LDL + r] = __float2bfloat16(xv * d);
        dxwT[(c + i) * LDL + r] = __float2bfloat16(xv * dw);
      }
    }
#pragma unroll
    for (int k = 0; k < BV; ++k) {
      const int v = tid + k * THREADS, r = v % CH, c = (v / CH) * 8;
      const bf16* e = reinterpret_cast<const bf16*>(&br[k]);
#pragma unroll
      for (int i = 0; i < 8; ++i) BT[(c + i) * LDL + r] = e[i];
    }
    __syncthreads();

    // ---- 3. scores = (C B^T) exp(cum_i - cum_j), j <= i; tiles on or
    // below the diagonal: row block m has 2m + 2 column tiles of 8
    for (int q = warp; q < 20; q += WARPS) {
      const int m = q < 2 ? 0 : q < 6 ? 1 : q < 12 ? 2 : 3;
      const int n = q - m * (m + 1);
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      const bf16* ar = Cs + (16 * m + g) * LDN + 2 * t;
      const bf16* bq = Bs + (8 * n + g) * LDN + 2 * t;
#pragma unroll
      for (int kk = 0; kk < NS / 16; ++kk) {
        uint32_t af[4];
        load_a(af, ar + 16 * kk, LDN);
        mma_bf16(acc, af, ld32(bq + 16 * kk), ld32(bq + 16 * kk + 8));
      }
      const int i0 = 16 * m + g, i1 = i0 + 8, j0 = 8 * n + 2 * t, j1 = j0 + 1;
      const float v00 = j0 <= i0 ? acc[0] * exp2f(cum[i0] - cum[j0]) : 0.f;
      const float v01 = j1 <= i0 ? acc[1] * exp2f(cum[i0] - cum[j1]) : 0.f;
      const float v10 = j0 <= i1 ? acc[2] * exp2f(cum[i1] - cum[j0]) : 0.f;
      const float v11 = j1 <= i1 ? acc[3] * exp2f(cum[i1] - cum[j1]) : 0.f;
      *reinterpret_cast<uint32_t*>(sc + i0 * LDL + j0) = pack_bf16(v00, v01);
      *reinterpret_cast<uint32_t*>(sc + i1 * LDL + j0) = pack_bf16(v10, v11);
    }
    __syncthreads();

    // ---- 4. y = scores . dtx + exp(cum_i) (C . (state_hi + state_lo))
    {
      const int m = warp & 3, p_base = 32 * (warp >> 2);
      float y1[4][4], y2[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) y1[j][e] = y2[j][e] = 0.f;
      const bf16* sa = sc + (16 * m + g) * LDL + 2 * t;
      for (int kk = 0; kk <= m; ++kk) {  // key blocks up to the diagonal
        uint32_t af[4];
        load_a(af, sa + 16 * kk, LDL);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bf16* bq = dxT + (p_base + 8 * j + g) * LDL + 16 * kk + 2 * t;
          mma_bf16(y1[j], af, ld32(bq), ld32(bq + 8));
        }
      }
      const bf16* ca = Cs + (16 * m + g) * LDN + 2 * t;
#pragma unroll
      for (int kk = 0; kk < NS / 16; ++kk) {
        uint32_t af[4];
        load_a(af, ca + 16 * kk, LDN);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int o = (p_base + 8 * j + g) * LDN + 16 * kk + 2 * t;
          mma_bf16(y2[j], af, ld32(stHi + o), ld32(stHi + o + 8));
          mma_bf16(y2[j], af, ld32(stLo + o), ld32(stLo + o + 8));
        }
      }
      const int i0 = 16 * m + g, i1 = i0 + 8;
      const float e0 = exp2f(cum[i0]), e1 = exp2f(cum[i1]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int p = p_base + 8 * j + 2 * t;
        if (i0 < valid)
          *reinterpret_cast<uint32_t*>(yp + (size_t)(s0 + i0) * H * PH + p) =
              pack_bf16(y1[j][0] + e0 * y2[j][0], y1[j][1] + e0 * y2[j][1]);
        if (i1 < valid)
          *reinterpret_cast<uint32_t*>(yp + (size_t)(s0 + i1) * H * PH + p) =
              pack_bf16(y1[j][2] + e1 * y2[j][2], y1[j][3] + e1 * y2[j][3]);
      }
    }

    // ---- 5. state = exp(cum_last) state + B^T . (dtx w)
    {
      const float dec = exp2f(cl);
#pragma unroll
      for (int n = 0; n < PH / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[n][e] *= dec;
      const bf16* wa = BT + (16 * warp + g) * LDL + 2 * t;
#pragma unroll
      for (int kk = 0; kk < CH / 16; ++kk) {
        uint32_t af[4];
        load_a(af, wa + 16 * kk, LDL);
#pragma unroll
        for (int n = 0; n < PH / 8; ++n) {
          const bf16* bq = dxwT + (8 * n + g) * LDL + 16 * kk + 2 * t;
          mma_bf16(st[n], af, ld32(bq), ld32(bq + 8));
        }
      }
    }
    __syncthreads();
  }

  float* so = state_out + ((size_t)b * H + h) * NS * PH;
  const int n0 = 16 * warp + g;
#pragma unroll
  for (int n = 0; n < PH / 8; ++n) {
    const int p0 = 8 * n + 2 * t;
    *reinterpret_cast<float2*>(so + n0 * PH + p0) = make_float2(st[n][0], st[n][1]);
    *reinterpret_cast<float2*>(so + (n0 + 8) * PH + p0) = make_float2(st[n][2], st[n][3]);
  }
}

extern "C" const char* sg_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// y: contiguous (B, S, H, P) bf16; state: contiguous (B, H, N, P) f32.
// Strides in elements; x, B and C need unit stride along P or N and
// 16-byte aligned rows.
extern "C" int ssd_scan(const void* x, const void* dt, const void* A,
                        const void* Bm, const void* Cm, void* y, void* state,
                        int Bsz, int S, int H, int P, int N, int xsb, int xss,
                        int xsh, int dsb, int dss, int dsh, int bsb, int bss,
                        int csb, int css, void* stream) {
  cudaGetLastError();
  if (P != PH || N != NS) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)ssd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  const dim3 grid(H, Bsz);
  ssd_scan_kernel<<<grid, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      (const bf16*)x, (const float*)dt, (const float*)A, (const bf16*)Bm,
      (const bf16*)Cm, (bf16*)y, (float*)state, S, H, xsb, xss, xsh, dsb, dss,
      dsh, bsb, bss, csb, css);
  return (int)cudaGetLastError();
}
