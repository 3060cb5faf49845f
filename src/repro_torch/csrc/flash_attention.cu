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
// (989 TFLOP/s bf16); shorter prompts are bound by the bytes.
//
// Design.  The TPU grid walks the key blocks in sequence and carries the
// running max, sum and output in VMEM scratch; on Hopper the blocks run in
// parallel, so one block of 4 warps owns a (b, h, 64-query) tile and loops
// over the key blocks itself, holding max, sum and the (16 x D) output of
// each warp's 16 rows in registers.  Q is read once into mma.sync A
// fragments; per step a 64-key tile of K is staged in shared memory row by
// row and V transposed, both zero past S, with rows padded so that the
// fragment loads hit 32 distinct banks.  QK^T and PV run on the tensor
// cores as mma.sync m16n8k16 (bf16 in, f32 out): the S fragment of one
// product is, register for register, the A fragment of the next.  The
// probabilities are rounded to bf16 for the PV product (the TPU kernel
// keeps them in f32); the row sum adds the same rounded values, so the
// output is an exactly normalised mean of V.  Key blocks that no query of
// the tile can see (above the causal diagonal, before the window) are
// skipped whole, as `flash_attention.py:56-62` does, and the grid starts
// the heaviest (last) query tiles first.  S need not divide the tile: the
// ragged edge is masked here (the JAX kernel asserts divisibility).
// Rows that see no key stay zero through the NEG_INF guards
// (`flash_attention.py:81-83`).  Kept simple: no wgmma, TMA or pipelining.
//
// --- K6, flash_decode_kernel ------------------------------------------------
// Replaces repro/kernels/flash_attention.py `_decode_body` +
// `decode_attention` (the pallas_call at line 232): one new token per row
// against a KV cache of which the first kv_len[b] positions are valid.
//
// Bound on an H100: every valid K and V row is read once and each is used
// for 4*group*D operations, 2*group operations per byte, so the bytes
// bound it: sum_b min(kv_len[b], S) * Hkv * D * 4 bytes over 3.35 TB/s.
//
// Design.  As on the TPU, the GQA group (group <= 16 query heads sharing
// one KV head) forms the rows of the product, one block per (b, hkv); the
// block loads its own kv_len[b] (the TPU's scalar prefetch), clamps it to
// [0, S] (an idle serving slot can count past S, and then every position
// is valid) and stops there.  So that one block keeps enough loads in
// flight, its 8 warps split the keys: warp w takes the 32-key tiles w,
// w + 8, ..., stages them in its own shared memory, and keeps its own
// online softmax in registers with the same mma.sync fragments as K5
// (rows past the group are zero).  At the end the warps' (max, sum,
// output) are merged through shared memory.  kv_len = 0 gives zeros, as
// the Pallas kernel does.  A split of the keys across blocks (split-KV,
// to fill 132 SMs when B * Hkv is small) is left for a later change.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

#define NEG_INF (-1e30f)
#define LOG2E 1.4426950408889634f
#define PAD 8            // bf16 of padding per staged row (bank spread)
#define PF_WARPS 4
#define PF_THREADS (PF_WARPS * 32)
#define BQ (PF_WARPS * 16)   // prefill queries per block
#define BK 64                // prefill keys per step
#define DEC_WARPS 8
#define DEC_THREADS (DEC_WARPS * 32)
#define DK 32                // decode keys per warp step

static_assert(BQ <= BK, "Q is staged in the K tile");

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

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
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

// One online-softmax step for the two rows (g, g + 8) a lane holds: `s`
// holds the scaled logits (log2 units, NEG_INF where masked) of NT key
// tiles of 8; on return it holds the probabilities rounded to bf16, and
// the max, the lane's partial sums and the output rows are rescaled.
template <int NT, int NO>
__device__ __forceinline__ void softmax_step(float (&s)[NT][4], float& m0,
                                             float& m1, float& l0, float& l1,
                                             float (&o)[NO][4]) {
  float mx0 = m0, mx1 = m1;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
    mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
  }
  mx0 = quad_max(mx0);
  mx1 = quad_max(mx1);
  const float a0 = m0 <= NEG_INF / 2 ? 0.f : exp2f(m0 - mx0);
  const float a1 = m1 <= NEG_INF / 2 ? 0.f : exp2f(m1 - mx1);
  m0 = mx0;
  m1 = mx1;
  l0 *= a0;
  l1 *= a1;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    o[n][0] *= a0;
    o[n][1] *= a0;
    o[n][2] *= a1;
    o[n][3] *= a1;
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float m = e < 2 ? m0 : m1;
      const float p = s[j][e] <= NEG_INF / 2 ? 0.f : round_bf16(exp2f(s[j][e] - m));
      s[j][e] = p;
      if (e < 2) l0 += p; else l1 += p;
    }
  }
}

// o += P V for 16 keys per k-step: P comes from the S fragments of key
// tiles 2kk and 2kk+1; sVt is V transposed, [D][ldv].
template <int NT, int D>
__device__ __forceinline__ void pv_product(const float (&s)[NT][4],
                                           const bf16* sVt, int ldv, int g,
                                           int t, float (&o)[D / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                           pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                           pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                           pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const bf16* vr = sVt + (n * 8 + g) * ldv + kk * 16 + 2 * t;
      mma_bf16(o[n], a, ld32(vr), ld32(vr + 8));
    }
  }
}

// s = Q K^T for NT key tiles of 8; sK is [keys][ldk].
template <int NT, int D>
__device__ __forceinline__ void qk_product(const uint32_t (&qf)[D / 16][4],
                                           const bf16* sK, int ldk, int g,
                                           int t, float (&s)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const bf16* kr = sK + (j * 8 + g) * ldk + kk * 16 + 2 * t;
      mma_bf16(s[j], qf[kk], ld32(kr), ld32(kr + 8));
    }
  }
}

template <int D>
__global__ void __launch_bounds__(PF_THREADS)
flash_prefill_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o, int S,
                     int Hq, int group, int causal, int window, int qsb,
                     int qsh, int qss, int ksb, int ksh, int kss, int vsb,
                     int vsh, int vss, float scale) {
  constexpr int LD = D + PAD;    // sK row stride
  constexpr int LDV = BK + PAD;  // sVt row stride
  constexpr int CH = D / 8;      // 16-byte chunks per row
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);  // [BK][LD]; Q staged here first
  bf16* sVt = sK + BK * LD;                  // [D][LDV]

  const int qb = gridDim.x - 1 - blockIdx.x;  // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z, hk = h / group;
  const int q0 = qb * BQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const bf16* qp = q + (size_t)b * qsb + (size_t)h * qsh;
  const bf16* kp = k + (size_t)b * ksb + (size_t)hk * ksh;
  const bf16* vp = v + (size_t)b * vsb + (size_t)hk * vsh;

  for (int i = tid; i < BQ * CH; i += PF_THREADS) {
    const int r = i / CH, c = (i % CH) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (q0 + r < S) val = *reinterpret_cast<const uint4*>(qp + (size_t)(q0 + r) * qss + c);
    *reinterpret_cast<uint4*>(sK + r * LD + c) = val;
  }
  __syncthreads();
  const int r0 = warp * 16 + g;
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const bf16* p0 = sK + r0 * LD + kk * 16 + 2 * t;
    const bf16* p1 = p0 + 8 * LD;
    qf[kk][0] = ld32(p0);
    qf[kk][1] = ld32(p1);
    qf[kk][2] = ld32(p0 + 8);
    qf[kk][3] = ld32(p1 + 8);
  }
  __syncthreads();

  int k_begin = 0, k_end = S;
  if (causal) k_end = min(S, q0 + BQ);
  if (window > 0) k_begin = max(0, q0 - window + 1) / BK * BK;
  const int qpos0 = q0 + r0, qpos1 = qpos0 + 8;
  const float sl2 = scale * LOG2E;

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    for (int i = tid; i < BK * CH; i += PF_THREADS) {
      const int r = i / CH, c = (i % CH) * 8;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (k0 + r < S) val = *reinterpret_cast<const uint4*>(kp + (size_t)(k0 + r) * kss + c);
      *reinterpret_cast<uint4*>(sK + r * LD + c) = val;
    }
    for (int i = tid; i < BK * CH; i += PF_THREADS) {
      const int r = i % BK, c = (i / BK) * 8;  // neighbouring lanes, neighbouring keys
      uint4 val = make_uint4(0, 0, 0, 0);
      if (k0 + r < S) val = *reinterpret_cast<const uint4*>(vp + (size_t)(k0 + r) * vss + c);
      const bf16* e = reinterpret_cast<const bf16*>(&val);
#pragma unroll
      for (int j = 0; j < 8; ++j) sVt[(c + j) * LDV + r] = e[j];
    }
    __syncthreads();

    float s[BK / 8][4];
    qk_product<BK / 8, D>(qf, sK, LD, g, t, s);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k0 + j * 8 + 2 * t + (e & 1);
        const int qpos = e < 2 ? qpos0 : qpos1;
        const bool ok = kpos < S && (!causal || kpos <= qpos)
                        && (window <= 0 || kpos > qpos - window);
        s[j][e] = ok ? s[j][e] * sl2 : NEG_INF;
      }
    }
    softmax_step<BK / 8, D / 8>(s, m0, m1, l0, l1, acc);
    pv_product<BK / 8, D>(s, sVt, LDV, g, t, acc);
    __syncthreads();
  }

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const float inv0 = 1.f / (l0 == 0.f ? 1.f : l0);
  const float inv1 = 1.f / (l1 == 0.f ? 1.f : l1);
  bf16* op = o + ((size_t)b * Hq + h) * S * D;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int c = n * 8 + 2 * t;
    if (qpos0 < S)
      *reinterpret_cast<uint32_t*>(op + (size_t)qpos0 * D + c) =
          pack_bf16(acc[n][0] * inv0, acc[n][1] * inv0);
    if (qpos1 < S)
      *reinterpret_cast<uint32_t*>(op + (size_t)qpos1 * D + c) =
          pack_bf16(acc[n][2] * inv1, acc[n][3] * inv1);
  }
}

template <int D>
__global__ void __launch_bounds__(DEC_THREADS)
flash_decode_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v,
                    const int* __restrict__ kv_len, bf16* __restrict__ o,
                    int S, int Hq, int group, int qsb, int qsh, int ksb,
                    int ksh, int kss, int vsb, int vsh, int vss, float scale) {
  constexpr int LD = D + PAD;    // sK row stride
  constexpr int LDV = DK + PAD;  // sVt row stride
  constexpr int CH = D / 8;
  constexpr int WARP_SMEM = DK * LD + D * LDV;  // bf16 per warp
  extern __shared__ __align__(16) unsigned char smem[];
  const int hk = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  bf16* sK = reinterpret_cast<bf16*>(smem) + warp * WARP_SMEM;  // [DK][LD]
  bf16* sVt = sK + DK * LD;                                      // [D][LDV]
  const int len = min(max(kv_len[b], 0), S);
  const bf16* kp = k + (size_t)b * ksb + (size_t)hk * ksh;
  const bf16* vp = v + (size_t)b * vsb + (size_t)hk * vsh;

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

  for (int k0 = warp * DK; k0 < len; k0 += DEC_WARPS * DK) {
    for (int i = lane; i < DK * CH; i += 32) {
      const int r = i / CH, c = (i % CH) * 8;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (k0 + r < len) val = *reinterpret_cast<const uint4*>(kp + (size_t)(k0 + r) * kss + c);
      *reinterpret_cast<uint4*>(sK + r * LD + c) = val;
    }
    for (int i = lane; i < DK * CH; i += 32) {
      const int r = i % DK, c = (i / DK) * 8;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (k0 + r < len) val = *reinterpret_cast<const uint4*>(vp + (size_t)(k0 + r) * vss + c);
      const bf16* e = reinterpret_cast<const bf16*>(&val);
#pragma unroll
      for (int j = 0; j < 8; ++j) sVt[(c + j) * LDV + r] = e[j];
    }
    __syncwarp();

    float s[DK / 8][4];
    qk_product<DK / 8, D>(qf, sK, LD, g, t, s);
#pragma unroll
    for (int j = 0; j < DK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k0 + j * 8 + 2 * t + (e & 1);
        s[j][e] = kpos < len ? s[j][e] * sl2 : NEG_INF;
      }
    }
    softmax_step<DK / 8, D / 8>(s, m0, m1, l0, l1, acc);
    pv_product<DK / 8, D>(s, sVt, LDV, g, t, acc);
    __syncwarp();
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
  bf16* op = o + ((size_t)b * Hq + (size_t)hk * group) * D;
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
      const float c = exp2f(mw - mx);
      num += so[(w * 16 + r) * D + d] * c;
      den += sl[w * 16 + r] * c;
    }
    op[(size_t)r * D + d] = __float2bfloat16(num / (den == 0.f ? 1.f : den));
  }
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

template <int D>
static int launch_prefill(const void* q, const void* k, const void* v, void* o,
                          int B, int Hq, int Hkv, int S, int causal,
                          int window, int qsb, int qsh, int qss, int ksb,
                          int ksh, int kss, int vsb, int vsh, int vss,
                          float scale, cudaStream_t stream) {
  const int bytes = (BK * (D + PAD) + D * (BK + PAD)) * (int)sizeof(bf16);
  const int err = set_smem((const void*)flash_prefill_kernel<D>, bytes);
  if (err) return err;
  const dim3 grid((S + BQ - 1) / BQ, Hq, B);
  flash_prefill_kernel<D><<<grid, PF_THREADS, bytes, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, S, Hq,
      Hq / Hkv, causal, window, qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss,
      scale);
  return (int)cudaGetLastError();
}

template <int D>
static int launch_decode(const void* q, const void* k, const void* v,
                         const void* kv_len, void* o, int B, int Hq, int Hkv,
                         int S, int qsb, int qsh, int ksb, int ksh, int kss,
                         int vsb, int vsh, int vss, float scale,
                         cudaStream_t stream) {
  const int tiles = DEC_WARPS * (DK * (D + PAD) + D * (DK + PAD)) * (int)sizeof(bf16);
  const int merge = DEC_WARPS * 16 * (D + 2) * (int)sizeof(float);
  const int bytes = tiles > merge ? tiles : merge;
  const int err = set_smem((const void*)flash_decode_kernel<D>, bytes);
  if (err) return err;
  const dim3 grid(Hkv, B);
  flash_decode_kernel<D><<<grid, DEC_THREADS, bytes, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const int*)kv_len,
      (bf16*)o, S, Hq, Hq / Hkv, qsb, qsh, ksb, ksh, kss, vsb, vsh, vss,
      scale);
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
                               qsh, qss, ksb, ksh, kss, vsb, vsh, vss, scale, st);
  return (int)cudaErrorInvalidValue;
}

// o: contiguous (B, Hq, D) bf16; kv_len: (B,) int32 on the card.
extern "C" int fa_decode(const void* q, const void* k, const void* v,
                         const void* kv_len, void* o, int B, int Hq, int Hkv,
                         int S, int D, int qsb, int qsh, int ksb, int ksh,
                         int kss, int vsb, int vsh, int vss, float scale,
                         void* stream) {
  cudaGetLastError();
  const cudaStream_t st = (cudaStream_t)stream;
  if (D == 128)
    return launch_decode<128>(q, k, v, kv_len, o, B, Hq, Hkv, S, qsb, qsh, ksb,
                              ksh, kss, vsb, vsh, vss, scale, st);
  return (int)cudaErrorInvalidValue;
}
