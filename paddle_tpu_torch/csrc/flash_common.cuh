// Parts shared by the flash-attention forward (flash_attention.cu) and
// backward (flash_attention_bwd.cu) kernels for Hopper (sm_90a).
//
// The products.  Every warp computes its products in one output layout,
// the mma accumulator's, so the softmax, masks and stores around them are
// the same code for both dtypes:
//   * bfloat16: warp-wide mma.sync.m16n8k16 on the tensor cores with
//     float32 accumulators, the fragments loaded from shared memory by
//     ldmatrix (ldmatrix.trans for an operand stored with its depth along
//     rows);
//   * float32: register-tiled CUDA-core FMAs, each thread a 2 x 16 tile of
//     outputs (2 x 8 for a 32-key block), its operands read as float4
//     along the depth where a row holds it (Q·Kᵀ, dO·Vᵀ) and as float2
//     rows otherwise.  Each output is one fmaf chain in depth order, as
//     the earlier CUDA-core kernels summed.  3xTF32 on the tensor cores
//     (hi = tf32(x), lo = x - hi, three TF32 products) passed every kernel
//     check against the plain version, but its tensor-core sums moved the
//     static BERT program's scores enough, under the padding bias below,
//     that the card's training loss left the host's by 6.5e-4 against the
//     check's 1e-4; plain TF32 is never used.
//
// Shared-memory tiles.  A [rows, D] tile is stored row-major with rows of
// DMAX + PAD elements: for float32 PAD = 4, so a row stride is 4 words
// mod 32 and the float4 reads of 8 rows touch 32 distinct banks; for
// bfloat16 PAD = 8, so a row is an odd number of 16-byte chunks and the 8
// rows an ldmatrix reads fall in distinct bank groups.  Tiles arrive by
// 16-byte cp.async; rows past T and the columns from D up to DK, the
// depth rounded up to the mma's (16 for bfloat16), are zero-filled.
//
// One score function.  score_tile computes the scaled, biased scores of a
// warp's 16 query rows: Q·Kᵀ with Q as A and K as B, in the same order
// over d in every kernel, then __fmul_rn by the scale and __fadd_rn of
// the bias (no contraction).  The forward and both backward kernels call
// it, so exp(score - m) / l in the backward reproduces the forward's P
// from the saved row max m and row sum l.  That matters for the static
// BERT program's padding bias, about -1e8, where float32 keeps only
// multiples of 8: a score rounded differently moves by 8, and a folded
// log-sum-exp m + log l would round the log away, so m and l are kept
// apart.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace flash {

constexpr int BN = 64;   // key rows of the dK/dV kernel's blocks

// key rows of a K/V tile streamed past the query rows: 64 in bfloat16; 32
// in float32, whose rows take twice the shared memory, so that as many
// blocks fit on an SM
template <typename T>
__host__ __device__ constexpr int kv_rows() {
  return sizeof(T) == 2 ? 64 : 32;
}

template <typename T> struct Elem;
// HILO: whether the backward's P and dS enter their products as hi/lo
// pairs of this type (float32 keeps them whole)
template <> struct Elem<float> {
  static constexpr int KSTEP = 8;   // D is a multiple of 8 already
  static constexpr int PAD = 4;
  static constexpr bool HILO = false;
};
template <> struct Elem<__nv_bfloat16> {
  static constexpr int KSTEP = 16;  // depth of one m16n8k16 bf16 mma
  static constexpr int PAD = 8;
  static constexpr bool HILO = true;
};

// depth of the score products: D rounded up to the mma's depth
template <typename T>
__host__ __device__ __forceinline__ int depth(int D) {
  return (D + Elem<T>::KSTEP - 1) / Elem<T>::KSTEP * Elem<T>::KSTEP;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// two adjacent values (p 2-element aligned) in one store
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// what rounding x to bfloat16 drops: x = bf16(x) + bf16_rest(x), the
// rest itself a bfloat16 to within 2^-16 of x
__device__ __forceinline__ float bf16_rest(float x) {
  return x - __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// asynchronous copies
// ---------------------------------------------------------------------------

// 16 bytes global -> shared; with valid false, 16 zero bytes
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::
                   "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [r0, r0 + ROWS) of a [T, D] slice with row stride `stride`
// elements (base and stride 16-byte aligned, which the wrapper checks) ->
// a shared tile of row stride `ld`.  Rows past T and columns [D, DK) are
// zero-filled.  Every thread of the block takes part; the caller commits.
template <typename T, int ROWS, int NTHREADS>
__device__ __forceinline__ void load_tile_async(T* dst, int ld, const T* src,
                                                int64_t stride, int r0, int T_,
                                                int D, int DK) {
  constexpr int EPC = 16 / sizeof(T);   // elements per 16-byte chunk
  const int chunks = DK / EPC;
  const int valid_chunks = D / EPC;
  for (int idx = threadIdx.x; idx < ROWS * chunks; idx += NTHREADS) {
    const int r = idx / chunks;
    const int c = idx - r * chunks;
    const int row = r0 + r;
    const bool ok = row < T_ && c < valid_chunks;
    const T* s = ok ? src + row * stride + c * EPC : src;
    cp_async16(dst + r * ld + c * EPC, s, ok);
  }
}

// ---------------------------------------------------------------------------
// bfloat16: mma.sync and ldmatrix
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ---------------------------------------------------------------------------
// the warp-level products
// ---------------------------------------------------------------------------
//
// Both dtypes keep one output layout, the mma accumulator's (PTX ISA, lane
// = 4g + t): a 16 x 8 tile c holds c[0], c[1] at row g, columns 2t, 2t + 1
// and c[2], c[3] at row g + 8, the same columns.  A thread so owns a 2 x
// 2·NT register tile of a 16 x 8·NT block.  bfloat16 fills it by mma;
// float32 by CUDA-core FMAs, each output one fmaf chain in depth order.

// acc[j] += A · Bᵀ over depth [0, dk), the products Q·Kᵀ and dO·Vᵀ.
// a_s: the warp's 16 rows of A; b_s: 8·NT rows of B (the keys); both
// shared tiles of row stride ld with the depth along the row.  float32
// reads both operands as float4 along the depth.
template <int NT>
__device__ __forceinline__ void mma_nt(float (&acc)[NT][4], const float* a_s,
                                       const float* b_s, int ld, int dk,
                                       int lane) {
  const int g = lane >> 2, t = lane & 3;
  for (int k0 = 0; k0 < dk; k0 += 4) {
    const float4 a0 = *reinterpret_cast<const float4*>(a_s + g * ld + k0);
    const float4 a1 =
        *reinterpret_cast<const float4*>(a_s + (g + 8) * ld + k0);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float4 b = *reinterpret_cast<const float4*>(
            b_s + (8 * j + 2 * t + e) * ld + k0);
        float& c0 = acc[j][e];
        float& c1 = acc[j][2 + e];
        c0 = fmaf(a0.x, b.x, c0);
        c0 = fmaf(a0.y, b.y, c0);
        c0 = fmaf(a0.z, b.z, c0);
        c0 = fmaf(a0.w, b.w, c0);
        c1 = fmaf(a1.x, b.x, c1);
        c1 = fmaf(a1.y, b.y, c1);
        c1 = fmaf(a1.z, b.z, c1);
        c1 = fmaf(a1.w, b.w, c1);
      }
    }
  }
}

template <int NT>
__device__ __forceinline__ void mma_nt(float (&acc)[NT][4],
                                       const __nv_bfloat16* a_s,
                                       const __nv_bfloat16* b_s, int ld,
                                       int dk, int lane) {
  static_assert(NT % 2 == 0, "bf16 B fragments come in pairs of n-tiles");
  for (int k0 = 0; k0 < dk; k0 += 16) {
    uint32_t a[4];
    ldsm_x4(a, a_s + (lane & 15) * ld + k0 + (lane >> 4) * 8);
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      uint32_t b[4];
      ldsm_x4(b, b_s + (j * 8 + (lane & 7) + (lane >> 4) * 8) * ld + k0 +
                     ((lane >> 3) & 1) * 8);
      mma_bf16(acc[j], a, b[0], b[1]);
      mma_bf16(acc[j + 1], a, b[2], b[3]);
    }
  }
}

// float32: acc[n] += a0 · B[k, :] in row g and a1 · B[k, :] in row g + 8,
// for the n-tiles inside D; b points at row k of B, column 2t.
template <int NTD>
__device__ __forceinline__ void fma_row(float (&acc)[NTD][4], float a0,
                                        float a1, const float* b, int D) {
#pragma unroll
  for (int n = 0; n < NTD; ++n) {
    if (n * 8 < D) {
      const float2 bv = *reinterpret_cast<const float2*>(b + 8 * n);
      acc[n][0] = fmaf(a0, bv.x, acc[n][0]);
      acc[n][1] = fmaf(a0, bv.y, acc[n][1]);
      acc[n][2] = fmaf(a1, bv.x, acc[n][2]);
      acc[n][3] = fmaf(a1, bv.y, acc[n][3]);
    }
  }
}

// bfloat16: acc[n] += A · B[k0 : k0 + 16, :] for the n-tiles inside D, A
// one fragment, B a shared tile whose depth runs down its rows (read by
// ldmatrix.trans).
template <int NTD>
__device__ __forceinline__ void mma_rows_step(float (&acc)[NTD][4],
                                              const uint32_t (&a)[4],
                                              const __nv_bfloat16* b_s,
                                              int ld, int k0, int D,
                                              int lane) {
  static_assert(NTD % 2 == 0, "bf16 B fragments come in pairs of n-tiles");
#pragma unroll
  for (int n = 0; n < NTD; n += 2) {
    if (n * 8 < D) {
      uint32_t b[4];
      ldsm_x4_trans(b, b_s + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld +
                           n * 8 + (lane >> 4) * 8);
      mma_bf16(acc[n], a, b[0], b[1]);
      if ((n + 1) * 8 < D) mma_bf16(acc[n + 1], a, b[2], b[3]);
    }
  }
}

// acc += P · B, P a 16 x 8·KT block held as KT accumulator tiles (the
// products P·V and dS·K), B the shared tile of 8·KT rows (depth down its
// rows).  float32 takes each depth's two P values from the lane that holds
// them by shuffles; bfloat16 rounds P to bfloat16, whose accumulator tiles
// then are mma A fragments as they stand.
template <int KT, int NTD>
__device__ __forceinline__ void mma_reg_a(float (&acc)[NTD][4],
                                          const float (&p)[KT][4],
                                          const float* b_s, int ld, int D,
                                          int lane) {
  const int t = lane & 3, base = lane & ~3;
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) {
#pragma unroll
    for (int tt = 0; tt < 4; ++tt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        // P[g][k] and P[g + 8][k] of depth k = 8 kt + 2 tt + e
        const float a0 = __shfl_sync(0xffffffffu, p[kt][e], base + tt);
        const float a1 = __shfl_sync(0xffffffffu, p[kt][2 + e], base + tt);
        fma_row(acc, a0, a1, b_s + (8 * kt + 2 * tt + e) * ld + 2 * t, D);
      }
    }
  }
}

template <int KT, int NTD>
__device__ __forceinline__ void mma_reg_a(float (&acc)[NTD][4],
                                          const float (&p)[KT][4],
                                          const __nv_bfloat16* b_s, int ld,
                                          int D, int lane) {
  static_assert(KT % 2 == 0, "a bf16 A fragment is two accumulator tiles");
#pragma unroll
  for (int kk = 0; kk < KT / 2; ++kk) {
    uint32_t a[4];
    a[0] = pack_bf16(p[2 * kk][0], p[2 * kk][1]);
    a[1] = pack_bf16(p[2 * kk][2], p[2 * kk][3]);
    a[2] = pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]);
    a[3] = pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3]);
    mma_rows_step(acc, a, b_s, ld, kk * 16, D, lane);
  }
}

// acc += Xᵀ · B over depth [0, KD), the products Pᵀ·dO and dSᵀ·Q.  x_s:
// the shared P or dS tile (rows = depth, the queries; row stride ldx),
// offset to the warp's first of 16 columns (its keys); b_s: the shared
// tile of KD rows.  bfloat16 reads X by ldmatrix.trans.
template <int KD, int NTD>
__device__ __forceinline__ void mma_trans_a(float (&acc)[NTD][4],
                                            const float* x_s, int ldx,
                                            const float* b_s, int ld, int D,
                                            int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll 4
  for (int k = 0; k < KD; ++k)
    fma_row(acc, x_s[k * ldx + g], x_s[k * ldx + g + 8],
            b_s + k * ld + 2 * t, D);
}

template <int KD, int NTD>
__device__ __forceinline__ void mma_trans_a(float (&acc)[NTD][4],
                                            const __nv_bfloat16* x_s,
                                            int ldx,
                                            const __nv_bfloat16* b_s, int ld,
                                            int D, int lane) {
#pragma unroll
  for (int k0 = 0; k0 < KD; k0 += 16) {
    uint32_t a[4];
    ldsm_x4_trans(a, x_s + (k0 + (lane & 7) + (lane >> 4) * 8) * ldx +
                         ((lane >> 3) & 1) * 8);
    mma_rows_step(acc, a, b_s, ld, k0, D, lane);
  }
}

// ---------------------------------------------------------------------------
// the score function
// ---------------------------------------------------------------------------

struct ScoreArgs {
  const float* bias;   // at (b, h), or null
  int64_t bias_q, bias_k;   // its query and key strides (0 if broadcast)
  float scale;
  int Tq, Tk;
  int causal;
};

// s[j] = the scores of the warp's 16 query rows q0 + [0, 16) against keys
// k0 + 8j + [0, 8): Q·Kᵀ by mma_nt over depth [0, dk), then
// __fmul_rn(·, scale) and __fadd_rn(·, bias).  A key past Tk, or past the
// query under the causal mask, scores -inf.  Query rows past Tq read the
// bias of row Tq - 1; the callers drop them.
template <typename T, int NT>
__device__ __forceinline__ void score_tile(float (&s)[NT][4], const T* q_s,
                                           const T* k_s, int ld, int dk,
                                           const ScoreArgs& a, int q0, int k0,
                                           int lane) {
  const int g = lane >> 2, t = lane & 3;
  // the bias loads are issued before the products, so their latency
  // hides behind the mma chain
  float bv[2][NT][2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qi = q0 + g + 8 * h;
    const float* brow =
        a.bias != nullptr ? a.bias + (qi < a.Tq ? qi : a.Tq - 1) * a.bias_q
                          : nullptr;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kj = k0 + 8 * j + 2 * t + e;
        bv[h][j][e] =
            brow != nullptr && kj < a.Tk ? brow[kj * a.bias_k] : 0.f;
      }
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
  mma_nt(s, q_s, k_s, ld, dk, lane);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qi = q0 + g + 8 * h;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kj = k0 + 8 * j + 2 * t + e;
        float x = __fmul_rn(s[j][2 * h + e], a.scale);
        if (a.bias != nullptr) x = __fadd_rn(x, bv[h][j][e]);
        const bool valid = kj < a.Tk && (!a.causal || kj <= qi);
        s[j][2 * h + e] = valid ? x : -INFINITY;
      }
    }
  }
}

}  // namespace flash
