// Dropout and the two epilogues fused with it, for Hopper (sm_90a), written
// by hand: five entry points over one counter-based generator.
//
// Replaces, in paddle_tpu/ops/pallas_kernels.py:
//   pt_dropout          _run_dropout :175 (pallas_call :178), the kernel of
//                       fused_dropout_tpu :693 and of the backward of dropout
//                       (_fused_dropout_bwd :203) and of dropout-add's x
//                       (_fused_dropout_add_bwd :271), applied to the
//                       cotangent;
//   pt_dropout_mask     fused_dropout_tpu.mask_fn :706 (pallas_call :709);
//   pt_dropout_add      _run_dropout_add :246 (pallas_call :249), the kernel
//                       of fused_dropout_add_tpu :280;
//   pt_act_dropout      _fused_act_dropout :348 (pallas_call :352), the
//                       kernel of fused_act_dropout_tpu :392;
//   pt_act_dropout_bwd  _fused_act_dropout_bwd :370 (pallas_call :375).
//
// The bits.  The TPU kernels draw from the core's hardware PRNG seeded per
// grid block; that stream exists nowhere else.  Here every element draws
// from Philox4x32-10 (Salmon et al., SC'11; Random123's philox4x32 with its
// published round and key constants), written out below, no cuRAND:
//
//   key     = (low, high) 32-bit words of the 64-bit op seed
//   counter = (j mod 2^32, j / 2^32, 0, 0) for group j = i / 4
//   bits[i] = word i % 4 of philox4x32_10(counter, key)
//   keep[i] = bits[i] >= threshold,  threshold = min(rate * 2^32, 2^32 - 1)
//
// so the mask is a function of (seed, flat index) alone: not of the grid,
// the block, the dtype or the launch, and the backward regenerates the
// forward's mask from the seed with no mask in memory.  The plain version
// (paddle_tpu_torch/ops/nn_ops.py _reference_keep) computes the same bits
// with 64-bit integer tensor ops, on any device.
//
// The arithmetic.  Every value is read as float32, computed in float32 and
// rounded once to the output's type (float32 or bfloat16, round to
// nearest even).  Kept values are x * scale, scale = float32(1/(1-rate))
// or 1; dropout and dropout-add use explicitly rounded intrinsics
// (__fmul_rn, __fadd_rn) so that nvcc contracts nothing into an FMA and
// the results are bit for bit the plain version's separate torch ops.
// gelu is the exact erf form, 0.5 x (1 + erf(x / sqrt 2)), with erff (the
// TPU kernel used Abramowitz-Stegun 7.1.26 only because Mosaic has no
// erf); its derivative is Phi(x) + x phi(x).
//
// What bounds these on this card: bytes, but for the mask.  Each element
// is read once per input and written once.  The generator is not free:
// Philox4x32-10 needs, per group of four, ten rounds of two 32x32->64
// multiplies (the FMA pipe) and two three-way xors (the ALU pipe), then
// four compares (ALU): 24 ALU-pipe operations at 64 lanes a clock per SM,
// 0.375 SM clocks a group.  At the BERT-base step's [8192, 768], over 132
// SMs at 1980 MHz, that is 2.3 us: under the float32 dropout's 50.3 MB of
// bytes (15.0 us at 3.35 TB/s) and act-dropout's [8192, 3072] backward's
// 302 MB (90.1 us), but above the mask's 6.3 MB (1.9 us), which the
// integer work binds (chip_smoke.py _dropout_bound).  The design: every
// thread computes the ten round keys once.  The value kernels: one thread
// per group of four elements, grid-stride, 16-byte (float32) or 8-byte
// (bfloat16) vector loads and stores where the pointers allow, no shared
// memory.  The mask, whose only work is the generator's: eight groups a
// thread as eight independent chains interleaved round by round, their
// 32 bytes packed into two 16-byte stores, the group counter in 32 bits.
//
// Layout: contiguous buffers of n elements, any n (a tail group shorter
// than four, or a mask tail shorter than a thread's 32 bytes, takes the
// scalar path).  The kernels allocate nothing and launch on the caller's
// stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int NUM_THREADS = 256;
constexpr int MAX_BLOCKS = 132 * 16;   // several waves over 132 SMs
constexpr int MASK_GROUPS = 8;         // Philox groups a mask thread draws
static_assert(MASK_GROUPS % 4 == 0 && (MASK_GROUPS & (MASK_GROUPS - 1)) == 0,
              "the mask kernel stores four groups a uint4 and keeps a "
              "chunk's groups under one high counter word");

// Random123's philox4x32 constants
constexpr uint32_t PHILOX_M0 = 0xD2511F53u;
constexpr uint32_t PHILOX_M1 = 0xCD9E8D57u;
constexpr uint32_t PHILOX_W0 = 0x9E3779B9u;
constexpr uint32_t PHILOX_W1 = 0xBB67AE85u;

struct Key {
  uint32_t k0, k1;
};

// the ten round keys of a key, the Weyl constants added before every
// round but the first: the same for every group of a call, so a thread
// computes them once
struct RoundKeys {
  uint32_t k0[10], k1[10];
};

__device__ __forceinline__ RoundKeys round_keys(Key key) {
  RoundKeys rk;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    rk.k0[r] = key.k0 + static_cast<uint32_t>(r) * PHILOX_W0;
    rk.k1[r] = key.k1 + static_cast<uint32_t>(r) * PHILOX_W1;
  }
  return rk;
}

// One Philox round on x under round key (k0, k1).  Each 32x32->64 product
// is written as __umulhi and the low product, and nvcc chooses: one
// IMAD.WIDE.U32 for the pair in the mask kernel, IMAD.HI and IMAD in the
// value kernels (spelled as one 64-bit product, it slowed the bfloat16
// act-dropout backward on the card; PERF.md section 6).
__device__ __forceinline__ void philox_round(uint32_t x[4], uint32_t k0,
                                             uint32_t k1) {
  const uint32_t hi0 = __umulhi(PHILOX_M0, x[0]), lo0 = PHILOX_M0 * x[0];
  const uint32_t hi1 = __umulhi(PHILOX_M1, x[2]), lo1 = PHILOX_M1 * x[2];
  const uint32_t y0 = hi1 ^ x[1] ^ k0;
  const uint32_t y2 = hi0 ^ x[3] ^ k1;
  x[0] = y0;
  x[1] = lo1;
  x[2] = y2;
  x[3] = lo0;
}

// Philox4x32-10 of counter (c0, c1, 0, 0)
__device__ __forceinline__ uint4 philox4x32_10(uint32_t c0, uint32_t c1,
                                               const RoundKeys& rk) {
  uint32_t x[4] = {c0, c1, 0u, 0u};
#pragma unroll
  for (int r = 0; r < 10; ++r) philox_round(x, rk.k0[r], rk.k1[r]);
  return make_uint4(x[0], x[1], x[2], x[3]);
}

// the keep bits of group j's four elements
__device__ __forceinline__ void keep4(int64_t j, const RoundKeys& rk,
                                      uint32_t threshold, bool keep[4]) {
  const uint4 b = philox4x32_10(static_cast<uint32_t>(j),
                                static_cast<uint32_t>(j >> 32), rk);
  keep[0] = b.x >= threshold;
  keep[1] = b.y >= threshold;
  keep[2] = b.z >= threshold;
  keep[3] = b.w >= threshold;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// four elements from base (all four when VEC and the group is whole: one
// 16-byte float32 or 8-byte bfloat16 load); missing elements read 0
template <typename T, bool VEC>
__device__ __forceinline__ void load4(const T* __restrict__ p, int64_t base,
                                      int64_t n, float v[4]) {
  if (VEC && base + 4 <= n) {
    if constexpr (std::is_same<T, float>::value) {
      const float4 f = *reinterpret_cast<const float4*>(p + base);
      v[0] = f.x;
      v[1] = f.y;
      v[2] = f.z;
      v[3] = f.w;
    } else {
      const uint2 u = *reinterpret_cast<const uint2*>(p + base);
      const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
      const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
      v[0] = __low2float(a);
      v[1] = __high2float(a);
      v[2] = __low2float(b);
      v[3] = __high2float(b);
    }
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) v[e] = base + e < n ? to_f32(p[base + e]) : 0.0f;
}

template <typename T, bool VEC>
__device__ __forceinline__ void store4(T* __restrict__ p, int64_t base,
                                       int64_t n, const float v[4]) {
  if (VEC && base + 4 <= n) {
    if constexpr (std::is_same<T, float>::value) {
      *reinterpret_cast<float4*>(p + base) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
      __nv_bfloat162 a, b;
      a.x = __float2bfloat16_rn(v[0]);
      a.y = __float2bfloat16_rn(v[1]);
      b.x = __float2bfloat16_rn(v[2]);
      b.y = __float2bfloat16_rn(v[3]);
      uint2 u;
      u.x = *reinterpret_cast<const uint32_t*>(&a);
      u.y = *reinterpret_cast<const uint32_t*>(&b);
      *reinterpret_cast<uint2*>(p + base) = u;
    }
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (base + e < n) p[base + e] = from_f32<T>(v[e]);
}

constexpr int ACT_GELU = 0;
constexpr int ACT_RELU = 1;

__device__ __forceinline__ float act_fwd(float x, int act) {
  if (act == ACT_RELU) return x > 0.0f ? x : 0.0f;
  const float e = erff(__fmul_rn(x, 0.70710678118654752f));
  return __fmul_rn(__fmul_rn(0.5f, x), __fadd_rn(1.0f, e));
}

__device__ __forceinline__ float act_grad(float x, int act) {
  if (act == ACT_RELU) return x > 0.0f ? 1.0f : 0.0f;
  // Phi(x) + x phi(x), phi the standard normal density
  const float e = erff(__fmul_rn(x, 0.70710678118654752f));
  const float phi_cdf = __fmul_rn(0.5f, __fadd_rn(1.0f, e));
  const float pdf = expf(__fmul_rn(__fmul_rn(-0.5f, x), x));
  return __fadd_rn(phi_cdf,
                   __fmul_rn(__fmul_rn(x, 0.3989422804014327f), pdf));
}

// One kernel body for the four value-producing entry points.  KIND:
// 0 dropout (a = x), 1 dropout-add (a = x, + r), 2 act-dropout (a =
// act(x)), 3 act-dropout backward ((keep ? g*scale : 0) * act'(x)).
template <typename T, bool VEC, int KIND>
__global__ void __launch_bounds__(NUM_THREADS)
dropout_kernel(const T* __restrict__ x, const T* __restrict__ y,
               T* __restrict__ out, int64_t n, Key key, uint32_t threshold,
               float scale, int act) {
  const RoundKeys rk = round_keys(key);
  const int64_t groups = (n + 3) / 4;
  const int64_t stride = (int64_t)gridDim.x * NUM_THREADS;
  for (int64_t j = (int64_t)blockIdx.x * NUM_THREADS + threadIdx.x;
       j < groups; j += stride) {
    const int64_t base = 4 * j;
    bool keep[4];
    keep4(j, rk, threshold, keep);
    float xv[4], yv[4], o[4];
    load4<T, VEC>(x, base, n, xv);
    if (KIND != 0 && KIND != 2) load4<T, VEC>(y, base, n, yv);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (KIND == 0 || KIND == 1) {
        o[e] = keep[e] ? __fmul_rn(xv[e], scale) : 0.0f;
        if (KIND == 1) o[e] = __fadd_rn(o[e], yv[e]);
      } else if (KIND == 2) {
        o[e] = keep[e] ? __fmul_rn(act_fwd(xv[e], act), scale) : 0.0f;
      } else {   // y is the cotangent
        const float gk = keep[e] ? __fmul_rn(yv[e], scale) : 0.0f;
        o[e] = __fmul_rn(gk, act_grad(xv[e], act));
      }
    }
    store4<T, VEC>(out, base, n, o);
  }
}

// the mask bytes (0 or 1) of one group's four words, element 0 in the
// lowest byte
__device__ __forceinline__ uint32_t keep_bytes(const uint32_t x[4],
                                               uint32_t threshold) {
  return (x[0] >= threshold ? 0x1u : 0u) | (x[1] >= threshold ? 0x100u : 0u) |
         (x[2] >= threshold ? 0x10000u : 0u) |
         (x[3] >= threshold ? 0x1000000u : 0u);
}

// MASK_GROUPS groups of four a thread, 4 * MASK_GROUPS mask bytes in
// 16-byte stores.  The thread's chunk t holds groups G·t .. G·t + G - 1
// (G = MASK_GROUPS, a power of two); G·t is a multiple of G, so their
// counters share the high word (G·t) >> 32 and their low words G·t + g
// (mod 2^32) never carry into it: the counting stays in 32 bits for any
// n.  The G Philox chains are independent and interleave round by round.
__global__ void __launch_bounds__(NUM_THREADS)
dropout_mask_kernel(uint8_t* __restrict__ mask, int64_t n, Key key,
                    uint32_t threshold) {
  constexpr int G = MASK_GROUPS;
  constexpr int BYTES = 4 * G;
  const RoundKeys rk = round_keys(key);
  const int64_t chunks = (n + BYTES - 1) / BYTES;
  const int64_t stride = (int64_t)gridDim.x * NUM_THREADS;
  for (int64_t t = (int64_t)blockIdx.x * NUM_THREADS + threadIdx.x;
       t < chunks; t += stride) {
    const uint32_t lo = static_cast<uint32_t>(t) * G;
    const uint32_t hi = static_cast<uint32_t>((t * G) >> 32);
    uint32_t x[G][4];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      x[g][0] = lo + g;
      x[g][1] = hi;
      x[g][2] = 0u;
      x[g][3] = 0u;
    }
#pragma unroll
    for (int r = 0; r < 10; ++r)
#pragma unroll
      for (int g = 0; g < G; ++g) philox_round(x[g], rk.k0[r], rk.k1[r]);
    uint32_t m[G];
#pragma unroll
    for (int g = 0; g < G; ++g) m[g] = keep_bytes(x[g], threshold);
    const int64_t base = t * BYTES;
    if (base + BYTES <= n) {
#pragma unroll
      for (int q = 0; q < G / 4; ++q)
        *reinterpret_cast<uint4*>(mask + base + 16 * q) =
            make_uint4(m[4 * q], m[4 * q + 1], m[4 * q + 2], m[4 * q + 3]);
    } else {   // the tail, shorter than a chunk
#pragma unroll
      for (int e = 0; e < BYTES; ++e)
        if (base + e < n)
          mask[base + e] = static_cast<uint8_t>(m[e / 4] >> (8 * (e % 4)));
    }
  }
}

int blocks_for(int64_t n) {
  const int64_t want = ((n + 3) / 4 + NUM_THREADS - 1) / NUM_THREADS;
  return static_cast<int>(want < MAX_BLOCKS ? (want > 0 ? want : 1)
                                            : MAX_BLOCKS);
}

bool aligned(const void* p, int bytes) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <typename T, int KIND>
int launch_typed(const void* x, const void* y, void* out, int64_t n, Key key,
                 uint32_t threshold, float scale, int act,
                 cudaStream_t stream) {
  const int vec_bytes = 4 * sizeof(T);
  const bool vec = aligned(x, vec_bytes) && aligned(y, vec_bytes) &&
                   aligned(out, vec_bytes);
  const T* xt = static_cast<const T*>(x);
  const T* yt = static_cast<const T*>(y);
  T* ot = static_cast<T*>(out);
  if (vec)
    dropout_kernel<T, true, KIND><<<blocks_for(n), NUM_THREADS, 0, stream>>>(
        xt, yt, ot, n, key, threshold, scale, act);
  else
    dropout_kernel<T, false, KIND><<<blocks_for(n), NUM_THREADS, 0, stream>>>(
        xt, yt, ot, n, key, threshold, scale, act);
  return static_cast<int>(cudaGetLastError());
}

// dtype: 0 float32, 1 bfloat16
template <int KIND>
int launch(const void* x, const void* y, void* out, int64_t n, uint32_t k0,
           uint32_t k1, uint32_t threshold, float scale, int act, int dtype,
           void* stream) {
  if (n <= 0 || (dtype != 0 && dtype != 1) ||
      (act != ACT_GELU && act != ACT_RELU))
    return static_cast<int>(cudaErrorInvalidValue);
  const Key key{k0, k1};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0
             ? launch_typed<float, KIND>(x, y, out, n, key, threshold, scale,
                                         act, s)
             : launch_typed<__nv_bfloat16, KIND>(x, y, out, n, key, threshold,
                                                 scale, act, s);
}

}  // namespace

extern "C" {

// Each returns a cudaError_t (0 = launched).  k0, k1: the seed's low and
// high words; scale rounded to float32 by the caller.

// out = keep ? x * scale : 0
int pt_dropout(const void* x, void* out, int64_t n, uint32_t k0, uint32_t k1,
               uint32_t threshold, float scale, int dtype, void* stream) {
  return launch<0>(x, nullptr, out, n, k0, k1, threshold, scale, ACT_GELU,
                   dtype, stream);
}

// mask = keep (uint8 0/1); mask 16-byte aligned (torch.empty's are)
int pt_dropout_mask(uint8_t* mask, int64_t n, uint32_t k0, uint32_t k1,
                    uint32_t threshold, void* stream) {
  if (n <= 0 || mask == nullptr || !aligned(mask, 16))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t want =
      ((n + 4 * MASK_GROUPS - 1) / (4 * MASK_GROUPS) + NUM_THREADS - 1) /
      NUM_THREADS;   // a thread a chunk, up to MAX_BLOCKS
  const int blocks = static_cast<int>(want < MAX_BLOCKS ? want : MAX_BLOCKS);
  dropout_mask_kernel<<<blocks, NUM_THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      mask, n, Key{k0, k1}, threshold);
  return static_cast<int>(cudaGetLastError());
}

// out = (keep ? x * scale : 0) + r
int pt_dropout_add(const void* x, const void* r, void* out, int64_t n,
                   uint32_t k0, uint32_t k1, uint32_t threshold, float scale,
                   int dtype, void* stream) {
  return launch<1>(x, r, out, n, k0, k1, threshold, scale, ACT_GELU, dtype,
                   stream);
}

// out = keep ? act(x) * scale : 0;  act: 0 gelu (erf), 1 relu
int pt_act_dropout(const void* x, void* out, int64_t n, uint32_t k0,
                   uint32_t k1, uint32_t threshold, float scale, int act,
                   int dtype, void* stream) {
  return launch<2>(x, nullptr, out, n, k0, k1, threshold, scale, act, dtype,
                   stream);
}

// dx = (keep ? g * scale : 0) * act'(x)
int pt_act_dropout_bwd(const void* x, const void* g, void* dx, int64_t n,
                       uint32_t k0, uint32_t k1, uint32_t threshold,
                       float scale, int act, int dtype, void* stream) {
  return launch<3>(x, g, dx, n, k0, k1, threshold, scale, act, dtype, stream);
}

const char* pt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
