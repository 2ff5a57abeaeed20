// Fused Adam step over a flattened parameter bucket, for Hopper (sm_90a),
// written by hand.
//
// Replaces paddle_tpu/ops/pallas_kernels.py:647 fused_adam_tpu (the
// pallas_call at :652), the kernel of the fuse_optimizer pass's bucketed
// update.  Five inputs and three outputs, element for element:
//
//   m' = b1 * m + (1 - b1) * g
//   v' = b2 * v + (1 - b2) * (g * g)
//   p' = p - lrt * m' / (sqrt(v') + eps)
//
// lrt is each element's bias-corrected learning rate, broadcast over its
// parameter's segment outside the kernel.  Contract: bit-identical to the
// per-parameter adam lowering, which torch runs as separate kernels that
// round every product and sum.  So every multiply, add, square root and
// division here is an explicitly rounded intrinsic (__fmul_rn, __fadd_rn,
// __fsqrt_rn, __fdiv_rn): nvcc can contract none of them into an FMA.
//
// What bounds it on this card: bytes.  8 x 4 bytes per element (5 read, 3
// written) and 13 flops: at BERT-base's 51.79 M-element bucket that is
// 1.657 GB, 0.495 ms at 3.35 TB/s.  The design streams each input once in
// 16-byte vector loads, grid-stride, with no shared memory.
//
// Layout: contiguous float32 buffers of n elements, any n (the flattened
// bucket, unpadded; a tail of n % 4 takes a scalar loop).  The kernel allocates nothing and launches on the
// caller's stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NUM_THREADS = 256;

struct Coeffs {
  float b1, omb1, b2, omb2, eps;
};

__device__ __forceinline__ void adam_one(float p, float g, float m, float v,
                                         float lrt, const Coeffs& c,
                                         float* po, float* mo, float* vo) {
  const float m_new = __fadd_rn(__fmul_rn(c.b1, m), __fmul_rn(c.omb1, g));
  const float v_new =
      __fadd_rn(__fmul_rn(c.b2, v), __fmul_rn(c.omb2, __fmul_rn(g, g)));
  const float denom = __fadd_rn(__fsqrt_rn(v_new), c.eps);
  *po = __fsub_rn(p, __fdiv_rn(__fmul_rn(lrt, m_new), denom));
  *mo = m_new;
  *vo = v_new;
}

__global__ void __launch_bounds__(NUM_THREADS)
fused_adam_kernel(const float* __restrict__ p, const float* __restrict__ g,
                  const float* __restrict__ m, const float* __restrict__ v,
                  const float* __restrict__ lrt, float* __restrict__ po,
                  float* __restrict__ mo, float* __restrict__ vo, int64_t n,
                  Coeffs c) {
  const int64_t stride = (int64_t)gridDim.x * NUM_THREADS;
  const int64_t first = (int64_t)blockIdx.x * NUM_THREADS + threadIdx.x;
  // 16-byte vectors over the first n - n % 4 elements (the buffers come
  // from the caching allocator, so they are 16-byte aligned)
  const int64_t n4 = n / 4;
  for (int64_t i = first; i < n4; i += stride) {
    const float4 p4 = reinterpret_cast<const float4*>(p)[i];
    const float4 g4 = reinterpret_cast<const float4*>(g)[i];
    const float4 m4 = reinterpret_cast<const float4*>(m)[i];
    const float4 v4 = reinterpret_cast<const float4*>(v)[i];
    const float4 l4 = reinterpret_cast<const float4*>(lrt)[i];
    float4 pn, mn, vn;
    adam_one(p4.x, g4.x, m4.x, v4.x, l4.x, c, &pn.x, &mn.x, &vn.x);
    adam_one(p4.y, g4.y, m4.y, v4.y, l4.y, c, &pn.y, &mn.y, &vn.y);
    adam_one(p4.z, g4.z, m4.z, v4.z, l4.z, c, &pn.z, &mn.z, &vn.z);
    adam_one(p4.w, g4.w, m4.w, v4.w, l4.w, c, &pn.w, &mn.w, &vn.w);
    reinterpret_cast<float4*>(po)[i] = pn;
    reinterpret_cast<float4*>(mo)[i] = mn;
    reinterpret_cast<float4*>(vo)[i] = vn;
  }
  for (int64_t i = 4 * n4 + first; i < n; i += stride)
    adam_one(p[i], g[i], m[i], v[i], lrt[i], c, po + i, mo + i, vo + i);
}

}  // namespace

extern "C" {

// omb1 = 1 - beta1 and omb2 = 1 - beta2, each rounded once to float32 by
// the caller, as torch rounds the Python scalar (1 - beta).  Returns a
// cudaError_t (0 = launched).
int pt_fused_adam(const float* p, const float* g, const float* m,
                  const float* v, const float* lrt, float* po, float* mo,
                  float* vo, int64_t n, float b1, float omb1, float b2,
                  float omb2, float eps, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const Coeffs c{b1, omb1, b2, omb2, eps};
  const int64_t want = (n / 4 + NUM_THREADS - 1) / NUM_THREADS;
  // enough blocks to fill 132 SMs several times over; the loop strides
  const int blocks = static_cast<int>(want < 132 * 16 ? (want > 0 ? want : 1)
                                                      : 132 * 16);
  fused_adam_kernel<<<blocks, NUM_THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      p, g, m, v, lrt, po, mo, vo, n, c);
  return static_cast<int>(cudaGetLastError());
}

const char* pt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
