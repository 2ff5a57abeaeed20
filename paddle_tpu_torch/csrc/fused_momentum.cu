// Fused Momentum step over a flattened parameter bucket, for Hopper
// (sm_90a), written by hand.
//
// Replaces paddle_tpu/ops/pallas_kernels.py:678 fused_momentum_tpu (the
// pallas_call at :682, kernel _fused_momentum_kernel :663), the kernel of
// the fuse_optimizer pass's bucketed momentum update.  Three inputs, the
// learning rate and two outputs, element for element:
//
//   g' = g + l2 * p                 (only when l2 != 0: l2_decay)
//   v' = mu * v + g'
//   p' = p - lr * v'                or, Nesterov, p - lr * (g' + mu * v')
//
// lr is read from device memory through the [1] tensor's pointer, as the
// TPU kernel reads it from SMEM: the host never reads it, so a step never
// waits for the card.  Contract: bit-identical to the per-parameter
// momentum lowering, which torch runs as separate kernels that round every
// product and sum; so each is an explicitly rounded intrinsic (__fmul_rn,
// __fadd_rn, __fsub_rn) and nvcc contracts none of them into an FMA.
//
// What bounds it on this card: bytes.  5 x 4 bytes per element (p, g, v
// read, p', v' written): at the CTR program's 416,013,807-value bucket that
// is 8.32 GB, 2.48 ms at 3.35 TB/s.  The design streams each input once in
// 16-byte vector loads, grid-stride, with no shared memory.
//
// Layout: contiguous float32 buffers of n elements, any n (the flattened
// bucket, unpadded; a tail of n % 4 takes a scalar loop).  The kernel
// allocates nothing and launches on the caller's stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NUM_THREADS = 256;

struct Coeffs {
  float mu, l2;
  int nesterov;
};

__device__ __forceinline__ void momentum_one(float p, float g, float v,
                                             float lr, const Coeffs& c,
                                             float* po, float* vo) {
  if (c.l2 != 0.0f) g = __fadd_rn(g, __fmul_rn(c.l2, p));
  const float v_new = __fadd_rn(__fmul_rn(c.mu, v), g);
  const float step =
      c.nesterov ? __fadd_rn(g, __fmul_rn(c.mu, v_new)) : v_new;
  *po = __fsub_rn(p, __fmul_rn(lr, step));
  *vo = v_new;
}

__global__ void __launch_bounds__(NUM_THREADS)
fused_momentum_kernel(const float* __restrict__ p, const float* __restrict__ g,
                      const float* __restrict__ v,
                      const float* __restrict__ lr_ptr, float* __restrict__ po,
                      float* __restrict__ vo, int64_t n, Coeffs c) {
  const float lr = *lr_ptr;
  const int64_t stride = (int64_t)gridDim.x * NUM_THREADS;
  const int64_t first = (int64_t)blockIdx.x * NUM_THREADS + threadIdx.x;
  // 16-byte vectors over the first n - n % 4 elements (the buffers come
  // from the caching allocator, so they are 16-byte aligned)
  const int64_t n4 = n / 4;
  for (int64_t i = first; i < n4; i += stride) {
    const float4 p4 = reinterpret_cast<const float4*>(p)[i];
    const float4 g4 = reinterpret_cast<const float4*>(g)[i];
    const float4 v4 = reinterpret_cast<const float4*>(v)[i];
    float4 pn, vn;
    momentum_one(p4.x, g4.x, v4.x, lr, c, &pn.x, &vn.x);
    momentum_one(p4.y, g4.y, v4.y, lr, c, &pn.y, &vn.y);
    momentum_one(p4.z, g4.z, v4.z, lr, c, &pn.z, &vn.z);
    momentum_one(p4.w, g4.w, v4.w, lr, c, &pn.w, &vn.w);
    reinterpret_cast<float4*>(po)[i] = pn;
    reinterpret_cast<float4*>(vo)[i] = vn;
  }
  for (int64_t i = 4 * n4 + first; i < n; i += stride)
    momentum_one(p[i], g[i], v[i], lr, c, po + i, vo + i);
}

}  // namespace

extern "C" {

// mu and l2 rounded once to float32 by the caller, as torch rounds a
// Python scalar operand of a float32 tensor op.  Returns a cudaError_t
// (0 = launched).
int pt_fused_momentum(const float* p, const float* g, const float* v,
                      const float* lr, float* po, float* vo, int64_t n,
                      float mu, float l2, int nesterov, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const Coeffs c{mu, l2, nesterov};
  const int64_t want = (n / 4 + NUM_THREADS - 1) / NUM_THREADS;
  // enough blocks to fill 132 SMs several times over; the loop strides
  const int blocks = static_cast<int>(want < 132 * 16 ? (want > 0 ? want : 1)
                                                      : 132 * 16);
  fused_momentum_kernel<<<blocks, NUM_THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      p, g, v, lr, po, vo, n, c);
  return static_cast<int>(cudaGetLastError());
}

const char* pt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
