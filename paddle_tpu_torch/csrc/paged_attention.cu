// Paged decode attention for Hopper (sm_90a), written by hand.
//
// Replaces paddle_tpu/ops/pallas_kernels.py:117 paged_flash_attention_tpu
// (the pallas_call at :128, kernel body _paged_attn_kernel :84), the TPU
// lowering of the paged_attention op that the fuse_paged_attention pass
// makes of the decode step's gather -> mul+reduce_sum -> scale -> masked add
// -> softmax -> mul+reduce_sum chain.  One query row per decode slot
// attends over K/V rows that live in flat page pools:
//
//   s[b, j]   = (q[b] . kp[idx[b, j]]) * scale                 (valid = 1)
//   s[b, j]   = (q[b] . kp[idx[b, j]]) * scale * v + (v * neg - neg)
//               for any valid value v, which is exactly -neg at v = 0
//   out[b]    = sum over j of softmax_j(s[b, :]) * vp[idx[b, j]]
//
// the arithmetic of the op's plain version (ops/attention.py
// _paged_reference), not the TPU kernel's page walk: the kernel reads the
// page table (idx) and the mask (valid) per position, so it is exact for
// any table and any 0/1 mask, needs no host sync to form lengths, and
// assumes nothing about a page's rows being contiguous.
//
// Softmax: online, in float32, with expf (not __expf).  A masked score is
// -neg (-1e30 in the decode programs); exp(-1e30 - m) is exactly 0 for any
// real score m, so a masked position contributes exactly 0 whenever its
// row has one valid position, in whichever order the positions arrive and
// however the warps' partial states merge.  A row with no valid position
// has every score equal to -neg and gives the mean of its V rows, as the
// plain softmax over equal scores does.
//
// What bounds it on this card: bytes.  A call must read the K and V rows
// of every position (the kernel does not skip the masked tail yet), q, the
// page table and the mask, and write out; at the decode path's 32 slots of
// 512 positions of width 768 that is about 100.7 MB, 30 us at 3.35 TB/s.
// The FLOPs (4 * B * S * d, 50 MFLOP) do not bind.
//
// The design, simple first: one CTA per slot, q staged in shared memory,
// each of the CTA's warps takes every n_warps-th position: a warp-wide dot
// over d (lanes striding the row, so each row read is coalesced), a
// shuffle reduce, and the warp's own running (m, l, acc) softmax state,
// acc a d-float row in shared memory.  The warps' states merge through
// shared memory at the end.  Right at any d the shared memory holds
// ((n_warps + 1) * d floats; n_warps is cut from 16 to fit, so d up to
// about 29,000).  It launches only B CTAs on 132 SMs: splitting the
// positions across CTAs (flash-decoding), cp.async or TMA page loads and
// skipping the masked tail are the redesign's work.
//
// A pool row index outside [0, R) traps on the device.  The kernel
// allocates nothing and launches on the caller's stream.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAX_WARPS = 16;
constexpr int STATIC_SMEM_LIMIT = 48 * 1024;

__global__ void __launch_bounds__(MAX_WARPS * 32)
paged_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ kp,
                       const float* __restrict__ vp,
                       const int32_t* __restrict__ idx,
                       const float* __restrict__ valid,
                       float* __restrict__ out, int s, int64_t r, int d,
                       float scale, float neg) {
  extern __shared__ float smem[];
  float* q_s = smem;          // [d]
  float* acc_s = smem + d;    // [n_warps][d]
  __shared__ float m_s[MAX_WARPS], l_s[MAX_WARPS], f_s[MAX_WARPS];
  __shared__ float l_all_s;

  const int b = blockIdx.x;
  const int n_warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  for (int c = threadIdx.x; c < d; c += blockDim.x)
    q_s[c] = q[(int64_t)b * d + c];
  float* acc = acc_s + (int64_t)warp * d;
  for (int c = lane; c < d; c += 32) acc[c] = 0.0f;
  __syncthreads();

  const int32_t* idx_b = idx + (int64_t)b * s;
  const float* valid_b = valid + (int64_t)b * s;
  float m = -INFINITY;
  float l = 0.0f;
  for (int j = warp; j < s; j += n_warps) {
    const int64_t row = idx_b[j];
    if (row < 0 || row >= r) __trap();
    const float* krow = kp + row * d;
    float dot = 0.0f;
    for (int c = lane; c < d; c += 32) dot = fmaf(q_s[c], krow[c], dot);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      dot += __shfl_xor_sync(0xffffffffu, dot, off);
    // the plain version's masked score, each step rounded as it rounds:
    // (dot * scale + 0) * valid + (valid * neg + (-neg))
    const float vj = valid_b[j];
    const float sc = __fadd_rn(__fmul_rn(__fmul_rn(dot, scale), vj),
                               __fadd_rn(__fmul_rn(vj, neg), -neg));
    const float m_new = fmaxf(m, sc);
    const float corr = expf(m - m_new);   // the first position: exp(-inf) = 0
    const float p = expf(sc - m_new);
    l = l * corr + p;
    const float* vrow = vp + row * d;
    for (int c = lane; c < d; c += 32) acc[c] = acc[c] * corr + p * vrow[c];
    m = m_new;
  }
  if (lane == 0) {
    m_s[warp] = m;
    l_s[warp] = l;
  }
  __syncthreads();

  // merge: each warp's state rescaled to the row's max; a warp that took
  // no position (s < n_warps) has l = 0 and acc = 0 and adds nothing
  if (threadIdx.x < n_warps) {
    float m_all = -INFINITY;
    for (int w = 0; w < n_warps; ++w) m_all = fmaxf(m_all, m_s[w]);
    const float mw = m_s[threadIdx.x];
    f_s[threadIdx.x] = mw == -INFINITY ? 0.0f : expf(mw - m_all);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float l_all = 0.0f;
    for (int w = 0; w < n_warps; ++w) l_all += l_s[w] * f_s[w];
    l_all_s = l_all;
  }
  __syncthreads();
  const float inv_l = 1.0f / l_all_s;
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    float o = 0.0f;
    for (int w = 0; w < n_warps; ++w) o += acc_s[(int64_t)w * d + c] * f_s[w];
    out[(int64_t)b * d + c] = o * inv_l;
  }
}

}  // namespace

extern "C" {

// q [b, d], kp and vp [r, d], idx [b, s] int32, valid [b, s], out [b, d];
// all float32 but idx, all contiguous.
// Returns a cudaError_t (0 = launched).
int pt_paged_attention(const float* q, const float* kp, const float* vp,
                       const int32_t* idx, const float* valid, float* out,
                       int b, int s, int64_t r, int d, float scale,
                       float neg, void* stream) {
  if (b <= 0 || s <= 0 || r <= 0 || d <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  // (n_warps + 1) rows of d floats in dynamic shared memory, plus the
  // static merge arrays
  const int64_t row_bytes = (int64_t)d * sizeof(float);
  const int64_t room = (int64_t)optin - 1024;
  int n_warps = MAX_WARPS;
  while (n_warps > 0 && (int64_t)(n_warps + 1) * row_bytes > room) --n_warps;
  if (n_warps == 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = static_cast<size_t>((n_warps + 1) * row_bytes);
  if (bytes > STATIC_SMEM_LIMIT) {
    err = cudaFuncSetAttribute(paged_attention_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  paged_attention_kernel<<<b, n_warps * 32, bytes,
                           static_cast<cudaStream_t>(stream)>>>(
      q, kp, vp, idx, valid, out, s, r, d, scale, neg);
  return static_cast<int>(cudaGetLastError());
}

const char* pt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
