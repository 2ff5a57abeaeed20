// Fused gather and pool of a sparse embedding, for Hopper (sm_90a), written
// by hand.
//
// Replaces paddle_tpu/ops/pallas_kernels.py:455 fused_embedding_pool_tpu
// (the pallas_call at :464, kernel _gather_pool_kernel :443) and :506
// fused_embedding_pool_stream_tpu (:518, kernel :477), the forward of the
// fused_embedding_pool op that the fuse_sparse_embedding pass makes of each
// lookup_table -> sequence_pool chain of the CTR program.  The streaming
// variant exists only because a TPU table must pass through VMEM in slabs;
// here the table stays in device memory and one kernel covers both.
//
//   out[i, d] = sum over j = 0 .. S-1, in j order, of
//               w[ids[i, j], d] * wgt[i, j]
//
// wgt folds padding_idx, the Length mask and AVERAGE's divisor (the op's
// _emb_pool_prep); a null wgt means every weight is 1 (a SUM slot with
// neither), and then each term is the table value itself, as x * 1 is x.
// Each product and each sum is an explicitly rounded
// intrinsic (__fmul_rn, __fadd_rn), the sum starting from 0, so nvcc
// contracts nothing into an FMA and the result is the plain version's
// elementwise arithmetic in j order.
//
// What bounds it on this card: bytes, and at the CTR program's shapes the
// launch.  Per batch row it reads S ids (int64, as fed: no conversion copy),
// S weights, S table rows of D floats and writes D floats; at B = 4096,
// S = 5, D = 16 that is about 1.8 MB, 0.5 us at 3.35 TB/s, well under a
// launch.  The design: one thread per output element (i, d); D consecutive
// threads read one table row, so a row is one coalesced 4*D-byte read.
// No shared memory: nothing is reused within a block.
//
// An id outside [0, V) traps on the device (as torch's own index kernels
// stop), so a bad feed never reads outside the table.  Any D.  The kernel
// allocates nothing and launches on the caller's stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NUM_THREADS = 256;

__global__ void __launch_bounds__(NUM_THREADS)
embedding_pool_fwd_kernel(const float* __restrict__ w,
                          const int64_t* __restrict__ ids,
                          const float* __restrict__ wgt,
                          float* __restrict__ out, int64_t b, int64_t s,
                          int64_t v, int64_t d) {
  const int64_t e = (int64_t)blockIdx.x * NUM_THREADS + threadIdx.x;
  if (e >= b * d) return;
  const int64_t i = e / d;
  const int64_t col = e - i * d;
  const int64_t* row_ids = ids + i * s;
  const float* row_wgt = wgt ? wgt + i * s : nullptr;
  float acc = 0.0f;
  for (int64_t j = 0; j < s; ++j) {
    const int64_t id = row_ids[j];
    if (id < 0 || id >= v) __trap();
    const float x = w[id * d + col];
    acc = __fadd_rn(acc, row_wgt ? __fmul_rn(x, row_wgt[j]) : x);
  }
  out[e] = acc;
}

}  // namespace

extern "C" {

// w [v, d], ids [b, s] int64, wgt [b, s] or null (all ones), out [b, d];
// all contiguous.
// Returns a cudaError_t (0 = launched).
int pt_embedding_pool_fwd(const float* w, const int64_t* ids,
                          const float* wgt, float* out, int64_t b, int64_t s,
                          int64_t v, int64_t d, void* stream) {
  if (b <= 0 || s <= 0 || v <= 0 || d <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (b * d + NUM_THREADS - 1) / NUM_THREADS;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  embedding_pool_fwd_kernel<<<static_cast<unsigned>(blocks), NUM_THREADS, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      w, ids, wgt, out, b, s, v, d);
  return static_cast<int>(cudaGetLastError());
}

const char* pt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
