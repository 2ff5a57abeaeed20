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
// latency of one launch.  Per batch row it reads S ids (int64, as fed: no
// conversion copy), S weights, S table rows of D floats and writes D
// floats; at B = 4096, S = 5, D = 16 that is about 1.8 MB, 0.5 us at 3.35
// TB/s, under a launch.  What is left to win is the chain inside the body:
// a loop that loads an id, checks it and only then loads the row waits
// through 2·S dependent round trips to memory.  The design:
//
// - All ids first.  A thread loads every id and weight of its row
//   together, checks every id, and only then issues all of the row's table
//   loads before the first add: about two round trips, not 2·S.  S is a
//   template parameter up to 8 (the CTR program's 5 among them), so the
//   ids and rows sit in registers; longer rows run in chunks of 8.
// - 16-byte row loads.  Where D % 4 == 0 and w and out are 16-byte
//   aligned, D/4 lanes share an output row and each reads a float4 (4
//   lanes at D = 16, a warp at D = 128); other D, or a w view at an
//   unaligned offset, take 4-byte loads in the same kernel (never a copy
//   of the table).  Ids, weights and rows go through the read-only path.
// - A grid that fills the card.  A block is lanes x rows threads, its
//   size the largest of 256, 128, 64 and 32 that still gives at least one
//   block per SM, so a 512-row serve batch at D = 16 spreads over 64
//   blocks, not 8.
//
// An id outside [0, V) traps on the device (as torch's own index kernels
// stop) before any row is read with it, so a bad feed never reads outside
// the table.  Any B, S and D.  The kernel allocates nothing and launches
// on the caller's stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_THREADS = 256;
constexpr int CHUNK = 8;          // ids a thread holds in registers

__device__ __forceinline__ int64_t ld(const int64_t* p) {
  return __ldg(reinterpret_cast<const long long*>(p));
}
__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }
__device__ __forceinline__ float4 ld(const float4* p) { return __ldg(p); }

__device__ __forceinline__ float term(float x, float wt, bool weighted) {
  return weighted ? __fmul_rn(x, wt) : x;
}
__device__ __forceinline__ float4 term(float4 x, float wt, bool weighted) {
  return weighted ? make_float4(__fmul_rn(x.x, wt), __fmul_rn(x.y, wt),
                                __fmul_rn(x.z, wt), __fmul_rn(x.w, wt))
                  : x;
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float4 add(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}
__device__ __forceinline__ void zero(float& a) { a = 0.0f; }
__device__ __forceinline__ void zero(float4& a) {
  a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// T = float4 (four columns a lane) or float (one).  S > 0: every row has
// exactly S <= CHUNK ids, one pass; S = 0: s ids, in chunks of CHUNK.
// threadIdx.x + blockIdx.y * blockDim.x is the lane within the row,
// threadIdx.y + blockIdx.x * blockDim.y the row.
template <typename T, int S>
__global__ void __launch_bounds__(MAX_THREADS)
embedding_pool_fwd_kernel(const T* __restrict__ w,
                          const int64_t* __restrict__ ids,
                          const float* __restrict__ wgt, T* __restrict__ out,
                          int64_t b, int s, uint64_t v, int64_t lanes) {
  const int64_t lane = (int64_t)blockIdx.y * blockDim.x + threadIdx.x;
  const int64_t i = (int64_t)blockIdx.x * blockDim.y + threadIdx.y;
  if (lane >= lanes || i >= b) return;
  constexpr int N = S > 0 ? S : CHUNK;
  const int64_t* row_ids = ids + i * (S > 0 ? S : s);
  const float* row_wgt = wgt ? wgt + i * (S > 0 ? S : s) : nullptr;
  const T* col = w + lane;
  T acc;
  zero(acc);
  for (int j0 = 0; j0 < (S > 0 ? S : s); j0 += N) {
    const int m = S > 0 ? S : min(N, s - j0);
    uint64_t id[N];
    float wt[N];
#pragma unroll
    for (int k = 0; k < N; ++k) {
      if (k < m) {
        id[k] = static_cast<uint64_t>(ld(row_ids + j0 + k));
        wt[k] = row_wgt ? ld(row_wgt + j0 + k) : 1.0f;
      }
    }
    bool bad = false;
#pragma unroll
    for (int k = 0; k < N; ++k)
      if (k < m) bad |= id[k] >= v;   // a negative id wraps past v
    if (bad) __trap();
    T x[N];
#pragma unroll
    for (int k = 0; k < N; ++k)
      if (k < m) x[k] = ld(col + id[k] * lanes);
#pragma unroll
    for (int k = 0; k < N; ++k)
      if (k < m) acc = add(acc, term(x[k], wt[k], row_wgt != nullptr));
  }
  out[i * lanes + lane] = acc;
}

// The block: lanes x rows threads, the largest of 256, 128, 64 and 32
// that still gives n_sm blocks (else 32), rows cut to b; lanes past 256
// take more blocks along y.
template <typename T, int S>
int launch_typed(const void* w, const int64_t* ids, const float* wgt,
                 void* out, int64_t b, int s, int64_t v, int64_t lanes,
                 int n_sm, cudaStream_t stream) {
  const int lx = static_cast<int>(lanes < MAX_THREADS ? lanes : MAX_THREADS);
  const int64_t gy = (lanes + lx - 1) / lx;
  int threads = MAX_THREADS;
  for (; threads > 32; threads /= 2) {
    const int64_t ry = threads / lx > 0 ? threads / lx : 1;
    if ((b + ry - 1) / ry * gy >= n_sm) break;
  }
  int64_t ry = threads / lx > 0 ? threads / lx : 1;
  if (ry > b) ry = b;
  const int64_t gx = (b + ry - 1) / ry;
  if (gy > 65535 || gx > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  embedding_pool_fwd_kernel<T, S>
      <<<dim3(static_cast<unsigned>(gx), static_cast<unsigned>(gy)),
         dim3(lx, static_cast<unsigned>(ry)), 0, stream>>>(
          static_cast<const T*>(w), ids, wgt, static_cast<T*>(out), b, s,
          static_cast<uint64_t>(v), lanes);
  return static_cast<int>(cudaGetLastError());
}

// S = s for s <= CHUNK, else 0 (chunks of CHUNK)
template <typename T>
int launch(const void* w, const int64_t* ids, const float* wgt, void* out,
           int64_t b, int s, int64_t v, int64_t lanes, int n_sm,
           cudaStream_t st) {
  using Launch = int (*)(const void*, const int64_t*, const float*, void*,
                         int64_t, int, int64_t, int64_t, int, cudaStream_t);
  static constexpr Launch by_s[CHUNK + 1] = {
      launch_typed<T, 0>, launch_typed<T, 1>, launch_typed<T, 2>,
      launch_typed<T, 3>, launch_typed<T, 4>, launch_typed<T, 5>,
      launch_typed<T, 6>, launch_typed<T, 7>, launch_typed<T, 8>};
  return by_s[s <= CHUNK ? s : 0](w, ids, wgt, out, b, s, v, lanes, n_sm,
                                  st);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" {

// w [v, d], ids [b, s] int64, wgt [b, s] or null (all ones), out [b, d];
// all contiguous.  n_sm: the card's SM count, for the grid.
// Returns a cudaError_t (0 = launched).
int pt_embedding_pool_fwd(const float* w, const int64_t* ids,
                          const float* wgt, float* out, int64_t b, int64_t s,
                          int64_t v, int64_t d, int n_sm, void* stream) {
  if (b <= 0 || s <= 0 || s > 0x7fffffffLL || v <= 0 || d <= 0 || n_sm <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int si = static_cast<int>(s);
  if (d % 4 == 0 && aligned16(w) && aligned16(out))
    return launch<float4>(w, ids, wgt, out, b, si, v, d / 4, n_sm, st);
  return launch<float>(w, ids, wgt, out, b, si, v, d, n_sm, st);
}

const char* pt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
