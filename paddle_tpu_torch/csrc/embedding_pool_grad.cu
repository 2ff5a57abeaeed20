// Weighted scatter-add gradient of the fused sparse embedding, for Hopper
// (sm_90a), written by hand.
//
// Replaces paddle_tpu/ops/pallas_kernels.py:550 embedding_pool_grad_tpu
// (the pallas_call at :559, kernel _scatter_grad_kernel :532) and :603
// embedding_pool_grad_stream_tpu (:611, kernel :572), the custom gradient
// of the fused_embedding_pool op.  The two TPU variants are bit-identical
// to each other; this kernel computes the same function:
//
//   dW[r, d] = sum over positions p = i*S + j with ids[i, j] == r, in
//              ascending p order, of g[i, d] * wgt[i, j]      (0 if none)
//
// The TPU kernel gets that order for free from its sequential grid: it
// walks the positions and read-modify-writes dW.  Here blocks run in
// parallel and in no order, and float atomics would add in a different
// order on every launch, so the order is rebuilt first:
//
//   1. prep: keys[p] = ids[p] (checked: an id outside [0, V) traps on the
//      device), vals[p] = p;
//   2. a stable radix sort of (key, p) by key (cub::DeviceRadixSort, over
//      the bits V - 1 needs).  Stability keeps each id's positions in
//      ascending p, which is (i, j) order;
//   3. products: prod[k, d] = g[i, d] * wgt[i, j] for the k-th sorted
//      position p = i*S + j, one rounded product per element (g[i, d]
//      itself where wgt is null, meaning all ones), written in sorted
//      order, so each row's terms lie contiguous;
//   4. rows: one block per run of consecutive rows of dW.  It finds its
//      rows' span of the sorted keys by two binary searches, marks where
//      each row's segment begins and ends in shared memory, and then sums
//      each row's contiguous products in order, one thread per (row, d),
//      and writes the row once.  Untouched rows are written as 0, so dW
//      needs no memset and is written exactly once.
//
// The accumulation, the function the TPU kernel computes, is steps 3 and
// 4, with every product and sum an explicitly rounded intrinsic
// (__fmul_rn, __fadd_rn, the sum starting from 0) so nvcc contracts
// nothing into an FMA: the result is bit for bit a sequential index_add_
// in position order, and two launches are bit-identical.
//
// What bounds it on this card: bytes.  dW is dense ([V, D] float32: at the
// CTR program's V = 1e6, D = 16 a 64 MB write, 19 us at 3.35 TB/s); the
// sort, the products and the reads of g, ids and wgt are under 3 MB at
// B = 4096, S = 5.  A hot id's segment is one chain of dependent adds,
// but over products that stream from contiguous memory (the loads do not
// wait for the sum), summed by D threads of one warp while every other
// block goes on: hot ids delay one block, not the grid.
//
// The kernels allocate nothing (the caller passes the four int32 scratch
// arrays, the [n, d] product buffer and CUB's temp storage, sized by
// pt_embedding_pool_grad_temp_bytes) and launch on the caller's stream.

#include <cub/cub.cuh>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NUM_THREADS = 256;
constexpr int MAX_ROWS = 256;          // rows of dW per block, at most
constexpr int ELEMS_PER_BLOCK = 4096;  // rows per block = this / D

__global__ void __launch_bounds__(NUM_THREADS)
embedding_pool_grad_prep_kernel(const int64_t* __restrict__ ids,
                                int* __restrict__ keys,
                                int* __restrict__ vals, int n, int v) {
  const int p = blockIdx.x * NUM_THREADS + threadIdx.x;
  if (p >= n) return;
  const int64_t id = ids[p];
  if (id < 0 || id >= v) __trap();
  keys[p] = static_cast<int>(id);
  vals[p] = p;
}

__device__ __forceinline__ int lower_bound(const int* __restrict__ keys,
                                           int n, int key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (keys[mid] < key)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(NUM_THREADS)
embedding_pool_grad_products_kernel(const float* __restrict__ g,
                                    const float* __restrict__ wgt,
                                    const int* __restrict__ pos,
                                    float* __restrict__ prod, int n, int s,
                                    int d) {
  const int64_t e = (int64_t)blockIdx.x * NUM_THREADS + threadIdx.x;
  if (e >= (int64_t)n * d) return;
  const int k = static_cast<int>(e / d);
  const int col = static_cast<int>(e - (int64_t)k * d);
  const int p = pos[k];
  const float x = g[(int64_t)(p / s) * d + col];
  prod[e] = wgt ? __fmul_rn(x, wgt[p]) : x;
}

__global__ void __launch_bounds__(NUM_THREADS)
embedding_pool_grad_rows_kernel(const float* __restrict__ prod,
                                const int* __restrict__ keys,
                                float* __restrict__ dw, int n, int v, int d,
                                int rows_per_block) {
  __shared__ int seg_begin[MAX_ROWS];
  __shared__ int seg_end[MAX_ROWS];
  __shared__ int span[2];
  const int r0 = blockIdx.x * rows_per_block;
  const int rows = min(rows_per_block, v - r0);
  for (int t = threadIdx.x; t < rows; t += NUM_THREADS) {
    seg_begin[t] = 0;
    seg_end[t] = 0;
  }
  // the two searches run in different warps
  if (threadIdx.x == 0) span[0] = lower_bound(keys, n, r0);
  if (threadIdx.x == 32) span[1] = lower_bound(keys, n, r0 + rows);
  __syncthreads();
  const int s0 = span[0], s1 = span[1];
  for (int k = s0 + threadIdx.x; k < s1; k += NUM_THREADS) {
    const int key = keys[k];
    if (k == s0 || keys[k - 1] != key) seg_begin[key - r0] = k;
    if (k == s1 - 1 || keys[k + 1] != key) seg_end[key - r0] = k + 1;
  }
  __syncthreads();
  // element e = local * d + col of this block's rows; stepping e by
  // NUM_THREADS steps (local, col) by (NUM_THREADS / d, NUM_THREADS % d)
  const int elems = rows * d;
  const int step_rows = NUM_THREADS / d, step_cols = NUM_THREADS % d;
  int local = threadIdx.x / d, col = threadIdx.x % d;
  float* out = dw + static_cast<int64_t>(r0) * d;
  for (int e = threadIdx.x; e < elems; e += NUM_THREADS) {
    const int end = seg_end[local];
    float acc = 0.0f;
#pragma unroll 8
    for (int k = seg_begin[local]; k < end; ++k)
      acc = __fadd_rn(acc, prod[static_cast<int64_t>(k) * d + col]);
    out[e] = acc;
    local += step_rows;
    col += step_cols;
    if (col >= d) {
      col -= d;
      ++local;
    }
  }
}

}  // namespace

extern "C" {

// Bytes of CUB temp storage the sort of n (key, position) pairs over
// end_bit key bits needs.  Returns a cudaError_t.
int pt_embedding_pool_grad_temp_bytes(int n, int end_bit, size_t* bytes) {
  *bytes = 0;
  if (n <= 0) return 0;
  return static_cast<int>(cub::DeviceRadixSort::SortPairs(
      static_cast<void*>(nullptr), *bytes, static_cast<const int*>(nullptr),
      static_cast<int*>(nullptr), static_cast<const int*>(nullptr),
      static_cast<int*>(nullptr), n, 0, end_bit));
}

// g [n / s, d], ids and wgt [n / s, s] (ids int64; wgt null for all
// ones), dw [v, d]; keys_in,
// vals_in, keys_out, vals_out int32 [n]; prod float32 [n, d]; temp of
// temp_bytes bytes.  All contiguous.  end_bit: the bits v - 1 needs (at
// least 1).  Returns a cudaError_t (0 = every launch accepted).
int pt_embedding_pool_grad(const float* g, const int64_t* ids,
                           const float* wgt, float* dw, int* keys_in,
                           int* vals_in, int* keys_out, int* vals_out,
                           float* prod, void* temp, size_t temp_bytes, int n,
                           int s, int v, int d, int end_bit, void* stream) {
  if (n < 0 || s <= 0 || v <= 0 || d <= 0 || end_bit <= 0 || end_bit > 31)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n > 0) {
    embedding_pool_grad_prep_kernel<<<(n + NUM_THREADS - 1) / NUM_THREADS,
                                      NUM_THREADS, 0, st>>>(ids, keys_in,
                                                            vals_in, n, v);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    size_t bytes = temp_bytes;
    err = cub::DeviceRadixSort::SortPairs(temp, bytes, keys_in, keys_out,
                                          vals_in, vals_out, n, 0, end_bit,
                                          st);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int64_t elems = (int64_t)n * d;
    embedding_pool_grad_products_kernel<<<
        static_cast<unsigned>((elems + NUM_THREADS - 1) / NUM_THREADS),
        NUM_THREADS, 0, st>>>(g, wgt, vals_out, prod, n, s, d);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int rows_per_block = ELEMS_PER_BLOCK / d;
  rows_per_block = rows_per_block < 1 ? 1
                   : rows_per_block > MAX_ROWS ? MAX_ROWS
                                               : rows_per_block;
  const int blocks = (v + rows_per_block - 1) / rows_per_block;
  embedding_pool_grad_rows_kernel<<<blocks, NUM_THREADS, 0, st>>>(
      prod, keys_out, dw, n, v, d, rows_per_block);
  return static_cast<int>(cudaGetLastError());
}

const char* pt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
