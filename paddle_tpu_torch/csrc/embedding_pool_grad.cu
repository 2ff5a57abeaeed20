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
// order on every launch, so the order is rebuilt first.  Three steps:
//
//   1. fill: one grid-stride kernel zero-fills the dense dW with 16-byte
//      stores (a scalar tail where V * D is not a multiple of 4).  In the
//      same launch its first blocks sort the positions: each takes a tile
//      of 2048 positions and sorts them stably by id (cub::BlockRadixSort
//      over the bits V - 1 needs), so the sorts run under the fill
//      instead of before it.  An id outside [0, V) traps on the device;
//   2. merge: every block reads the tile-sorted ids into shared memory
//      and sends each (id, position) to its place in one stable order:
//      its index in its tile, plus the ids <= it in the tiles before and
//      the ids < it in the tiles after (binary searches in shared
//      memory).  Stability keeps each id's positions in ascending p,
//      which is (i, j) order.  Past 16 tiles (32,768 positions) the ids
//      would not fit in shared memory: there the fill kernel only lays
//      out (id, p), and a device-wide stable radix sort
//      (cub::DeviceRadixSort on a double buffer) takes the place of the
//      tile sorts and the merge;
//   3. segments: over the sorted positions only, never over V.  Block b
//      owns sorted positions [256 b, 256 b + 256) and a slice of up to 32
//      columns of D (blockIdx.y).  It finds the runs of equal keys that
//      start among its positions from the sorted keys alone (a warp
//      ballot and a prefix over the warps), forms the products
//      g[i, d] * wgt[p] of its positions into shared memory (g is [B, D],
//      L2-resident), and sums each run's column in order, one thread per
//      (run, column), from shared memory; it then overwrites the run's
//      row of the zero-filled dW.  A run that goes on past the block's
//      positions (a hot id: under Zipf(1.1) the hottest holds ~9.5% of
//      them) is streamed: warps 1 to 7 stage its next chunk of products
//      into the other half of a two-stage ring while warp 0's column
//      threads sum the current one, so the serial chain of adds waits on
//      shared memory, not on global loads.
//
// The accumulation, the function the TPU kernel computes, is step 3,
// with every product and sum an explicitly rounded intrinsic (__fmul_rn,
// __fadd_rn, the sum starting from 0) so nvcc contracts nothing into an
// FMA: the result is bit for bit a sequential index_add_ in position
// order, and two launches are bit-identical.
//
// What bounds it on this card: bytes.  dW is dense ([V, D] float32: at the
// CTR program's V = 1e6, D = 16 a 64 MB write, 19 us at 3.35 TB/s); the
// reads of g, ids and wgt are under 3 MB at B = 4096, S = 5, and the
// touched rows (at most B * S of them) are written a second time.  What
// stays in the way is latency: the merge's searches, and a hot id's
// chain of dependent adds, four cycles each.
//
// The kernels allocate nothing: the caller passes one workspace of
// pt_embedding_pool_grad_workspace_bytes bytes (two key and two value
// buffers and CUB's temp storage); all launch on the caller's stream.

#include <cub/cub.cuh>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int FILL_THREADS = 256;
constexpr int FILL_BLOCKS = 132 * 8;       // a full wave of the card
constexpr int SEG_THREADS = 256;           // sorted positions a block owns
constexpr int COLS = 32;                   // columns of D a block sums
constexpr int PRODUCERS = SEG_THREADS - 32;        // warps 1 to 7
constexpr int STAGE_FLOATS = SEG_THREADS * COLS;   // one stage, 32 KB
constexpr int MAX_CHUNK = 2 * PRODUCERS;   // terms of a streamed chunk
constexpr int SEG_SMEM = 2 * STAGE_FLOATS * sizeof(float);
constexpr int FILL_UNROLL = 4;
constexpr int TILE_ITEMS = 8;
constexpr int TILE = FILL_THREADS * TILE_ITEMS;    // positions a tile holds
constexpr int MAX_TILES = 16;      // n <= 32768: tile sorts, then a merge
constexpr int MERGE_THREADS = 256;

using TileSort = cub::BlockRadixSort<unsigned, FILL_THREADS, TILE_ITEMS, int>;

__device__ __forceinline__ int checked_id(const int64_t* ids, int p, int v) {
  const int64_t id = ids[p];
  if (id < 0 || id >= v) __trap();
  return static_cast<int>(id);
}

// Zero-fills dw and lays out the sort's input.  With tiles > 0 (n at most
// MAX_TILES * TILE), blocks 0 to tiles - 1 first sort one tile of TILE
// positions each by id, stably, writing tile-sorted keys and positions
// (the merge kernel then ranks them into one order); the other blocks
// start filling at once, so the sorts hide under the fill.  With tiles ==
// 0 it writes keys[p] = ids[p] and vals[p] = p for the device-wide sort.
__global__ void __launch_bounds__(FILL_THREADS)
embedding_pool_grad_fill_kernel(const int64_t* __restrict__ ids,
                                int* __restrict__ keys,
                                int* __restrict__ vals,
                                float* __restrict__ dw, int64_t elems, int n,
                                int v, int tiles, int end_bit) {
  __shared__ TileSort::TempStorage sort_temp;
  const int64_t stride = (int64_t)gridDim.x * FILL_THREADS;
  const int64_t first = (int64_t)blockIdx.x * FILL_THREADS + threadIdx.x;
  if (tiles == 0) {
    for (int64_t p = first; p < n; p += stride) {
      keys[p] = checked_id(ids, static_cast<int>(p), v);
      vals[p] = static_cast<int>(p);
    }
  } else if (blockIdx.x < tiles) {
    // blocked: thread t holds positions base + 8 t .. base + 8 t + 7, so
    // the stable sort keeps each id's positions ascending.  Past n, the
    // largest key of the bit range: it sorts after every real position
    const int base = blockIdx.x * TILE + threadIdx.x * TILE_ITEMS;
    const unsigned pad = end_bit >= 32 ? ~0u : (1u << end_bit) - 1u;
    unsigned k[TILE_ITEMS];
    int p[TILE_ITEMS];
#pragma unroll
    for (int i = 0; i < TILE_ITEMS; ++i) {
      p[i] = base + i;
      k[i] = p[i] < n ? static_cast<unsigned>(checked_id(ids, p[i], v)) : pad;
    }
    TileSort(sort_temp).Sort(k, p, 0, end_bit);
#pragma unroll
    for (int i = 0; i < TILE_ITEMS; ++i) {
      if (base + i < n) {
        keys[base + i] = static_cast<int>(k[i]);
        vals[base + i] = p[i];
      }
    }
  }
  // dw comes from the caching allocator: 16-byte aligned
  const int64_t n4 = elems / 4;
  float4* dw4 = reinterpret_cast<float4*>(dw);
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll FILL_UNROLL
  for (int64_t i = first; i < n4; i += stride) dw4[i] = zero;
  for (int64_t i = 4 * n4 + first; i < elems; i += stride) dw[i] = 0.0f;
}

// Merges the tile-sorted (key, position) pairs into one stable order:
// element e of tile t, at index l within it, goes to l + the keys <= its
// key in the tiles before t + the keys < its key in the tiles after t
// (equal keys: earlier tiles hold earlier positions).  Every block reads
// all n keys into shared memory and searches them there.
__global__ void __launch_bounds__(MERGE_THREADS)
embedding_pool_grad_merge_kernel(const int* __restrict__ tile_keys,
                                 const int* __restrict__ tile_vals,
                                 int* __restrict__ keys,
                                 int* __restrict__ vals, int n, int tiles) {
  extern __shared__ int skeys[];
  for (int i = threadIdx.x; i < n; i += MERGE_THREADS)
    skeys[i] = tile_keys[i];
  __syncthreads();
  const int e = blockIdx.x * MERGE_THREADS + threadIdx.x;
  if (e >= n) return;
  const int t = e / TILE, key = skeys[e];
  int dst = e - t * TILE;
  for (int u = 0; u < tiles; ++u) {
    if (u == t) continue;
    const int* tk = skeys + u * TILE;
    int lo = 0, hi = min(TILE, n - u * TILE);
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (u < t ? tk[mid] <= key : tk[mid] < key)
        lo = mid + 1;
      else
        hi = mid;
    }
    dst += lo;
  }
  keys[dst] = key;
  vals[dst] = tile_vals[e];
}

// The count of PRODUCERS threads (warps 1 to 7) whose pred is nonzero, and
// a barrier among them (named barrier 1; warp 0 does not take part).
__device__ __forceinline__ int producers_count(int pred) {
  int count;
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.s32 p, %1, 0;\n\t"
      "bar.red.popc.u32 %0, 1, %2, p;\n\t}"
      : "=r"(count)
      : "r"(pred), "r"(PRODUCERS)
      : "memory");
  return count;
}

// dst[col] = g[i, c0 + col] * wgt[p] (g itself where wgt is null) for
// col < cols, i = p / s: one term's products, its loads all in flight
// before its stores.  VEC: cols % 4 == 0 and the row 16-byte aligned.
template <bool VEC>
__device__ __forceinline__ void stage_term(const float* __restrict__ g,
                                           const float* __restrict__ wgt,
                                           int p, int s, int d, int c0,
                                           int cols, float* dst) {
  const float w = wgt ? wgt[p] : 1.0f;
  const float* row = g + static_cast<int64_t>(p / s) * d + c0;
  if constexpr (VEC) {
    float4 x[COLS / 4];
#pragma unroll
    for (int u = 0; u < COLS / 4; ++u)
      if (4 * u < cols) x[u] = reinterpret_cast<const float4*>(row)[u];
#pragma unroll
    for (int u = 0; u < COLS / 4; ++u) {
      if (4 * u >= cols) break;
      float4 y = x[u];
      if (wgt) {
        y.x = __fmul_rn(y.x, w);
        y.y = __fmul_rn(y.y, w);
        y.z = __fmul_rn(y.z, w);
        y.w = __fmul_rn(y.w, w);
      }
      reinterpret_cast<float4*>(dst)[u] = y;
    }
  } else {
    float x[COLS];
#pragma unroll
    for (int u = 0; u < COLS; ++u)
      if (u < cols) x[u] = row[u];
#pragma unroll
    for (int u = 0; u < COLS; ++u) {
      if (u >= cols) break;
      dst[u] = wgt ? __fmul_rn(x[u], w) : x[u];
    }
  }
}

// VEC: D % 4 == 0 and g 16-byte aligned, so every slice of a g row is
// read in 16-byte loads.
template <bool VEC>
__global__ void __launch_bounds__(SEG_THREADS)
embedding_pool_grad_segments_kernel(const float* __restrict__ g,
                                    const float* __restrict__ wgt,
                                    const int* __restrict__ keys,
                                    const int* __restrict__ pos,
                                    float* __restrict__ dw, int n, int s,
                                    int d) {
  extern __shared__ __align__(16) float stage[];   // [2][STAGE_FLOATS]
  __shared__ int run_start[SEG_THREADS + 1];    // ascending
  __shared__ int run_key[SEG_THREADS];
  __shared__ int warp_runs[SEG_THREADS / 32];
  __shared__ int staged[2];
  __shared__ int goes_on;

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int k0 = blockIdx.x * SEG_THREADS;
  const int kend = min(k0 + SEG_THREADS, n);
  const int c0 = blockIdx.y * COLS;
  const int cols = min(COLS, d - c0);
  const int k = k0 + t;

  // the runs that start among this block's positions, in order
  int key = 0, p = 0;
  bool start = false;
  if (k < kend) {
    key = keys[k];
    p = pos[k];
    start = k == 0 || keys[k - 1] != key;
  }
  const unsigned ballot = __ballot_sync(0xffffffffu, start);
  if (lane == 0) warp_runs[warp] = __popc(ballot);
  if (t == 0) goes_on = kend < n && keys[kend] == keys[kend - 1];
  __syncthreads();
  int before = 0, runs = 0;
#pragma unroll
  for (int w = 0; w < SEG_THREADS / 32; ++w) {
    before += w < warp ? warp_runs[w] : 0;
    runs += warp_runs[w];
  }
  if (start) {
    const int r = before + __popc(ballot & ((1u << lane) - 1u));
    run_start[r] = k;
    run_key[r] = key;
  }
  if (t == 0) run_start[runs] = kend;
  if (runs == 0) return;                        // inside an earlier run
  if (k < kend)
    stage_term<VEC>(g, wgt, p, s, d, c0, cols, stage + t * cols);
  __syncthreads();

  // every run that ends among this block's positions: one thread per
  // (run, column), its terms in order from shared memory
  const bool streamed = goes_on;
  const int local_runs = runs - (streamed ? 1 : 0);
  const int rows_per_pass = SEG_THREADS / cols;
  if (t < rows_per_pass * cols) {
    const int col = t % cols;
    for (int r = t / cols; r < local_runs; r += rows_per_pass) {
      const int end = run_start[r + 1] - k0;
      float acc = 0.0f;
#pragma unroll 8
      for (int q = run_start[r] - k0; q < end; ++q)
        acc = __fadd_rn(acc, stage[q * cols + col]);
      dw[static_cast<int64_t>(run_key[r]) * d + c0 + col] = acc;
    }
  }
  if (!streamed) return;

  // the last run goes on past the block: warp 0's column threads sum one
  // stage while warps 1 to 7 stage the next chunk into the other
  const int last = run_key[runs - 1];
  const int chunk = min(MAX_CHUNK, STAGE_FLOATS / cols);
  float acc = 0.0f;
  int cur = 0, from = run_start[runs - 1] - k0, to = kend - k0, next = kend;
  for (;;) {
    if (warp == 0) {
      if (t < cols) {
        const float* src = stage + cur * STAGE_FLOATS;
#pragma unroll 8
        for (int q = from; q < to; ++q)
          acc = __fadd_rn(acc, src[q * cols + t]);
      }
    } else if (next >= 0) {
      // each producer takes terms pt and pt + PRODUCERS of the chunk;
      // the sorted keys make the run's terms a prefix of it
      const int pt = t - 32;
      float* dst = stage + (cur ^ 1) * STAGE_FLOATS;
      int kv[2], pv[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q = pt + h * PRODUCERS, kk = next + q;
        const bool in = q < chunk && kk < n;
        kv[h] = in ? keys[kk] : -1;
        pv[h] = in ? pos[kk] : 0;
      }
      const int count = producers_count(kv[0] == last) +
                        producers_count(kv[1] == last);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q = pt + h * PRODUCERS;
        if (q < count)
          stage_term<VEC>(g, wgt, pv[h], s, d, c0, cols, dst + q * cols);
      }
      if (t == 32) staged[cur ^ 1] = count;
    }
    __syncthreads();
    if (next < 0) break;
    const int count = staged[cur ^ 1];
    cur ^= 1;
    from = 0;
    to = count;
    next = count == chunk && next + chunk < n ? next + chunk : -1;
  }
  if (t < cols) dw[static_cast<int64_t>(last) * d + c0 + t] = acc;
}

size_t align256(size_t x) { return (x + 255) & ~static_cast<size_t>(255); }

cudaError_t sort_temp_bytes(int n, int end_bit, size_t* bytes) {
  cub::DoubleBuffer<int> keys(nullptr, nullptr), vals(nullptr, nullptr);
  *bytes = 0;
  return cub::DeviceRadixSort::SortPairs(static_cast<void*>(nullptr), *bytes,
                                         keys, vals, n, 0, end_bit);
}

}  // namespace

extern "C" {

// Bytes of the workspace pt_embedding_pool_grad needs for n positions
// over end_bit key bits: four int32 [n] buffers and CUB's temp storage.
// Returns a cudaError_t.
int pt_embedding_pool_grad_workspace_bytes(int n, int end_bit,
                                           size_t* bytes) {
  *bytes = 0;
  if (n <= 0) return 0;
  size_t temp = 0;
  const cudaError_t err = sort_temp_bytes(n, end_bit, &temp);
  if (err != cudaSuccess) return static_cast<int>(err);
  *bytes = 4 * align256(static_cast<size_t>(n) * sizeof(int)) +
           align256(temp);
  return 0;
}

// g [n / s, d], ids and wgt [n / s, s] (ids int64; wgt null for all
// ones), dw [v, d] (16-byte aligned), all contiguous; workspace of
// workspace_bytes bytes, 256-byte aligned.  end_bit: the bits v - 1
// needs (at least 1).  Returns a cudaError_t (0 = every launch
// accepted).
int pt_embedding_pool_grad(const float* g, const int64_t* ids,
                           const float* wgt, float* dw, void* workspace,
                           size_t workspace_bytes, int n, int s, int v, int d,
                           int end_bit, void* stream) {
  if (n < 0 || s <= 0 || v <= 0 || d <= 0 || end_bit <= 0 || end_bit > 31 ||
      (d + COLS - 1) / COLS > 65535 ||
      reinterpret_cast<uintptr_t>(dw) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(workspace) % 256 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t slot = align256(static_cast<size_t>(n) * sizeof(int));
  char* ws = static_cast<char*>(workspace);
  int* keys_a = reinterpret_cast<int*>(ws);
  int* keys_b = reinterpret_cast<int*>(ws + slot);
  int* vals_a = reinterpret_cast<int*>(ws + 2 * slot);
  int* vals_b = reinterpret_cast<int*>(ws + 3 * slot);
  void* temp = ws + 4 * slot;
  size_t temp_bytes = 0;
  if (n > 0) {
    const cudaError_t err = sort_temp_bytes(n, end_bit, &temp_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (4 * slot + temp_bytes > workspace_bytes)
      return static_cast<int>(cudaErrorInvalidValue);
  }

  const int64_t elems = static_cast<int64_t>(v) * d;
  const int tiles = n > 0 && n <= MAX_TILES * TILE ? (n + TILE - 1) / TILE
                                                   : 0;
  const int64_t work = elems / 4 > n ? elems / 4 : n;
  const int64_t want = (work + FILL_THREADS - 1) / FILL_THREADS;
  int fill_blocks = static_cast<int>(
      want < 1 ? 1 : want > FILL_BLOCKS ? FILL_BLOCKS : want);
  if (fill_blocks < tiles) fill_blocks = tiles;
  embedding_pool_grad_fill_kernel<<<fill_blocks, FILL_THREADS, 0, st>>>(
      ids, keys_a, vals_a, dw, elems, n, v, tiles, end_bit);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n == 0) return static_cast<int>(err);

  const int* sorted_keys = keys_b;
  const int* sorted_vals = vals_b;
  if (tiles > 0) {
    const int smem = n * static_cast<int>(sizeof(int));
    err = cudaFuncSetAttribute(embedding_pool_grad_merge_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               MAX_TILES * TILE * sizeof(int));
    if (err != cudaSuccess) return static_cast<int>(err);
    embedding_pool_grad_merge_kernel<<<(n + MERGE_THREADS - 1) / MERGE_THREADS,
                                       MERGE_THREADS, smem, st>>>(
        keys_a, vals_a, keys_b, vals_b, n, tiles);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  } else {
    cub::DoubleBuffer<int> keys(keys_a, keys_b), vals(vals_a, vals_b);
    err = cub::DeviceRadixSort::SortPairs(temp, temp_bytes, keys, vals, n, 0,
                                          end_bit, st);
    if (err != cudaSuccess) return static_cast<int>(err);
    sorted_keys = keys.Current();
    sorted_vals = vals.Current();
  }

  const bool vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(g) % 16 == 0;
  const auto kernel = vec ? embedding_pool_grad_segments_kernel<true>
                          : embedding_pool_grad_segments_kernel<false>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SEG_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + SEG_THREADS - 1) / SEG_THREADS, (d + COLS - 1) / COLS);
  kernel<<<grid, SEG_THREADS, SEG_SMEM, st>>>(g, wgt, sorted_keys,
                                              sorted_vals, dw, n, s, d);
  return static_cast<int>(cudaGetLastError());
}

const char* pt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
