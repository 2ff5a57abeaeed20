// Flash-attention forward for Hopper (sm_90a), written by hand.
//
// Replaces paddle_tpu/ops/pallas_kernels.py:41 flash_attention_tpu (the
// forward half; the TPU version wraps jax's Pallas flash kernel).
// Computes  O = softmax(scale * Q K^T + bias) V  over [B, H, T, D], with an
// optional causal mask (key j visible to query i iff j <= i), and, when the
// caller passes pointers, each row's softmax statistics for the backward
// kernels (flash_attention_bwd.cu): the row max m of the scores and the sum
// l of exp(score - m), float32 [B, H, Tq] each.  They are kept apart, not
// folded into one log-sum-exp m + log l: the static BERT program's padding
// bias is about -1e8, where float32 holds only multiples of 8, so m + log l
// would round the log away.  The score of each (query, key) pair is rounded
// exactly as the backward kernels round it: the same FMA chain over d, then
// scale and bias each applied with one rounding (__fmul_rn, __fadd_rn, no
// contraction), so exp(score - m) / l there reproduces this kernel's P.
//
// What bounds it on this card.  At the serving slice's shapes (B=32,
// H=12, T=128, D=64) the work is 4*B*H*T^2*D = 1.61 GFLOP against 50.3 MB
// of q/k/v/o in fp32 (25.2 MB in bf16).  In fp32 the operations bound it:
// 67 TFLOP/s of fp32 FMA outside the tensor cores gives ~24 us, above the
// 15 us the bytes need at 3.35 TB/s.  In bf16 the bytes bound it (~7.5 us).
//
// What the design does about it.  The [T, T] score matrix never reaches
// device memory: each block keeps a 64-row query tile resident in shared
// memory and streams 64-row K/V tiles past it, folding each tile into an
// fp32 accumulator with an online softmax (running max m, running sum l),
// so q, k, v and o cross device memory once and the 128x128 scores of the
// slice live only in registers and shared memory.  The products are fp32
// FMAs on CUDA cores (bf16 inputs are widened on load); wgmma, TMA and warp
// specialisation are left for a later kernel.
//
// What limits this design in practice: every FMA of the score and PV
// loops reads one operand from shared memory, so shared-memory bandwidth
// caps the loops near a quarter of the FMA rate.  On an H100 SXM at 700 W
// it runs at about a sixth of the fp32 bound above (PERF.md).  Register
// tiling (several rows x several keys per thread) is the next step.
//
// Layout: q, k, v, o are [B, H, T, D] with D contiguous; the B, H and T
// strides of each are arguments, so the permuted views transpose2 leaves
// behind reach the kernel without a copy.  The fp32 bias is read through
// four strides (0 on a broadcast dim), so a [B,1,1,Tk] padding mask is
// never expanded in memory.  D <= 128, D % 8 == 0; any Tq, Tk (ragged
// tiles are masked here).  The kernel allocates nothing and launches on
// the caller's stream.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BLOCK_M = 64;                 // query rows per block
constexpr int BLOCK_N = 64;                 // key rows per K/V tile
constexpr int THREADS_PER_ROW = 4;          // threads sharing one query row
constexpr int NUM_THREADS = BLOCK_M * THREADS_PER_ROW;   // 256
constexpr int KEYS_PER_THREAD = BLOCK_N / THREADS_PER_ROW;  // 16
constexpr int P_LD = BLOCK_N + 1;           // padded row of the P tile

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* row_max;    // m, may be null
  float* row_sum;    // l, may be null
  const float* bias;
  // element strides: [q_b, q_h, q_t, k_b, k_h, k_t, v_b, v_h, v_t,
  //                   o_b, o_h, o_t, bias_b, bias_h, bias_q, bias_k]
  int64_t s[16];
  int B, H, Tq, Tk, D;
  float scale;
  int causal;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Shared memory, in floats: Q, K, V tiles of 64 x (D + 1) and the 64 x 65
// probability tile.  The +1 pads rows so the 8 rows a warp touches at one
// column fall in distinct banks.
inline size_t smem_bytes(int D) {
  return sizeof(float) * (size_t)(3 * BLOCK_M * (D + 1) + BLOCK_M * P_LD);
}

// DMAX bounds D at compile time (32, 64 or 128) so each thread's slice of
// the output row, columns t, t+4, t+8, ..., lives in registers.
template <typename T, int DMAX>
__global__ void __launch_bounds__(NUM_THREADS)
flash_fwd_kernel(const Params p) {
  extern __shared__ float smem[];
  const int D = p.D;
  const int ld = D + 1;
  float* Qs = smem;
  float* Ks = Qs + BLOCK_M * ld;
  float* Vs = Ks + BLOCK_N * ld;
  float* Ps = Vs + BLOCK_N * ld;

  const int tid = threadIdx.x;
  const int r = tid / THREADS_PER_ROW;      // query row within the tile
  const int t = tid % THREADS_PER_ROW;      // lane within the row's group
  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int m0 = blockIdx.y * BLOCK_M;
  const int qi = m0 + r;

  const T* q = static_cast<const T*>(p.q) + b * p.s[0] + h * p.s[1];
  const T* k = static_cast<const T*>(p.k) + b * p.s[3] + h * p.s[4];
  const T* v = static_cast<const T*>(p.v) + b * p.s[6] + h * p.s[7];
  T* o = static_cast<T*>(p.o) + b * p.s[9] + h * p.s[10];
  const float* bias_row = nullptr;
  if (p.bias != nullptr) {
    const int qb = qi < p.Tq ? qi : p.Tq - 1;   // stay in bounds past Tq
    bias_row = p.bias + b * p.s[12] + h * p.s[13] + qb * p.s[14];
  }

  // Q tile -> shared memory, zero past Tq.  Consecutive threads read
  // consecutive columns of a row: coalesced.
  for (int idx = tid; idx < BLOCK_M * D; idx += NUM_THREADS) {
    const int rr = idx / D;
    const int d = idx - rr * D;
    const int row = m0 + rr;
    Qs[rr * ld + d] = row < p.Tq ? to_f32(q[row * p.s[2] + d]) : 0.f;
  }

  constexpr int CPT = DMAX / THREADS_PER_ROW;   // output columns per thread
  float acc[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) acc[c] = 0.f;
  float m_i = -INFINITY;   // running max of this row's scores
  float l_i = 0.f;         // running sum of exp(score - m_i)

  // causal: keys past the block's last query row are never visible
  const int n_end = p.causal ? min(p.Tk, m0 + BLOCK_M) : p.Tk;
  for (int n0 = 0; n0 < n_end; n0 += BLOCK_N) {
    __syncthreads();   // the previous tile's K, V and P reads are done
    for (int idx = tid; idx < BLOCK_N * D; idx += NUM_THREADS) {
      const int rr = idx / D;
      const int d = idx - rr * D;
      const int row = n0 + rr;
      const bool in = row < p.Tk;
      Ks[rr * ld + d] = in ? to_f32(k[row * p.s[5] + d]) : 0.f;
      Vs[rr * ld + d] = in ? to_f32(v[row * p.s[8] + d]) : 0.f;
    }
    __syncthreads();

    // scores of keys t, t+4, ..., t+60 of this tile against row r
    float s[KEYS_PER_THREAD];
#pragma unroll
    for (int i = 0; i < KEYS_PER_THREAD; ++i) s[i] = 0.f;
    const float* qrow = Qs + r * ld;
    for (int d = 0; d < D; ++d) {
      const float qv = qrow[d];
#pragma unroll
      for (int i = 0; i < KEYS_PER_THREAD; ++i)
        s[i] = fmaf(qv, Ks[(t + THREADS_PER_ROW * i) * ld + d], s[i]);
    }

    float tile_max = -INFINITY;
#pragma unroll
    for (int i = 0; i < KEYS_PER_THREAD; ++i) {
      const int kj = n0 + t + THREADS_PER_ROW * i;
      const bool valid = kj < p.Tk && (!p.causal || kj <= qi);
      float x = __fmul_rn(s[i], p.scale);
      if (bias_row != nullptr && kj < p.Tk)
        x = __fadd_rn(x, bias_row[kj * p.s[15]]);
      s[i] = valid ? x : -INFINITY;
      tile_max = fmaxf(tile_max, s[i]);
    }
    // the 4 threads of a row are adjacent lanes of one warp
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 2));

    const float m_new = fmaxf(m_i, tile_max);
    // a row with nothing visible yet keeps m = -inf; exp against 0 then
    // gives exact zeros instead of NaN from (-inf) - (-inf)
    const float m_use = m_new == -INFINITY ? 0.f : m_new;
    const float alpha = __expf(m_i - m_use);
    float psum = 0.f;
#pragma unroll
    for (int i = 0; i < KEYS_PER_THREAD; ++i) {
      s[i] = __expf(s[i] - m_use);
      psum += s[i];
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l_i = l_i * alpha + psum;
    m_i = m_new;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[c] *= alpha;

#pragma unroll
    for (int i = 0; i < KEYS_PER_THREAD; ++i)
      Ps[r * P_LD + t + THREADS_PER_ROW * i] = s[i];
    __syncthreads();

    // acc[c] += sum_j P[r, j] * V[j, t + 4c]
    const float* prow = Ps + r * P_LD;
    for (int j = 0; j < BLOCK_N; ++j) {
      const float pj = prow[j];
      const float* vrow = Vs + j * ld;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int col = t + THREADS_PER_ROW * c;
        if (col < D) acc[c] = fmaf(pj, vrow[col], acc[c]);
      }
    }
  }

  if (qi < p.Tq) {
    const float inv = l_i > 0.f ? 1.f / l_i : 0.f;
    T* orow = o + qi * p.s[11];
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int col = t + THREADS_PER_ROW * c;
      if (col < D) store(orow + col, acc[c] * inv);
    }
    if (p.row_max != nullptr && t == 0) {
      p.row_max[(size_t)bh * p.Tq + qi] = m_i;
      p.row_sum[(size_t)bh * p.Tq + qi] = l_i;
    }
  }
}

template <typename T, int DMAX>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t bytes = smem_bytes(p.D);
  // above 48 KB a block's shared memory must be opted into
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid(p.B * p.H, (p.Tq + BLOCK_M - 1) / BLOCK_M);
  flash_fwd_kernel<T, DMAX><<<grid, NUM_THREADS, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const Params& p, cudaStream_t stream) {
  if (p.D <= 32) return launch<T, 32>(p, stream);
  if (p.D <= 64) return launch<T, 64>(p, stream);
  return launch<T, 128>(p, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  strides: 16 element strides, see
// Params::s.  row_max and row_sum (both or neither) and bias may be null.
// Returns a cudaError_t (0 = launched).
int pt_flash_attention_fwd(const void* q, const void* k, const void* v,
                           void* o, float* row_max, float* row_sum,
                           const float* bias, const int64_t* strides,
                           int B, int H, int Tq, int Tk, int D, float scale,
                           int causal, int dtype, void* stream) {
  if (D <= 0 || D > 128 || D % 8 != 0 || B <= 0 || H <= 0 || Tq <= 0 ||
      Tk <= 0 || (row_max == nullptr) != (row_sum == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.row_max = row_max;
  p.row_sum = row_sum;
  p.bias = bias;
  for (int i = 0; i < 16; ++i) p.s[i] = strides[i];
  p.B = B;
  p.H = H;
  p.Tq = Tq;
  p.Tk = Tk;
  p.D = D;
  p.scale = scale;
  p.causal = causal;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch_d<float>(p, s);
  else if (dtype == 1)
    err = dispatch_d<__nv_bfloat16>(p, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

const char* pt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
