// Flash-attention backward for Hopper (sm_90a), written by hand.
//
// Replaces the backward half of paddle_tpu/ops/pallas_kernels.py:41
// flash_attention_tpu (jax's TPU dq and dkv Pallas kernels).  Computes
// dQ, dK, dV of  O = softmax(scale * Q K^T + bias) V  from the forward's O
// and its softmax statistics, the row max m and row sum l
// (flash_attention.cu), without ever writing the [T, T] probabilities to
// device memory:
//
//   P  = exp(scale * Q K^T + bias - m) / l     recomputed per tile
//   D  = rowsum(dO o O)                        flash_bwd_delta_kernel
//   dS = P o (dO V^T - D)
//   dV = P^T dO,  dK = scale * dS^T Q          flash_bwd_dkdv_kernel
//   dQ = scale * dS K                          flash_bwd_dq_kernel
//
// As in jax's TPU backward (two pallas_calls), dK/dV and dQ are separate
// kernels: one block per (b, h, 64-key tile) loops over the query tiles
// and keeps its dK and dV rows in registers; one block per (b, h, 64-query
// tile) loops over the key tiles and keeps its dQ rows.  No atomics: every
// output element is summed by one thread in a fixed order, so the result
// is deterministic.  P is recomputed with the forward's arithmetic (the
// same FMA chain over d, __fmul_rn by the scale, __fadd_rn of the bias,
// __expf, times 1 / l as the forward normalises), so it matches the saved
// statistics.  m and l stay apart: with the static BERT program's padding
// bias near -1e8 a folded log-sum-exp m + log l would lose log l to
// float32 rounding.
//
// What bounds it on this card.  At the training slice's shapes (B=32,
// H=12, T=128, D=64, float32) the five products (QK^T twice, dO V^T twice,
// P^T dO, dS^T Q, dS K; counted as 5 x 2*B*H*T^2*D) are 4.03 GFLOP, 0.060
// ms at 67 TFLOP/s of fp32 FMA, against ~101 MB of q, k, v, o, dO, m, l in
// and dq, dk, dv out (0.030 ms at 3.35 TB/s): the operations bound it.
// Like the forward, the products are fp32 FMAs on CUDA cores reading one
// operand from shared memory; wgmma and register tiling come later.
//
// Layout: q, k, v, o, dO, dq, dk, dv are [B, H, T, D] with D contiguous and
// their B, H and T strides passed in; the fp32 bias is read through four
// strides (0 on a broadcast dim).  m, l and the D scratch are contiguous
// float32 [B, H, Tq].  D <= 128, D % 8 == 0; causal needs Tq == Tk.  The
// kernels allocate nothing and launch on the caller's stream.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 64;                   // rows of a query or key tile
constexpr int TPR = 4;                      // threads sharing one row
constexpr int NUM_THREADS = BLOCK * TPR;    // 256
constexpr int PER = BLOCK / TPR;            // 16 partner rows per thread
constexpr int P_LD = BLOCK + 1;             // padded row of a P/dS tile

// element strides, 3 per tensor (B, H, T) and 4 for the bias
enum { SQ = 0, SK = 3, SV = 6, SO = 9, SDO = 12, SDQ = 15, SDK = 18,
       SDV = 21, SBIAS = 24, NSTRIDES = 28 };

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* row_max;
  const float* row_sum;
  float* delta;
  void* dq;
  void* dk;
  void* dv;
  const float* bias;
  int64_t s[NSTRIDES];
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

// rows [r0, r0 + 64) of a [T, D] slice -> a 64 x (D + 1) fp32 tile, zero
// past T
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          int64_t row_stride, int r0, int T_,
                                          int D) {
  const int ld = D + 1;
  for (int idx = threadIdx.x; idx < BLOCK * D; idx += NUM_THREADS) {
    const int rr = idx / D;
    const int d = idx - rr * D;
    const int row = r0 + rr;
    dst[rr * ld + d] = row < T_ ? to_f32(src[row * row_stride + d]) : 0.f;
  }
}

// scale * q.k + bias, rounded as the forward kernel rounds it
__device__ __forceinline__ float score(float qk, const Params& p,
                                       const float* bias_bh, int i, int j) {
  float x = __fmul_rn(qk, p.scale);
  if (bias_bh != nullptr)
    x = __fadd_rn(x, bias_bh[i * p.s[SBIAS + 2] + j * p.s[SBIAS + 3]]);
  return x;
}

// D[b, h, i] = sum_d dO[i, d] * O[i, d]: one warp per row
template <typename T>
__global__ void __launch_bounds__(NUM_THREADS)
flash_bwd_delta_kernel(const Params p) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int64_t row = (int64_t)blockIdx.x * (NUM_THREADS / 32) + warp;
  if (row >= (int64_t)p.B * p.H * p.Tq) return;   // whole warp leaves
  const int i = (int)(row % p.Tq);
  const int64_t bh = row / p.Tq;
  const int h = (int)(bh % p.H);
  const int b = (int)(bh / p.H);
  const T* o = static_cast<const T*>(p.o) + b * p.s[SO] + h * p.s[SO + 1] +
               i * p.s[SO + 2];
  const T* dout = static_cast<const T*>(p.dout) + b * p.s[SDO] +
                  h * p.s[SDO + 1] + i * p.s[SDO + 2];
  float acc = 0.f;
  for (int d = lane; d < p.D; d += 32)
    acc = fmaf(to_f32(dout[d]), to_f32(o[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) p.delta[row] = acc;
}

// Shared memory of the dK/dV kernel, in floats: K, V, Q, dO tiles of
// 64 x (D + 1), the P and dS tiles of 64 x 65, and the query tile's 64
// values of m, 1 / l and D.  The +1 pads rows so a warp's 8 rows at one
// column fall in distinct banks.
inline size_t dkdv_smem_bytes(int D) {
  return sizeof(float) *
         (size_t)(4 * BLOCK * (D + 1) + 2 * BLOCK * P_LD + 3 * BLOCK);
}

// Shared memory of the dQ kernel: Q, dO, K, V tiles, the dS tile and the
// query tile's m, 1 / l and D.
inline size_t dq_smem_bytes(int D) {
  return sizeof(float) *
         (size_t)(4 * BLOCK * (D + 1) + BLOCK * P_LD + 3 * BLOCK);
}

// One block per (b, h, 64-key tile).  Thread (j = tid / 4, t = tid % 4)
// owns key row j of the tile and its output columns t, t+4, ...; for each
// query tile it computes P and dS of queries t, t+4, ..., t+60 against
// key j, then, after a barrier, folds the whole tile's column j of P and
// dS into its dV and dK rows.
template <typename T, int DMAX>
__global__ void __launch_bounds__(NUM_THREADS)
flash_bwd_dkdv_kernel(const Params p) {
  extern __shared__ float smem[];
  const int D = p.D;
  const int ld = D + 1;
  float* Ks = smem;
  float* Vs = Ks + BLOCK * ld;
  float* Qs = Vs + BLOCK * ld;
  float* dOs = Qs + BLOCK * ld;
  float* Ps = dOs + BLOCK * ld;
  float* dSs = Ps + BLOCK * P_LD;
  float* m_s = dSs + BLOCK * P_LD;
  float* inv_l_s = m_s + BLOCK;
  float* delta_s = inv_l_s + BLOCK;

  const int tid = threadIdx.x;
  const int j = tid / TPR;
  const int t = tid % TPR;
  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int n0 = blockIdx.y * BLOCK;
  const int kj = n0 + j;

  const T* q = static_cast<const T*>(p.q) + b * p.s[SQ] + h * p.s[SQ + 1];
  const T* k = static_cast<const T*>(p.k) + b * p.s[SK] + h * p.s[SK + 1];
  const T* v = static_cast<const T*>(p.v) + b * p.s[SV] + h * p.s[SV + 1];
  const T* dout =
      static_cast<const T*>(p.dout) + b * p.s[SDO] + h * p.s[SDO + 1];
  const float* row_max = p.row_max + (size_t)bh * p.Tq;
  const float* row_sum = p.row_sum + (size_t)bh * p.Tq;
  const float* delta = p.delta + (size_t)bh * p.Tq;
  const float* bias_bh =
      p.bias != nullptr ? p.bias + b * p.s[SBIAS] + h * p.s[SBIAS + 1]
                        : nullptr;

  load_tile(Ks, k, p.s[SK + 2], n0, p.Tk, D);
  load_tile(Vs, v, p.s[SV + 2], n0, p.Tk, D);

  constexpr int CPT = DMAX / TPR;   // output columns per thread
  float dk[CPT], dv[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) dk[c] = dv[c] = 0.f;

  // causal: queries before the key tile's first row never see its keys
  const int m_start = p.causal ? n0 : 0;
  for (int m0 = m_start; m0 < p.Tq; m0 += BLOCK) {
    __syncthreads();   // the previous tile's reads of Q, dO, P, dS are done
    load_tile(Qs, q, p.s[SQ + 2], m0, p.Tq, D);
    load_tile(dOs, dout, p.s[SDO + 2], m0, p.Tq, D);
    if (tid < BLOCK) {
      const bool in = m0 + tid < p.Tq;
      const float l = in ? row_sum[m0 + tid] : 0.f;
      m_s[tid] = in ? row_max[m0 + tid] : 0.f;
      inv_l_s[tid] = l > 0.f ? 1.f / l : 0.f;
      delta_s[tid] = in ? delta[m0 + tid] : 0.f;
    }
    __syncthreads();

    float s[PER], dp[PER];
#pragma unroll
    for (int ii = 0; ii < PER; ++ii) s[ii] = dp[ii] = 0.f;
    const float* krow = Ks + j * ld;
    const float* vrow = Vs + j * ld;
    for (int d = 0; d < D; ++d) {
      const float kd = krow[d];
      const float vd = vrow[d];
#pragma unroll
      for (int ii = 0; ii < PER; ++ii) {
        const int r = t + TPR * ii;
        s[ii] = fmaf(Qs[r * ld + d], kd, s[ii]);
        dp[ii] = fmaf(dOs[r * ld + d], vd, dp[ii]);
      }
    }
#pragma unroll
    for (int ii = 0; ii < PER; ++ii) {
      const int r = t + TPR * ii;
      const int qi = m0 + r;
      const bool valid = qi < p.Tq && kj < p.Tk && (!p.causal || kj <= qi);
      const float pij =
          valid ? __expf(score(s[ii], p, bias_bh, qi, kj) - m_s[r]) *
                      inv_l_s[r]
                : 0.f;
      Ps[r * P_LD + j] = pij;
      dSs[r * P_LD + j] = pij * (dp[ii] - delta_s[r]);
    }
    __syncthreads();

    // dV[j, col] += sum_r P[r, j] dO[r, col]
    // dK[j, col] += sum_r dS[r, j] Q[r, col]
    for (int r = 0; r < BLOCK; ++r) {
      const float pr = Ps[r * P_LD + j];
      const float dsr = dSs[r * P_LD + j];
      const float* dorow = dOs + r * ld;
      const float* qrow = Qs + r * ld;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int col = t + TPR * c;
        if (col < D) {
          dv[c] = fmaf(pr, dorow[col], dv[c]);
          dk[c] = fmaf(dsr, qrow[col], dk[c]);
        }
      }
    }
  }

  if (kj < p.Tk) {
    T* dkrow = static_cast<T*>(p.dk) + b * p.s[SDK] + h * p.s[SDK + 1] +
               kj * p.s[SDK + 2];
    T* dvrow = static_cast<T*>(p.dv) + b * p.s[SDV] + h * p.s[SDV + 1] +
               kj * p.s[SDV + 2];
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int col = t + TPR * c;
      if (col < D) {
        store(dkrow + col, dk[c] * p.scale);
        store(dvrow + col, dv[c]);
      }
    }
  }
}

// One block per (b, h, 64-query tile).  Thread (r = tid / 4, t) owns query
// row r and its dQ columns t, t+4, ...; for each key tile it computes dS of
// keys t, t+4, ..., t+60 against row r, then folds row r of dS against the
// key tile into dQ.
template <typename T, int DMAX>
__global__ void __launch_bounds__(NUM_THREADS)
flash_bwd_dq_kernel(const Params p) {
  extern __shared__ float smem[];
  const int D = p.D;
  const int ld = D + 1;
  float* Qs = smem;
  float* dOs = Qs + BLOCK * ld;
  float* Ks = dOs + BLOCK * ld;
  float* Vs = Ks + BLOCK * ld;
  float* dSs = Vs + BLOCK * ld;
  float* m_s = dSs + BLOCK * P_LD;
  float* inv_l_s = m_s + BLOCK;
  float* delta_s = inv_l_s + BLOCK;

  const int tid = threadIdx.x;
  const int r = tid / TPR;
  const int t = tid % TPR;
  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int m0 = blockIdx.y * BLOCK;
  const int qi = m0 + r;

  const T* q = static_cast<const T*>(p.q) + b * p.s[SQ] + h * p.s[SQ + 1];
  const T* k = static_cast<const T*>(p.k) + b * p.s[SK] + h * p.s[SK + 1];
  const T* v = static_cast<const T*>(p.v) + b * p.s[SV] + h * p.s[SV + 1];
  const T* dout =
      static_cast<const T*>(p.dout) + b * p.s[SDO] + h * p.s[SDO + 1];
  const float* row_max = p.row_max + (size_t)bh * p.Tq;
  const float* row_sum = p.row_sum + (size_t)bh * p.Tq;
  const float* delta = p.delta + (size_t)bh * p.Tq;
  const float* bias_bh =
      p.bias != nullptr ? p.bias + b * p.s[SBIAS] + h * p.s[SBIAS + 1]
                        : nullptr;

  load_tile(Qs, q, p.s[SQ + 2], m0, p.Tq, D);
  load_tile(dOs, dout, p.s[SDO + 2], m0, p.Tq, D);
  if (tid < BLOCK) {
    const bool in = m0 + tid < p.Tq;
    const float l = in ? row_sum[m0 + tid] : 0.f;
    m_s[tid] = in ? row_max[m0 + tid] : 0.f;
    inv_l_s[tid] = l > 0.f ? 1.f / l : 0.f;
    delta_s[tid] = in ? delta[m0 + tid] : 0.f;
  }

  constexpr int CPT = DMAX / TPR;
  float dq[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) dq[c] = 0.f;

  // causal: keys past the tile's last query row are never visible
  const int n_end = p.causal ? min(p.Tk, m0 + BLOCK) : p.Tk;
  for (int n0 = 0; n0 < n_end; n0 += BLOCK) {
    __syncthreads();   // the previous tile's reads of K, V, dS are done
    load_tile(Ks, k, p.s[SK + 2], n0, p.Tk, D);
    load_tile(Vs, v, p.s[SV + 2], n0, p.Tk, D);
    __syncthreads();

    float s[PER], dp[PER];
#pragma unroll
    for (int i = 0; i < PER; ++i) s[i] = dp[i] = 0.f;
    const float* qrow = Qs + r * ld;
    const float* dorow = dOs + r * ld;
    for (int d = 0; d < D; ++d) {
      const float qd = qrow[d];
      const float dod = dorow[d];
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int jj = t + TPR * i;
        s[i] = fmaf(qd, Ks[jj * ld + d], s[i]);
        dp[i] = fmaf(dod, Vs[jj * ld + d], dp[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int jj = t + TPR * i;
      const int kj = n0 + jj;
      const bool valid = qi < p.Tq && kj < p.Tk && (!p.causal || kj <= qi);
      const float pij =
          valid ? __expf(score(s[i], p, bias_bh, qi, kj) - m_s[r]) *
                      inv_l_s[r]
                : 0.f;
      dSs[r * P_LD + jj] = pij * (dp[i] - delta_s[r]);
    }
    __syncthreads();

    // dQ[r, col] += sum_j dS[r, j] K[j, col]
    const float* dsrow = dSs + r * P_LD;
    for (int jj = 0; jj < BLOCK; ++jj) {
      const float dsj = dsrow[jj];
      const float* krow = Ks + jj * ld;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int col = t + TPR * c;
        if (col < D) dq[c] = fmaf(dsj, krow[col], dq[c]);
      }
    }
  }

  if (qi < p.Tq) {
    T* dqrow = static_cast<T*>(p.dq) + b * p.s[SDQ] + h * p.s[SDQ + 1] +
               qi * p.s[SDQ + 2];
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int col = t + TPR * c;
      if (col < D) store(dqrow + col, dq[c] * p.scale);
    }
  }
}

template <typename Kernel>
cudaError_t launch_tiles(Kernel kernel, size_t bytes, int tiles,
                         const Params& p, cudaStream_t stream) {
  // above 48 KB a block's shared memory must be opted into
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid(p.B * p.H, tiles);
  kernel<<<grid, NUM_THREADS, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int DMAX>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const int64_t rows = (int64_t)p.B * p.H * p.Tq;
  const int64_t rows_per_block = NUM_THREADS / 32;
  const unsigned delta_blocks =
      static_cast<unsigned>((rows + rows_per_block - 1) / rows_per_block);
  flash_bwd_delta_kernel<T><<<delta_blocks, NUM_THREADS, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = launch_tiles(flash_bwd_dkdv_kernel<T, DMAX>, dkdv_smem_bytes(p.D),
                     (p.Tk + BLOCK - 1) / BLOCK, p, stream);
  if (err != cudaSuccess) return err;
  return launch_tiles(flash_bwd_dq_kernel<T, DMAX>, dq_smem_bytes(p.D),
                      (p.Tq + BLOCK - 1) / BLOCK, p, stream);
}

template <typename T>
cudaError_t dispatch_d(const Params& p, cudaStream_t stream) {
  if (p.D <= 32) return launch<T, 32>(p, stream);
  if (p.D <= 64) return launch<T, 64>(p, stream);
  return launch<T, 128>(p, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  strides: 28 element strides, see the
// S* enum.  delta is float32 [B, H, Tq] scratch.  bias may be null.
// Returns a cudaError_t (0 = all three kernels launched).
int pt_flash_attention_bwd(const void* q, const void* k, const void* v,
                           const void* o, const void* dout,
                           const float* row_max, const float* row_sum,
                           float* delta, void* dq, void* dk, void* dv,
                           const float* bias, const int64_t* strides, int B,
                           int H, int Tq, int Tk, int D, float scale,
                           int causal, int dtype, void* stream) {
  if (D <= 0 || D > 128 || D % 8 != 0 || B <= 0 || H <= 0 || Tq <= 0 ||
      Tk <= 0 || (causal && Tq != Tk))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.dout = dout;
  p.row_max = row_max;
  p.row_sum = row_sum;
  p.delta = delta;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.bias = bias;
  for (int i = 0; i < NSTRIDES; ++i) p.s[i] = strides[i];
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
