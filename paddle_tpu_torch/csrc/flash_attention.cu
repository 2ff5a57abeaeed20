// Flash-attention forward for Hopper (sm_90a), written by hand.
//
// Replaces paddle_tpu/ops/pallas_kernels.py:41 flash_attention_tpu (the
// forward half; the TPU version wraps jax's Pallas flash kernel).
// Computes  O = softmax(scale * Q K^T + bias) V  over [B, H, T, D], with an
// optional causal mask (key j visible to query i iff j <= i), and, when the
// caller passes pointers, each row's softmax statistics for the backward
// kernels (flash_attention_bwd.cu): the row max m of the scores and the sum
// l of exp(score - m), float32 [B, H, Tq] each, kept apart (no folded
// log-sum-exp; flash_common.cuh says why).  The scores come from the score
// function the backward kernels share (flash_common.cuh: score_tile).
//
// What bounds it on this card.  At the serving slice's shapes (B=32,
// H=12, T=128, D=64) the work is 4*B*H*T^2*D = 1.61 GFLOP against 50.3 MB
// of q/k/v/o in float32 (25.2 MB in bfloat16).  In bfloat16 the bytes
// bound it (7.5 us at 3.35 TB/s; the tensor cores need 1.6 us).  Float32
// runs as CUDA-core FMAs (flash_common.cuh says why not 3xTF32): 1.61
// GFLOP at 67 TFLOP/s, 24 us, above the 15 us its bytes need.
//
// What the design does about it.  The [T, T] score matrix never reaches
// device memory: a block of 4 warps keeps a 64-row query tile in shared
// memory, 16 rows a warp, and streams K/V tiles (64 rows; 32 in float32)
// past it through a two-stage cp.async ring, so the next tile is in flight
// while the current one is multiplied.  Q·K^T and P·V are warp-level products
// (flash_common.cuh: mma.sync in bfloat16, register-tiled FMAs in
// float32); the online softmax (running max m, running sum l) stays in
// registers, each row reduced across the 4 lanes that hold it by
// shuffles.  P goes to bfloat16 for P·V in bfloat16, as the plain version
// casts P to q's dtype.  The bias values of a tile are loaded before its
// products, so their latency hides behind them.  When the
// 64-row grid would leave the card under-filled (fewer than 2 blocks per
// SM, e.g. a served batch of 1 row of 12 heads), the block is one warp of
// 16 query rows instead.  The Q operand is read from shared memory again
// for every K/V tile, which keeps the registers for the output rows.
//
// Layout: q, k, v, o are [B, H, T, D] with D contiguous; the B, H and T
// strides of each are arguments, so the permuted views transpose2 leaves
// behind reach the kernel without a copy (the base pointers and the
// strides of q, k, v must be 16-byte multiples, which the wrapper checks).
// The fp32 bias is read through four strides (0 on a broadcast dim), so a
// [B,1,1,Tk] padding mask is never expanded in memory.  D <= 128, D % 8
// == 0; any Tq, Tk (ragged tiles are masked here).  The kernel allocates
// nothing and launches on the caller's stream.

#include "flash_common.cuh"

namespace {

using flash::Elem;

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

// key rows of a K/V tile: flash::kv_rows for 4-warp blocks, where shared
// memory bounds the blocks an SM holds; 64 for one-warp blocks, which run
// on a card with SMs to spare and take half the tiles so
template <typename T, int WARPS>
__host__ __device__ constexpr int kv_tile() {
  return WARPS == 1 ? 64 : flash::kv_rows<T>();
}

template <typename T, int DMAX, int WARPS>
constexpr size_t smem_bytes() {
  constexpr int BN = kv_tile<T, WARPS>();
  // the Q tile and two stages of K and V tiles
  return sizeof(T) * (size_t)(DMAX + Elem<T>::PAD) *
         (16 * WARPS + 2 * 2 * BN);
}

template <typename T, int DMAX, int WARPS>
__global__ void __launch_bounds__(WARPS * 32)
flash_fwd_kernel(const Params p) {
  constexpr int BM = 16 * WARPS;            // query rows per block
  constexpr int BN = kv_tile<T, WARPS>();   // key rows per K/V tile
  constexpr int NTHREADS = WARPS * 32;
  constexpr int LD = DMAX + Elem<T>::PAD;
  constexpr int NTD = DMAX / 8;             // n-tiles of an output row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* q_s = reinterpret_cast<T*>(smem_raw);
  T* kv_s = q_s + BM * LD;                  // stage i: K, then V

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int D = p.D;
  const int DK = flash::depth<T>(D);
  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int m0 = blockIdx.y * BM;
  const int q0 = m0 + warp * 16;            // the warp's first query row

  const T* q = static_cast<const T*>(p.q) + b * p.s[0] + h * p.s[1];
  const T* k = static_cast<const T*>(p.k) + b * p.s[3] + h * p.s[4];
  const T* v = static_cast<const T*>(p.v) + b * p.s[6] + h * p.s[7];
  T* o = static_cast<T*>(p.o) + b * p.s[9] + h * p.s[10];
  flash::ScoreArgs sa;
  sa.bias = p.bias != nullptr ? p.bias + b * p.s[12] + h * p.s[13] : nullptr;
  sa.bias_q = p.s[14];
  sa.bias_k = p.s[15];
  sa.scale = p.scale;
  sa.Tq = p.Tq;
  sa.Tk = p.Tk;
  sa.causal = p.causal;

  // causal: keys past the block's last query row are never visible
  const int n_end = p.causal ? min(p.Tk, m0 + BM) : p.Tk;
  const int tiles = (n_end + BN - 1) / BN;

  flash::load_tile_async<T, BM, NTHREADS>(q_s, LD, q, p.s[2], m0, p.Tq, D,
                                          DK);
  flash::load_tile_async<T, BN, NTHREADS>(kv_s, LD, k, p.s[5], 0, p.Tk, D,
                                          DK);
  flash::load_tile_async<T, BN, NTHREADS>(kv_s + BN * LD, LD, v, p.s[8], 0,
                                          p.Tk, D, DK);
  flash::cp_async_commit();

  float acc[NTD][4];
#pragma unroll
  for (int n = 0; n < NTD; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  // rows g and g + 8 of the warp: running max and sum
  float m_i[2] = {-INFINITY, -INFINITY};
  float l_i[2] = {0.f, 0.f};

  for (int it = 0; it < tiles; ++it) {
    if (it + 1 < tiles) {
      // the stage refilled here was last read in iteration it - 1, which
      // ended at a barrier
      T* nxt = kv_s + ((it + 1) & 1) * 2 * BN * LD;
      const int n1 = (it + 1) * BN;
      flash::load_tile_async<T, BN, NTHREADS>(nxt, LD, k, p.s[5], n1, p.Tk,
                                              D, DK);
      flash::load_tile_async<T, BN, NTHREADS>(nxt + BN * LD, LD, v, p.s[8],
                                              n1, p.Tk, D, DK);
      flash::cp_async_commit();
      flash::cp_async_wait<1>();
    } else {
      flash::cp_async_wait<0>();
    }
    __syncthreads();
    const T* k_s = kv_s + (it & 1) * 2 * BN * LD;
    const T* v_s = k_s + BN * LD;

    float s[BN / 8][4];
    flash::score_tile<T, BN / 8>(s, q_s + warp * 16 * LD, k_s, LD, DK, sa, q0,
                                 it * BN, lane);

    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
    }
    float m_use[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // the 4 lanes of a row are adjacent
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_i[r], mx[r]);
      // a row with nothing visible yet keeps m = -inf; exp against 0 then
      // gives exact zeros instead of NaN from (-inf) - (-inf)
      m_use[r] = m_new == -INFINITY ? 0.f : m_new;
      alpha[r] = __expf(m_i[r] - m_use[r]);
      m_i[r] = m_new;
    }
    float psum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = __expf(s[j][e] - m_use[e >> 1]);
        psum[e >> 1] += s[j][e];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 1);
      psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 2);
      l_i[r] = l_i[r] * alpha[r] + psum[r];
    }
#pragma unroll
    for (int n = 0; n < NTD; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }
    flash::mma_reg_a<BN / 8, NTD>(acc, s, v_s, LD, D, lane);
    __syncthreads();   // this stage's reads are done before it is refilled
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + g + 8 * r;
    if (qi >= p.Tq) continue;
    const float inv = l_i[r] > 0.f ? 1.f / l_i[r] : 0.f;
    T* orow = o + qi * p.s[11];
#pragma unroll
    for (int n = 0; n < NTD; ++n) {
      const int col = n * 8 + 2 * t;
      if (col < D) {
        flash::store(orow + col, acc[n][2 * r] * inv);
        flash::store(orow + col + 1, acc[n][2 * r + 1] * inv);
      }
    }
    if (p.row_max != nullptr && t == 0) {
      p.row_max[(size_t)bh * p.Tq + qi] = m_i[r];
      p.row_sum[(size_t)bh * p.Tq + qi] = l_i[r];
    }
  }
}

template <typename T, int DMAX, int WARPS>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<T, DMAX, WARPS>();
  // above 48 KB a block's shared memory must be opted into
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DMAX, WARPS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid(p.B * p.H, (p.Tq + 16 * WARPS - 1) / (16 * WARPS));
  flash_fwd_kernel<T, DMAX, WARPS><<<grid, WARPS * 32, bytes, stream>>>(p);
  return cudaGetLastError();
}

// 64-row blocks unless they would give fewer than 2 blocks per SM of the
// H100's 132; then one warp of 16 rows a block
template <typename T, int DMAX>
cudaError_t dispatch_rows(const Params& p, cudaStream_t stream) {
  const int64_t blocks64 = (int64_t)p.B * p.H * ((p.Tq + 63) / 64);
  if (blocks64 < 2 * 132) return launch<T, DMAX, 1>(p, stream);
  return launch<T, DMAX, 4>(p, stream);
}

template <typename T>
cudaError_t dispatch_d(const Params& p, cudaStream_t stream) {
  if (p.D <= 32) return dispatch_rows<T, 32>(p, stream);
  if (p.D <= 64) return dispatch_rows<T, 64>(p, stream);
  return dispatch_rows<T, 128>(p, stream);
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
