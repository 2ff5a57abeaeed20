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
// kernels: one block per (b, h, 64-key tile) loops over 32-row query tiles
// and keeps its dK and dV rows in registers; one block per (b, h, 64-query
// tile) loops over the key tiles and keeps its dQ rows.  No atomics: every
// output element is summed by one thread in a fixed order, so the result
// is deterministic.  The scores come from the forward's score function
// (flash_common.cuh: score_tile), then __expf(score - m) times 1 / l as
// the forward normalises, so P matches the saved statistics; m and l stay
// apart (flash_common.cuh says why).
//
// What bounds it on this card.  At the training slice's shapes (B=32,
// H=12, T=128, D=64) the five products (QK^T and dO V^T, recomputed in
// each of the two kernels, P^T dO, dS^T Q, dS K; counted as 5 x
// 2*B*H*T^2*D) are 4.03 GFLOP against ~101 MB of q, k, v, o, dO, m, l in
// and dq, dk, dv out in float32 (0.030 ms at 3.35 TB/s; half the bytes in
// bfloat16, 0.015 ms).  bfloat16 runs them on the tensor cores (989
// TFLOP/s: 4 us), so the bytes bound it; float32 runs them as CUDA-core
// FMAs (flash_common.cuh says why not 3xTF32), 4.03 GFLOP at 67 TFLOP/s,
// 60 us, so the operations bound it.
//
// What the design does about it.  All products are warp-level
// (flash_common.cuh: mma.sync in bfloat16, register-tiled FMAs in
// float32).  dK/dV kernel: K and V stay in shared memory; Q and dO tiles
// stream through a two-stage cp.async ring; the 4 warps compute S and dP =
// dO V^T of the tile's block, write P and dS to shared memory (in the
// bfloat16 instantiation each as a hi/lo pair of bfloat16 values: rounded
// once, as flash-attention 2 rounds them, they put dV, dQ and dK past the
// bfloat16 checks' tolerance at head dim 40), and after a barrier each
// folds P^T dO and dS^T Q into its 16 key rows of dV and dK, reading P and
// dS transposed (ldmatrix.trans in bfloat16).  The D kernel reads o and
// dO by 16-byte loads, 8 lanes a row.  dQ kernel: Q and dO stay in shared
// memory, K/V tiles (64 rows; 32 in float32) stream through the ring;
// each warp keeps S, dP and dS of its 16 query rows in registers and feeds
// dS (bfloat16: its hi and lo parts) straight into dS K as the A operand.
//
// Layout: q, k, v, o, dO, dq, dk, dv are [B, H, T, D] with D contiguous and
// their B, H and T strides passed in (q, k, v, o and dO with 16-byte aligned
// bases and strides, which the wrapper checks); the fp32 bias is read
// through four strides (0 on a broadcast dim).  m, l and the D scratch are
// contiguous float32 [B, H, Tq].  D <= 128, D % 8 == 0; causal needs Tq ==
// Tk.  The kernels allocate nothing and launch on the caller's stream.

#include "flash_common.cuh"

namespace {

using flash::BN;
using flash::Elem;

constexpr int NUM_THREADS = 128;   // 4 warps
// query rows of the dK/dV kernel's tiles: 64 in bfloat16; 32 in float32,
// whose tiles take twice the shared memory
template <typename T>
__host__ __device__ constexpr int dkdv_rows() {
  return sizeof(T) == 2 ? 64 : 32;
}
constexpr int BM = 64;             // query rows of a dQ block
constexpr int DELTA_THREADS = 256;
constexpr int DELTA_TPR = 8;       // threads per row of the D kernel

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

__device__ __forceinline__ flash::ScoreArgs score_args(const Params& p, int b,
                                                       int h) {
  flash::ScoreArgs sa;
  sa.bias = p.bias != nullptr ? p.bias + b * p.s[SBIAS] + h * p.s[SBIAS + 1]
                              : nullptr;
  sa.bias_q = p.s[SBIAS + 2];
  sa.bias_k = p.s[SBIAS + 3];
  sa.scale = p.scale;
  sa.Tq = p.Tq;
  sa.Tk = p.Tk;
  sa.causal = p.causal;
  return sa;
}

// D[b, h, i] = sum_d dO[i, d] * O[i, d]: DELTA_TPR adjacent lanes per
// row, each reading 16-byte chunks of the row (o and dO 16-byte aligned,
// which the wrapper checks)
template <typename T>
__global__ void __launch_bounds__(DELTA_THREADS)
flash_bwd_delta_kernel(const Params p) {
  constexpr int EPC = 16 / sizeof(T);
  const int sub = threadIdx.x % DELTA_TPR;
  const int64_t row =
      (int64_t)blockIdx.x * (DELTA_THREADS / DELTA_TPR) +
      threadIdx.x / DELTA_TPR;
  const bool in = row < (int64_t)p.B * p.H * p.Tq;
  float acc = 0.f;
  if (in) {
    const int i = (int)(row % p.Tq);
    const int64_t bh = row / p.Tq;
    const int h = (int)(bh % p.H);
    const int b = (int)(bh / p.H);
    const T* o = static_cast<const T*>(p.o) + b * p.s[SO] +
                 h * p.s[SO + 1] + i * p.s[SO + 2];
    const T* dout = static_cast<const T*>(p.dout) + b * p.s[SDO] +
                    h * p.s[SDO + 1] + i * p.s[SDO + 2];
    for (int c = sub; c < p.D / EPC; c += DELTA_TPR) {
      const uint4 ov = *reinterpret_cast<const uint4*>(o + c * EPC);
      const uint4 dv = *reinterpret_cast<const uint4*>(dout + c * EPC);
      const T* oe = reinterpret_cast<const T*>(&ov);
      const T* de = reinterpret_cast<const T*>(&dv);
#pragma unroll
      for (int e = 0; e < EPC; ++e)
        acc = fmaf(flash::to_f32(de[e]), flash::to_f32(oe[e]), acc);
    }
  }
  // the DELTA_TPR lanes of a row are adjacent
#pragma unroll
  for (int off = DELTA_TPR / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (in && sub == 0) p.delta[row] = acc;
}

// P = exp(score - m) / l and dS = P (dP - D) of a row, 0 past Tq
struct RowStats {
  float m, inv_l, delta;
  bool in;
};

__device__ __forceinline__ RowStats row_stats(const float* row_max,
                                              const float* row_sum,
                                              const float* delta, int qi,
                                              int Tq) {
  RowStats r;
  r.in = qi < Tq;
  const float l = r.in ? row_sum[qi] : 0.f;
  r.m = r.in ? row_max[qi] : 0.f;
  r.inv_l = l > 0.f ? 1.f / l : 0.f;
  r.delta = r.in ? delta[qi] : 0.f;
  return r;
}

// scores s -> P in place and dS into dp, for one warp's 16 x 8NT block
template <int NT>
__device__ __forceinline__ void probs_and_ds(float (&s)[NT][4],
                                             float (&dp)[NT][4],
                                             const RowStats (&rs)[2]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const RowStats& r = rs[e >> 1];
      const float pij = r.in ? __expf(s[j][e] - r.m) * r.inv_l : 0.f;
      s[j][e] = pij;
      dp[j][e] = pij * (dp[j][e] - r.delta);
    }
  }
}

template <typename T, int DMAX>
constexpr size_t dkdv_smem_bytes() {
  constexpr int BMQ = dkdv_rows<T>();
  // K and V, two stages of Q and dO, the P and dS tiles (and their rests)
  return sizeof(T) * ((size_t)(DMAX + Elem<T>::PAD) * (2 * BN + 2 * 2 * BMQ) +
                      (size_t)(BN + Elem<T>::PAD) * (2 + 2 * Elem<T>::HILO) *
                          BMQ);
}

template <typename T, int DMAX>
constexpr size_t dq_smem_bytes() {
  constexpr int BN = flash::kv_rows<T>();
  // Q and dO, two stages of K and V
  return sizeof(T) * (size_t)(DMAX + Elem<T>::PAD) * (2 * BM + 2 * 2 * BN);
}

// One block per (b, h, 64-key tile).  Per query tile of BMQ rows (64 in
// bfloat16, 32 in float32), the 4 warps split the BMQ x 64 block of S, P,
// dP and dS (16 query rows and 64 keys a warp, or 16 rows and 32 keys)
// and write P and dS to shared memory; after a barrier warp w folds P^T dO
// and dS^T Q into dV and dK of keys 16 w + [0, 16).
template <typename T, int DMAX>
__global__ void __launch_bounds__(NUM_THREADS)
flash_bwd_dkdv_kernel(const Params p) {
  constexpr int BMQ = dkdv_rows<T>();
  constexpr int RG = BMQ / 16;              // query row groups of a tile
  constexpr int KW = BN * RG / 4;           // keys of a warp's block
  constexpr int LD = DMAX + Elem<T>::PAD;
  constexpr int LDP = BN + Elem<T>::PAD;
  constexpr int NTD = DMAX / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* k_s = reinterpret_cast<T*>(smem_raw);
  T* v_s = k_s + BN * LD;
  T* ring = v_s + BN * LD;                  // stage i: Q, then dO
  T* p_s = ring + 2 * 2 * BMQ * LD;
  T* ds_s = p_s + BMQ * LDP;
  T* pl_s = ds_s + BMQ * LDP;               // bfloat16: the rests of P
  T* dsl_s = pl_s + BMQ * LDP;              // and of dS

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int D = p.D;
  const int DK = flash::depth<T>(D);
  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int n0 = blockIdx.y * BN;

  const T* q = static_cast<const T*>(p.q) + b * p.s[SQ] + h * p.s[SQ + 1];
  const T* k = static_cast<const T*>(p.k) + b * p.s[SK] + h * p.s[SK + 1];
  const T* v = static_cast<const T*>(p.v) + b * p.s[SV] + h * p.s[SV + 1];
  const T* dout =
      static_cast<const T*>(p.dout) + b * p.s[SDO] + h * p.s[SDO + 1];
  const float* row_max = p.row_max + (size_t)bh * p.Tq;
  const float* row_sum = p.row_sum + (size_t)bh * p.Tq;
  const float* delta = p.delta + (size_t)bh * p.Tq;
  const flash::ScoreArgs sa = score_args(p, b, h);

  // causal: queries before the key tile's first row never see its keys
  const int m_start = p.causal ? n0 : 0;
  const int tiles = p.Tq > m_start ? (p.Tq - m_start + BMQ - 1) / BMQ : 0;

  flash::load_tile_async<T, BN, NUM_THREADS>(k_s, LD, k, p.s[SK + 2], n0,
                                             p.Tk, D, DK);
  flash::load_tile_async<T, BN, NUM_THREADS>(v_s, LD, v, p.s[SV + 2], n0,
                                             p.Tk, D, DK);
  if (tiles > 0) {
    flash::load_tile_async<T, BMQ, NUM_THREADS>(ring, LD, q, p.s[SQ + 2],
                                                m_start, p.Tq, D, DK);
    flash::load_tile_async<T, BMQ, NUM_THREADS>(ring + BMQ * LD, LD, dout,
                                                p.s[SDO + 2], m_start, p.Tq,
                                                D, DK);
  }
  flash::cp_async_commit();

  float dk[NTD][4], dv[NTD][4];
#pragma unroll
  for (int n = 0; n < NTD; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  const int wq = (warp % RG) * 16;  // the warp's query rows in the tile
  const int wk = (warp / RG) * KW;  // and its keys, for S, P, dP, dS
  for (int it = 0; it < tiles; ++it) {
    const int m0 = m_start + it * BMQ;
    if (it + 1 < tiles) {
      T* nxt = ring + ((it + 1) & 1) * 2 * BMQ * LD;
      flash::load_tile_async<T, BMQ, NUM_THREADS>(nxt, LD, q, p.s[SQ + 2],
                                                  m0 + BMQ, p.Tq, D, DK);
      flash::load_tile_async<T, BMQ, NUM_THREADS>(nxt + BMQ * LD, LD, dout,
                                                  p.s[SDO + 2], m0 + BMQ,
                                                  p.Tq, D, DK);
      flash::cp_async_commit();
      flash::cp_async_wait<1>();
    } else {
      flash::cp_async_wait<0>();
    }
    __syncthreads();
    const T* q_s = ring + (it & 1) * 2 * BMQ * LD;
    const T* do_s = q_s + BMQ * LD;

    float s[KW / 8][4], dp[KW / 8][4];
    flash::score_tile<T, KW / 8>(s, q_s + wq * LD, k_s + wk * LD, LD, DK, sa,
                                 m0 + wq, n0 + wk, lane);
#pragma unroll
    for (int j = 0; j < KW / 8; ++j)
      dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
    flash::mma_nt(dp, do_s + wq * LD, v_s + wk * LD, LD, DK, lane);
    const RowStats rs[2] = {
        row_stats(row_max, row_sum, delta, m0 + wq + g, p.Tq),
        row_stats(row_max, row_sum, delta, m0 + wq + g + 8, p.Tq)};
    probs_and_ds(s, dp, rs);
#pragma unroll
    for (int j = 0; j < KW / 8; ++j) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {   // rows g and g + 8, two keys each
        const int idx = (wq + g + 8 * r) * LDP + wk + 8 * j + 2 * t;
        const float* pr = &s[j][2 * r];
        const float* dsr = &dp[j][2 * r];
        flash::store2(p_s + idx, pr[0], pr[1]);
        flash::store2(ds_s + idx, dsr[0], dsr[1]);
        if constexpr (Elem<T>::HILO) {
          flash::store2(pl_s + idx, flash::bf16_rest(pr[0]),
                        flash::bf16_rest(pr[1]));
          flash::store2(dsl_s + idx, flash::bf16_rest(dsr[0]),
                        flash::bf16_rest(dsr[1]));
        }
      }
    }
    __syncthreads();

    flash::mma_trans_a<BMQ, NTD>(dv, p_s + warp * 16, LDP, do_s, LD, D, lane);
    if constexpr (Elem<T>::HILO) {
      flash::mma_trans_a<BMQ, NTD>(dv, pl_s + warp * 16, LDP, do_s, LD, D,
                                   lane);
      flash::mma_trans_a<BMQ, NTD>(dk, dsl_s + warp * 16, LDP, q_s, LD, D,
                                   lane);
    }
    flash::mma_trans_a<BMQ, NTD>(dk, ds_s + warp * 16, LDP, q_s, LD, D, lane);
    __syncthreads();   // P, dS and this stage are read before reuse
  }
  flash::cp_async_wait<0>();   // no copy outlives the block

  T* dkp = static_cast<T*>(p.dk) + b * p.s[SDK] + h * p.s[SDK + 1];
  T* dvp = static_cast<T*>(p.dv) + b * p.s[SDV] + h * p.s[SDV + 1];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kj = n0 + warp * 16 + g + 8 * r;
    if (kj >= p.Tk) continue;
#pragma unroll
    for (int n = 0; n < NTD; ++n) {
      const int col = n * 8 + 2 * t;
      if (col < D) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          flash::store(dkp + kj * p.s[SDK + 2] + col + e,
                       dk[n][2 * r + e] * p.scale);
          flash::store(dvp + kj * p.s[SDV + 2] + col + e, dv[n][2 * r + e]);
        }
      }
    }
  }
}

// One block per (b, h, 64-query tile), warp w on queries 16 w + [0, 16).
// For each key tile it computes S, P, dP and dS of its rows in registers
// and folds dS K into dQ.
template <typename T, int DMAX>
__global__ void __launch_bounds__(NUM_THREADS)
flash_bwd_dq_kernel(const Params p) {
  constexpr int BN = flash::kv_rows<T>();   // key rows per K/V tile
  constexpr int LD = DMAX + Elem<T>::PAD;
  constexpr int NTD = DMAX / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* q_s = reinterpret_cast<T*>(smem_raw);
  T* do_s = q_s + BM * LD;
  T* ring = do_s + BM * LD;                 // stage i: K, then V

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int D = p.D;
  const int DK = flash::depth<T>(D);
  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int m0 = blockIdx.y * BM;
  const int q0 = m0 + warp * 16;

  const T* q = static_cast<const T*>(p.q) + b * p.s[SQ] + h * p.s[SQ + 1];
  const T* k = static_cast<const T*>(p.k) + b * p.s[SK] + h * p.s[SK + 1];
  const T* v = static_cast<const T*>(p.v) + b * p.s[SV] + h * p.s[SV + 1];
  const T* dout =
      static_cast<const T*>(p.dout) + b * p.s[SDO] + h * p.s[SDO + 1];
  const flash::ScoreArgs sa = score_args(p, b, h);
  const float* row_max = p.row_max + (size_t)bh * p.Tq;
  const float* row_sum = p.row_sum + (size_t)bh * p.Tq;
  const float* delta = p.delta + (size_t)bh * p.Tq;
  const RowStats rs[2] = {row_stats(row_max, row_sum, delta, q0 + g, p.Tq),
                          row_stats(row_max, row_sum, delta, q0 + g + 8,
                                    p.Tq)};

  // causal: keys past the tile's last query row are never visible
  const int n_end = p.causal ? min(p.Tk, m0 + BM) : p.Tk;
  const int tiles = (n_end + BN - 1) / BN;

  flash::load_tile_async<T, BM, NUM_THREADS>(q_s, LD, q, p.s[SQ + 2], m0,
                                             p.Tq, D, DK);
  flash::load_tile_async<T, BM, NUM_THREADS>(do_s, LD, dout, p.s[SDO + 2], m0,
                                             p.Tq, D, DK);
  flash::load_tile_async<T, BN, NUM_THREADS>(ring, LD, k, p.s[SK + 2], 0,
                                             p.Tk, D, DK);
  flash::load_tile_async<T, BN, NUM_THREADS>(ring + BN * LD, LD, v,
                                             p.s[SV + 2], 0, p.Tk, D, DK);
  flash::cp_async_commit();

  float dq[NTD][4];
#pragma unroll
  for (int n = 0; n < NTD; ++n)
    dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;

  for (int it = 0; it < tiles; ++it) {
    if (it + 1 < tiles) {
      T* nxt = ring + ((it + 1) & 1) * 2 * BN * LD;
      const int n1 = (it + 1) * BN;
      flash::load_tile_async<T, BN, NUM_THREADS>(nxt, LD, k, p.s[SK + 2], n1,
                                                 p.Tk, D, DK);
      flash::load_tile_async<T, BN, NUM_THREADS>(nxt + BN * LD, LD, v,
                                                 p.s[SV + 2], n1, p.Tk, D,
                                                 DK);
      flash::cp_async_commit();
      flash::cp_async_wait<1>();
    } else {
      flash::cp_async_wait<0>();
    }
    __syncthreads();
    const T* k_s = ring + (it & 1) * 2 * BN * LD;
    const T* v_s = k_s + BN * LD;

    float s[BN / 8][4], dp[BN / 8][4];
    flash::score_tile<T, BN / 8>(s, q_s + warp * 16 * LD, k_s, LD, DK, sa, q0,
                                 it * BN, lane);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
      dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
    flash::mma_nt(dp, do_s + warp * 16 * LD, v_s, LD, DK, lane);
    probs_and_ds(s, dp, rs);
    if constexpr (Elem<T>::HILO) {
      float rest[BN / 8][4];
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) rest[j][e] = flash::bf16_rest(dp[j][e]);
      flash::mma_reg_a<BN / 8, NTD>(dq, rest, k_s, LD, D, lane);
    }
    flash::mma_reg_a<BN / 8, NTD>(dq, dp, k_s, LD, D, lane);
    __syncthreads();   // this stage's reads are done before it is refilled
  }

  T* dqp = static_cast<T*>(p.dq) + b * p.s[SDQ] + h * p.s[SDQ + 1];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + g + 8 * r;
    if (qi >= p.Tq) continue;
#pragma unroll
    for (int n = 0; n < NTD; ++n) {
      const int col = n * 8 + 2 * t;
      if (col < D) {
        flash::store(dqp + qi * p.s[SDQ + 2] + col, dq[n][2 * r] * p.scale);
        flash::store(dqp + qi * p.s[SDQ + 2] + col + 1,
                     dq[n][2 * r + 1] * p.scale);
      }
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
  const int64_t rows_per_block = DELTA_THREADS / DELTA_TPR;
  const unsigned delta_blocks =
      static_cast<unsigned>((rows + rows_per_block - 1) / rows_per_block);
  flash_bwd_delta_kernel<T><<<delta_blocks, DELTA_THREADS, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = launch_tiles(flash_bwd_dkdv_kernel<T, DMAX>,
                     dkdv_smem_bytes<T, DMAX>(), (p.Tk + BN - 1) / BN, p,
                     stream);
  if (err != cudaSuccess) return err;
  return launch_tiles(flash_bwd_dq_kernel<T, DMAX>, dq_smem_bytes<T, DMAX>(),
                      (p.Tq + BM - 1) / BM, p, stream);
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
