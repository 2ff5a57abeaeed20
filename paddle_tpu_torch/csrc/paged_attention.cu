// Paged decode attention for Hopper (sm_90a), written by hand.
//
// Replaces paddle_tpu/ops/pallas_kernels.py:117 paged_flash_attention_tpu
// (the pallas_call at :128, kernel body _paged_attn_kernel :84), the TPU
// lowering of the paged_attention op that the fuse_paged_attention pass
// makes of the decode step's gather -> mul+reduce_sum -> scale -> masked add
// -> softmax -> mul+reduce_sum chain.  One query row per decode slot
// attends over K/V rows that live in flat page pools:
//
//   s[b, j]   = (q[b] . kp[idx[b, j]]) * scale * v + (v * neg - neg)
//               for the mask value v = valid[b, j]: the score at v = 1,
//               exactly -neg at v = 0
//   out[b]    = sum over j of softmax_j(s[b, :]) * vp[idx[b, j]]
//
// the arithmetic of the op's plain version (ops/attention.py
// _paged_reference), not the TPU kernel's page walk: the kernel reads the
// page table (idx) and the mask (valid) per position, so it is right for
// any table, needs no host sync to form lengths, and assumes nothing about
// a page's rows being contiguous.
//
// Softmax: online, in float32, with expf (not __expf).  A masked score is
// -neg (-1e30 in the decode programs); exp(-1e30 - m) is exactly 0 for any
// real score m, so in a row with one valid position a masked position
// contributes exactly 0, in whichever order the positions arrive and
// however the partial states merge.  A row with no valid position has
// every score equal to -neg and gives the mean of its V rows, as the plain
// softmax over equal scores does.
//
// What bounds it on this card: bytes, those of the valid rows.  A call
// must read the K and V rows of every valid position, q, the page table
// and the mask, and write out.  At the decode path's 32 slots of 512
// positions of width 768 that is about 100.7 MB when every position is
// valid (30 us at 3.35 TB/s), 59.2 MB at 300 valid positions a slot.  The
// FLOPs (4 * B * S * d, 50 MFLOP) do not bind.
//
// The design (flash-decoding):
// - Split.  The grid is B x n_split CTAs (cuda_kernels.paged_splits: about
//   two CTAs per SM, one wave, while each split of an all-valid row still
//   holds a 16-position chunk).  Every CTA of a slot reads q and the slot's
//   mask and page table once, in one round of independent loads (and traps
//   on a row outside [0, R)).
// - Skip.  If the row has a position with v != 0 (and neg >= 1e20, so
//   that a masked weight exp(-neg - m) is exactly 0 for every real m), the
//   kept positions are those with v != 0 and no K/V load is issued for the
//   others; a row with no valid position keeps, and reads, every position.
//   The kept positions, ranked in position order, are shared out evenly:
//   CTA t takes ranks [t * kept / n_split, (t + 1) * kept / n_split), so a
//   decode step's masked tail leaves no CTA idle while another reads
//   twice its share.  A CTA with no rank contributes m = -inf, l = 0.
// - Ring.  The CTA's positions go through a ring of nst stages (2, or 1 at
//   very wide d) of p positions each (8 at d = 768) in shared memory, sized
//   so that two CTAs share an SM up to d ~ 3,500.  Where rows are 16-byte
//   aligned and d % 4 == 0, one thread issues a 1-D bulk copy
//   (cp.async.bulk, the TMA's) of each K and V row, d * 4 bytes, completing
//   on the stage's mbarrier; else every thread issues 4-byte cp.async
//   copies.  A stage loads while the one before it is computed: at d = 768
//   up to 96 KB of rows in flight per CTA.
// - Scores.  Each warp takes a stage's positions warp, warp + 8, ...: a dot
//   over d from shared memory, a shuffle reduce, the masked score.  Warp 0
//   (a lane a position) updates the running (m, l) and the stage's
//   weights; every thread then updates its own columns of acc, held in
//   registers (one float4 per thread up to d = 1,024; up to 16 to
//   d = 16,384).
// - Wider heads (d > 16,384) take a slower loop in the same kernel: the
//   columns go in tiles of 16,384, the split's positions walked once a
//   tile, each warp scoring a position from q and its K row in device
//   memory (the whole dot, so m and l come out the same bits every tile)
//   and every thread adding the tile's columns of the weighted V rows,
//   also from device memory.  So the kernel is right at any d.
// - Merge.  With n_split > 1 each CTA writes its partial (m, l, acc[d]) to
//   a float32 workspace, fences, and takes a ticket on its slot; the last
//   CTA of the slot merges: l by a fixed warp tree, acc in split order (a
//   split with m = -inf weighs 0), the partials staged through the ring
//   (the first batch in flight while the (m, l) pairs are read);
//   it writes out and resets the ticket to 0 for the next call.  It reads
//   every partial from the workspace, its own too, so two calls give the
//   same bits whichever CTA comes last.
//
// The kernel allocates nothing (the wrapper owns the workspace and the
// zeroed tickets) and launches on the caller's stream.  The device's
// shared-memory limits are read, and each kernel's attributes set, once
// per device.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_P = 16;          // positions per ring stage
constexpr int LOADS = 4;           // independent loads a thread issues
constexpr int WINDOW = 512;        // positions compacted at a time
constexpr int MAX_SPLITS = 512;    // cuda_kernels.PAGED_MAX_SPLITS
constexpr int MAX_NACC = 16;       // float4 columns of acc per thread
constexpr int STATIC_RESERVE = 5120;   // static shared memory, rounded up
constexpr int MAX_DEVICES = 64;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)));
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// Issue the copies of stage st's K and V rows (ranks [st * p, min(n,
// st * p + p)) of the window's list) into ring buffer buf.  VEC: one
// thread issues a 1-D bulk copy of each row (d * 4 bytes, 16-byte
// aligned), completing on the buffer's mbarrier; else every thread issues
// 4-byte cp.async copies into the current commit group.
template <bool VEC>
__device__ __forceinline__ void load_stage(float* ring, uint64_t* bars,
                                           int buf, int st, int n, int p,
                                           int dp, int d, const int* rows_s,
                                           const float* __restrict__ kp,
                                           const float* __restrict__ vp) {
  float* kdst = ring + (size_t)buf * p * 2 * dp;
  float* vdst = kdst + (size_t)p * dp;
  const int k0 = st * p;
  const int np = min(p, n - k0);
  if (VEC) {
    if (threadIdx.x != 0) return;
    const unsigned row_bytes = (unsigned)d * sizeof(float);
    const unsigned bar = smem_u32(bars + buf);
    // the ring's earlier reads (generic proxy) before these writes
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 ::"r"(bar), "r"(2u * np * row_bytes) : "memory");
    for (int i = 0; i < np; ++i) {
      const int64_t src = (int64_t)rows_s[k0 + i] * d;
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1], %2, [%3];\n"
          ::"r"(smem_u32(kdst + (size_t)i * dp)), "l"(kp + src),
          "r"(row_bytes), "r"(bar) : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1], %2, [%3];\n"
          ::"r"(smem_u32(vdst + (size_t)i * dp)), "l"(vp + src),
          "r"(row_bytes), "r"(bar) : "memory");
    }
  } else {
    for (int t = threadIdx.x; t < np * d; t += THREADS) {
      const int i = t / d;
      const int c = t - i * d;
      const int64_t src = (int64_t)rows_s[k0 + i] * d + c;
      cp_async4(kdst + (size_t)i * dp + c, kp + src);
      cp_async4(vdst + (size_t)i * dp + c, vp + src);
    }
  }
}

// a call's tensors and sizes; skip: masked positions may be skipped
struct Args {
  const float* q;
  const float* kp;
  const float* vp;
  const int32_t* idx;
  const float* valid;
  float* out;
  float* part;
  int* tickets;
  int s;
  int64_t r;
  int d;
  float scale, neg;
  int skip;
};

// cp.async the partial acc rows of splits [t0, t0 + nb) into the ring
__device__ __forceinline__ void stage_partials(float* ring, const float* pslot,
                                               int t0, int nb, int dp) {
  const int total = nb * (dp / 4);
  for (int i = threadIdx.x; i < total; i += THREADS)
    cp_async16(ring + 4 * i, pslot + (int64_t)t0 * dp + 4 * i);
  cp_async_commit();
}

// the plain version's masked score, each step rounded as it rounds:
// (dot * scale + 0) * v + (v * neg + (-neg))
__device__ __forceinline__ float masked_score(float dot, float vj, float scale,
                                              float neg) {
  return __fadd_rn(__fmul_rn(__fmul_rn(dot, scale), vj),
                   __fadd_rn(__fmul_rn(vj, neg), -neg));
}

// q . k over d columns by one warp: lane-strided float4 (VEC) or float
// partial sums, then a shuffle reduce; every lane gets the dot
template <bool VEC>
__device__ __forceinline__ float warp_dot(const float* q, const float* k,
                                          int d, int lane) {
  float dot = 0.0f;
  if (VEC) {   // four independent chains, summed at the end
    const float4* k4 = reinterpret_cast<const float4*>(k);
    const float4* q4 = reinterpret_cast<const float4*>(q);
    float4 part4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 2
    for (int c = lane; c < d / 4; c += 32) {
      const float4 kk = k4[c];
      const float4 qq = q4[c];
      part4.x = fmaf(qq.x, kk.x, part4.x);
      part4.y = fmaf(qq.y, kk.y, part4.y);
      part4.z = fmaf(qq.z, kk.z, part4.z);
      part4.w = fmaf(qq.w, kk.w, part4.w);
    }
    dot = (part4.x + part4.y) + (part4.z + part4.w);
  } else {
    for (int c = lane; c < d; c += 32) dot = fmaf(q[c], k[c], dot);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    dot += __shfl_xor_sync(0xffffffffu, dot, o);
  return dot;
}

// the online softmax over a stage's np scores (sc_s), in warp 0 (lane i:
// position i), which alone keeps (m, l); the weights (p_s) and the
// correction of acc (corr_s) go to every thread through shared memory
__device__ __forceinline__ void softmax_stage(int np, int lane, float& m,
                                              float& l, const float* sc_s,
                                              float* p_s, float* corr_s) {
  const float sc = lane < np ? sc_s[lane] : -INFINITY;
  float m_new = sc;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m_new = fmaxf(m_new, __shfl_xor_sync(0xffffffffu, m_new, o));
  m_new = fmaxf(m, m_new);
  const float pj = lane < np ? expf(sc - m_new) : 0.0f;
  float psum = pj;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    psum += __shfl_xor_sync(0xffffffffu, psum, o);
  const float corr = expf(m - m_new);   // the first stage: exp(-inf)
  l = l * corr + psum;
  m = m_new;
  if (lane < np) p_s[lane] = pj;
  if (lane == 0) *corr_s = corr;
}

// acc[a][e] += w * row[c + e] over this thread's columns c < dt of a row
// (shared or global memory; 16-byte aligned where VEC)
template <bool VEC, int NACC>
__device__ __forceinline__ void acc_row(float (&acc)[NACC][4], float w,
                                        const float* row, int dt) {
#pragma unroll
  for (int a = 0; a < NACC; ++a) {
    const int c = 4 * (threadIdx.x + THREADS * a);
    if (c >= dt) continue;
    if (VEC) {
      const float4 vv = *reinterpret_cast<const float4*>(row + c);
      acc[a][0] = fmaf(w, vv.x, acc[a][0]);
      acc[a][1] = fmaf(w, vv.y, acc[a][1]);
      acc[a][2] = fmaf(w, vv.z, acc[a][2]);
      acc[a][3] = fmaf(w, vv.w, acc[a][3]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (c + e < dt) acc[a][e] = fmaf(w, row[c + e], acc[a][e]);
    }
  }
}

// dst[c] = acc * mul over this thread's columns c < dt; CG: store past L1
template <int NACC, bool CG>
__device__ __forceinline__ void store_acc(float* dst, const float (&acc)[NACC][4],
                                          float mul, int dt) {
#pragma unroll
  for (int a = 0; a < NACC; ++a) {
    const int c = 4 * (threadIdx.x + THREADS * a);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (c + e < dt) {
        if (CG)
          __stcg(dst + c + e, acc[a][e] * mul);
        else
          dst[c + e] = acc[a][e] * mul;
      }
  }
}

// WIDE: d past what acc holds in registers (4 * THREADS * NACC columns)
// or a ring stage holds in shared memory.  The columns go in tiles of 4 *
// THREADS * NACC, the split's positions walked once a tile: each warp
// takes a position, its score from q and the K row in device memory (the
// whole dot, so the scores, and m and l, come out the same bits every
// tile), and every thread adds the weighted V row's columns of the tile
// from device memory.  No ring, no q in shared memory.
template <bool VEC, int NACC, bool WIDE>
__global__ void __launch_bounds__(THREADS, 2)
paged_attention_kernel(const Args args, int p, int nst) {
  const float* __restrict__ q = args.q;
  const float* __restrict__ kp = args.kp;
  const float* __restrict__ vp = args.vp;
  const int32_t* __restrict__ idx = args.idx;
  const float* __restrict__ valid = args.valid;
  float* __restrict__ out = args.out;
  float* __restrict__ part = args.part;
  int* __restrict__ tickets = args.tickets;
  const int s = args.s, d = args.d;
  const int64_t r = args.r;
  const float scale = args.scale, neg = args.neg;
  // dynamic: the ring [nst][p][K, V][dp] and q [dp] (neither when WIDE),
  // the compacted window's pool rows and mask values [WINDOW] each
  extern __shared__ __align__(16) float smem[];
  const int dp = (d + 3) & ~3;
  float* ring = smem;
  float* q_s = ring + (size_t)nst * p * 2 * dp;
  int* rows_s = reinterpret_cast<int*>(WIDE ? smem : q_s + dp);
  float* v_s = reinterpret_cast<float*>(rows_s + WINDOW);
  __shared__ float sc_s[MAX_P], p_s[MAX_P];
  __shared__ float corr_s;
  __shared__ float f_s[MAX_SPLITS], lt_s[MAX_SPLITS];
  __shared__ int cnt_s[WARPS];
  __shared__ float l_s;
  __shared__ int last_s;
  __shared__ __align__(8) uint64_t bars_s[2];   // the ring's, VEC

  const int b = blockIdx.x;
  const int split = blockIdx.y;
  const int n_split = gridDim.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const float* q_b = q + (int64_t)b * d;
  const int32_t* idx_b = idx + (int64_t)b * s;
  const float* valid_b = valid + (int64_t)b * s;
  constexpr bool RING_BARS = VEC && !WIDE;

  // one round of independent loads, LOADS a thread at a time: q, the
  // count of the row's valid positions, and the check of its page table
  // (which also brings the row's mask and table into L1 for the ranking)
  if (!WIDE)
    for (int c0 = tid; c0 < d; c0 += LOADS * THREADS) {
      float qv[LOADS];
#pragma unroll
      for (int k = 0; k < LOADS; ++k) {
        const int c = c0 + k * THREADS;
        qv[k] = c < d ? q_b[c] : 0.0f;
      }
#pragma unroll
      for (int k = 0; k < LOADS; ++k)
        if (c0 + k * THREADS < d) q_s[c0 + k * THREADS] = qv[k];
    }
  int nz = 0;
  for (int j0 = tid; j0 < s; j0 += LOADS * THREADS) {
    int rows[LOADS];
    float vs[LOADS];
#pragma unroll
    for (int k = 0; k < LOADS; ++k) {
      const int j = j0 + k * THREADS;
      rows[k] = j < s ? idx_b[j] : 0;
      vs[k] = j < s ? valid_b[j] : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < LOADS; ++k) {
      if (rows[k] < 0 || rows[k] >= r) __trap();
      nz += args.skip && vs[k] != 0.0f;
    }
  }
  if (RING_BARS && tid == 0) {
    mbar_init(bars_s);
    mbar_init(bars_s + 1);
  }
  nz = __reduce_add_sync(0xffffffffu, nz);
  if (lane == 0) cnt_s[warp] = nz;
  __syncthreads();   // orders q_s and the mbarriers' init too
  int total_nz = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) total_nz += cnt_s[w];
  // masked positions are skipped only in a row that has a valid one; the
  // kept positions, ranked in position order, are shared out evenly
  const bool skip_masked = total_nz > 0;
  const int kept = skip_masked ? total_nz : s;
  const int lo = (int)((int64_t)split * kept / n_split);
  const int hi = (int)((int64_t)(split + 1) * kept / n_split);
  __syncthreads();   // cnt_s is rewritten below

  // the partials: acc [B][n_split][dp], then (m, l) [B][n_split][2]
  const int64_t slot = (int64_t)b * n_split;
  float* pacc = part + (slot + split) * dp;
  float* pml = part + (int64_t)gridDim.x * n_split * dp;
  float* orow = out + (int64_t)b * d;
  constexpr int TILE = 4 * THREADS * NACC;   // columns of acc a pass
  float m = -INFINITY;   // the running max and sum, kept by warp 0
  float l = 0.0f;
  float acc[NACC][4];
  int g0 = 0;            // ring stages loaded before this window

  for (int c_base = 0; c_base < d; c_base += TILE) {
    const int dt = min(TILE, d - c_base);
    m = -INFINITY;
    l = 0.0f;
#pragma unroll
    for (int a = 0; a < NACC; ++a)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][e] = 0.0f;

    int jr = 0, rank0 = 0;   // the walk: a round's first position, its rank
    for (int w_lo = lo; w_lo < hi; w_lo += WINDOW) {
      const int w_hi = min(hi, w_lo + WINDOW);
      const int n = w_hi - w_lo;
      // the window's kept positions, ranks w_lo to w_hi - 1
      if (!skip_masked) {   // every position kept: the rank is the position
        for (int k = tid; k < n; k += THREADS) {
          rows_s[k] = idx_b[w_lo + k];
          v_s[k] = valid_b[w_lo + k];
        }
      } else {
        // rank the positions a round of THREADS at a time; a round that
        // runs past the window is ranked again for the next window
        while (jr < s && rank0 < w_hi) {
          const int j = jr + tid;
          int row = 0;
          float v = 0.0f;
          if (j < s) {
            row = idx_b[j];
            v = valid_b[j];
          }
          const bool keep = v != 0.0f;
          const unsigned bal = __ballot_sync(0xffffffffu, keep);
          if (lane == 0) cnt_s[warp] = __popc(bal);
          __syncthreads();
          int rank = rank0, round = 0;
#pragma unroll
          for (int w = 0; w < WARPS; ++w) {
            rank += w < warp ? cnt_s[w] : 0;
            round += cnt_s[w];
          }
          rank += __popc(bal & ((1u << lane) - 1u));
          if (keep && rank >= w_lo && rank < w_hi) {
            rows_s[rank - w_lo] = row;
            v_s[rank - w_lo] = v;
          }
          __syncthreads();   // cnt_s is rewritten next round
          if (rank0 + round > w_hi) break;
          rank0 += round;
          jr += THREADS;
        }
      }
      __syncthreads();   // rows_s is whole

      if (WIDE) {
        // a position a warp, K and V rows straight from device memory
        for (int k0 = 0; k0 < n; k0 += p) {
          const int np = min(p, n - k0);
          if (warp < np) {
            const float dot = warp_dot<VEC>(
                q_b, kp + (int64_t)rows_s[k0 + warp] * d, d, lane);
            if (lane == 0)
              sc_s[warp] = masked_score(dot, v_s[k0 + warp], scale, neg);
          }
          __syncthreads();
          if (warp == 0) softmax_stage(np, lane, m, l, sc_s, p_s, &corr_s);
          __syncthreads();
          const float corr = corr_s;
#pragma unroll
          for (int a = 0; a < NACC; ++a)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[a][e] *= corr;
          for (int i = 0; i < np; ++i)
            acc_row<VEC, NACC>(acc, p_s[i],
                               vp + (int64_t)rows_s[k0 + i] * d + c_base, dt);
          __syncthreads();   // sc_s and p_s are free again
        }
        __syncthreads();   // rows_s is rewritten next window
        continue;
      }

      // the ring: stage g of the call in buffer g % nst; with VEC its
      // (g / nst)-th use completes phase (g / nst) & 1 of the buffer's
      // mbarrier, else the stage is one cp.async commit group
      const int n_stages = (n + p - 1) / p;
      for (int st = 0; st < nst; ++st) {
        if (st < n_stages)
          load_stage<VEC>(ring, bars_s, (g0 + st) % nst, st, n, p, dp, d,
                          rows_s, kp, vp);
        if (!VEC) cp_async_commit();
      }
      for (int st = 0; st < n_stages; ++st) {
        const int buf = (g0 + st) % nst;
        if (VEC)
          mbar_wait(bars_s + buf, ((g0 + st) / nst) & 1);
        else if (nst == 2)
          cp_async_wait<1>();
        else
          cp_async_wait<0>();
        __syncthreads();
        const float* kst = ring + (size_t)buf * p * 2 * dp;
        const float* vst = kst + (size_t)p * dp;
        const int k0 = st * p;
        const int np = min(p, n - k0);
        for (int i = warp; i < np; i += WARPS) {
          const float dot = warp_dot<VEC>(q_s, kst + (size_t)i * dp, d, lane);
          if (lane == 0)
            sc_s[i] = masked_score(dot, v_s[k0 + i], scale, neg);
        }
        __syncthreads();
        if (warp == 0) softmax_stage(np, lane, m, l, sc_s, p_s, &corr_s);
        __syncthreads();
        const float corr = corr_s;
#pragma unroll
        for (int a = 0; a < NACC; ++a)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[a][e] *= corr;
#pragma unroll 4
        for (int i = 0; i < np; ++i)
          acc_row<VEC, NACC>(acc, p_s[i], vst + (size_t)i * dp, d);
        __syncthreads();   // the stage's buffer, sc_s and p_s are free again
        if (st + nst < n_stages)
          load_stage<VEC>(ring, bars_s, buf, st + nst, n, p, dp, d, rows_s,
                          kp, vp);
        if (!VEC) cp_async_commit();
      }
      if (!VEC) cp_async_wait<0>();
      g0 += n_stages;
      __syncthreads();   // rows_s and the ring are rewritten next window
    }

    // the tile's columns: out = acc / l, or the split's partial acc
    if (n_split == 1) {
      if (tid == 0) l_s = l;
      __syncthreads();
      store_acc<NACC, false>(orow + c_base, acc, 1.0f / l_s, dt);
      __syncthreads();   // l_s is rewritten next tile
    } else {
      store_acc<NACC, true>(pacc + c_base, acc, 1.0f, dt);
    }
  }
  if (n_split == 1) return;

  if (tid == 0) {
    __stcg(pml + 2 * (slot + split), m);
    __stcg(pml + 2 * (slot + split) + 1, l);
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) last_s = atomicAdd(tickets + b, 1) == n_split - 1;
  __syncthreads();
  if (!last_s) return;
  __threadfence();

  // the slot's last CTA merges: (m, l) of every split into shared
  // memory, the max and the weights f_t = exp(m_t - max) (0 for a split
  // with m = -inf), l by a fixed warp tree, then acc in split order, the
  // partials staged through the ring a batch of splits at a time (read
  // straight from the workspace, a column tile at a time, when WIDE)
  const float* ml = pml + 2 * slot;
  const float* pslot = part + slot * dp;
  const int per_batch = nst * p * 2;   // partial rows the ring holds
  // the first batch of partials is in flight while (m, l) are read
  if (!WIDE) stage_partials(ring, pslot, 0, min(per_batch, n_split), dp);
  for (int t = tid; t < n_split; t += THREADS) {
    f_s[t] = __ldcg(ml + 2 * t);
    lt_s[t] = __ldcg(ml + 2 * t + 1);
  }
  __syncthreads();
  if (warp == 0) {
    float mx = -INFINITY;
    for (int t = lane; t < n_split; t += 32) mx = fmaxf(mx, f_s[t]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float lsum = 0.0f;
    for (int t = lane; t < n_split; t += 32) {
      const float mt = f_s[t];
      const float f = mt == -INFINITY ? 0.0f : expf(mt - mx);
      f_s[t] = f;
      lsum = fmaf(lt_s[t], f, lsum);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      lsum += __shfl_xor_sync(0xffffffffu, lsum, o);
    if (lane == 0) {
      l_s = lsum;
      tickets[b] = 0;   // ready for the next call on this workspace
    }
  }
  __syncthreads();
  const float inv_l = 1.0f / l_s;
  for (int c_base = 0; c_base < d; c_base += TILE) {
    const int dt = min(TILE, d - c_base);
#pragma unroll
    for (int a = 0; a < NACC; ++a)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][e] = 0.0f;
    if (WIDE) {
      // partial rows are dp floats, 16-byte aligned: float4 reads
      for (int t = 0; t < n_split; ++t) {
        const float f = f_s[t];
        const float* prow = pslot + (int64_t)t * dp + c_base;
#pragma unroll
        for (int a = 0; a < NACC; ++a) {
          const int c = 4 * (tid + THREADS * a);
          if (c >= dt) continue;
          const float4 pv = __ldcg(reinterpret_cast<const float4*>(prow + c));
          acc[a][0] = fmaf(pv.x, f, acc[a][0]);
          acc[a][1] = fmaf(pv.y, f, acc[a][1]);
          acc[a][2] = fmaf(pv.z, f, acc[a][2]);
          acc[a][3] = fmaf(pv.w, f, acc[a][3]);
        }
      }
    } else {
      for (int t0 = 0; t0 < n_split; t0 += per_batch) {
        const int nb = min(per_batch, n_split - t0);
        if (t0 > 0) stage_partials(ring, pslot, t0, nb, dp);
        cp_async_wait<0>();
        __syncthreads();
#pragma unroll 4
        for (int t = 0; t < nb; ++t)
          acc_row<true, NACC>(acc, f_s[t0 + t], ring + t * dp, dt);
        __syncthreads();   // the ring is refilled by the next batch
      }
    }
    store_acc<NACC, false>(orow + c_base, acc, inv_l, dt);
  }
}

// the shared-memory geometry of a call: p positions a stage, nst stages,
// the dynamic bytes
struct Geometry {
  int p, nst;
  size_t bytes;
};

size_t smem_bytes(int d, int p, int nst) {
  const size_t dp = (size_t)((d + 3) & ~3);
  return ((size_t)nst * p * 2 * dp + dp) * sizeof(float) +
         (size_t)WINDOW * (sizeof(int) + sizeof(float));
}

// Two stages of as many positions as fit (at most MAX_P) in half an SM's
// shared memory, so that two CTAs share an SM; else in the most one CTA
// may hold; else one stage.  p = 0: d is too wide for the ring.
Geometry geometry(int d, int per_sm, int optin) {
  const int budgets[2] = {per_sm / 2 - 1024 - STATIC_RESERVE,
                          optin - STATIC_RESERVE};
  const size_t row_pair = (size_t)2 * ((d + 3) & ~3) * sizeof(float);
  for (int nst = 2; nst >= 1; --nst)
    for (int k = 0; k < 2; ++k) {
      if (nst == 1 && k == 0) continue;
      const size_t fixed = smem_bytes(d, 0, nst);
      if ((size_t)budgets[k] <= fixed) continue;
      const size_t p = ((size_t)budgets[k] - fixed) / (nst * row_pair);
      if (p >= 1) {
        const int pp = p < MAX_P ? static_cast<int>(p) : MAX_P;
        return {pp, nst, smem_bytes(d, pp, nst)};
      }
    }
  return {0, 0, 0};
}

// the device's limits, read once per device; each kernel's attributes set
// once per device
struct DeviceLimits {
  bool ready = false;
  int per_sm = 0, optin = 0;
  bool set[2][6] = {};
};
DeviceLimits g_limits[MAX_DEVICES];
std::mutex g_mutex;

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// the kernel of each (VEC, NACC, WIDE), and whether its attributes are set
template <bool VEC, int NACC, bool WIDE = false>
int launch(DeviceLimits& lim, int slot, const Geometry& g, dim3 grid,
           cudaStream_t stream, const Args& a) {
  auto kernel = paged_attention_kernel<VEC, NACC, WIDE>;
  {
    std::lock_guard<std::mutex> lock(g_mutex);
    if (!lim.set[VEC][slot]) {
      cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          lim.optin - STATIC_RESERVE);
      if (err == cudaSuccess)
        err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
            cudaSharedmemCarveoutMaxShared);
      if (err != cudaSuccess) return static_cast<int>(err);
      lim.set[VEC][slot] = true;
    }
  }
  kernel<<<grid, THREADS, g.bytes, stream>>>(a, g.p, g.nst);
  return static_cast<int>(cudaGetLastError());
}

template <bool VEC>
int launch_nacc(int nacc, bool wide, DeviceLimits& lim, const Geometry& g,
                dim3 grid, cudaStream_t stream, const Args& a) {
  if (wide) return launch<VEC, MAX_NACC, true>(lim, 5, g, grid, stream, a);
  switch (nacc) {
    case 1: return launch<VEC, 1>(lim, 0, g, grid, stream, a);
    case 2: return launch<VEC, 2>(lim, 1, g, grid, stream, a);
    case 4: return launch<VEC, 4>(lim, 2, g, grid, stream, a);
    case 8: return launch<VEC, 8>(lim, 3, g, grid, stream, a);
    default: return launch<VEC, 16>(lim, 4, g, grid, stream, a);
  }
}

}  // namespace

extern "C" {

// q [b, d], kp and vp [r, d], idx [b, s] int32, valid [b, s], out [b, d];
// all float32 but idx, all contiguous.  n_split CTAs a slot share out its
// kept positions.  With n_split > 1, part holds
// b * n_split * (round_up(d, 4) + 2) floats and tickets b ints, all 0 on
// entry and again on exit.  device: the current device's index.
// Returns a cudaError_t (0 = launched).
int pt_paged_attention(const float* q, const float* kp, const float* vp,
                       const int32_t* idx, const float* valid, float* out,
                       float* part, int* tickets, int b, int s, int64_t r,
                       int d, int n_split, float scale, float neg, int device,
                       void* stream) {
  if (b <= 0 || s <= 0 || r <= 0 || d <= 0 || n_split <= 0 ||
      n_split > MAX_SPLITS || device < 0 || device >= MAX_DEVICES ||
      (n_split > 1 && (part == nullptr || tickets == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int nacc_need = (d + 4 * THREADS - 1) / (4 * THREADS);
  int nacc = 1;
  while (nacc < nacc_need && nacc < MAX_NACC) nacc *= 2;
  DeviceLimits& lim = g_limits[device];
  {
    std::lock_guard<std::mutex> lock(g_mutex);
    if (!lim.ready) {
      cudaError_t err = cudaDeviceGetAttribute(
          &lim.per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, device);
      if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(
            &lim.optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
      if (err != cudaSuccess) return static_cast<int>(err);
      lim.ready = true;
    }
  }
  // past what acc holds in registers, or a ring stage in shared memory,
  // the kernel walks the columns in tiles with no ring (WIDE)
  Geometry g = geometry(d, lim.per_sm, lim.optin);
  const bool wide = nacc_need > MAX_NACC || g.p == 0;
  if (wide)
    g = {WARPS, 0, (size_t)WINDOW * (sizeof(int) + sizeof(float))};
  const Args a{q, kp, vp, idx, valid, out, part, tickets, s, r, d, scale, neg,
               neg >= 1e20f ? 1 : 0};
  const dim3 grid(b, n_split);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // the ring path stages q through shared memory; WIDE reads it as float4
  const bool vec = d % 4 == 0 && aligned16(kp) && aligned16(vp) &&
                   (!wide || aligned16(q));
  return vec ? launch_nacc<true>(nacc, wide, lim, g, grid, st, a)
             : launch_nacc<false>(nacc, wide, lim, g, grid, st, a);
}

const char* pt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
