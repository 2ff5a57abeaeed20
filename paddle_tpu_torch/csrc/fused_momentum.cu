// Fused Momentum step over a bucket of parameters, for Hopper (sm_90a),
// written by hand.
//
// Replaces paddle_tpu/ops/pallas_kernels.py:678 fused_momentum_tpu (the
// pallas_call at :682, kernel _fused_momentum_kernel :663), the kernel of
// the fuse_optimizer pass's bucketed momentum update.  Element for
// element:
//
//   g' = g + l2 * p                 (only when l2 != 0: l2_decay)
//   v' = mu * v + g'
//   p' = p - lr * v'                or, Nesterov, p - lr * (g' + mu * v')
//
// lr is read from device memory through the [1] tensor's pointer, as the
// TPU kernel reads it from SMEM: the host never reads it, so a step never
// waits for the card.  Contract: bit-identical to the per-parameter
// momentum lowering, which torch runs as separate kernels that round every
// product and sum; so each is an explicitly rounded intrinsic (__fmul_rn,
// __fadd_rn, __fsub_rn) and nvcc contracts none of them into an FMA.
//
// Multi-tensor: the TPU kernel takes the bucket flattened into one padded
// buffer; on this card the three concatenations that would make it move
// as many bytes again as the update itself and hold three bucket-sized
// buffers live.  So the kernel reads p, g and v from each parameter's own
// tensor through a table of segment pointers passed by value (the launch
// copies the table with its arguments, so nothing on the host or the card
// can change it before the kernel reads it), and writes p' and v' into two
// flat output buffers in which every segment starts on a 4-float
// boundary; the op hands them out as per-parameter views.  Each block
// takes BLOCK_ELEMS consecutive values of one segment and finds that
// segment by a binary search over block_start.  A segment whose three
// inputs all start 16-byte aligned moves in float4 vectors with a scalar
// tail of its n % 4 values, taken by its last block; any other segment (an
// input that is a view at an odd offset) moves one float at a time.
//
// What bounds it on this card: bytes.  5 x 4 bytes per value (p, g, v
// read; p', v' written) and 4 to 8 flops: at the CTR program's
// 416,013,807-value bucket that is 8.32 GB, 2.48 ms at 3.35 TB/s.  Each
// thread keeps VECS float4 loads of each input in flight before it
// computes, so that enough bytes are on their way to cover the memory's
// latency.
//
// The master path (the bucket's update ops carry fp32 master weights):
// the table's p are the float32 masters, each gradient is read in its
// own dtype (float32, bfloat16 or float16, per segment) and widened in
// registers, and the kernel writes the new master and v' and, in the
// same pass, the parameter rounded to bfloat16 or float16
// (__float2bfloat16_rn, __float2half_rn: round to nearest even, as
// torch's Tensor.to rounds) into a third flat buffer.  Bit for bit the
// per-parameter momentum lowering with MasterParam.  Bytes a value stay
// at 20 for a 16-bit gradient and parameter (4 + 2 + 4 read, 4 + 4 + 2
// written), so its bound at a given bucket is the float32 path's.
//
// The C entry launches one kernel per chunk of at most MAX_SEGS segments,
// as the caller cut the table; nothing is allocated, and every launch is
// on the caller's stream.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NUM_THREADS = 256;
constexpr int VECS = 4;                                // float4s a thread
constexpr int BLOCK_ELEMS = NUM_THREADS * 4 * VECS;    // values a block
constexpr int MAX_SEGS = 48;   // the table stays under 4 KB of arguments

struct Coeffs {
  float mu, l2;
  int nesterov;
};

// dtype codes of a gradient and of the rounded parameter
constexpr int F32 = 0, BF16 = 1, F16 = 2;

struct Table {
  const float* p[MAX_SEGS];           // the params, or the fp32 masters
  const void* g[MAX_SEGS];            // of dtype gdt[j]
  const float* v[MAX_SEGS];
  int64_t n[MAX_SEGS];
  int64_t out[MAX_SEGS];              // the segment's offset in po, vo
  int block_start[MAX_SEGS + 1];
  unsigned long long vec;             // bit j: segment j moves in float4s
  unsigned char gdt[MAX_SEGS];        // F32, BF16 or F16
  int nseg;
};

struct Outs {
  const float* lr;
  float* po;
  float* vo;
  void* plo;                          // the rounded params (master path)
};

__device__ __forceinline__ float load_g(const void* g, int dt, int64_t i) {
  if (dt == BF16)
    return __bfloat162float(static_cast<const __nv_bfloat16*>(g)[i]);
  if (dt == F16) return __half2float(static_cast<const __half*>(g)[i]);
  return static_cast<const float*>(g)[i];
}

// the four values [4 i4, 4 i4 + 4) of a gradient, widened
__device__ __forceinline__ float4 load_g4(const void* g, int dt,
                                          int64_t i4) {
  if (dt == F32) return reinterpret_cast<const float4*>(g)[i4];
  const uint2 raw = reinterpret_cast<const uint2*>(g)[i4];
  float2 a, b;
  if (dt == BF16) {
    a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  } else {
    a = __half22float2(*reinterpret_cast<const __half2*>(&raw.x));
    b = __half22float2(*reinterpret_cast<const __half2*>(&raw.y));
  }
  return make_float4(a.x, a.y, b.x, b.y);
}

template <int LO>
__device__ __forceinline__ void store_lo(void* plo, int64_t i, float v) {
  if (LO == BF16)
    static_cast<__nv_bfloat16*>(plo)[i] = __float2bfloat16_rn(v);
  else if (LO == F16)
    static_cast<__half*>(plo)[i] = __float2half_rn(v);
}

template <int LO>
__device__ __forceinline__ void store_lo4(void* plo, int64_t i4, float4 v) {
  uint2 raw;
  if (LO == BF16) {
    const __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
    const __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
    raw.x = *reinterpret_cast<const unsigned*>(&a);
    raw.y = *reinterpret_cast<const unsigned*>(&b);
  } else if (LO == F16) {
    const __half2 a = __floats2half2_rn(v.x, v.y);
    const __half2 b = __floats2half2_rn(v.z, v.w);
    raw.x = *reinterpret_cast<const unsigned*>(&a);
    raw.y = *reinterpret_cast<const unsigned*>(&b);
  } else {
    return;
  }
  reinterpret_cast<uint2*>(plo)[i4] = raw;
}

__device__ __forceinline__ void momentum_one(float p, float g, float v,
                                             float lr, const Coeffs& c,
                                             float* po, float* vo) {
  if (c.l2 != 0.0f) g = __fadd_rn(g, __fmul_rn(c.l2, p));
  const float v_new = __fadd_rn(__fmul_rn(c.mu, v), g);
  const float step =
      c.nesterov ? __fadd_rn(g, __fmul_rn(c.mu, v_new)) : v_new;
  *po = __fsub_rn(p, __fmul_rn(lr, step));
  *vo = v_new;
}

// LO: the rounded parameter's dtype on the master path, F32 (nothing
// rounded, no third output) on the float32 path
template <int LO>
__global__ void __launch_bounds__(NUM_THREADS)
fused_momentum_kernel(const __grid_constant__ Table t, const Outs o,
                      const Coeffs c) {
  // the segment of this block: the last j with block_start[j] <= block
  const int block = blockIdx.x;
  int lo = 0, hi = t.nseg - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.block_start[mid] <= block)
      lo = mid;
    else
      hi = mid - 1;
  }
  const int j = lo;
  const int64_t n = t.n[j];
  const int64_t begin = (int64_t)(block - t.block_start[j]) * BLOCK_ELEMS;
  const float lr = *o.lr;
  const float* __restrict__ p = t.p[j];
  const void* __restrict__ g = t.g[j];
  const int gdt = t.gdt[j];
  const float* __restrict__ v = t.v[j];
  float* __restrict__ po = o.po + t.out[j];
  float* __restrict__ vo = o.vo + t.out[j];
  void* plo = LO == F32 ? nullptr
                        : static_cast<void*>(static_cast<char*>(o.plo) +
                                             2 * t.out[j]);

  if ((t.vec >> j) & 1ull) {
    const int64_t n4 = n / 4;
    const int64_t first = begin / 4 + threadIdx.x;
    float4 p4[VECS], g4[VECS], v4[VECS];
#pragma unroll
    for (int k = 0; k < VECS; ++k) {
      const int64_t i = first + k * NUM_THREADS;
      if (i < n4) {
        p4[k] = reinterpret_cast<const float4*>(p)[i];
        g4[k] = load_g4(g, gdt, i);
        v4[k] = reinterpret_cast<const float4*>(v)[i];
      }
    }
#pragma unroll
    for (int k = 0; k < VECS; ++k) {
      const int64_t i = first + k * NUM_THREADS;
      if (i < n4) {
        float4 pn, vn;
        momentum_one(p4[k].x, g4[k].x, v4[k].x, lr, c, &pn.x, &vn.x);
        momentum_one(p4[k].y, g4[k].y, v4[k].y, lr, c, &pn.y, &vn.y);
        momentum_one(p4[k].z, g4[k].z, v4[k].z, lr, c, &pn.z, &vn.z);
        momentum_one(p4[k].w, g4[k].w, v4[k].w, lr, c, &pn.w, &vn.w);
        reinterpret_cast<float4*>(po)[i] = pn;
        reinterpret_cast<float4*>(vo)[i] = vn;
        store_lo4<LO>(plo, i, pn);
      }
    }
    // the n % 4 tail, by the segment's last block
    const int64_t i = 4 * n4 + threadIdx.x;
    if (begin + BLOCK_ELEMS >= n && i < n) {
      float pn;
      momentum_one(p[i], load_g(g, gdt, i), v[i], lr, c, &pn, vo + i);
      po[i] = pn;
      store_lo<LO>(plo, i, pn);
    }
  } else {
#pragma unroll 4
    for (int k = 0; k < 4 * VECS; ++k) {
      const int64_t i = begin + k * NUM_THREADS + threadIdx.x;
      if (i < n) {
        float pn;
        momentum_one(p[i], load_g(g, gdt, i), v[i], lr, c, &pn, vo + i);
        po[i] = pn;
        store_lo<LO>(plo, i, pn);
      }
    }
  }
}

// One launch over segments [first, first + nseg) of the table.
cudaError_t launch_chunk(const void* const* table, const int64_t* n,
                         const int64_t* out, const unsigned char* gdt,
                         int lo, int first, int nseg, int nparams,
                         const Outs& o, const Coeffs& c, cudaStream_t st) {
  const int k = nparams;
  Table t;
  t.nseg = nseg;
  t.vec = 0;
  int64_t blocks = 0;
  for (int j = 0; j < nseg; ++j) {
    const int i = first + j;
    if (n[i] < 0 || out[i] % 4 != 0) return cudaErrorInvalidValue;
    t.p[j] = static_cast<const float*>(table[i]);
    t.g[j] = table[k + i];
    t.v[j] = static_cast<const float*>(table[2 * k + i]);
    t.gdt[j] = gdt ? gdt[i] : F32;
    if (t.gdt[j] > F16) return cudaErrorInvalidValue;
    t.n[j] = n[i];
    t.out[j] = out[i];
    t.block_start[j] = static_cast<int>(blocks);
    // a segment of no values still takes a block, which writes nothing:
    // the grid is never empty
    const int64_t nb = (n[i] + BLOCK_ELEMS - 1) / BLOCK_ELEMS;
    blocks += nb > 0 ? nb : 1;
    const uintptr_t any = reinterpret_cast<uintptr_t>(t.p[j]) |
                          reinterpret_cast<uintptr_t>(t.v[j]);
    const uintptr_t ga = reinterpret_cast<uintptr_t>(t.g[j]);
    if (any % 16 == 0 && ga % (t.gdt[j] == F32 ? 16 : 8) == 0)
      t.vec |= 1ull << j;
  }
  if (blocks >= (int64_t)1 << 31) return cudaErrorInvalidValue;
  t.block_start[nseg] = static_cast<int>(blocks);
  const unsigned nb = static_cast<unsigned>(blocks);
  if (lo == BF16)
    fused_momentum_kernel<BF16><<<nb, NUM_THREADS, 0, st>>>(t, o, c);
  else if (lo == F16)
    fused_momentum_kernel<F16><<<nb, NUM_THREADS, 0, st>>>(t, o, c);
  else
    fused_momentum_kernel<F32><<<nb, NUM_THREADS, 0, st>>>(t, o, c);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// One Momentum step over a bucket of nparams parameters, one launch per
// chunk.  table holds 3 * nparams pointers on the card: each parameter's
// p (its fp32 master on the master path), then each g, then each v, each
// kind nparams long; parameter i has n[i] values in each of its three
// tensors, float32 but for g, whose dtype code gdt[i] gives (0 float32,
// 1 bfloat16, 2 float16; gdt null: all float32), and starts at out[i] (a
// multiple of 4) in the flat outputs po and vo (16-byte aligned).  lo: 0,
// or the master path's rounded-parameter dtype code (1 bfloat16, 2
// float16), written into plo at the same offsets.
// chunks: nchunks + 1 ascending parameter indices from 0 to nparams, at
// most MAX_SEGS apart: launch c takes parameters [chunks[c], chunks[c +
// 1]).  lr: the bucket's one-value LearningRate.  mu and l2 rounded once
// to float32 by the caller, as torch rounds a Python scalar operand of a
// float32 tensor op.  Returns a cudaError_t (0 = every launch accepted).
int pt_fused_momentum(const void* const* table, const int64_t* n,
                      const int64_t* out, const unsigned char* gdt,
                      const int* chunks, int nchunks, int nparams,
                      const float* lr, float* po, float* vo, void* plo,
                      int lo, float mu, float l2, int nesterov,
                      void* stream) {
  const uintptr_t outs =
      reinterpret_cast<uintptr_t>(po) | reinterpret_cast<uintptr_t>(vo);
  if (nchunks <= 0 || nparams <= 0 || chunks[0] != 0 ||
      chunks[nchunks] != nparams || outs % 16 != 0 || lo < F32 ||
      lo > F16 || (lo != F32 && (plo == nullptr ||
                                 reinterpret_cast<uintptr_t>(plo) % 8 != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  for (int ch = 0; ch < nchunks; ++ch)
    if (chunks[ch + 1] <= chunks[ch] || chunks[ch + 1] - chunks[ch] > MAX_SEGS)
      return static_cast<int>(cudaErrorInvalidValue);
  const Outs o{lr, po, vo, plo};
  const Coeffs c{mu, l2, nesterov};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  for (int ch = 0; ch < nchunks; ++ch) {
    const cudaError_t err =
        launch_chunk(table, n, out, gdt, lo, chunks[ch],
                     chunks[ch + 1] - chunks[ch], nparams, o, c, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

const char* pt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
