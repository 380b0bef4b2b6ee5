// Flash attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel `_flash_kernel`
// (open_gpu_kernel_modules_tpu/ops/flash_attention.py:103, the default
// "grid" implementation): blockwise causal or full attention with an online
// base-2 softmax.
//
//   q, out  [B, Sq, H, D] ("bshd") or [B, H, Sq, D] ("bhsd"), contiguous
//   k, v    the same layout with Sk rows
//
// The caller passes the element strides of the batch, head and sequence
// axes, so both layouts are read in place: no transpose or padding copies.
//
// Bound on the H100: at Llama prefill shapes (S=2048, D=128) the work is
// 4*B*H*Sq*Sk*D FLOPs (half under causal) against a few bytes per FLOP, so
// the tensor-core rate bounds it: 989 TFLOP/s in bf16.
//
// Two bodies, chosen by dtype:
//
// - bf16 runs the tensor-core core of attn_sm90.cuh as a ring: one CTA per
//   (b*h, 128-row q block), a producer warp keeps kStages 64-key K/V blocks
//   in flight by TMA while two consumer warpgroups run QK^T and PV as wgmma
//   with the softmax in registers.  Under `causal` the loop stops at the
//   last block the q block can see.
// - fp32 runs the FMA body below, kept as PR 1 wrote it (templated on the
//   element type; only float is instantiated now).  The tensor cores have
//   no full-fp32 mode, and TF32 (10 mantissa bits) cannot meet the fp32
//   limit of (1e-4, 0) against the plain version, so fp32 stays on the CUDA
//   cores (67 TFLOP/s peak).  One CTA per (b*h, 64-row q block); an in-CTA
//   loop over 64-row k blocks.  Q, K, V and P tiles sit in shared memory in
//   fp32; each of the 256 threads owns a 4x4 patch of the 64x64 score tile
//   and a 4 x D/16 patch of the output, accumulated with plain FMAs.  Only
//   the diagonal and kv-length-tail blocks are masked (to -1e30, as on the
//   TPU).  With `prescale` Q is multiplied by `scale` while it is loaded;
//   otherwise the scores are scaled.  A zero denominator becomes 1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attn_sm90.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBQ = 64, kBK = 64, kThreads = 256;
constexpr int kStages = 4;   // K/V blocks in flight in the bf16 ring

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

using attn_sm90::Strides;

// Shared memory, in floats: Q [BQ][D+1], K [BK][D+1], V [BK][D], P [BQ][BK+1].
// Q, K and P rows are padded by one float so threads reading one column of
// different rows hit different banks.
__host__ __device__ constexpr int smem_floats(int d) {
  return kBQ * (d + 1) + kBK * (d + 1) + kBK * d + kBQ * (kBK + 1);
}

// Load rows [row0, row0+64) of one (b, h) slice into an fp32 tile with row
// stride `ld`; rows at or past `rows` are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* base,
                                          long long s_stride, int row0, int rows,
                                          bool round_scaled, float scale) {
  constexpr int per = 16 / sizeof(T);          // elements per 16-byte read
  constexpr int chunks = D / per;
  for (int i = threadIdx.x; i < 64 * chunks; i += kThreads) {
    const int r = i / chunks, c = i % chunks;
    float* o = dst + r * ld + c * per;
    if (row0 + r < rows) {
      const uint4 raw = *reinterpret_cast<const uint4*>(base + (row0 + r) * s_stride + c * per);
      const T* x = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int e = 0; e < per; ++e)
        o[e] = round_scaled ? to_f(from_f<T>(to_f(x[e]) * scale)) : to_f(x[e]);
    } else {
#pragma unroll
      for (int e = 0; e < per; ++e) o[e] = 0.f;
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int H, int Sq,
                 int Sk, Strides qs, Strides ks, int causal, int prescale,
                 float scale) {
  constexpr int NE = D / 16;                   // output columns per thread
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + kBQ * (D + 1);
  float* Vs = Ks + kBK * (D + 1);
  float* Ps = Vs + kBK * D;

  const int n_qb = (Sq + kBQ - 1) / kBQ;
  const int qb = causal ? n_qb - 1 - blockIdx.x : blockIdx.x;   // heavy first
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q_first = qb * kBQ;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  const T* qbase = q + b * qs.b + h * qs.h;
  const T* kbase = k + b * ks.b + h * ks.h;
  const T* vbase = v + b * ks.b + h * ks.h;
  load_tile<T, D>(Qs, D + 1, qbase, qs.s, q_first, Sq, prescale != 0, scale);
  const float s_scale = prescale ? 1.f : scale;

  float m[4], l[4], acc[4][NE];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m[a] = kNegInf;
    l[a] = 0.f;
#pragma unroll
    for (int e = 0; e < NE; ++e) acc[a][e] = 0.f;
  }

  int n_kb = (Sk + kBK - 1) / kBK;
  if (causal) n_kb = min(n_kb, (q_first + kBQ - 1) / kBK + 1);

  for (int kb = 0; kb < n_kb; ++kb) {
    const int k_base = kb * kBK;
    __syncthreads();                           // last block's PV is done
    load_tile<T, D>(Ks, D + 1, kbase, ks.s, k_base, Sk, false, 1.f);
    load_tile<T, D>(Vs, D, vbase, ks.s, k_base, Sk, false, 1.f);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[a][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) qv[a] = Qs[(ty + 16 * a) * (D + 1) + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) kv[c] = Ks[(tx + 16 * c) * (D + 1) + d];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[a][c] = fmaf(qv[a], kv[c], s[a][c]);
    }

    const bool needs_mask = k_base + kBK > Sk || (causal && k_base + kBK - 1 > q_first);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int qi = q_first + ty + 16 * a;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float x = s[a][c] * s_scale;
        if (needs_mask) {
          const int kj = k_base + tx + 16 * c;
          if (kj >= Sk || (causal && kj > qi)) x = kNegInf;
        }
        s[a][c] = x;
        mx = fmaxf(mx, x);
      }
      for (int o = 8; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o, 16));
      const float m_new = fmaxf(m[a], mx);
      const float corr = exp2f(m[a] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = exp2f(s[a][c] - m_new);
        sum += p;
        Ps[(ty + 16 * a) * (kBK + 1) + tx + 16 * c] = to_f(from_f<T>(p));
      }
      for (int o = 8; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o, 16);
      l[a] = corr * l[a] + sum;
      m[a] = m_new;
#pragma unroll
      for (int e = 0; e < NE; ++e) acc[a][e] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float pv[4], vv[NE];
#pragma unroll
      for (int a = 0; a < 4; ++a) pv[a] = Ps[(ty + 16 * a) * (kBK + 1) + j];
#pragma unroll
      for (int e = 0; e < NE; ++e) vv[e] = Vs[j * D + tx + 16 * e];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int e = 0; e < NE; ++e) acc[a][e] = fmaf(pv[a], vv[e], acc[a][e]);
    }
  }

  T* obase = out + b * qs.b + h * qs.h;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int qi = q_first + ty + 16 * a;
    if (qi >= Sq) continue;
    const float inv = 1.f / (l[a] == 0.f ? 1.f : l[a]);
#pragma unroll
    for (int e = 0; e < NE; ++e)
      obase[qi * qs.s + tx + 16 * e] = from_f<T>(acc[a][e] * inv);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int B, int H,
           int Sq, int Sk, Strides qs, Strides ks, int causal, int prescale,
           float scale, cudaStream_t stream) {
  const int bytes = smem_floats(D) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + kBQ - 1) / kBQ, B * H);
  flash_fwd_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), H, Sq, Sk, qs, ks, causal, prescale, scale);
  return (int)cudaGetLastError();
}

int dispatch_fp32(const void* q, const void* k, const void* v, void* out, int B, int H,
                  int Sq, int Sk, int D, Strides qs, Strides ks, int causal,
                  int prescale, float scale, cudaStream_t s) {
  if (D == 64) return launch<float, 64>(q, k, v, out, B, H, Sq, Sk, qs, ks, causal, prescale, scale, s);
  if (D == 128) return launch<float, 128>(q, k, v, out, B, H, Sq, Sk, qs, ks, causal, prescale, scale, s);
  return (int)cudaErrorInvalidValue;
}

int dispatch_bf16(const void* q, const void* k, const void* v, void* out, int B, int H,
                  int Sq, int Sk, int D, Strides qs, Strides ks,
                  int causal, int prescale, float scale, cudaStream_t s) {
  if (D == 64)
    return attn_sm90::launch<64, false>(q, k, v, out, B, H, Sq, Sk, qs, ks, causal, prescale,
                                        scale, kStages, s);
  if (D == 128)
    return attn_sm90::launch<128, false>(q, k, v, out, B, H, Sq, Sk, qs, ks, causal, prescale,
                                         scale, kStages, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; D in {64, 128}.  q/out share strides
// (q_sb, q_sh, q_ss), k/v share (k_sb, k_sh, k_ss).  The `scale` is
// log2(e)/sqrt(D) rounded to fp32.  bf16 runs on the tensor cores, fp32 on
// the CUDA cores.  Returns 0, a CUDA error, or attn_sm90's tensor-map codes.
int flash_attn_fwd(const void* q, const void* k, const void* v, void* out, int B,
                   int H, int Sq, int Sk, int D, long long q_sb, long long q_sh,
                   long long q_ss, long long k_sb, long long k_sh, long long k_ss,
                   int causal, int prescale, float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_fp32(q, k, v, out, B, H, Sq, Sk, D, {q_sb, q_sh, q_ss}, {k_sb, k_sh, k_ss},
                         causal, prescale, scale, s);
  if (dtype == 1)
    return dispatch_bf16(q, k, v, out, B, H, Sq, Sk, D, {q_sb, q_sh, q_ss}, {k_sb, k_sh, k_ss},
                         causal, prescale, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
