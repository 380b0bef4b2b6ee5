// Row-resident flash attention forward for Hopper (sm_90a), plain C interface
// for ctypes.
//
// Replaces the Pallas TPU kernel `_flash_kernel_rows`
// (open_gpu_kernel_modules_tpu/ops/flash_attention.py:37, selected by
// `flash_attention(impl="rows")`): the same causal or full attention as the
// grid kernel, but the K/V row of each (b, h) stays resident in fast memory
// while an in-kernel loop walks its key blocks, and the loop's trip count is
// cut to the blocks the q block can see.
//
//   q, out  [B, Sq, H, D] ("bshd") or [B, H, Sq, D] ("bhsd"), contiguous
//   k, v    the same layout with Sk rows
//
// The caller passes the element strides of the batch, head and sequence
// axes, so both layouts are read in place.
//
// Bound on the H100: at Llama prefill shapes (S=2048, D=128) the work is
// 4*B*H*Sq*Sk*D FLOPs (about half under causal) against a few bytes per FLOP,
// so the tensor-core rate bounds it: 989 TFLOP/s in bf16.
//
// Two bodies, chosen by dtype:
//
// - bf16 runs the tensor-core core of attn_sm90.cuh in its segment mode.
//   One CTA per (b*h, 128-row q block) keeps the LIVE part of its K/V row
//   (min(Sk, q_last + 1) keys under causal, else Sk) resident in shared
//   memory: up to 384 keys at D=128 (832 at D=64) beside the Q tile, each
//   64-key block landing by TMA on its own mbarrier, so the wgmma math on
//   block j starts as soon as block j has arrived.  A longer span is staged
//   in segments of whole blocks, one after the other.
// - fp32 runs the FMA body below.  The tensor cores have no full-fp32 mode,
//   and TF32 (10 mantissa bits) cannot meet the fp32 limit of (1e-4, 0)
//   against the plain version, so fp32 stays on the CUDA cores (67 TFLOP/s
//   peak).  The CTA stages the live span with 16-byte cp.async, rows padded
//   by 16 bytes so eight threads reading eight rows at one column hit eight
//   bank groups: 128 keys at D=128 beside the Q and P tiles, more in
//   segments.  Each of the 256 threads owns a 4x4 patch of the 64x64 score
//   tile and a 4 x D/16 patch of the output, in fp32 registers.  Staging is
//   not overlapped with the math.
//
// Both follow the grid kernel and the JAX wrapper: with `prescale` Q is
// multiplied by `scale` (and in bf16 rounded) before QK^T, otherwise the
// scores are scaled; only blocks that cross the causal diagonal or the Sk
// tail are masked (to -1e30); a zero denominator becomes 1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attn_sm90.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBQ = 64, kBK = 64, kThreads = 256;
constexpr int kPadBytes = 16;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
}

using attn_sm90::kSmemLimit;   // opt-in shared memory per CTA
using attn_sm90::Strides;

// Shared memory layout in bytes, the same on host and device:
//   Q  [64][row]          pre-scaled when `prescale`
//   P  [64][65]           the block's probabilities
//   K  [seg][row], V [seg][row]
struct Layout {
  int row, q_off, p_off, k_off, v_off, total;
  __host__ __device__ Layout(int d, int seg) {
    row = d * 4 + kPadBytes;
    q_off = 0;
    p_off = q_off + kBQ * row;
    k_off = p_off + kBQ * (kBK + 1) * 4;
    v_off = k_off + seg * row;
    total = v_off + seg * row;
  }
};

// Keys one segment may hold: as many 64-key blocks as fit beside Q and P.
__host__ __device__ inline int segment_capacity(int d) {
  const Layout base(d, 0);
  return (kSmemLimit - base.total) / (2 * base.row) / kBK * kBK;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_rows_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ out, int H, int Sq,
                  int Sk, Strides qs, Strides ks, int causal, int prescale,
                  float scale, int seg_cap) {
  constexpr int PER = 4;                       // floats per 16-byte chunk
  constexpr int CH = D / PER;                  // 16-byte chunks per row
  constexpr int NE = D / 16;                   // output columns per thread
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lay(D, seg_cap);
  unsigned char* Qs = smem + lay.q_off;
  float* Ps = reinterpret_cast<float*>(smem + lay.p_off);
  unsigned char* Ks = smem + lay.k_off;
  unsigned char* Vs = smem + lay.v_off;

  const int n_qb = (Sq + kBQ - 1) / kBQ;
  const int qb = causal ? n_qb - 1 - blockIdx.x : blockIdx.x;   // heavy first
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q_first = qb * kBQ;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  const float* qbase = q + b * qs.b + h * qs.h;
  const float* kbase = k + b * ks.b + h * ks.h;
  const float* vbase = v + b * ks.b + h * ks.h;

  // Q tile, after the optional pre-scale; rows past Sq are 0.
  for (int i = threadIdx.x; i < kBQ * CH; i += kThreads) {
    const int r = i / CH, c = i % CH;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (q_first + r < Sq) {
      raw = *reinterpret_cast<const uint4*>(qbase + (q_first + r) * qs.s + c * PER);
      if (prescale) {
        float* x = reinterpret_cast<float*>(&raw);
#pragma unroll
        for (int e = 0; e < PER; ++e) x[e] *= scale;
      }
    }
    *reinterpret_cast<uint4*>(Qs + r * lay.row + c * 16) = raw;
  }
  const float s_scale = prescale ? 1.f : scale;

  // The live key span of this q block.
  const int q_last = min(q_first + kBQ, Sq) - 1;
  const int live = causal ? min(Sk, q_last + 1) : Sk;

  float m[4], l[4], acc[4][NE];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m[a] = kNegInf;
    l[a] = 0.f;
#pragma unroll
    for (int e = 0; e < NE; ++e) acc[a][e] = 0.f;
  }

  for (int seg0 = 0; seg0 < live; seg0 += seg_cap) {
    const int n = min(seg_cap, live - seg0);             // keys staged
    const int n_pad = (n + kBK - 1) / kBK * kBK;         // whole blocks
    __syncthreads();                                     // last segment done
    for (int i = threadIdx.x; i < n_pad * CH; i += kThreads) {
      const int r = i / CH, c = i % CH;
      unsigned char* kd = Ks + r * lay.row + c * 16;
      unsigned char* vd = Vs + r * lay.row + c * 16;
      if (r < n) {
        const long long off = (long long)(seg0 + r) * ks.s + c * PER;
        cp_async16(kd, kbase + off);
        cp_async16(vd, vbase + off);
      } else {
        // Past the live span: zeros, so masked keys never meet NaN bits.
        *reinterpret_cast<uint4*>(kd) = make_uint4(0u, 0u, 0u, 0u);
        *reinterpret_cast<uint4*>(vd) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    cp_async_commit_wait_all();
    __syncthreads();

    for (int blk = 0; blk < n_pad; blk += kBK) {
      const int k_base = seg0 + blk;
      const unsigned char* Kb = Ks + blk * lay.row;
      const unsigned char* Vb = Vs + blk * lay.row;

      float s[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[a][c] = 0.f;
#pragma unroll 2
      for (int ch = 0; ch < CH; ++ch) {
        float qv[4][PER], kv[4][PER];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const uint4 raw = *reinterpret_cast<const uint4*>(
              Qs + (ty + 16 * a) * lay.row + ch * 16);
          const float* x = reinterpret_cast<const float*>(&raw);
#pragma unroll
          for (int e = 0; e < PER; ++e) qv[a][e] = x[e];
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const uint4 raw = *reinterpret_cast<const uint4*>(
              Kb + (tx + 16 * c) * lay.row + ch * 16);
          const float* x = reinterpret_cast<const float*>(&raw);
#pragma unroll
          for (int e = 0; e < PER; ++e) kv[c][e] = x[e];
        }
#pragma unroll
        for (int e = 0; e < PER; ++e)
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int c = 0; c < 4; ++c) s[a][c] = fmaf(qv[a][e], kv[c][e], s[a][c]);
      }

      // Mask only the blocks that cross the Sk tail or the causal diagonal.
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
          Ps[(ty + 16 * a) * (kBK + 1) + tx + 16 * c] = p;
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
        const float* vrow = reinterpret_cast<const float*>(Vb + j * lay.row);
#pragma unroll
        for (int e = 0; e < NE; ++e) vv[e] = vrow[tx + 16 * e];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int e = 0; e < NE; ++e) acc[a][e] = fmaf(pv[a], vv[e], acc[a][e]);
      }
      __syncthreads();                                   // P is rewritten next
    }
  }

  float* obase = out + b * qs.b + h * qs.h;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int qi = q_first + ty + 16 * a;
    if (qi >= Sq) continue;
    const float inv = 1.f / (l[a] == 0.f ? 1.f : l[a]);
#pragma unroll
    for (int e = 0; e < NE; ++e)
      obase[qi * qs.s + tx + 16 * e] = acc[a][e] * inv;
  }
}

// Keys the largest CTA stages at once: its live span rounded up to whole
// blocks, capped at the segment capacity of the dtype's body (bf16: the
// tensor-core core's 64-key blocks beside Q; fp32: the FMA layout).  Short
// rows take less shared memory, so more CTAs fit on an SM.
int segment_tokens(int Sq, int Sk, int D, int itemsize, int causal) {
  const int n_qb = (Sq + kBQ - 1) / kBQ;
  const int max_live = causal ? min(Sk, n_qb * kBQ) : Sk;
  const int need = (max_live + kBK - 1) / kBK * kBK;
  const int cap = itemsize == 2 ? attn_sm90::max_slots(D) * kBK : segment_capacity(D);
  return need < cap ? (need > 0 ? need : kBK) : cap;
}

template <int D>
int launch_fp32(const void* q, const void* k, const void* v, void* out, int B, int H,
                int Sq, int Sk, Strides qs, Strides ks, int causal, int prescale,
                float scale, cudaStream_t stream) {
  const int seg = segment_tokens(Sq, Sk, D, 4, causal);
  const int bytes = Layout(D, seg).total;
  cudaError_t err = cudaFuncSetAttribute(
      flash_rows_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + kBQ - 1) / kBQ, B * H);
  flash_rows_kernel<D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), H, Sq, Sk, qs, ks, causal, prescale, scale, seg);
  return (int)cudaGetLastError();
}

int dispatch_fp32(const void* q, const void* k, const void* v, void* out, int B, int H,
                  int Sq, int Sk, int D, Strides qs, Strides ks, int causal,
                  int prescale, float scale, cudaStream_t s) {
  if (D == 64) return launch_fp32<64>(q, k, v, out, B, H, Sq, Sk, qs, ks, causal, prescale, scale, s);
  if (D == 128) return launch_fp32<128>(q, k, v, out, B, H, Sq, Sk, qs, ks, causal, prescale, scale, s);
  return (int)cudaErrorInvalidValue;
}

int dispatch_bf16(const void* q, const void* k, const void* v, void* out, int B, int H,
                  int Sq, int Sk, int D, Strides qs, Strides ks, int causal,
                  int prescale, float scale, cudaStream_t s) {
  const int slots = segment_tokens(Sq, Sk, D, 2, causal) / kBK;
  if (D == 64)
    return attn_sm90::launch<64, true>(q, k, v, out, B, H, Sq, Sk, qs, ks, causal, prescale,
                                       scale, slots, s);
  if (D == 128)
    return attn_sm90::launch<128, true>(q, k, v, out, B, H, Sq, Sk, qs, ks, causal, prescale,
                                        scale, slots, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Keys one CTA stages per segment for this problem (D in {64, 128},
// itemsize 4 or 2).  A CTA whose live span exceeds it stages in segments.
int flash_rows_segment_tokens(int Sq, int Sk, int D, int itemsize, int causal) {
  return segment_tokens(Sq, Sk, D, itemsize, causal);
}

// dtype: 0 = float32, 1 = bfloat16; D in {64, 128}.  q/out share strides
// (q_sb, q_sh, q_ss), k/v share (k_sb, k_sh, k_ss).  The `scale` is
// log2(e)/sqrt(D) rounded to fp32.  bf16 runs on the tensor cores, fp32 on
// the CUDA cores.  Returns 0, a CUDA error, or attn_sm90's tensor-map codes.
int flash_rows_fwd(const void* q, const void* k, const void* v, void* out, int B,
                   int H, int Sq, int Sk, int D, long long q_sb, long long q_sh,
                   long long q_ss, long long k_sb, long long k_sh, long long k_ss,
                   int causal, int prescale, float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss};
  if (dtype == 0)
    return dispatch_fp32(q, k, v, out, B, H, Sq, Sk, D, qs, ks, causal, prescale, scale, s);
  if (dtype == 1)
    return dispatch_bf16(q, k, v, out, B, H, Sq, Sk, D, qs, ks, causal, prescale, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
