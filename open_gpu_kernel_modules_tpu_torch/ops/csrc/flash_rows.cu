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
// Design.  One CTA per (b*h, 64-row q block).  The CTA stages the LIVE part
// of its K/V row (min(Sk, q_last + 1) keys under causal, else Sk) in dynamic
// shared memory with 16-byte cp.async, in the input type, rows padded by 16
// bytes so that eight threads reading eight rows at one column hit eight
// different bank groups.  A row that fits the opt-in shared memory (232,448
// bytes) is staged in one wave: about 320 keys at D=128 in bf16, next to the
// Q and P tiles.  A longer row is staged in segments, each as large as the
// shared memory holds (a multiple of 64 keys), one after the other.  Inside a
// segment an in-CTA loop walks 64-key blocks with the online base-2 softmax
// of the TPU kernel; only blocks that cross the causal diagonal or the Sk tail
// are masked (to -1e30, as on the TPU).  Each of the 256 threads owns a 4x4
// patch of the 64x64 score tile and a 4 x D/16 patch of the output, in fp32
// registers with plain FMAs.  Numerics follow the grid kernel and the JAX
// wrapper: with `prescale` Q is multiplied by `scale` and rounded to the input
// type as it is staged, otherwise the scores are scaled; P is rounded to V's
// type before PV; a zero denominator becomes 1.
//
// Bound on the H100: at Llama prefill shapes (S=2048, D=128) the work is
// 4*B*H*Sq*Sk*D FLOPs (about half under causal) against a few bytes per FLOP,
// so the tensor-core rate bounds it: 989 TFLOP/s in bf16.  Like the grid
// kernel this one runs CUDA-core FMAs (67 TFLOP/s fp32 peak) and stays well
// short of that bound.  What residency buys on the card is that each K/V byte
// of a segment is read from device memory once per q block and then reused
// by every key block from shared memory; staging is not overlapped with the
// math.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBQ = 64, kBK = 64, kThreads = 256;
constexpr int kPadBytes = 16;
constexpr int kSmemLimit = 232448;   // opt-in shared memory per CTA on Hopper

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
}

struct Strides {
  long long b, h, s;   // in elements; the head dim is contiguous
};

// Shared memory layout in bytes, the same on host and device:
//   Q  [64][row]          input type, pre-scaled when `prescale`
//   P  [64][65] fp32      the block's probabilities, rounded to V's type
//   K  [seg][row], V [seg][row]
struct Layout {
  int row, q_off, p_off, k_off, v_off, total;
  __host__ __device__ Layout(int d, int itemsize, int seg) {
    row = d * itemsize + kPadBytes;
    q_off = 0;
    p_off = q_off + kBQ * row;
    k_off = p_off + kBQ * (kBK + 1) * 4;
    v_off = k_off + seg * row;
    total = v_off + seg * row;
  }
};

// Keys one segment may hold: as many 64-key blocks as fit beside Q and P.
__host__ __device__ inline int segment_capacity(int d, int itemsize) {
  const Layout base(d, itemsize, 0);
  return (kSmemLimit - base.total) / (2 * base.row) / kBK * kBK;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_rows_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ out, int H, int Sq,
                  int Sk, Strides qs, Strides ks, int causal, int prescale,
                  float scale, int seg_cap) {
  constexpr int PER = 16 / sizeof(T);          // elements per 16-byte chunk
  constexpr int CH = D / PER;                  // 16-byte chunks per row
  constexpr int NE = D / 16;                   // output columns per thread
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lay(D, sizeof(T), seg_cap);
  unsigned char* Qs = smem + lay.q_off;
  float* Ps = reinterpret_cast<float*>(smem + lay.p_off);
  unsigned char* Ks = smem + lay.k_off;
  unsigned char* Vs = smem + lay.v_off;

  const int n_qb = (Sq + kBQ - 1) / kBQ;
  const int qb = causal ? n_qb - 1 - blockIdx.x : blockIdx.x;   // heavy first
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q_first = qb * kBQ;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  const T* qbase = q + b * qs.b + h * qs.h;
  const T* kbase = k + b * ks.b + h * ks.h;
  const T* vbase = v + b * ks.b + h * ks.h;

  // Q tile, rounded to T after the optional pre-scale; rows past Sq are 0.
  for (int i = threadIdx.x; i < kBQ * CH; i += kThreads) {
    const int r = i / CH, c = i % CH;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (q_first + r < Sq) {
      raw = *reinterpret_cast<const uint4*>(qbase + (q_first + r) * qs.s + c * PER);
      if (prescale) {
        T* x = reinterpret_cast<T*>(&raw);
#pragma unroll
        for (int e = 0; e < PER; ++e) x[e] = from_f<T>(to_f(x[e]) * scale);
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
          const T* x = reinterpret_cast<const T*>(&raw);
#pragma unroll
          for (int e = 0; e < PER; ++e) qv[a][e] = to_f(x[e]);
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const uint4 raw = *reinterpret_cast<const uint4*>(
              Kb + (tx + 16 * c) * lay.row + ch * 16);
          const T* x = reinterpret_cast<const T*>(&raw);
#pragma unroll
          for (int e = 0; e < PER; ++e) kv[c][e] = to_f(x[e]);
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
        const T* vrow = reinterpret_cast<const T*>(Vb + j * lay.row);
#pragma unroll
        for (int e = 0; e < NE; ++e) vv[e] = to_f(vrow[tx + 16 * e]);
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int e = 0; e < NE; ++e) acc[a][e] = fmaf(pv[a], vv[e], acc[a][e]);
      }
      __syncthreads();                                   // P is rewritten next
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

// Keys the largest CTA stages at once: its live span rounded up to whole
// blocks, capped at the segment capacity.  Short rows take less shared
// memory, so more CTAs fit on an SM.
int segment_tokens(int Sq, int Sk, int D, int itemsize, int causal) {
  const int n_qb = (Sq + kBQ - 1) / kBQ;
  const int max_live = causal ? min(Sk, n_qb * kBQ) : Sk;
  const int need = (max_live + kBK - 1) / kBK * kBK;
  const int cap = segment_capacity(D, itemsize);
  return need < cap ? (need > 0 ? need : kBK) : cap;
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int B, int H,
           int Sq, int Sk, Strides qs, Strides ks, int causal, int prescale,
           float scale, cudaStream_t stream) {
  const int seg = segment_tokens(Sq, Sk, D, sizeof(T), causal);
  const int bytes = Layout(D, sizeof(T), seg).total;
  cudaError_t err = cudaFuncSetAttribute(
      flash_rows_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + kBQ - 1) / kBQ, B * H);
  flash_rows_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), H, Sq, Sk, qs, ks, causal, prescale, scale, seg);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, void* out, int B, int H,
               int Sq, int Sk, int D, Strides qs, Strides ks, int causal,
               int prescale, float scale, cudaStream_t s) {
  if (D == 64) return launch<T, 64>(q, k, v, out, B, H, Sq, Sk, qs, ks, causal, prescale, scale, s);
  if (D == 128) return launch<T, 128>(q, k, v, out, B, H, Sq, Sk, qs, ks, causal, prescale, scale, s);
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
// log2(e)/sqrt(D) rounded to fp32.  Returns cudaGetLastError() (0 = ok).
int flash_rows_fwd(const void* q, const void* k, const void* v, void* out, int B,
                   int H, int Sq, int Sk, int D, long long q_sb, long long q_sh,
                   long long q_ss, long long k_sb, long long k_sh, long long k_ss,
                   int causal, int prescale, float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss};
  if (dtype == 0)
    return dispatch_d<float>(q, k, v, out, B, H, Sq, Sk, D, qs, ks, causal, prescale, scale, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(q, k, v, out, B, H, Sq, Sk, D, qs, ks, causal, prescale, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
