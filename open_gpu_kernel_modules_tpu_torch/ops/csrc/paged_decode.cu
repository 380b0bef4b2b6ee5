// Paged decode attention for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel `_paged_decode_kernel`
// (open_gpu_kernel_modules_tpu/ops/paged_attention.py:35, launched by
// `_paged_attention_kernel`): single-token GQA decode attention over a
// block-paged pool.
//
//   q       [B, H, D]       the query; the kernel scales it by `scale`
//                           (log2(e)/sqrt(D)) and rounds it to the input type
//   k, v    [N, P, KV, D]   the page pool
//   table   [B, M] int32    page ids per sequence
//   lens    [B] int32       live tokens per sequence
//   out     [B, H, D]
//
// The bound on the H100: device memory.  The least time is the live K/V
// bytes, 2 * sum(lens) * KV * D * itemsize, over 3.35 TB/s; the math is a few
// FLOPs per byte.  Reaching that rate takes many bytes in flight on every SM,
// and at decode shapes one CTA per (sequence, kv head) is too few CTAs (64
// for Llama-3-8B at batch 8, 8 for one long sequence) on 132 SMs.  So:
//
//   split   The grid is (splits, KV, B).  Each CTA takes a contiguous span of
//           `pps` table entries of one (sequence, kv head); the host picks
//           pps from B*KV and M so the grid reaches about two waves.  A CTA
//           whose span starts past the live tokens loads nothing.  Each CTA
//           writes fp32 (m, l, acc[rep, D]) to a workspace; the last CTA of a
//           (sequence, kv head) to finish, counted in `counters`, combines
//           them: m = max m_i, l = sum l_i 2^(m_i - m), acc = sum acc_i
//           2^(m_i - m), out = acc / (l or 1), and resets the counter.  An
//           empty partial keeps m = -1e30 (never -inf, so 2^(m_i - m) stays
//           finite for a row with lens = 0).  With one split the CTA writes
//           `out` itself.
//   ring    A producer warp streams the span into a ring of stages in shared
//           memory with TMA: a 4-D tensor map over the pool (D, KV, P, N),
//           one box of `box_rows` rows of a (page, kv head) per 128-byte
//           column block, the coordinate a page id the CTA reads from the
//           table itself and clamps to [0, N-1].  Each stage completes on an
//           mbarrier.  The ring holds the whole span when it fits (the main
//           shape's two pages are all in flight at once), else a few stages.
//           Tiles keep TMA's 128-byte swizzle, so ldmatrix and the FMA body's
//           16-byte reads are free of bank conflicts.
//   tile    bf16 runs the tensor cores: the rep = H/KV query heads of the kv
//           head are the rows of an mma.sync m16n8k16 tile (padded to 16),
//           Q the register A operand, K via ldmatrix.  Each of the four
//           consumer warps takes its own 16 tokens of a 64-token stage; its
//           S fragment becomes P's A fragment (rounded to bf16) for PV with V
//           via ldmatrix.trans.  The warps' (m, l, acc) merge in shared
//           memory.  fp32 (which TF32 cannot serve at (1e-4, 0)), and bf16
//           shapes the tile does not take, run a CUDA-core FMA body on the
//           same split, ring and combine.
//
// Numerics: scores fp32, base-2 online softmax, P rounded to V's type before
// PV while l sums the unrounded fp32 p, a zero denominator becomes 1 (a row
// with lens = 0 is exactly zero).  Lens are clamped to [0, M*P].

#include "attn_sm90.cuh"

namespace {

using attn_sm90::kMaxSlots;
using attn_sm90::kNegInf;
using attn_sm90::kSmemLimit;
using attn_sm90::mbar_arrive;
using attn_sm90::mbar_expect_tx;
using attn_sm90::mbar_init;
using attn_sm90::mbar_wait;
using attn_sm90::pack_bf16;
using attn_sm90::smem_u32;
using attn_sm90::tma_load;

constexpr int kWarps = 4;                      // consumer warps
constexpr int kConsumers = 32 * kWarps;
constexpr int kThreads = kConsumers + 32;      // plus one producer warp
constexpr int kTcTokens = 16 * kWarps;         // tokens per tensor-core stage
constexpr int kBarBytes = 16 * kMaxSlots + 16; // full and empty barriers, a flag
constexpr int kSlack = 1024;                   // the ring starts 1 KB aligned

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Barrier 1 joins the four consumer warps (the producer warp never waits).
__device__ __forceinline__ void sync_consumers() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Byte offset of byte column `bc` of row `t` in a tile of `tk` rows, as
// TMA's 128-byte swizzle lays it out: the 128-byte column blocks one after
// the other, 16-byte chunk c of row t at chunk c ^ (t % 8).
__device__ __forceinline__ int swz(int tk, int t, int bc) {
  return (bc >> 7) * tk * 128 + t * 128 + ((((bc >> 4) & 7) ^ (t & 7)) << 4) + (bc & 15);
}

struct Params {
  const void* q;
  const int* table;
  const int* lens;
  void* out;
  float* ws_acc;   // [B, KV, splits, rep, D]
  float* ws_m;     // [B, KV, splits, rep]
  float* ws_l;
  int* counters;   // [B, KV], zero between calls
  int H, KV, D, N, P, M;
  int pps, splits, tk, slots, box_rows;
  float scale;
};

// Shared memory (bytes), computed identically on host and device: the
// barriers, then (1 KB aligned) `slots` stages of [K tile | V tile], each
// tile `halves` column blocks of tk rows x 128 bytes, then the FMA body's
// scratch.  The tensor-core body merges its warps over the ring.
struct Layout {
  int halves, tile, stage, ring_bytes, total;
  __host__ __device__ Layout(int tc, int tk, int slots, int rep, int d, int itemsize) {
    halves = (d * itemsize + 127) / 128;
    tile = halves * tk * 128;
    stage = 2 * tile;
    const int merge = tc ? 4 * kWarps * 16 * (d + 2) : 0;
    ring_bytes = slots * stage > merge ? slots * stage : merge;
    // q [rep, D], acc [rep, D], s and p [rep, tk], m, l, corr [rep]; fp32.
    total = kBarBytes + kSlack + ring_bytes +
            (tc ? 0 : 4 * (2 * rep * d + 2 * rep * tk + 3 * rep));
  }
};

// The CTA's span: tokens [first, first + n_tok) of sequence b.
struct Span {
  int b, kvh, split, first, n_tok;
  __device__ Span(const Params& p) {
    split = blockIdx.x;
    kvh = blockIdx.y;
    b = blockIdx.z;
    int len = p.lens[b];
    len = len < 0 ? 0 : (len > p.M * p.P ? p.M * p.P : len);
    first = split * p.pps * p.P;
    n_tok = max(0, min(len, first + p.pps * p.P) - first);
  }
};

__device__ __forceinline__ uint32_t full_bar(uint32_t bars, int s) { return bars + 8 * s; }
__device__ __forceinline__ uint32_t empty_bar(uint32_t bars, int s) {
  return bars + 8 * (kMaxSlots + s);
}

// Barriers at the start of shared memory; returns the 1 KB aligned ring.
__device__ __forceinline__ uint32_t setup(uint32_t bars, int slots) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < slots; ++s) {
      mbar_init(full_bar(bars, s), 1);
      mbar_init(empty_bar(bars, s), kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return (bars + kBarBytes + kSlack - 1) & ~(uint32_t)(kSlack - 1);
}

// The producer warp: stage i of the span goes to slot i % slots once the
// consumers released the slot's previous stage.  The warp's lanes read 32
// table entries at a time; lane 0 arms the stage's barrier with its bytes
// and starts its TMA boxes.  A box of R = box_rows rows never crosses a
// page, since R divides both P and tk.
template <typename T>
__device__ void produce(const CUtensorMap* mk, const CUtensorMap* mv, const Params& p,
                        const Span& sp, uint32_t bars, uint32_t ring, const Layout& lay) {
  constexpr int kCols = 128 / sizeof(T);   // elements per column block
  const int lane = threadIdx.x & 31, R = p.box_rows;
  const int n_tiles = (sp.n_tok + p.tk - 1) / p.tk;
  const int* trow = p.table + (size_t)sp.b * p.M;
  int window = -32, page_of_lane = 0;   // table entries [window, window + 32)
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % p.slots, round = i / p.slots;
    if (round > 0) mbar_wait(empty_bar(bars, s), (round - 1) & 1);
    const int boxes = (min(p.tk, sp.n_tok - i * p.tk) + R - 1) / R;
    if (lane == 0) mbar_expect_tx(full_bar(bars, s), 2 * boxes * lay.halves * R * 128);
    const uint32_t kt = ring + s * lay.stage, vt = kt + lay.tile;
    for (int j = 0; j < boxes; ++j) {
      const int tok = sp.first + i * p.tk + j * R;
      const int entry = tok / p.P;
      if (entry >= window + 32) {
        window = entry;
        const int pg = entry + lane < p.M ? trow[entry + lane] : 0;
        page_of_lane = pg < 0 ? 0 : (pg >= p.N ? p.N - 1 : pg);
      }
      const int page = __shfl_sync(0xffffffffu, page_of_lane, entry - window);
      if (lane == 0) {
        for (int h = 0; h < lay.halves; ++h) {
          const uint32_t off = h * p.tk * 128 + j * R * 128;
          tma_load(kt + off, mk, full_bar(bars, s), h * kCols, sp.kvh, tok % p.P, page);
          tma_load(vt + off, mv, full_bar(bars, s), h * kCols, sp.kvh, tok % p.P, page);
        }
      }
    }
  }
}

// One element (row r, column d) of the CTA's result: `out` itself with one
// split, else the CTA's partial.
template <typename T>
__device__ __forceinline__ void store_result(const Params& p, const Span& sp, int r, int d,
                                             float m, float l, float a) {
  const int rep = p.H / p.KV;
  if (p.splits == 1) {
    T* out = static_cast<T*>(p.out) + ((size_t)sp.b * p.H + sp.kvh * rep + r) * p.D + d;
    *out = from_f<T>(a / (l == 0.f ? 1.f : l));
    return;
  }
  const size_t row = (((size_t)sp.b * p.KV + sp.kvh) * p.splits + sp.split) * rep + r;
  p.ws_acc[row * p.D + d] = a;
  if (d == 0) {
    p.ws_m[row] = m;
    p.ws_l[row] = l;
  }
}

// The last CTA of a (sequence, kv head) to finish merges the splits'
// partials into `out`: one warp per query head, its lanes over the splits
// for m and l and over the columns for acc.  Loads bypass L1, since other
// CTAs wrote the partials.
template <typename T>
__device__ void combine_if_last(const Params& p, const Span& sp, uint8_t* flag_smem) {
  if (p.splits == 1) return;
  __threadfence();   // this CTA's partial is visible before it counts
  sync_consumers();
  int* last = reinterpret_cast<int*>(flag_smem);
  int* counter = p.counters + (size_t)sp.b * p.KV + sp.kvh;
  if (threadIdx.x == 0) *last = atomicAdd(counter, 1) == p.splits - 1;
  sync_consumers();
  if (!*last) return;
  __threadfence();
  const int rep = p.H / p.KV, D = p.D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t row0 = ((size_t)sp.b * p.KV + sp.kvh) * p.splits * rep;
  T* out = static_cast<T*>(p.out) + ((size_t)sp.b * p.H + sp.kvh * rep) * D;
  constexpr int kCols = 8;   // columns lane + 32c, D <= 256
  for (int r = warp; r < rep; r += kWarps) {
    float m = kNegInf;
    for (int s = lane; s < p.splits; s += 32)
      m = fmaxf(m, __ldcg(p.ws_m + row0 + (size_t)s * rep + r));
    m = warp_max(m);
    float l = 0.f, a[kCols] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int s0 = 0; s0 < p.splits; s0 += 32) {
      float w = 0.f;   // this lane's split s0 + lane: its weight 2^(m_i - m)
      if (s0 + lane < p.splits) {
        const size_t row = row0 + (size_t)(s0 + lane) * rep + r;
        w = exp2f(__ldcg(p.ws_m + row) - m);
        l += __ldcg(p.ws_l + row) * w;
      }
      const int n = min(32, p.splits - s0);
#pragma unroll 4
      for (int j = 0; j < n; ++j) {
        const float wj = __shfl_sync(0xffffffffu, w, j);
        const float* src = p.ws_acc + (row0 + (size_t)(s0 + j) * rep + r) * D;
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          if (lane + 32 * c < D) a[c] += wj * __ldcg(src + lane + 32 * c);
      }
    }
    l = warp_sum(l);
    const float den = l == 0.f ? 1.f : l;
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      if (lane + 32 * c < D) out[r * D + lane + 32 * c] = from_f<T>(a[c] / den);
  }
  if (threadIdx.x == 0) *counter = 0;
}

// ------------------------------------------------ tensor-core body (bf16)

template <int D>
__global__ void __launch_bounds__(kThreads)
paged_decode_tc(const __grid_constant__ CUtensorMap mk, const __grid_constant__ CUtensorMap mv,
                const Params p) {
  extern __shared__ __align__(16) uint8_t smem[];
  const uint32_t bars = smem_u32(smem);
  const Span sp(p);
  const Layout lay(1, kTcTokens, p.slots, p.H / p.KV, D, 2);
  const uint32_t ring = setup(bars, p.slots);
  if (threadIdx.x >= kConsumers) {
    produce<__nv_bfloat16>(&mk, &mv, p, sp, bars, ring, lay);
    return;
  }
  constexpr int kBlock = kTcTokens * 128;   // bytes of one column block of a tile
  const int rep = p.H / p.KV;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c0 = 2 * (lane % 4);   // fragment row and column pair
  const int x = lane & 7;                        // the swizzle of the lane's ldmatrix row

  // Q as the A operand: k16 slice kk, register e holds row g + 8*(e&1),
  // columns 16kk + 8*(e>>1) + c0 + {0,1}; rows past rep are zero.  Scaled
  // and rounded to bf16 here.
  uint32_t qa[D / 16][4];
  const __nv_bfloat16* qrow =
      static_cast<const __nv_bfloat16*>(p.q) + ((size_t)sp.b * p.H + sp.kvh * rep) * D;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = g + 8 * (e & 1), col = 16 * kk + 8 * (e >> 1) + c0;
      uint32_t w = 0;
      if (row < rep) {
        const float2 f =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(qrow + row * D + col));
        w = pack_bf16(f.x * p.scale, f.y * p.scale);
      }
      qa[kk][e] = w;
    }
  }

  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  const int n_tiles = (sp.n_tok + kTcTokens - 1) / kTcTokens;
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % p.slots;
    const int nv = min(16, sp.n_tok - i * kTcTokens - 16 * warp);   // this warp's tokens
    mbar_wait(full_bar(bars, s), (i / p.slots) & 1);
    if (nv > 0) {
      const uint32_t kt = ring + s * lay.stage, vt = kt + lay.tile;
      if (nv < 16) {
        // Rows past the span hold stale bytes: zero them in V so that p = 0
        // never meets a NaN pattern (K's are masked out of S below).
        uint8_t* vz = smem + (vt - bars);
        for (int c = lane; c < (16 - nv) * lay.halves * 8; c += 32) {
          const int row = 16 * warp + nv + c / (lay.halves * 8), rest = c % (lay.halves * 8);
          *reinterpret_cast<uint4*>(vz + (rest / 8) * kBlock + row * 128 + (rest % 8) * 16) =
              make_uint4(0, 0, 0, 0);
        }
        __syncwarp();
      }
      // S = Q K^T for the warp's 16 tokens: two n8 tiles.  ldmatrix matrix
      // q = lane/8 reads tokens 8*(q/2).., columns 8*(q%2).. of the slice.
      float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      const uint32_t krow = kt + (16 * warp + (lane >> 4) * 8 + x) * 128;
      const int ksel = (lane >> 3) & 1;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t b[4];
        ldsm_x4(b, krow + (kk >> 2) * kBlock + (((2 * (kk & 3) + ksel) ^ x) << 4));
        mma16816(sc[0], qa[kk], b[0], b[1]);
        mma16816(sc[1], qa[kk], b[2], b[3]);
      }
      // Online base-2 softmax; a row spans the 4 lanes of a quad.
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float v = 8 * t + c0 + (e & 1) < nv ? sc[t][e] : kNegInf;
          sc[t][e] = v;
          mx[e >> 1] = fmaxf(mx[e >> 1], v);
        }
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        corr[r] = exp2f(m[r] - m_new);
        m[r] = m_new;
        l[r] *= corr[r];
      }
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[t][e] = exp2f(sc[t][e] - m[e >> 1]);
          l[e >> 1] += sc[t][e];
        }
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[j][0] *= corr[0];
        o[j][1] *= corr[0];
        o[j][2] *= corr[1];
        o[j][3] *= corr[1];
      }
      // P (bf16) as the A fragment of k16 = the warp's 16 tokens; V's
      // matrix q reads tokens 8*(q%2).., columns 8*(q/2).. (transposed).
      const uint32_t pa[4] = {pack_bf16(sc[0][0], sc[0][1]), pack_bf16(sc[0][2], sc[0][3]),
                              pack_bf16(sc[1][0], sc[1][1]), pack_bf16(sc[1][2], sc[1][3])};
      const uint32_t vrow = vt + (16 * warp + ((lane >> 3) & 1) * 8 + x) * 128;
      const int vsel = lane >> 4;
#pragma unroll
      for (int dd = 0; dd < D / 16; ++dd) {
        uint32_t b[4];
        ldsm_x4_t(b, vrow + (dd >> 2) * kBlock + (((2 * (dd & 3) + vsel) ^ x) << 4));
        mma16816(o[2 * dd], pa, b[0], b[1]);
        mma16816(o[2 * dd + 1], pa, b[2], b[3]);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty_bar(bars, s));
  }

  // Merge the four warps' (m, l, acc) in shared memory, over the ring.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  sync_consumers();   // every warp is done with the ring
  float* wo = reinterpret_cast<float*>(smem + (ring - bars));   // [kWarps][16][D]
  float* wm = wo + kWarps * 16 * D;                              // [kWarps][16]
  float* wl = wm + kWarps * 16;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = g + 8 * r;
    if (row >= rep) continue;
    if (c0 == 0) {
      wm[warp * 16 + row] = m[r];
      wl[warp * 16 + row] = l[r];
    }
    float* dst = wo + (warp * 16 + row) * D + c0;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(dst + 8 * j) = make_float2(o[j][2 * r], o[j][2 * r + 1]);
  }
  sync_consumers();
  for (int i = threadIdx.x; i < rep * D; i += kConsumers) {
    const int r = i / D, d = i % D;
    float mm = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, wm[w * 16 + r]);
    float ll = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = exp2f(wm[w * 16 + r] - mm);
      ll += wl[w * 16 + r] * f;
      a += wo[(w * 16 + r) * D + d] * f;
    }
    store_result<__nv_bfloat16>(p, sp, r, d, mm, ll, a);
  }
  combine_if_last<__nv_bfloat16>(p, sp, smem + 16 * kMaxSlots);
}

// ------------------------------------------------------- CUDA-core body

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_decode_fma(const __grid_constant__ CUtensorMap mk, const __grid_constant__ CUtensorMap mv,
                 const Params p) {
  extern __shared__ __align__(16) uint8_t smem[];
  const uint32_t bars = smem_u32(smem);
  const Span sp(p);
  const int rep = p.H / p.KV, D = p.D, TK = p.tk;
  const Layout lay(0, TK, p.slots, rep, D, sizeof(T));
  const uint32_t ring = setup(bars, p.slots);
  if (threadIdx.x >= kConsumers) {
    produce<T>(&mk, &mv, p, sp, bars, ring, lay);
    return;
  }
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  uint8_t* ring_ptr = smem + (ring - bars);
  float* qs = reinterpret_cast<float*>(ring_ptr + lay.ring_bytes);   // [rep, D]
  float* acc = qs + rep * D;                                           // [rep, D]
  float* ss = acc + rep * D;                                           // [rep, TK]
  float* ps = ss + rep * TK;                                           // [rep, TK]
  float* m_s = ps + rep * TK;
  float* l_s = m_s + rep;
  float* corr_s = l_s + rep;

  const T* qrow = static_cast<const T*>(p.q) + ((size_t)sp.b * p.H + sp.kvh * rep) * D;
  for (int i = tid; i < rep * D; i += kConsumers) {
    qs[i] = to_f(from_f<T>(to_f(qrow[i]) * p.scale));
    acc[i] = 0.f;
  }
  for (int r = tid; r < rep; r += kConsumers) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  sync_consumers();

  const int chunks_per_row = D * (int)sizeof(T) / 16;
  const int n_tiles = (sp.n_tok + TK - 1) / TK;
  for (int c = 0; c < n_tiles; ++c) {
    const int s = c % p.slots;
    mbar_wait(full_bar(bars, s), (c / p.slots) & 1);
    const uint8_t* kd = ring_ptr + s * lay.stage;
    const uint8_t* vd = kd + lay.tile;
    const int n = min(TK, sp.n_tok - c * TK);

    // Scores s[r, t] = q_r . k_t (q carries the softmax scale).
    for (int i = tid; i < rep * TK; i += kConsumers) {
      const int r = i / TK, t = i % TK;
      if (t >= n) continue;
      const float* qv = qs + r * D;
      float sum = 0.f;
      for (int ch = 0; ch < chunks_per_row; ++ch) {
        const uint4 raw = *reinterpret_cast<const uint4*>(kd + swz(TK, t, ch * 16));
        const T* kv8 = reinterpret_cast<const T*>(&raw);
        constexpr int per = 16 / sizeof(T);
#pragma unroll
        for (int e = 0; e < per; ++e) sum += qv[ch * per + e] * to_f(kv8[e]);
      }
      ss[i] = sum;
    }
    sync_consumers();

    // Online base-2 softmax, one warp per query head.
    for (int r = warp; r < rep; r += kWarps) {
      float mx = kNegInf;
      for (int t = lane; t < n; t += 32) mx = fmaxf(mx, ss[r * TK + t]);
      mx = warp_max(mx);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = lane; t < n; t += 32) {
        const float pv = exp2f(ss[r * TK + t] - m_new);
        sum += pv;
        ps[r * TK + t] = to_f(from_f<T>(pv));   // P in V's type for PV
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = exp2f(m_prev - m_new);
        l_s[r] = corr * l_s[r] + sum;
        m_s[r] = m_new;
        corr_s[r] = corr;
      }
    }
    sync_consumers();

    // acc[r, d] = acc * corr + sum_t p[r, t] * v[t, d].
    for (int i = tid; i < rep * D; i += kConsumers) {
      const int r = i / D, d = i % D;
      const float* pr = ps + r * TK;
      float a = 0.f;
      for (int t = 0; t < n; ++t)
        a += pr[t] * to_f(*reinterpret_cast<const T*>(vd + swz(TK, t, d * (int)sizeof(T))));
      acc[i] = acc[i] * corr_s[r] + a;
    }
    sync_consumers();   // the stage is read: release it
    if (lane == 0) mbar_arrive(empty_bar(bars, s));
  }
  for (int i = tid; i < rep * D; i += kConsumers)
    store_result<T>(p, sp, i / D, i % D, m_s[i / D], l_s[i / D], acc[i]);
  combine_if_last<T>(p, sp, smem + 16 * kMaxSlots);
}

// ----------------------------------------------------------------- host

// 4-D map (D, KV, P, N) over a pool of `itemsize`-byte elements: boxes of
// one 128-byte column block x 1 kv head x `rows` rows x 1 page, 128-byte
// swizzle, zero fill past D.
int encode_pool(CUtensorMap* map, const void* pool, int itemsize, int D, int KV, int P, int N,
                int rows) {
  const attn_sm90::EncodeTiledFn fn = attn_sm90::encode_fn();
  if (!fn) return attn_sm90::kNoEncode;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)KV, (cuuint64_t)P, (cuuint64_t)N};
  const cuuint64_t row = (cuuint64_t)D * itemsize;
  const cuuint64_t strides[3] = {row, row * KV, row * KV * P};
  const cuuint32_t box[4] = {(cuuint32_t)(128 / itemsize), 1, (cuuint32_t)rows, 1};
  const cuuint32_t estride[4] = {1, 1, 1, 1};
  const CUresult r = fn(map,
                        itemsize == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                      : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                        4, const_cast<void*>(pool), dims, strides, box, estride,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : attn_sm90::kEncodeError + (int)r;
}

// The opt-in to the full shared memory holds for the current device only,
// so it is set on every launch (well under a microsecond).
template <typename Kernel>
int launch(Kernel kernel, const CUtensorMap& mk, const CUtensorMap& mv, const Params& p,
           dim3 grid, int smem, cudaStream_t stream) {
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, kThreads, smem, stream>>>(mk, mv, p);
  return (int)cudaGetLastError();
}

template <typename T>
int run(const void* k, const void* v, const Params& p, int B, int tc, cudaStream_t stream) {
  const int rep = p.H / p.KV;
  const Layout lay(tc, p.tk, p.slots, rep, p.D, sizeof(T));
  if (p.slots < 1 || p.slots > kMaxSlots || lay.total > kSmemLimit || p.box_rows < 1 ||
      p.tk % p.box_rows || p.P % p.box_rows)
    return (int)cudaErrorInvalidValue;
  CUtensorMap mk, mv;
  int err = encode_pool(&mk, k, sizeof(T), p.D, p.KV, p.P, p.N, p.box_rows);
  if (!err) err = encode_pool(&mv, v, sizeof(T), p.D, p.KV, p.P, p.N, p.box_rows);
  if (err) return err;
  const dim3 grid(p.splits, p.KV, B);
  if (!tc) return launch(paged_decode_fma<T>, mk, mv, p, grid, lay.total, stream);
  if (sizeof(T) != 2 || p.tk != kTcTokens || rep > 16) return (int)cudaErrorInvalidValue;
  switch (p.D) {
    case 16: return launch(paged_decode_tc<16>, mk, mv, p, grid, lay.total, stream);
    case 32: return launch(paged_decode_tc<32>, mk, mv, p, grid, lay.total, stream);
    case 64: return launch(paged_decode_tc<64>, mk, mv, p, grid, lay.total, stream);
    case 128: return launch(paged_decode_tc<128>, mk, mv, p, grid, lay.total, stream);
    case 256: return launch(paged_decode_tc<256>, mk, mv, p, grid, lay.total, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one CTA needs (the wrapper checks it).
int paged_decode_smem_bytes(int tc, int tk, int slots, int rep, int d, int itemsize) {
  return Layout(tc, tk, slots, rep, d, itemsize).total;
}

// dtype: 0 = float32, 1 = bfloat16; tc: 1 = tensor-core body (bf16, D in
// {16, 32, 64, 128, 256}, rep <= 16, tk = 64), 0 = FMA body.  box_rows
// divides both P and tk.  With splits > 1, `ws` holds B*KV*splits*rep*(D+2)
// floats and `counters` B*KV ints, zero (the kernel leaves them zero).
// Returns 0, a CUDA error, or attn_sm90's tensor-map codes (2000: no
// cuTensorMapEncodeTiled; 3000 + r: it refused the map with r).
int paged_decode(const void* q, const void* k, const void* v, const void* table,
                 const void* lens, void* out, void* ws, void* counters, int B, int H, int KV,
                 int D, int N, int P, int M, int pps, int splits, int tk, int slots,
                 int box_rows, float scale, int dtype, int tc, void* stream) {
  const size_t rows = (size_t)B * KV * splits * (H / KV);
  float* w = static_cast<float*>(ws);
  const Params p{q, static_cast<const int*>(table), static_cast<const int*>(lens), out,
                 w, w + rows * D, w + rows * (D + 1), static_cast<int*>(counters),
                 H, KV, D, N, P, M, pps, splits, tk, slots, box_rows, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && !tc) return run<float>(k, v, p, B, 0, s);
  if (dtype == 1) return run<__nv_bfloat16>(k, v, p, B, tc, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
