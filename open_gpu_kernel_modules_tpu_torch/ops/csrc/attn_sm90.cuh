// Shared warpgroup core of the two bf16 flash-attention kernels for Hopper
// (sm_90a): flash_attn.cu (grid, B2) and flash_rows.cu (row-resident, B3).
// The paged decode kernel (paged_decode.cu, B1) shares its constants and
// primitives: the TMA loads, the mbarriers and their trapping wait, and the
// tensor-map encoding.
//
// The bound.  At Llama prefill shapes (S=2048, D=128) the work is
// 4*B*H*Sq*Sk*D FLOPs (half under causal) against a few bytes per FLOP, so
// the tensor-core rate bounds it: 989 TFLOP/s in bf16.  Only wgmma reaches
// that rate, so both products run on the tensor cores here.
//
// CTA layout: 288 threads, one CTA per SM.  Warps 0-7 are two consumer
// warpgroups, each owning 64 of the CTA's 128 q rows, so every K/V byte
// brought into shared memory serves 128 rows; warp 8 is the producer, whose
// lane 0 starts every TMA load.  The grid is (B*H, q blocks) and launches
// the heaviest causal q blocks of every head first.
//
//   Q tile   64 x D bf16 per warpgroup, loaded once by TMA, then read once
//            into registers as the A operand of QK^T; with `prescale` the
//            consumers multiply it by `scale` and round it to bf16 there (TMA
//            copies bytes unchanged).  Keeping A out of shared memory halves
//            the shared-memory traffic of QK^T.
//   S = QK^T wgmma m64n64k16, B = K (K-major) from shared memory.
//            The masked online base-2 softmax runs on the accumulator
//            fragment in registers; a row spans 4 threads (shfl_xor 1, 2).
//   O += PV  P is rounded to bf16 in registers and is the register A
//            operand of wgmma m64n{D}k16; V is the MN-major (transposed) B
//            operand.  Nothing passes through shared memory between them.
//   store    O / l rounded to bf16, straight from registers to global
//            memory; rows past Sq are skipped.
//
// Tiles sit in shared memory in TMA's 128-byte swizzle, as wgmma's B128
// layout wants.  A bf16 row of D=128 is 256 bytes and a swizzled box is at
// most 128 bytes wide, so each tile is loaded as D/64 boxes of 64 x 64, one
// 8 KB half after the other; the descriptors step 32 bytes per k16 slice
// inside a half (K-major) or 2 KB per 16 keys (MN-major, V).  TMA zero-fills
// rows past Sq and Sk, so keys past the span are zeros, never NaN bits.
//
// The tensor maps are 4-D (D, seq, head, batch) with the caller's strides,
// so both layouts ("bshd" and "bhsd") are read in place.  They are encoded
// per call with cuTensorMapEncodeTiled, reached through
// cudaGetDriverEntryPoint, so the library needs no -lcuda.
//
// The two kernels differ only in how K/V arrive (the producer's policy):
//
//   ring      (B2) `slots` stages of 64 keys; the producer refills a stage as
//             soon as the consumers release it.
//   segments  (B3) the live span of the row is resident: as many 64-key
//             blocks as fit in shared memory (`slots`) are loaded at once,
//             each on its own mbarrier, so the math on block j starts when
//             block j lands; a longer span is staged in segments, the next
//             one started after the consumers released the whole previous one.
//
// Numerics are those of the fp32 FMA bodies and of the JAX wrapper: masking
// to -1e30 only on diagonal and Sk-tail blocks, P rounded to bf16 before PV
// while the row sum l takes the unrounded fp32 p, a zero denominator
// becomes 1.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace attn_sm90 {

constexpr float kNegInf = -1e30f;
constexpr int kBlk = 64;                   // keys per block, q rows per warpgroup
constexpr int kWG = 2;                     // consumer warpgroups
constexpr int kBlkQ = kBlk * kWG;          // q rows per CTA
constexpr int kConsumers = 128 * kWG;
constexpr int kThreads = kConsumers + 32;  // plus one producer warp
constexpr int kMaxSlots = 16;
constexpr int kSmemLimit = 232448;         // opt-in shared memory per CTA
constexpr int kSlack = 1024 + 512;         // 1 KB alignment + barriers
static_assert(8 * (1 + 3 * kMaxSlots) <= 512, "mbarriers overflow the slack");

struct Strides {
  long long b, h, s;   // in elements; the head dim is contiguous
};

struct Params {
  __nv_bfloat16* out;
  Strides os;
  int H, Sq, Sk, causal, prescale, slots;
  float scale;
};

// Bytes of one 64-row tile (a warpgroup's Q, or one block's K or V) and of
// the whole shared memory: kWG Q tiles, then `slots` K/V blocks.
__host__ __device__ constexpr int tile_bytes(int d) { return kBlk * d * 2; }
__host__ __device__ constexpr int smem_bytes(int d, int slots) {
  return tile_bytes(d) * (kWG + 2 * slots) + kSlack;
}
// 64-key blocks that fit beside Q.
__host__ __device__ constexpr int max_slots(int d) {
  return (kSmemLimit - kSlack - kWG * tile_bytes(d)) / (2 * tile_bytes(d)) < kMaxSlots
             ? (kSmemLimit - kSlack - kWG * tile_bytes(d)) / (2 * tile_bytes(d))
             : kMaxSlots;
}

// ------------------------------------------------------------- primitives

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// A wait that has not completed after about 10 s of clock cycles is a fault
// (a load that never landed); trapping turns it into a launch error instead
// of a hung card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  const long long t0 = clock64();
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && clock64() - t0 > 20000000000LL) __trap();
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// One 64 x 64 box of a 4-D map at (col, row, head, batch) into shared memory.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int col, int row, int h, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(h), "r"(b), "r"(bar)
      : "memory");
}

// A whole 64-row tile: D/64 boxes, one 8 KB half after the other.
template <int D>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int row, int h, int b) {
#pragma unroll
  for (int half = 0; half < D / 64; ++half)
    tma_load(dst + half * tile_bytes(64), map, bar, half * 64, row, h, b);
}

// wgmma shared-memory descriptor, 128-byte swizzle (layout type 1).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)1 << 62);
}
// K-major tile (K): k16 slice kk sits in half kk/4, 32 bytes per slice;
// 8-row groups are 1 KB apart.
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t tile, int kk) {
  return desc_sw128(tile + (kk / 4) * tile_bytes(64) + (kk % 4) * 32, 16, 1024);
}
// MN-major V tile for keys [16kk, 16kk+16): 8-key groups 1 KB apart (SBO),
// the two 64-column halves 8 KB apart (LBO).
__device__ __forceinline__ uint64_t desc_v(uint32_t tile, int kk) {
  return desc_sw128(tile + kk * 2048, tile_bytes(64), 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed wgmma groups are still running.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// wgmma with A from registers; kTransB = 1 reads B MN-major (transposed).
template <int kTransB>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(kTransB));
}

template <int kTransB>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(kTransB));
}

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2], const uint32_t (&a)[4], uint64_t db);
template <>
__device__ __forceinline__ void wgmma_pv<64>(float (&o)[32], const uint32_t (&a)[4], uint64_t db) {
  wgmma_rs_n64<1>(o, a, db, 1);
}
template <>
__device__ __forceinline__ void wgmma_pv<128>(float (&o)[64], const uint32_t (&a)[4], uint64_t db) {
  wgmma_rs_n128<1>(o, a, db, 1);
}

// 2^x on the special-function unit, one instruction; subnormal results
// flush to 0 (P is rounded to bf16 anyway).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// -------------------------------------------------- the warpgroup's steps

// Start S = Q K^T for one 64-key block as one wgmma group (the caller
// waits): Q from registers, K (K-major) from shared memory.
template <int D>
__device__ __forceinline__ void start_qk(float (&sc)[32], const uint32_t (&qa)[D / 16][4],
                                         uint32_t k_tile) {
  fence_regs(sc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_rs_n64<0>(sc, qa[kk], desc_kmajor(k_tile, kk), kk > 0);
  wgmma_commit();
}

// Start O += P V for one 64-key block as one wgmma group: P from
// registers, V (MN-major) from shared memory.
template <int D>
__device__ __forceinline__ void start_pv(float (&o)[D / 2], const uint32_t (&pa)[4][4],
                                         uint32_t v_tile) {
  fence_regs(o);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_pv<D>(o, pa[kk], desc_v(v_tile, kk));
  wgmma_commit();
}

// The online base-2 softmax of one block, in place on the S fragment: this
// thread's entry j is row qi0 + 8*((j>>1)&1), key k_base + 8*(j>>2) + c0 +
// (j&1).  Scales, masks (only when `needs_mask`), updates the running max m
// and sum l (over the unrounded fp32 p), and leaves p in `sc` and the
// factor that rescales the previous output in `corr`.
__device__ __forceinline__ void online_softmax(float (&sc)[32], float (&m)[2], float (&l)[2],
                                               float (&corr)[2], float s_scale, bool needs_mask,
                                               int k_base, int qi0, int c0, int Sk, int causal) {
  float mx[2] = {kNegInf, kNegInf};
  if (s_scale != 1.f) {                           // no prescale: scale the scores
#pragma unroll
    for (int j = 0; j < 32; ++j) sc[j] *= s_scale;
  }
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int hi = (j >> 1) & 1;                  // rows qi0 (0) or qi0+8 (1)
    float x = sc[j];
    if (needs_mask) {
      const int kj = k_base + 8 * (j >> 2) + c0 + (j & 1);
      if (kj >= Sk || (causal && kj > qi0 + 8 * hi)) x = kNegInf;
    }
    sc[j] = x;
    mx[hi] = fmaxf(mx[hi], x);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {                   // a row spans 4 threads
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    corr[r] = ex2(m[r] - m_new);
    m[r] = m_new;
    l[r] *= corr[r];
  }
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    sc[j] = ex2(sc[j] - m[(j >> 1) & 1]);
    l[(j >> 1) & 1] += sc[j];
  }
}

// Rescale the output by `corr` and round P to bf16 as the A fragments of
// PV: k16 slice kk takes entries 8kk..8kk+7 of the S fragment, pairwise.
template <int D>
__device__ __forceinline__ void rescale_and_pack(float (&o)[D / 2], uint32_t (&pa)[4][4],
                                                 const float (&sc)[32], const float (&corr)[2]) {
  if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {  // a row max moved
#pragma unroll
    for (int j = 0; j < D / 2; ++j) o[j] *= corr[(j >> 1) & 1];
  }
#pragma unroll
  for (int j = 0; j < 32; j += 2) pa[j / 8][(j / 2) % 4] = pack_bf16(sc[j], sc[j + 1]);
}

// ------------------------------------------------------------------ kernel

// kSegments: false = ring (B2), true = resident segments (B3).
template <int D, bool kSegments>
__global__ void __launch_bounds__(kThreads, 1)
attn_fwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, const Params p) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;   // swizzle atoms are 1 KB
  uint8_t* gbase = smem_raw + (base - raw);
  constexpr int TB = tile_bytes(D);
  const int slots = p.slots;
  const uint32_t q_tile = base;                   // kWG tiles, one per warpgroup
  const uint32_t bars = base + TB * (kWG + 2 * slots);
  const uint32_t q_full = bars;
  auto k_tile = [&](int s) { return base + TB * (kWG + 2 * s); };
  auto v_tile = [&](int s) { return base + TB * (kWG + 1 + 2 * s); };
  auto k_full = [&](int s) { return bars + 8 * (1 + s); };
  auto v_full = [&](int s) { return bars + 8 * (1 + kMaxSlots + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + 2 * kMaxSlots + s); };

  const int n_qb = (p.Sq + kBlkQ - 1) / kBlkQ;
  const int qb = p.causal ? n_qb - 1 - blockIdx.y : blockIdx.y;   // heavy first
  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int q_first = qb * kBlkQ;
  // The live key span of q rows [q0, q0 + n), in 64-key blocks.
  auto live_blocks = [&](int q0, int n) {
    if (q0 >= p.Sq) return 0;
    const int live = p.causal ? min(p.Sk, min(q0 + n, p.Sq)) : p.Sk;
    return (live + kBlk - 1) / kBlk;
  };
  const int n_kb = live_blocks(q_first, kBlkQ);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < slots; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // ---------------------------------------------------------- producer
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(q_full, kWG * TB);
      for (int w = 0; w < kWG; ++w)
        tma_tile<D>(q_tile + w * TB, &tq, q_full, q_first + w * kBlk, h, b);
      for (int i = 0; i < n_kb; ++i) {
        const int s = i % slots, round = i / slots;
        if (kSegments) {
          // A new segment starts once every block of the last one is done.
          if (s == 0 && round > 0)
            for (int j = 0; j < slots; ++j) mbar_wait(empty(j), (round - 1) & 1);
        } else if (round > 0) {
          mbar_wait(empty(s), (round - 1) & 1);
        }
        mbar_expect_tx(k_full(s), TB);
        tma_tile<D>(k_tile(s), &tk, k_full(s), i * kBlk, h, b);
        mbar_expect_tx(v_full(s), TB);
        tma_tile<D>(v_tile(s), &tv, v_full(s), i * kBlk, h, b);
      }
    }
    return;
  }

  // ------------------------------------------------------------ consumers
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int q0 = q_first + wg * kBlk;            // this warpgroup's 64 q rows
  const int r0 = 16 * warp + lane / 4;           // this thread's rows r0, r0+8
  const int c0 = 2 * (lane % 4);                 // and columns c0, c0+1 of each n8
  const int my_kb = live_blocks(q0, kBlk);       // under causal, <= n_kb

  // Q as the register A operand of QK^T: k16 slice kk, fragment e holds row
  // r0 + 8*(e&1), columns 16kk + 8*(e>>1) + c0 + {0,1}, read out of the
  // 128-byte swizzle (16-byte chunk c of row r sits at chunk c ^ (r%8)).
  // The prescale is applied here, rounded to bf16 as the plain version does.
  uint32_t qa[D / 16][4];
  mbar_wait(q_full, 0);
  __syncwarp();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r0 + 8 * (e & 1), col = 16 * kk + 8 * (e >> 1) + c0;
      const int cc = col % 64;
      const uint8_t* src = gbase + wg * TB + (col / 64) * tile_bytes(64) + row * 128 +
                           (((cc / 8) ^ (row % 8)) * 16) + (cc % 8) * 2;
      uint32_t w = *reinterpret_cast<const uint32_t*>(src);
      if (p.prescale) {
        const float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&w));
        w = pack_bf16(f.x * p.scale, f.y * p.scale);
      }
      qa[kk][e] = w;
    }
  }
  const float s_scale = p.prescale ? 1.f : p.scale;

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, corr[2], sc[32];
  uint32_t pa[4][4];                              // P as 4 k16 A fragments
  auto needs_mask = [&](int i) {
    return i * kBlk + kBlk > p.Sk || (p.causal && i * kBlk + kBlk - 1 > q0);
  };

  // Each block: QK^T, softmax, PV, then release the slot.  (Issuing QK^T of
  // block i with PV of block i-1 and overlapping the softmax measured no
  // faster on the H100; see PERF.md.)
  for (int i = 0; i < my_kb; ++i) {
    const int s = i % slots;
    const uint32_t parity = (i / slots) & 1;
    mbar_wait(k_full(s), parity);
    __syncwarp();
    start_qk<D>(sc, qa, k_tile(s));
    wgmma_wait<0>();
    fence_regs(sc);
    online_softmax(sc, m, l, corr, s_scale, needs_mask(i), i * kBlk, q0 + r0, c0, p.Sk,
                   p.causal);
    rescale_and_pack<D>(o, pa, sc, corr);
    mbar_wait(v_full(s), parity);
    __syncwarp();
    start_pv<D>(o, pa, v_tile(s));
    wgmma_wait<0>();
    fence_regs(o);
    mbar_arrive(empty(s));
  }
  // Blocks past this warpgroup's rows (the other one's causal tail): nothing
  // to compute, but each slot is released only after it landed, so the
  // barrier phases stay paired.
  for (int i = my_kb; i < n_kb; ++i) {
    mbar_wait(k_full(i % slots), (i / slots) & 1);
    mbar_wait(v_full(i % slots), (i / slots) & 1);
    mbar_arrive(empty(i % slots));
  }

  // Epilogue: the row sums span the 4 threads of a row.
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.f / (l[r] == 0.f ? 1.f : l[r]);
  }
  __nv_bfloat16* obase = p.out + b * p.os.b + h * p.os.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + r0 + 8 * r;
    if (qi >= p.Sq) continue;
    __nv_bfloat16* orow = obase + qi * p.os.s;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + c0) =
          __floats2bfloat162_rn(o[4 * j + 2 * r] * inv[r], o[4 * j + 2 * r + 1] * inv[r]);
  }
}

// -------------------------------------------------------------------- host

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_fn() {
  static EncodeTiledFn fn = nullptr;
  if (!fn) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &q);
#endif
    if (q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiledFn>(ptr);
  }
  return fn;
}

// Error codes past CUDA's own: libcuda has no cuTensorMapEncodeTiled, or it
// refused a tensor map (code - kEncodeError is its CUresult).
constexpr int kNoEncode = 2000, kEncodeError = 3000;

// 4-D map (D, seq, head, batch) over bf16 with 64 x 64 boxes, 128-byte
// swizzle, zero fill out of bounds.  `rows` is at least 1: a map may not
// have an empty dimension, and no load is started when there are no rows.
inline int encode(CUtensorMap* map, const void* ptr, int d, int rows, int H, int B, Strides st) {
  EncodeTiledFn fn = encode_fn();
  if (!fn) return kNoEncode;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)(rows > 0 ? rows : 1), (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st.s * 2, (cuuint64_t)st.h * 2, (cuuint64_t)st.b * 2};
  const cuuint32_t box[4] = {64, kBlk, 1, 1};
  const cuuint32_t estride[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                        strides, box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeError + (int)r;
}

// Launch the bf16 kernel at D in {64, 128} with `slots` K/V blocks in
// shared memory.  Returns 0 or an error code.
template <int D, bool kSegments>
int launch(const void* q, const void* k, const void* v, void* out, int B, int H, int Sq, int Sk,
           Strides qs, Strides ks, int causal, int prescale, float scale, int slots,
           cudaStream_t stream) {
  if (slots < 1 || slots > max_slots(D)) return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  int err = encode(&tq, q, D, Sq, H, B, qs);
  if (!err) err = encode(&tk, k, D, Sk, H, B, ks);
  if (!err) err = encode(&tv, v, D, Sk, H, B, ks);
  if (err) return err;
  // The opt-in holds for the current device only: set it on every launch.
  const cudaError_t e = cudaFuncSetAttribute(
      attn_fwd_kernel<D, kSegments>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  if (e != cudaSuccess) return (int)e;
  const Params p{static_cast<__nv_bfloat16*>(out), qs, H, Sq, Sk, causal, prescale, slots, scale};
  dim3 grid(B * H, (Sq + kBlkQ - 1) / kBlkQ);
  attn_fwd_kernel<D, kSegments><<<grid, kThreads, smem_bytes(D, slots), stream>>>(tq, tk, tv, p);
  return (int)cudaGetLastError();
}

}  // namespace attn_sm90
