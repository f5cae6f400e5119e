// Flash-attention forward on Hopper's tensor cores (sm_90a): bf16 inputs,
// warpgroup MMA (wgmma) from shared memory that TMA fills through an
// mbarrier ring, hand-written CUDA C++.
//
// Replaces: learningorchestra_tpu/ops/attention.py `_fwd_kernel` (the
// Pallas TPU kernel launched by `_fwd_pallas`) for bf16 q/k/v whose
// head_dim is a multiple of 8 up to 128; flash_fwd_tf32x3.cu takes every
// other float32 or bf16 input. Same function: the softmax attention
// output O (bf16) and the per-row log-sum-exp (f32), with causal masking
// (row >= col + offset), a sliding window (col + offset > row - window),
// a ragged key edge (col < sk) and grouped-query heads (query head i
// reads kv head i / (h / kvh)). A row that sees no key gets o = 0 and
// lse = -1e30.
//
// Bound on an H100 SXM at the training shape (b 8, sq = sk = 2048, h 8,
// kvh 4, d 64, causal, window 1024): 1,573,376 visible pairs per head
// over b * h = 64, so 4 * d * pairs = 25.8 GFLOP per call against about
// 25 MB of bf16 inputs and outputs: bound by operations, 0.026 ms at the
// 989 TFLOP/s bf16 tensor-core rate (the bytes take 0.008 ms at 3.35
// TB/s).
//
// Design (the wide instance, head_dim 40-128; head_dim <= 32 takes the
// narrow instance below). One block per (batch * head, 128-row q tile):
// a producer warpgroup (one thread issues every load; setmaxnreg hands
// most of its registers to the consumers) and two consumer warpgroups of
// 64 q rows each. The producer loads the Q tile once and walks the
// tile's visible kv band [lo, hi) (causal bounds the top, the window the
// bottom), one TMA load of a 128-key K tile and one of V per stage into
// a two-stage ring of full/empty mbarriers; TMA zero-fills rows past sk
// and columns past d, so ragged edges need no load code. Each consumer
// warpgroup computes S = Q.K^T with wgmma (both operands K-major in
// shared memory), runs the online softmax on the
// accumulator registers (row max and sum over the four threads of a
// quad, exp2 with scale * log2(e) folded in, the mask applied only to
// tiles that cross the diagonal, the window edge, sk or sq), and adds
// P.V with P as wgmma's register A operand and V read MN-major (the
// transpose flag) from the same swizzled tile. O is acc / l in bf16, lse
// m + log(l) in f32.
//
// Precision. The Pallas kernel multiplies p by v in float32. Here P goes
// to the tensor cores split as bf16 hi + bf16 lo (two products), which
// carries p to about 2^-16 of itself, where bf16(p) alone departs from
// the float32 product by up to 2^-8 * sum_j p_j |v_j| / l per element of
// o; the split costs half again the tensor work (6 d FLOP per pair, not
// 4) and keeps o within one bf16 ulp plus float32 summation order of the
// plain version, the tolerance a float32 kernel meets once its o is
// rounded to bf16.

#include "sm90_common.cuh"

namespace {

using namespace sm90;

constexpr int kBlockM = 128;   // q rows per block: 2 warpgroups x 64
constexpr int kBlockN = 128;   // keys per stage
constexpr int kStages = 2;
constexpr int kConsumers = 256;
// + a producer warpgroup, so that setmaxnreg can move its registers to
// the consumers: 128 x 40 + 256 x 232 = the 384 x 168 the block starts
// with
constexpr int kThreads = kConsumers + 128;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kNegInf = -1e30f;

// shared memory, in bytes from a 1024-aligned base; NB boxes of 64
// head-dim columns (1 for d <= 64, 2 for d <= 128)
template <int NB>
struct Smem {
  static constexpr int kQBytes = NB * kBlockM * kRowBytes;
  static constexpr int kKVBytes = NB * kBlockN * kRowBytes;  // K or V
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kQBytes;             // + stage * kKVBytes
  static constexpr int kV = kK + kStages * kKVBytes;  // + stage * kKVBytes
  static constexpr int kBar = kV + kStages * kKVBytes;
  // barriers: q, full[kStages], empty[kStages]
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kStages);
};

template <int NB>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          __nv_bfloat16* __restrict__ o,
                          float* __restrict__ lse, int sq, int sk, int h,
                          int kvh, int d, float scale, int causal, int window,
                          int offset) {
  using L = Smem<NB>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_bar = base + L::kBar;
  const uint32_t full0 = q_bar + 8;
  const uint32_t empty0 = full0 + 8 * kStages;

  const int tid = threadIdx.x;
  const int bi = blockIdx.y / h;
  const int hi = blockIdx.y % h;
  const int kvi = hi / (h / kvh);
  const int row0 = blockIdx.x * kBlockM;
  const int row_last = min(row0 + kBlockM, sq) - 1;

  // keys the tile's rows can see: causal bounds the top, the window the
  // bottom; tiles outside [lo, hi_col) are never loaded
  int lo = 0, hi_col = sk;
  if (causal) hi_col = min(sk, row_last - offset + 1);
  if (window > 0) lo = max(0, row0 - window - offset + 1);
  const int start = (lo / kBlockN) * kBlockN;
  const int n_tiles =
      hi_col > start ? (hi_col - start + kBlockN - 1) / kBlockN : 0;

  if (tid == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // producer warpgroup: one thread issues every load
    reg_dealloc<40>();
    if (tid == kConsumers) {
      mbar_expect_tx(q_bar, L::kQBytes);
      for (int bx = 0; bx < NB; ++bx)
        tma_load_4d(base + L::kQ + bx * kBlockM * kRowBytes, &tq, q_bar,
                    bx * kBoxCols, hi, row0, bi);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        mbar_wait(empty0 + 8 * s, ((t / kStages) & 1) ^ 1);
        const uint32_t full = full0 + 8 * s;
        mbar_expect_tx(full, 2 * L::kKVBytes);
        const int kv0 = start + t * kBlockN;
        for (int bx = 0; bx < NB; ++bx) {
          const int off = s * L::kKVBytes + bx * kBlockN * kRowBytes;
          tma_load_4d(base + L::kK + off, &tk, full, bx * kBoxCols, kvi, kv0,
                      bi);
          tma_load_4d(base + L::kV + off, &tv, full, bx * kBoxCols, kvi, kv0,
                      bi);
        }
      }
    }
    return;
  }
  reg_alloc<232>();

  // consumer warpgroup wg owns q rows row0 + 64 wg .. + 63; this thread
  // rows r0 and r0 + 8, columns 8 j + cq + {0, 1} of each 64-wide chunk
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int wg_row0 = row0 + 64 * wg;
  const int r0 = wg_row0 + 16 * warp + lane / 4;
  const int cq = 2 * (lane % 4);
  const float scale_log2 = scale * kLog2e;

  float acc[NB][32];
#pragma unroll
  for (int bx = 0; bx < NB; ++bx)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[bx][i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running row max, raw scores
  float l[2] = {0.f, 0.f};              // this thread's part of the sum

  const uint32_t q_tile = base + L::kQ + wg * 64 * kRowBytes;
  mbar_wait(q_bar, 0);

  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages;
    mbar_wait(full0 + 8 * s, (t / kStages) & 1);
    const int kv0 = start + t * kBlockN;
    const uint32_t k_tile = base + L::kK + s * L::kKVBytes;
    const uint32_t v_tile = base + L::kV + s * L::kKVBytes;

    // S = Q . K^T: 64 rows x 128 keys as two 64-key halves (the first
    // k-step overwrites the zeros, which only keep sc defined)
    float sc[2][32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[0][i] = sc[1][i] = 0.f;
    fence_acc(sc[0]);
    fence_acc(sc[1]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * NB; ++kk) {
      const uint64_t a = desc_sw128(q_tile + (kk / 4) * kBlockM * kRowBytes +
                                    (kk % 4) * 32);
#pragma unroll
      for (int nh = 0; nh < 2; ++nh)
        wgmma_ss<0>(sc[nh], a,
                    desc_sw128(k_tile + (kk / 4) * kBlockN * kRowBytes +
                               nh * 64 * kRowBytes + (kk % 4) * 32),
                    kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(sc[0]);
    fence_acc(sc[1]);

    // the mask, only where the tile crosses an edge of what the
    // warpgroup's rows can see
    bool edge = kv0 + kBlockN > sk || wg_row0 + 63 >= sq;
    if (causal) edge = edge || wg_row0 < kv0 + kBlockN - 1 + offset;
    if (window > 0) edge = edge || kv0 + offset <= wg_row0 + 63 - window;
    if (edge) {
#pragma unroll
      for (int nh = 0; nh < 2; ++nh)
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int col = kv0 + nh * 64 + 8 * (i / 4) + cq + (i % 2);
          const int row = r0 + 8 * ((i / 2) % 2);
          bool ok = col < sk;
          if (causal) ok = ok && row >= col + offset;
          if (window > 0) ok = ok && col + offset > row - window;
          if (!ok) sc[nh][i] = -INFINITY;
        }
    }

    // online softmax on the accumulators; a row with nothing visible so
    // far keeps m = -inf and p = 0
    float alpha[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float mx = m[rr];
#pragma unroll
      for (int nh = 0; nh < 2; ++nh)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          mx = fmaxf(mx, fmaxf(sc[nh][4 * j + 2 * rr],
                               sc[nh][4 * j + 2 * rr + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_log2 = mx == -INFINITY ? 0.f : mx * scale_log2;
      alpha[rr] = exp2f(m[rr] * scale_log2 - m_log2);
      m[rr] = mx;
      float sum = 0.f;
#pragma unroll
      for (int nh = 0; nh < 2; ++nh)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = sc[nh][4 * j + 2 * rr + e];
            x = exp2f(fmaf(x, scale_log2, -m_log2));
            sum += x;
          }
      l[rr] = l[rr] * alpha[rr] + sum;
    }

    // O = O * alpha + P . V, P as bf16 hi + lo register fragments
    uint32_t p_hi[8][4], p_lo[8][4];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      split_fragment(sc[kk / 4], kk % 4, p_hi[kk], p_lo[kk]);
#pragma unroll
    for (int bx = 0; bx < NB; ++bx)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[bx][i] *= alpha[(i / 2) % 2];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      fence_frag(p_hi[kk]);
      fence_frag(p_lo[kk]);
    }
#pragma unroll
    for (int bx = 0; bx < NB; ++bx) fence_acc(acc[bx]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
#pragma unroll
      for (int bx = 0; bx < NB; ++bx) {
        const uint64_t b = desc_sw128(v_tile + bx * kBlockN * kRowBytes +
                                      kk * 16 * kRowBytes);
        wgmma_rs<1>(acc[bx], p_hi[kk], b);
        wgmma_rs<1>(acc[bx], p_lo[kk], b);
      }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int bx = 0; bx < NB; ++bx) fence_acc(acc[bx]);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      fence_frag(p_hi[kk]);
      fence_frag(p_lo[kk]);
    }
    mbar_arrive(empty0 + 8 * s);
  }

  // epilogue: o = acc / l in bf16, lse = m * scale + log(l)
  const int64_t row_stride = (int64_t)h * d;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float sum = l[rr];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const int row = r0 + 8 * rr;
    if (row >= sq) continue;
    const float inv = sum > 0.f ? 1.f / sum : 0.f;
    __nv_bfloat16* orow =
        o + ((int64_t)bi * sq + row) * row_stride + (int64_t)hi * d;
#pragma unroll
    for (int bx = 0; bx < NB; ++bx)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = bx * kBoxCols + 8 * j + cq;
        const int i = 4 * j + 2 * rr;
        if (col < d)
          *reinterpret_cast<__nv_bfloat162*>(orow + col) =
              __floats2bfloat162_rn(acc[bx][i] * inv, acc[bx][i + 1] * inv);
      }
    if (lane % 4 == 0)
      lse[((int64_t)bi * sq + row) * h + hi] =
          sum > 0.f ? m[rr] * scale + logf(sum) : kNegInf;
  }
}

// ---- the narrow instance: head_dim <= 32 --------------------------------
//
// At d <= 32 the 64-column boxes above are half zeros: S = Q.K^T takes 4
// k-steps where 2 do, and O accumulates in m64n64 with 32 columns real,
// so a visible pair costs 2 * 64 + 2 * 2 * 64 = 384 tensor FLOP where 192
// do. Here the tiles are boxes of 32 columns (64-byte rows, 64-byte
// swizzle, as the backward's narrow instances take them): S reduces over
// 2 k-steps and P.V accumulates in m64n32k16 (16 f32 registers), P still
// split bf16 hi + lo.
//
// Bound at the classifier's shape (b 128, 512 tokens, 8 heads over 4, d
// 32, non-causal; 268,435,456 visible pairs): 4 d FLOP a pair is 0.035
// ms at 989 TFLOP/s (0.052 with the split's second product), and one
// exp2 a pair on the special-function units (16 a clock on each of 132
// SMs) 0.064 ms at 1.98 GHz. Beside each exp2 a pair takes about six
// more instructions (the scale's FMA, the max, the sum, the split's
// packed conversions and subtractions), so issue sets a floor near
// 0.08 ms, and latency the pace: a warpgroup waits for its products,
// then runs its softmax, and only other warpgroups fill the SM
// meanwhile. So the block has four consumer warpgroups of 64 q rows (a
// 256-row item; their register budget, 112 a thread, holds S, P's
// fragments and O for 64-key tiles), each step issues the last tile's
// P.V with this tile's S (one wait a tile), the per-pair work is short
// (ex2.approx.ftz with scale * log2(e) folded into one FMA, maxima and
// sums over independent chains, the split as packed conversions,
// split_pair), and an item's prologue waits on little: work items are
// (batch * head, kFBlockM-row q tile), row tiles fastest, the grid is one
// block per SM walking items gridDim.x apart, and Q is double-buffered,
// so the producer loads the next item's Q and first K/V tiles while the
// consumers finish this one. The sweep (scripts/sm90_fwd_narrow_sweep.py)
// measures ring depth, consumer warpgroups and keys per tile.
//
// Every wgmma in flight is past a point where ptxas can see straight-line
// code to its wait: the ring's spins, the edge-mask branch, the item's
// writes and the loop back-edges all run with no product in flight, and
// no register a pending product reads or writes is written before its
// wait (ptxas serializes every wgmma of the kernel otherwise).

constexpr int kFStages = 4;      // K/V ring depth
constexpr int kFWarpgroups = 4;  // consumer warpgroups, 64 q rows each
constexpr int kFBlockN = 64;     // keys per tile: 64 or 128
constexpr int kFConsumers = 128 * kFWarpgroups;
constexpr int kFThreads = kFConsumers + 128;
constexpr int kFBlockM = 64 * kFWarpgroups;
constexpr int kFHalves = kFBlockN / 64;  // S as m64n64 accumulators
constexpr int kFSteps = kFBlockN / 16;   // P.V k-steps a tile
// the block's registers: what its launch takes (the SM's 65,536 over
// its threads, in steps of 8 a thread), 24 a producer thread and the
// rest over the consumers, in steps of 8: 240 a consumer thread with two
// consumer warpgroups, 160 with three, 112 with four
constexpr int kFLaunchRegs = 65536 / kFThreads / 8 * 8;
constexpr int kFProducerRegs = 24;
constexpr int kFConsumerRegs =
    (kFLaunchRegs * kFThreads - kFProducerRegs * 128) / kFConsumers / 8 * 8;
static_assert(kFConsumerRegs >= 96 && kFConsumerRegs <= 256,
              "register budget");
static_assert(kFBlockN == 64 || kFBlockN == 128, "keys per tile");

struct NarrowSmem {
  static constexpr int kQBytes = kFBlockM * kNarrowRowBytes;
  static constexpr int kKVBytes = kFBlockN * kNarrowRowBytes;  // K or V
  static constexpr int kQ = 0;                           // + buf * kQBytes
  static constexpr int kK = 2 * kQBytes;                 // + stage * kKVBytes
  static constexpr int kV = kK + kFStages * kKVBytes;    // + stage * kKVBytes
  static constexpr int kBar = kV + kFStages * kKVBytes;
  // barriers: q_full[2], q_empty[2], full[kFStages], empty[kFStages]
  static constexpr int kBytes = kBar + 8 * (4 + 2 * kFStages);
};

#define LO_FWD_OUT32                                                         \
  "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]),   \
      "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]),          \
      "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),      \
      "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]),      \
      "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]), "=f"(d[25]),      \
      "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]),      \
      "=f"(d[31])
#define LO_FWD_REGS32                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"

// S's first k-step: d (64x64 f32) = A (64x16, shared) . B (16x64,
// shared, K-major) with scale-d 0, so d is written without being read and
// needs no zeros first
__device__ __forceinline__ void wgmma_ss_first(float (&d)[32],
                                               uint64_t desc_a,
                                               uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " LO_FWD_REGS32
      ", %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : LO_FWD_OUT32
      : "l"(desc_a), "l"(desc_b), "r"(0));
}

#undef LO_FWD_OUT32
#undef LO_FWD_REGS32

// the keys a q tile's rows can see: causal bounds the top, the window
// the bottom; tiles outside [start, start + n_tiles kFBlockN) never load
__device__ __forceinline__ void fwd_band(int row0, int sq, int sk,
                                         int causal, int window, int offset,
                                         int& start, int& n_tiles) {
  const int row_last = min(row0 + kFBlockM, sq) - 1;
  int lo = 0, hi_col = sk;
  if (causal) hi_col = min(sk, row_last - offset + 1);
  if (window > 0) lo = max(0, row0 - window - offset + 1);
  start = (lo / kFBlockN) * kFBlockN;
  n_tiles = hi_col > start ? (hi_col - start + kFBlockN - 1) / kFBlockN : 0;
}

// the compiler fences around one step's products: nothing it reads or
// writes moves across them
__device__ __forceinline__ void fence_products(
    float (&sc)[kFHalves][32], uint32_t (&p_hi)[kFSteps][4],
    uint32_t (&p_lo)[kFSteps][4], float (&acc)[16]) {
#pragma unroll
  for (int nh = 0; nh < kFHalves; ++nh) fence_acc(sc[nh]);
#pragma unroll
  for (int kk = 0; kk < kFSteps; ++kk) {
    fence_frag(p_hi[kk]);
    fence_frag(p_lo[kk]);
  }
  fence_acc(acc);
}

// S = Q . K^T of the tile in ring slot gi into sc: 64 rows x kFBlockN
// keys as m64n64 halves, 2 k-steps each, Q read from shared memory at
// q_tile
__device__ __forceinline__ void issue_s(uint32_t base, uint32_t q_tile,
                                        float (&sc)[kFHalves][32], int gi) {
  const uint32_t kt =
      base + NarrowSmem::kK + (gi % kFStages) * NarrowSmem::kKVBytes;
#pragma unroll
  for (int nh = 0; nh < kFHalves; ++nh) {
    const uint32_t kb = kt + nh * 64 * kNarrowRowBytes;
    wgmma_ss_first(sc[nh], desc_sw64(q_tile), desc_sw64(kb));
    wgmma_ss<0>(sc[nh], desc_sw64(q_tile + 32), desc_sw64(kb + 32), 1);
  }
}

// one step's products, committed as one group: O += P . V of a tile (P
// as bf16 hi + lo register fragments, V in ring slot gi_pv read
// MN-major, 16 keys a k-step) and, with WITH_S, S of the tile in ring
// slot gi_s into sc
template <bool WITH_S>
__device__ __forceinline__ void issue_products(
    uint32_t base, uint32_t q_tile, float (&sc)[kFHalves][32],
    uint32_t (&p_hi)[kFSteps][4],
    uint32_t (&p_lo)[kFSteps][4], float (&acc)[16], int gi_pv, int gi_s) {
#pragma unroll
  for (int kk = 0; kk < kFSteps; ++kk) {
    fence_frag(p_hi[kk]);
    fence_frag(p_lo[kk]);
  }
  fence_acc(acc);
  wgmma_fence();
  const uint32_t vt =
      base + NarrowSmem::kV + (gi_pv % kFStages) * NarrowSmem::kKVBytes;
#pragma unroll
  for (int kk = 0; kk < kFSteps; ++kk) {
    const uint64_t vb = desc_sw64(vt + kk * 16 * kNarrowRowBytes);
    wgmma_rs_n32<1>(acc, p_hi[kk], vb);
    wgmma_rs_n32<1>(acc, p_lo[kk], vb);
  }
  if (WITH_S) issue_s(base, q_tile, sc, gi_s);
  wgmma_commit();
}

// the mask of the tile at key kv0 for this thread's rows r0 and r0 + 8,
// only where the tile crosses an edge of what the warpgroup's rows
// (wg_row0 ..) can see
__device__ __forceinline__ void mask_tile(float (&sc)[kFHalves][32],
                                          int kv0, int wg_row0, int r0,
                                          int cq, int sk, int causal,
                                          int window, int offset) {
  bool edge = kv0 + kFBlockN > sk;
  if (causal) edge = edge || wg_row0 < kv0 + kFBlockN - 1 + offset;
  if (window > 0) edge = edge || kv0 + offset <= wg_row0 + 63 - window;
  if (!edge) return;
#pragma unroll
  for (int nh = 0; nh < kFHalves; ++nh)
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int col = kv0 + nh * 64 + 8 * (i / 4) + cq + (i % 2);
      const int row = r0 + 8 * ((i / 2) % 2);
      bool ok = col < sk;
      if (causal) ok = ok && row >= col + offset;
      if (window > 0) ok = ok && col + offset > row - window;
      if (!ok) sc[nh][i] = -INFINITY;
    }
}

// the online softmax of a tile's scores, in place: P = exp2(s scale
// log2(e) - m), alpha the factor of what was summed before; a row with
// nothing visible so far keeps m = -inf and p = 0. Maxima and sums run
// over independent chains.
__device__ __forceinline__ void softmax_tile(float (&sc)[kFHalves][32],
                                             float (&m)[2], float (&l)[2],
                                             float (&alpha)[2],
                                             float scale_log2) {
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float mx[4] = {m[rr], -INFINITY, -INFINITY, -INFINITY};
#pragma unroll
    for (int nh = 0; nh < kFHalves; ++nh)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        mx[j % 4] = fmaxf(mx[j % 4], fmaxf(sc[nh][4 * j + 2 * rr],
                                           sc[nh][4 * j + 2 * rr + 1]));
    float mrow = fmaxf(fmaxf(mx[0], mx[1]), fmaxf(mx[2], mx[3]));
    mrow = fmaxf(mrow, __shfl_xor_sync(0xffffffffu, mrow, 1));
    mrow = fmaxf(mrow, __shfl_xor_sync(0xffffffffu, mrow, 2));
    const float m_log2 = mrow == -INFINITY ? 0.f : mrow * scale_log2;
    alpha[rr] = ex2_ftz(fmaf(m[rr], scale_log2, -m_log2));
    m[rr] = mrow;
    float sum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int nh = 0; nh < kFHalves; ++nh)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = sc[nh][4 * j + 2 * rr + e];
          x = ex2_ftz(fmaf(x, scale_log2, -m_log2));
          sum[2 * (j % 2) + e] += x;
        }
    l[rr] = fmaf(l[rr], alpha[rr], (sum[0] + sum[1]) + (sum[2] + sum[3]));
  }
}

// O's rescale (once the products that add to it are done) and P's hi +
// lo fragments (once the products that read the last ones are)
__device__ __forceinline__ void rescale_split(const float (&sc)[kFHalves][32],
                                              const float (&alpha)[2],
                                              float (&acc)[16],
                                              uint32_t (&p_hi)[kFSteps][4],
                                              uint32_t (&p_lo)[kFSteps][4]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] *= alpha[(i / 2) % 2];
#pragma unroll
  for (int kk = 0; kk < kFSteps; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      split_pair(sc[kk / 4][8 * (kk % 4) + 2 * i],
                 sc[kk / 4][8 * (kk % 4) + 2 * i + 1], p_hi[kk][i],
                 p_lo[kk][i]);
}

// an item's two rows r0 and r0 + 8 of this thread: o = acc / l in bf16,
// lse = m * scale + log(l), a row that saw no key o = 0 and lse =
// -1e30; rows past sq are not written (they computed on TMA's zeros)
__device__ __forceinline__ void store_rows(
    __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int bh, int r0,
    int lane, int sq, int h, int d, float scale, const float (&acc)[16],
    const float (&lsum)[2], const float (&mrow)[2]) {
  const int bi = bh / h, hq = bh % h;
  const int cq = 2 * (lane % 4);
  float total[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    total[rr] = lsum[rr];
    total[rr] += __shfl_xor_sync(0xffffffffu, total[rr], 1);
    total[rr] += __shfl_xor_sync(0xffffffffu, total[rr], 2);
  }
  const int64_t row_stride = (int64_t)h * d;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = r0 + 8 * rr;
    if (row >= sq) continue;
    const float inv = total[rr] > 0.f ? 1.f / total[rr] : 0.f;
    __nv_bfloat16* orow =
        o + ((int64_t)bi * sq + row) * row_stride + (int64_t)hq * d;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = 8 * j + cq;
      const int i = 4 * j + 2 * rr;
      if (col < d)
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(acc[i] * inv, acc[i + 1] * inv);
    }
    if (lane % 4 == 0)
      lse[((int64_t)bi * sq + row) * h + hq] =
          total[rr] > 0.f ? mrow[rr] * scale + logf(total[rr]) : kNegInf;
  }
}

__global__ void __launch_bounds__(kFThreads, 1)
    flash_fwd_sm90_narrow_kernel(const __grid_constant__ CUtensorMap tq,
                                 const __grid_constant__ CUtensorMap tk,
                                 const __grid_constant__ CUtensorMap tv,
                                 __nv_bfloat16* __restrict__ o,
                                 float* __restrict__ lse, int b, int sq,
                                 int sk, int h, int kvh, int d, float scale,
                                 int causal, int window, int offset) {
  using L = NarrowSmem;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t q_full0 = base + L::kBar;
  const uint32_t q_empty0 = q_full0 + 16;
  const uint32_t full0 = q_empty0 + 16;
  const uint32_t empty0 = full0 + 8 * kFStages;

  const int tid = threadIdx.x;
  const int n_row_tiles = (sq + kFBlockM - 1) / kFBlockM;
  const int n_items = n_row_tiles * b * h;

  if (tid == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(q_full0 + 8 * i, 1);
      mbar_init(q_empty0 + 8 * i, kFConsumers);
    }
    for (int s = 0; s < kFStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kFConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= kFConsumers) {
    // producer warpgroup: one thread issues every load
    reg_dealloc<kFProducerRegs>();
    if (tid == kFConsumers) {
      int g = 0;  // K/V tiles loaded so far: the ring's position
      int it = 0;
      for (int item = blockIdx.x; item < n_items; item += gridDim.x, ++it) {
        const int bh = item / n_row_tiles;
        const int bi = bh / h, hq = bh % h, kvi = hq / (h / kvh);
        const int row0 = (item % n_row_tiles) * kFBlockM;
        int start, n_tiles;
        fwd_band(row0, sq, sk, causal, window, offset, start, n_tiles);
        const int qb = it % 2;
        mbar_wait(q_empty0 + 8 * qb, ((it / 2) & 1) ^ 1);
        mbar_expect_tx(q_full0 + 8 * qb, L::kQBytes);
        tma_load_4d(base + L::kQ + qb * L::kQBytes, &tq, q_full0 + 8 * qb, 0,
                    hq, row0, bi);
        for (int t = 0; t < n_tiles; ++t, ++g) {
          const int s = g % kFStages;
          mbar_wait(empty0 + 8 * s, ((g / kFStages) & 1) ^ 1);
          const uint32_t full = full0 + 8 * s;
          mbar_expect_tx(full, 2 * L::kKVBytes);
          const int kv0 = start + t * kFBlockN;
          tma_load_4d(base + L::kK + s * L::kKVBytes, &tk, full, 0, kvi, kv0,
                      bi);
          tma_load_4d(base + L::kV + s * L::kKVBytes, &tv, full, 0, kvi, kv0,
                      bi);
        }
      }
    }
    return;
  }
  reg_alloc<kFConsumerRegs>();

  // consumer warpgroup wg owns q rows row0 + 64 wg .. + 63 of each item;
  // this thread rows r0 and r0 + 8, columns (keys, or O's head-dim
  // columns) 8 j + cq + {0, 1} of each chunk
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int wrow = 64 * wg + 16 * warp + lane / 4;  // r0 - row0
  const int cq = 2 * (lane % 4);
  const float scale_log2 = scale * kLog2e;

  float sc[kFHalves][32];
  uint32_t p_hi[kFSteps][4], p_lo[kFSteps][4];
  float acc[16];
  float m[2], l[2], alpha[2];  // running row max (raw scores), sum part
  int g = 0;                   // K/V tiles consumed so far: the ring's place
  int it = 0;
  for (int item = blockIdx.x; item < n_items; item += gridDim.x, ++it) {
    const int bh = item / n_row_tiles;
    const int row0 = (item % n_row_tiles) * kFBlockM;
    const int r0 = row0 + wrow;
    int start, n_tiles;
    fwd_band(row0, sq, sk, causal, window, offset, start, n_tiles);
    const int qb = it % 2;
    const uint32_t q_tile =
        base + L::kQ + qb * L::kQBytes + wg * 64 * kNarrowRowBytes;
    mbar_wait(q_full0 + 8 * qb, (it / 2) & 1);
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[i] = 0.f;
    m[0] = m[1] = -INFINITY;
    l[0] = l[1] = 0.f;

    if (n_tiles > 0) {
      // tile 0: its S alone
      mbar_wait(full0 + 8 * (g % kFStages), (g / kFStages) & 1);
      wgmma_fence();
      issue_s(base, q_tile, sc, g);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int nh = 0; nh < kFHalves; ++nh) fence_acc(sc[nh]);
      mask_tile(sc, start, row0 + 64 * wg, r0, cq, sk, causal, window,
                offset);
      softmax_tile(sc, m, l, alpha, scale_log2);
      rescale_split(sc, alpha, acc, p_hi, p_lo);
      // tiles 1 ..: a step issues this tile's S and the last tile's P.V
      for (int t = 1; t < n_tiles; ++t) {
        const int gi = g + t;
        const int kv0 = start + t * kFBlockN;
        mbar_wait(full0 + 8 * (gi % kFStages), (gi / kFStages) & 1);
        // both in one group, one wait, then the mask and the softmax
        issue_products<true>(base, q_tile, sc, p_hi, p_lo, acc, gi - 1, gi);
        wgmma_wait<0>();
        fence_products(sc, p_hi, p_lo, acc);
        mbar_arrive(empty0 + 8 * ((gi - 1) % kFStages));
        mask_tile(sc, kv0, row0 + 64 * wg, r0, cq, sk, causal, window,
                  offset);
        softmax_tile(sc, m, l, alpha, scale_log2);
        rescale_split(sc, alpha, acc, p_hi, p_lo);
      }
      // the last tile's P.V
      const int gl = g + n_tiles - 1;
      issue_products<false>(base, q_tile, sc, p_hi, p_lo, acc, gl, 0);
      wgmma_wait<0>();
      fence_products(sc, p_hi, p_lo, acc);
      mbar_arrive(empty0 + 8 * (gl % kFStages));
    }
    g += n_tiles;
    // the item's S products, which read its Q buffer, are done
    mbar_arrive(q_empty0 + 8 * qb);
    store_rows(o, lse, bh, r0, lane, sq, h, d, scale, acc, l, m);
  }
}

cudaError_t launch_narrow(const void* q, const void* k, const void* v,
                          void* o, void* lse, int b, int sq, int sk, int h,
                          int kvh, int d, float scale, int causal,
                          int window, int offset, cudaStream_t stream) {
  const CUtensorMapSwizzle sw = CU_TENSOR_MAP_SWIZZLE_64B;
  CUtensorMap tq, tk, tv;
  cudaError_t err = make_map(&tq, q, b, sq, h, d, kFBlockM, kNarrowCols, sw);
  if (err == cudaSuccess)
    err = make_map(&tk, k, b, sk, kvh, d, kFBlockN, kNarrowCols, sw);
  if (err == cudaSuccess)
    err = make_map(&tv, v, b, sk, kvh, d, kFBlockN, kNarrowCols, sw);
  if (err != cudaSuccess) return err;
  constexpr int smem = NarrowSmem::kBytes + 1024;  // + alignment slack
  static_assert(smem <= 232448, "shared memory past the 227 KB a block gets");
  err = cudaFuncSetAttribute(flash_fwd_sm90_narrow_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  const long long items =
      (long long)((sq + kFBlockM - 1) / kFBlockM) * b * h;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int blocks = (int)(items < sms ? items : sms);
  flash_fwd_sm90_narrow_kernel<<<blocks, kFThreads, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse),
      b, sq, sk, h, kvh, d, scale, causal, window, offset);
  return cudaGetLastError();
}

template <int NB>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int b, int sq, int sk, int h, int kvh, int d,
                   float scale, int causal, int window, int offset,
                   cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  cudaError_t err = make_map(&tq, q, b, sq, h, d, kBlockM);
  if (err == cudaSuccess) err = make_map(&tk, k, b, sk, kvh, d, kBlockN);
  if (err == cudaSuccess) err = make_map(&tv, v, b, sk, kvh, d, kBlockN);
  if (err != cudaSuccess) return err;
  constexpr int smem = Smem<NB>::kBytes + 1024;  // + alignment slack
  auto kernel = flash_fwd_sm90_kernel<NB>;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + kBlockM - 1) / kBlockM, b * h);
  kernel<<<grid, kThreads, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse),
      sq, sk, h, kvh, d, scale, causal, window, offset);
  return cudaGetLastError();
}

}  // namespace

// q (b, sq, h, d), k and v (b, sk, kvh, d), o like q: contiguous bf16
// with d a multiple of 8 up to 128 and 16-byte aligned bases; lse (b, sq,
// h) float32. Launches on `stream` and returns cudaGetLastError().
extern "C" int lo_flash_fwd_sm90(const void* q, const void* k, const void* v,
                                 void* o, void* lse, int b, int sq, int sk,
                                 int h, int kvh, int d, float scale,
                                 int causal, int window, int offset,
                                 void* stream) {
  if (b < 1 || sq < 1 || sk < 1 || h < 1 || kvh < 1 || h % kvh != 0 ||
      d < 8 || d > 128 || d % 8 != 0 || (int64_t)b * h > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= kNarrowCols)
    return (int)launch_narrow(q, k, v, o, lse, b, sq, sk, h, kvh, d, scale,
                              causal, window, offset, s);
  if (d <= 64)
    return (int)launch<1>(q, k, v, o, lse, b, sq, sk, h, kvh, d, scale,
                          causal, window, offset, s);
  return (int)launch<2>(q, k, v, o, lse, b, sq, sk, h, kvh, d, scale, causal,
                        window, offset, s);
}
