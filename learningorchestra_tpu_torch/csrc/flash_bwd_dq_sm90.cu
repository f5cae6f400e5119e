// Flash-attention backward, dQ, on Hopper's tensor cores (sm_90a): bf16
// inputs, warpgroup MMA (wgmma) from shared memory that TMA fills
// through an mbarrier ring, hand-written CUDA C++.
//
// Replaces: learningorchestra_tpu/ops/attention.py `_bwd_dq_kernel` (the
// first Pallas TPU kernel of `_bwd_pallas`) for bf16 q/k/v/dO whose
// head_dim is a multiple of 8 up to 128; flash_bwd_dq_tf32x3.cu takes
// every other float32 or bf16 input. Same function: with the forward's saved log-sum-exp `lse`
// and `delta = rowsum(dO * O) - dlse`, for every visible (row, col) pair
//   p  = exp(q.k * scale - lse),  dp = dO.v,
//   ds = p * (dp - delta) * scale,  dQ[row] += ds * k[col],
// under the forward's masks (causal row >= col + offset, window col +
// offset > row - window, ragged sk) with grouped-query heads (query head
// i reads kv head i / (h / kvh)). Masked pairs are zeroed before the
// exp, which overflows on a row with no visible key (lse = -1e30): such
// a row gets dQ = 0. dQ is float32, (b, sq, h, d).
//
// Bound on an H100 SXM at the training shape (b 8, sq = sk = 2048, h 8,
// kvh 4, d 64, causal, window 1024): 1,573,376 visible pairs per query
// head over b * h = 64, so 6 * d * pairs = 38.7 GFLOP per call against
// about 85 MB of inputs and outputs: bound by operations, 0.039 ms at the
// 989 TFLOP/s bf16 tensor-core rate (the bytes take 0.025 ms).
//
// Design. One block per (batch * head, 128-row q tile): a producer
// warpgroup (one thread issues every load; setmaxnreg hands most of its
// registers to the consumers) and two consumer warpgroups of 64 q rows
// each. The producer loads the tile's Q and dO once (they stay resident)
// and walks the tile's visible kv band [lo, hi) as the forward does
// (causal bounds the top, the window the bottom), one TMA load of a K
// tile and one of V per stage into a two-stage ring of full/empty
// mbarriers; TMA zero-fills rows past sk and sq and columns past d. lse
// and delta are per q row, and the rows are resident, so each consumer
// thread reads its two rows' values from the (b, sq, h) tensors once,
// before the kv loop. Per K/V tile each consumer warpgroup computes S =
// Q.K^T and dP = dO.V^T with wgmma (all operands K-major; dP's product
// runs while P is computed from S), P and dS on the accumulator
// registers (exp2 with scale * log2(e) folded in; the mask only on tiles
// that cross the diagonal, the window edge, sq or sk), and adds dQ +=
// dS.K with dS as the register A operand and K read MN-major (the
// transpose flag) from the same swizzled tile, the operand order of the
// forward's P.V. dQ accumulates in f32 registers and is written once: no
// atomics, deterministic.
//
// Tiles and registers. A consumer thread holds S, dP and dQ at once,
// so K and V stream in 64-key tiles: S and dP are one m64n64 accumulator
// each (32 f32 registers), dQ one per 64-column box of d (d > 64: two
// products per k-step), and the dS fragments 32 more, well inside the
// 232 registers setmaxnreg gives a consumer (128-key tiles would put
// d 128 past it).
//
// Precision. The Pallas kernel multiplies ds by float32 k. Here dS goes
// to the tensor cores split as bf16 hi + bf16 lo (two products), which
// carries ds to about 2^-16 of itself, where bf16 alone departs by up to
// 2^-8 * sum |ds| |k| per element of dQ; S and dP need no split (their
// bf16 operands are exact, the sums f32). The split costs a third more
// tensor work (8 d FLOP per pair, not 6).

#include "sm90_common.cuh"

namespace {

using namespace sm90;

constexpr int kBlockM = 128;  // q rows per block: 2 warpgroups x 64
constexpr int kBlockN = 64;   // keys per stage
constexpr int kStages = 2;
constexpr int kConsumers = 256;
// + a producer warpgroup, so that setmaxnreg can move its registers to
// the consumers: 128 x 40 + 256 x 232 = the 384 x 168 the block starts
// with
constexpr int kThreads = kConsumers + 128;
constexpr float kLog2e = 1.4426950408889634f;

// shared memory, in bytes from a 1024-aligned base; NB boxes of 64
// head-dim columns (1 for d <= 64, 2 for d <= 128)
template <int NB>
struct Smem {
  static constexpr int kQBytes = NB * kBlockM * kRowBytes;   // Q or dO
  static constexpr int kKVBytes = NB * kBlockN * kRowBytes;  // K or V
  static constexpr int kQ = 0;
  static constexpr int kDO = kQ + kQBytes;
  static constexpr int kK = kDO + kQBytes;            // + stage * kKVBytes
  static constexpr int kV = kK + kStages * kKVBytes;  // + stage * kKVBytes
  static constexpr int kBar = kV + kStages * kKVBytes;
  // barriers: q, full[kStages], empty[kStages]
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kStages);
};

template <int NB>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             const __grid_constant__ CUtensorMap tdo,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             float* __restrict__ dq, int sq, int sk, int h,
                             int kvh, int d, float scale, int causal,
                             int window, int offset) {
  using L = Smem<NB>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_bar = base + L::kBar;
  const uint32_t full0 = q_bar + 8;
  const uint32_t empty0 = full0 + 8 * kStages;

  const int tid = threadIdx.x;
  const int bi = blockIdx.y / h;
  const int hq = blockIdx.y % h;
  const int kvi = hq / (h / kvh);
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
      mbar_expect_tx(q_bar, 2 * L::kQBytes);
      for (int bx = 0; bx < NB; ++bx) {
        const int off = bx * kBlockM * kRowBytes;
        tma_load_4d(base + L::kQ + off, &tq, q_bar, bx * kBoxCols, hq, row0,
                    bi);
        tma_load_4d(base + L::kDO + off, &tdo, q_bar, bx * kBoxCols, hq,
                    row0, bi);
      }
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
  // rows r0 and r0 + 8, columns (keys, or dQ's head-dim columns) 8 j +
  // cq + {0, 1} of each 64-wide chunk
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int wg_row0 = row0 + 64 * wg;
  const int r0 = wg_row0 + 16 * warp + lane / 4;
  const int cq = 2 * (lane % 4);
  const float scale_log2 = scale * kLog2e;

  // the two rows' lse (in log2 units) and delta; rows past sq are masked
  float lse2[2], dlt[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = r0 + 8 * rr;
    const int64_t i = ((int64_t)bi * sq + row) * h + hq;
    lse2[rr] = row < sq ? lse[i] * kLog2e : 0.f;
    dlt[rr] = row < sq ? delta[i] : 0.f;
  }

  float acc[NB][32];
#pragma unroll
  for (int bx = 0; bx < NB; ++bx)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[bx][i] = 0.f;

  const uint32_t q_tile = base + L::kQ + wg * 64 * kRowBytes;
  const uint32_t do_tile = base + L::kDO + wg * 64 * kRowBytes;
  mbar_wait(q_bar, 0);

  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages;
    mbar_wait(full0 + 8 * s, (t / kStages) & 1);
    const int kv0 = start + t * kBlockN;
    const uint32_t k_tile = base + L::kK + s * L::kKVBytes;
    const uint32_t v_tile = base + L::kV + s * L::kKVBytes;

    // S = Q . K^T, then dP = dO . V^T, 64 rows x 64 keys each, in two
    // commit groups (the first k-step overwrites the zeros, which only
    // keep the accumulators defined)
    float sc[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
    fence_acc(sc);
    fence_acc(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * NB; ++kk) {
      const int ka = (kk / 4) * kBlockM * kRowBytes + (kk % 4) * 32;
      const int kb = (kk / 4) * kBlockN * kRowBytes + (kk % 4) * 32;
      wgmma_ss<0>(sc, desc_sw128(q_tile + ka), desc_sw128(k_tile + kb),
                  kk > 0);
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < 4 * NB; ++kk) {
      const int ka = (kk / 4) * kBlockM * kRowBytes + (kk % 4) * 32;
      const int kb = (kk / 4) * kBlockN * kRowBytes + (kk % 4) * 32;
      wgmma_ss<0>(dp, desc_sw128(do_tile + ka), desc_sw128(v_tile + kb),
                  kk > 0);
    }
    wgmma_commit();

    // P in place of S while dP is still in flight; the mask only where
    // the tile crosses an edge of what the warpgroup's rows can see
    wgmma_wait<1>();
    fence_acc(sc);
    bool edge = kv0 + kBlockN > sk || wg_row0 + 63 >= sq;
    if (causal) edge = edge || wg_row0 < kv0 + kBlockN - 1 + offset;
    if (window > 0) edge = edge || kv0 + offset <= wg_row0 + 63 - window;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int rr = (i / 2) % 2;
      bool ok = true;
      if (edge) {
        const int col = kv0 + 8 * (i / 4) + cq + (i % 2);
        const int row = r0 + 8 * rr;
        ok = row < sq && col < sk;
        if (causal) ok = ok && row >= col + offset;
        if (window > 0) ok = ok && col + offset > row - window;
      }
      sc[i] = exp2f(ok ? fmaf(sc[i], scale_log2, -lse2[rr]) : -INFINITY);
    }

    // dS in place of dP
    wgmma_wait<0>();
    fence_acc(dp);
#pragma unroll
    for (int i = 0; i < 32; ++i)
      dp[i] = sc[i] * (dp[i] - dlt[(i / 2) % 2]) * scale;

    // dQ += dS . K, dS as bf16 hi + lo register fragments
    uint32_t ds_hi[4][4], ds_lo[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      split_fragment(dp, kk, ds_hi[kk], ds_lo[kk]);
      fence_frag(ds_hi[kk]);
      fence_frag(ds_lo[kk]);
    }
#pragma unroll
    for (int bx = 0; bx < NB; ++bx) fence_acc(acc[bx]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int bx = 0; bx < NB; ++bx) {
        const uint64_t b = desc_sw128(k_tile + bx * kBlockN * kRowBytes +
                                      kk * 16 * kRowBytes);
        wgmma_rs<1>(acc[bx], ds_hi[kk], b);
        wgmma_rs<1>(acc[bx], ds_lo[kk], b);
      }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int bx = 0; bx < NB; ++bx) fence_acc(acc[bx]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      fence_frag(ds_hi[kk]);
      fence_frag(ds_lo[kk]);
    }
    mbar_arrive(empty0 + 8 * s);
  }

  // every element of the tile's valid rows written once, as float2 pairs
  // into rows h * d floats apart
  const int64_t row_stride = (int64_t)h * d;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = r0 + 8 * rr;
    if (row >= sq) continue;
    float* out = dq + ((int64_t)bi * sq + row) * row_stride + (int64_t)hq * d;
#pragma unroll
    for (int bx = 0; bx < NB; ++bx)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = bx * kBoxCols + 8 * j + cq;
        const int i = 4 * j + 2 * rr;
        if (col < d)
          *reinterpret_cast<float2*>(out + col) =
              make_float2(acc[bx][i], acc[bx][i + 1]);
      }
  }
}

// ---- the narrow instance: head_dim <= 32 --------------------------------
//
// At d <= 32 the 64-column boxes above are half zeros, and every product
// runs at width 64: S and dP take 4 k-steps where 2 do, and dQ
// accumulates in m64n64 with 32 columns real. Here the tiles are boxes
// of 32 columns (64-byte rows, 64-byte swizzle): S and dP reduce over 2
// k-steps, dQ accumulates in m64n32k16 (16 f32 registers), and each tile
// takes half the shared memory.
//
// Bound at the classifier's shape (b 128, 512 tokens, 8 heads over 4, d
// 32, non-causal; 268,435,456 visible pairs): 6 d FLOP a pair is 0.052
// ms at 989 TFLOP/s, and one exp2 a pair on the special-function units
// (16 a clock on each of 132 SMs) 0.064 ms at 1.98 GHz. The card spends
// most of its time elsewhere: each tile's dQ products wait for that
// tile's dS split, and each warpgroup for its products, one tile after
// the other (scripts/sm90_bwd_narrow_sweep.py: without that dependence,
// the -xss diagnostic, the kernel runs in less than half the time; the
// exp2s and splits themselves are a tenth). So the kernel keeps more
// tiles in flight: three consumer warpgroups (192 q rows a block; a
// warpgroup past sq idles), a persistent grid, Q and dO as register
// fragments for S and dP, and the per-pair work short (ex2.approx.ftz,
// scale folded into delta, the hi + lo split as packed conversions).
// The sweep measures these choices against the others kept as options
// (ring depth, one block per item, two warpgroups, S and dP from shared
// memory).
//
// It also takes over what the wrapper did around the wide instances:
// given `o` (`delta` null) it loads O's tile with Q and dO and computes
// its rows' delta = rowsum(dO * O) - dlse in float32 (4 lanes a row,
// each 16 bytes of it: the swizzle permutes a row's 16-byte chunks
// within the row, the same in both tiles, so the sum needs no unswizzle)
// and, given lse_t and delta_t, writes its rows' lse and delta by head,
// (b, h, sq_pad), zero past sq, the layout flash_bwd_dkv_sm90 reads.
//
// Work items are (batch * head, kNBlockM-row q tile), row tiles fastest.
// With kNPersistent the grid is one block per SM, each walking items
// gridDim.x apart, with Q, dO and O double-buffered: the producer loads
// the next item's while the consumers finish this one, so an item's
// prologue waits on nothing.

constexpr int kNStages = 2;         // K/V ring depth
constexpr int kNWarpgroups = 3;     // consumer warpgroups, 64 q rows each
constexpr bool kNPersistent = true;
// S and dP with Q and dO as register fragments, loaded once an item
// (true), or read from shared memory by every product (false)
constexpr bool kNRegA = true;
constexpr int kNConsumers = 128 * kNWarpgroups;
constexpr int kNThreads = kNConsumers + 128;
constexpr int kNBlockM = 64 * kNWarpgroups;
// the block's registers: 128 x 40 + 256 x 232 = 384 x 168 (two
// consumer warpgroups), 128 x 24 + 384 x 160 <= 512 x 128 (three)
constexpr int kNProducerRegs = kNWarpgroups == 2 ? 40 : 24;
constexpr int kNConsumerRegs = kNWarpgroups == 2 ? 232 : 160;
static_assert(kNProducerRegs * 128 + kNConsumerRegs * kNConsumers <= 65536,
              "register budget");
constexpr int kNQBufs = kNPersistent ? 2 : 1;

struct NarrowSmem {
  static constexpr int kQBytes = kNBlockM * kNarrowRowBytes;  // Q, dO or O
  static constexpr int kQSet = 3 * kQBytes;  // an item's Q, dO and O
  static constexpr int kKVBytes = kBlockN * kNarrowRowBytes;  // K or V
  static constexpr int kQ = 0;  // + buffer * kQSet; dO, O kQBytes apart
  static constexpr int kK = kNQBufs * kQSet;           // + stage * kKVBytes
  static constexpr int kV = kK + kNStages * kKVBytes;  // + stage * kKVBytes
  static constexpr int kBar = kV + kNStages * kKVBytes;
  // barriers: q_full[kNQBufs], q_empty[kNQBufs], full[kNStages],
  // empty[kNStages]
  static constexpr int kBytes = kBar + 8 * (2 * kNQBufs + 2 * kNStages);
};

// the keys a q tile's rows can see: causal bounds the top, the window
// the bottom; tiles outside [start, start + n_tiles kBlockN) never load
__device__ __forceinline__ void dq_band(int row0, int sq, int sk, int causal,
                                        int window, int offset, int& start,
                                        int& n_tiles) {
  const int row_last = min(row0 + kNBlockM, sq) - 1;
  int lo = 0, hi_col = sk;
  if (causal) hi_col = min(sk, row_last - offset + 1);
  if (window > 0) lo = max(0, row0 - window - offset + 1);
  start = (lo / kBlockN) * kBlockN;
  n_tiles = hi_col > start ? (hi_col - start + kBlockN - 1) / kBlockN : 0;
}

__global__ void __launch_bounds__(kNThreads, 1)
    flash_bwd_dq_sm90_narrow_kernel(
        const __grid_constant__ CUtensorMap tq,
        const __grid_constant__ CUtensorMap tk,
        const __grid_constant__ CUtensorMap tv,
        const __grid_constant__ CUtensorMap tdo,
        const __grid_constant__ CUtensorMap to, int fold,
        const float* __restrict__ lse, const float* __restrict__ dlse,
        const float* __restrict__ delta, float* __restrict__ dq,
        float* __restrict__ lse_t, float* __restrict__ delta_t, int b,
        int sq, int sk, int h, int kvh, int d, int sq_pad, float scale,
        int causal, int window, int offset) {
  using L = NarrowSmem;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint8_t* smem = smem_raw + (base - raw);  // generic view of base
  const uint32_t q_full0 = base + L::kBar;
  const uint32_t q_empty0 = q_full0 + 8 * kNQBufs;
  const uint32_t full0 = q_empty0 + 8 * kNQBufs;
  const uint32_t empty0 = full0 + 8 * kNStages;

  const int tid = threadIdx.x;
  const int n_row_tiles = (sq + kNBlockM - 1) / kNBlockM;
  const int n_items = n_row_tiles * b * h;

  if (tid == 0) {
    for (int i = 0; i < kNQBufs; ++i) {
      mbar_init(q_full0 + 8 * i, 1);
      mbar_init(q_empty0 + 8 * i, kNConsumers);
    }
    for (int s = 0; s < kNStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kNConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= kNConsumers) {
    // producer warpgroup: one thread issues every load
    reg_dealloc<kNProducerRegs>();
    if (tid == kNConsumers) {
      int g = 0;  // K/V tiles loaded so far: the ring's position
      int it = 0;
      for (int item = blockIdx.x; item < n_items; item += gridDim.x, ++it) {
        const int bh = item / n_row_tiles;
        const int bi = bh / h, hq = bh % h, kvi = hq / (h / kvh);
        const int row0 = (item % n_row_tiles) * kNBlockM;
        int start, n_tiles;
        dq_band(row0, sq, sk, causal, window, offset, start, n_tiles);
        const int qb = it % kNQBufs;
        if (kNPersistent)
          mbar_wait(q_empty0 + 8 * qb, ((it / kNQBufs) & 1) ^ 1);
        const uint32_t q_full = q_full0 + 8 * qb;
        const uint32_t qs = base + L::kQ + qb * L::kQSet;
        mbar_expect_tx(q_full, (fold ? 3 : 2) * L::kQBytes);
        tma_load_4d(qs, &tq, q_full, 0, hq, row0, bi);
        tma_load_4d(qs + L::kQBytes, &tdo, q_full, 0, hq, row0, bi);
        if (fold)
          tma_load_4d(qs + 2 * L::kQBytes, &to, q_full, 0, hq, row0, bi);
        for (int t = 0; t < n_tiles; ++t, ++g) {
          const int s = g % kNStages;
          mbar_wait(empty0 + 8 * s, ((g / kNStages) & 1) ^ 1);
          const uint32_t full = full0 + 8 * s;
          mbar_expect_tx(full, 2 * L::kKVBytes);
          const int kv0 = start + t * kBlockN;
          tma_load_4d(base + L::kK + s * L::kKVBytes, &tk, full, 0, kvi,
                      kv0, bi);
          tma_load_4d(base + L::kV + s * L::kKVBytes, &tv, full, 0, kvi,
                      kv0, bi);
        }
      }
    }
    return;
  }
  reg_alloc<kNConsumerRegs>();

  // consumer warpgroup wg owns q rows row0 + 64 wg .. + 63; this thread
  // rows r0 and r0 + 8, columns (keys, or dQ's head-dim columns) 8 j +
  // cq + {0, 1} of each chunk
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int wrow = 64 * wg + 16 * warp + lane / 4;  // r0 - row0
  const int cq = 2 * (lane % 4);
  const float scale_log2 = scale * kLog2e;

  int g = 0;
  int it = 0;
  for (int item = blockIdx.x; item < n_items; item += gridDim.x, ++it) {
    const int bh = item / n_row_tiles;
    const int bi = bh / h, hq = bh % h;
    const int row0 = (item % n_row_tiles) * kNBlockM;
    const int wg_row0 = row0 + 64 * wg;
    const int r0 = row0 + wrow;
    int start, n_tiles;
    dq_band(row0, sq, sk, causal, window, offset, start, n_tiles);
    const int qb = it % kNQBufs;
    const uint32_t qs = base + L::kQ + qb * L::kQSet;

    // the two rows' lse and delta (zero past sq, where rows are masked)
    float lse1[2], dlt[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int row = r0 + 8 * rr;
      const int64_t i = ((int64_t)bi * sq + row) * h + hq;
      lse1[rr] = row < sq ? lse[i] : 0.f;
      dlt[rr] = row < sq && !fold ? delta[i] : 0.f;
      if (row < sq && fold && dlse != nullptr) dlt[rr] = -dlse[i];
    }

    float acc[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[i] = 0.f;

    mbar_wait(q_full0 + 8 * qb, (it / kNQBufs) & 1);
    if (fold) {
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int off = (wrow + 8 * rr) * kNarrowRowBytes + (lane % 4) * 16;
        const uint8_t* q_set = smem + L::kQ + qb * L::kQSet;
        const uint4 a = *reinterpret_cast<const uint4*>(q_set + L::kQBytes +
                                                        off);
        const uint4 c =
            *reinterpret_cast<const uint4*>(q_set + 2 * L::kQBytes + off);
        const uint32_t av[4] = {a.x, a.y, a.z, a.w};
        const uint32_t cv[4] = {c.x, c.y, c.z, c.w};
        float sum = 0.f;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float2 x = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&av[k]));
          const float2 y = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&cv[k]));
          sum = fmaf(x.x, y.x, sum);
          sum = fmaf(x.y, y.y, sum);
        }
        sum += __shfl_xor_sync(0xFFFFFFFFu, sum, 1);
        sum += __shfl_xor_sync(0xFFFFFFFFu, sum, 2);
        if (r0 + 8 * rr < sq) dlt[rr] += sum;
      }
    }
    if (lse_t != nullptr && lane % 4 == 0) {
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int row = r0 + 8 * rr;
        if (row >= sq_pad) continue;
        const int64_t o = ((int64_t)bi * h + hq) * sq_pad + row;
        lse_t[o] = lse1[rr];
        delta_t[o] = dlt[rr];
      }
    }
    // lse in log2 units; ds = p * (dp - delta) * scale as p * (dp * scale
    // - delta * scale)
    const float lse2[2] = {lse1[0] * kLog2e, lse1[1] * kLog2e};
    dlt[0] *= scale;
    dlt[1] *= scale;

    const uint32_t q_tile = qs + wg * 64 * kNarrowRowBytes;
    const uint32_t do_tile = q_tile + L::kQBytes;
    uint32_t q_frag[2][4], do_frag[2][4];
    if (kNRegA) {
      const uint8_t* q_gen = smem + (q_tile - base);
      load_fragments_sw64(q_gen, warp, lane, q_frag);
      load_fragments_sw64(q_gen + L::kQBytes, warp, lane, do_frag);
    }
    // a warpgroup whose rows all lie past sq only keeps the ring going
    const bool idle = wg_row0 >= sq;
    if (idle) {
      for (int t = 0; t < n_tiles; ++t, ++g) {
        const int s = g % kNStages;
        mbar_wait(full0 + 8 * s, (g / kNStages) & 1);
        mbar_arrive(empty0 + 8 * s);
      }
    }
    for (int t = 0; t < (idle ? 0 : n_tiles); ++t, ++g) {
      const int s = g % kNStages;
      mbar_wait(full0 + 8 * s, (g / kNStages) & 1);
      const int kv0 = start + t * kBlockN;
      const uint32_t k_tile = base + L::kK + s * L::kKVBytes;
      const uint32_t v_tile = base + L::kV + s * L::kKVBytes;

      // S = Q . K^T, then dP = dO . V^T, 64 rows x 64 keys each over two
      // k-steps, in two commit groups (from register fragments the
      // products add to the zeros; from shared memory the first k-step
      // overwrites them)
      float sc[32], dp[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
      fence_acc(sc);
      fence_acc(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        if (kNRegA)
          wgmma_rs<0>(sc, q_frag[kk], desc_sw64(k_tile + 32 * kk));
        else
          wgmma_ss<0>(sc, desc_sw64(q_tile + 32 * kk),
                      desc_sw64(k_tile + 32 * kk), kk > 0);
      }
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        if (kNRegA)
          wgmma_rs<0>(dp, do_frag[kk], desc_sw64(v_tile + 32 * kk));
        else
          wgmma_ss<0>(dp, desc_sw64(do_tile + 32 * kk),
                      desc_sw64(v_tile + 32 * kk), kk > 0);
      }
      wgmma_commit();

      // P in place of S while dP is in flight; the mask only where the
      // tile crosses an edge of what the warpgroup's rows can see
      wgmma_wait<1>();
      fence_acc(sc);
      bool edge = kv0 + kBlockN > sk || wg_row0 + 63 >= sq;
      if (causal) edge = edge || wg_row0 < kv0 + kBlockN - 1 + offset;
      if (window > 0) edge = edge || kv0 + offset <= wg_row0 + 63 - window;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int rr = (i / 2) % 2;
        bool ok = true;
        if (edge) {
          const int col = kv0 + 8 * (i / 4) + cq + (i % 2);
          const int row = r0 + 8 * rr;
          ok = row < sq && col < sk;
          if (causal) ok = ok && row >= col + offset;
          if (window > 0) ok = ok && col + offset > row - window;
        }
        sc[i] = ex2_ftz(ok ? fmaf(sc[i], scale_log2, -lse2[rr]) : -INFINITY);
      }

      // dS in place of dP
      wgmma_wait<0>();
      fence_acc(dp);
      if (kNRegA) {
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          fence_frag(q_frag[kk]);
          fence_frag(do_frag[kk]);
        }
      }
#pragma unroll
      for (int i = 0; i < 32; ++i)
        dp[i] = sc[i] * fmaf(dp[i], scale, -dlt[(i / 2) % 2]);

      // dQ += dS . K, dS as bf16 hi + lo register fragments and K read
      // MN-major, 16 keys a k-step
      uint32_t ds_hi[4][4], ds_lo[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          split_pair(dp[8 * kk + 2 * i], dp[8 * kk + 2 * i + 1],
                     ds_hi[kk][i], ds_lo[kk][i]);
        fence_frag(ds_hi[kk]);
        fence_frag(ds_lo[kk]);
      }
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t kb = desc_sw64(k_tile + kk * 16 * kNarrowRowBytes);
        wgmma_rs_n32<1>(acc, ds_hi[kk], kb);
        wgmma_rs_n32<1>(acc, ds_lo[kk], kb);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(acc);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        fence_frag(ds_hi[kk]);
        fence_frag(ds_lo[kk]);
      }
      mbar_arrive(empty0 + 8 * s);
    }
    // this item's Q, dO and O are read: the buffer goes back
    if (kNPersistent) mbar_arrive(q_empty0 + 8 * qb);

    // every element of the tile's valid rows written once, as float2
    // pairs into rows h * d floats apart
    const int64_t row_stride = (int64_t)h * d;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int row = r0 + 8 * rr;
      if (row >= sq) continue;
      float* out =
          dq + ((int64_t)bi * sq + row) * row_stride + (int64_t)hq * d;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = 8 * j + cq;
        const int i = 4 * j + 2 * rr;
        if (col < d)
          *reinterpret_cast<float2*>(out + col) =
              make_float2(acc[i], acc[i + 1]);
      }
    }
  }
}

cudaError_t launch_narrow(const void* q, const void* k, const void* v,
                          const void* dout, const void* o, const void* lse,
                          const void* dlse, const void* delta, void* dq,
                          void* lse_t, void* delta_t, int b, int sq, int sk,
                          int h, int kvh, int d, int sq_pad, float scale,
                          int causal, int window, int offset,
                          cudaStream_t stream) {
  const CUtensorMapSwizzle sw = CU_TENSOR_MAP_SWIZZLE_64B;
  CUtensorMap tq, tk, tv, tdo, to;
  cudaError_t err = make_map(&tq, q, b, sq, h, d, kNBlockM, kNarrowCols, sw);
  if (err == cudaSuccess)
    err = make_map(&tdo, dout, b, sq, h, d, kNBlockM, kNarrowCols, sw);
  if (err == cudaSuccess)
    err = make_map(&to, o != nullptr ? o : dout, b, sq, h, d, kNBlockM,
                   kNarrowCols, sw);
  if (err == cudaSuccess)
    err = make_map(&tk, k, b, sk, kvh, d, kBlockN, kNarrowCols, sw);
  if (err == cudaSuccess)
    err = make_map(&tv, v, b, sk, kvh, d, kBlockN, kNarrowCols, sw);
  if (err != cudaSuccess) return err;
  constexpr int smem = NarrowSmem::kBytes + 1024;  // + alignment slack
  static_assert(smem <= 232448, "shared memory past the 227 KB a block gets");
  err = cudaFuncSetAttribute(flash_bwd_dq_sm90_narrow_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  const long long items =
      (long long)((sq + kNBlockM - 1) / kNBlockM) * b * h;
  int blocks = (int)items;
  if (kNPersistent) {
    int dev = 0, sms = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    blocks = (int)(items < sms ? items : sms);
  }
  flash_bwd_dq_sm90_narrow_kernel<<<blocks, kNThreads, smem, stream>>>(
      tq, tk, tv, tdo, to, o != nullptr, static_cast<const float*>(lse),
      static_cast<const float*>(dlse), static_cast<const float*>(delta),
      static_cast<float*>(dq), static_cast<float*>(lse_t),
      static_cast<float*>(delta_t), b, sq, sk, h, kvh, d, sq_pad, scale,
      causal, window, offset);
  return cudaGetLastError();
}

template <int NB>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dq, int b, int sq, int sk, int h, int kvh, int d,
                   float scale, int causal, int window, int offset,
                   cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err = make_map(&tq, q, b, sq, h, d, kBlockM);
  if (err == cudaSuccess) err = make_map(&tdo, dout, b, sq, h, d, kBlockM);
  if (err == cudaSuccess) err = make_map(&tk, k, b, sk, kvh, d, kBlockN);
  if (err == cudaSuccess) err = make_map(&tv, v, b, sk, kvh, d, kBlockN);
  if (err != cudaSuccess) return err;
  constexpr int smem = Smem<NB>::kBytes + 1024;  // + alignment slack
  auto kernel = flash_bwd_dq_sm90_kernel<NB>;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + kBlockM - 1) / kBlockM, b * h);
  kernel<<<grid, kThreads, smem, stream>>>(
      tq, tk, tv, tdo, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dq), sq, sk, h,
      kvh, d, scale, causal, window, offset);
  return cudaGetLastError();
}

}  // namespace

// q, dout and o (b, sq, h, d), k and v (b, sk, kvh, d): contiguous bf16
// with d a multiple of 8 up to 128 and 16-byte aligned bases; lse,
// dlse and delta (b, sq, h) float32; dq (b, sq, h, d) float32, every
// element written. d <= 32 takes the narrow instance: with `o` given
// (`delta` then unused) it computes delta = rowsum(dout * o) - dlse
// itself (dlse may be null), and with lse_t and delta_t given ((b, h,
// sq_pad) float32, sq_pad a multiple of 64 at least sq) it writes lse
// and delta there by head, zero past sq. d 40-128 read `delta` and take
// neither. Launches on `stream` and returns cudaGetLastError().
extern "C" int lo_flash_bwd_dq_sm90(
    const void* q, const void* k, const void* v, const void* dout,
    const void* o, const void* lse, const void* dlse, const void* delta,
    void* dq, void* lse_t, void* delta_t, int b, int sq, int sk, int h,
    int kvh, int d, int sq_pad, float scale, int causal, int window,
    int offset, void* stream) {
  if (b < 1 || sq < 1 || sk < 1 || h < 1 || kvh < 1 || h % kvh != 0 ||
      d < 8 || d > 128 || d % 8 != 0 || (int64_t)b * h > 65535 ||
      (lse_t == nullptr) != (delta_t == nullptr))
    return (int)cudaErrorInvalidValue;
  const bool narrow = d <= kNarrowCols;
  if (narrow ? o == nullptr && delta == nullptr
             : delta == nullptr || o != nullptr || lse_t != nullptr)
    return (int)cudaErrorInvalidValue;
  if (lse_t != nullptr && (sq_pad < sq || sq_pad % 64 != 0))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (narrow)
    return (int)launch_narrow(q, k, v, dout, o, lse, dlse, delta, dq, lse_t,
                              delta_t, b, sq, sk, h, kvh, d, sq_pad, scale,
                              causal, window, offset, s);
  if (d <= 64)
    return (int)launch<1>(q, k, v, dout, lse, delta, dq, b, sq, sk, h, kvh, d,
                          scale, causal, window, offset, s);
  return (int)launch<2>(q, k, v, dout, lse, delta, dq, b, sq, sk, h, kvh, d,
                        scale, causal, window, offset, s);
}
