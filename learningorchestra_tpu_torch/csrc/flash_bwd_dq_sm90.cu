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

// q and dout (b, sq, h, d), k and v (b, sk, kvh, d): contiguous bf16 with
// d a multiple of 8 up to 128 and 16-byte aligned bases; lse and delta
// (b, sq, h) float32; dq (b, sq, h, d) float32, every element written.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int lo_flash_bwd_dq_sm90(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const void* lse, const void* delta,
                                    void* dq, int b, int sq, int sk, int h,
                                    int kvh, int d, float scale, int causal,
                                    int window, int offset, void* stream) {
  if (b < 1 || sq < 1 || sk < 1 || h < 1 || kvh < 1 || h % kvh != 0 ||
      d < 8 || d > 128 || d % 8 != 0 || (int64_t)b * h > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 64)
    return (int)launch<1>(q, k, v, dout, lse, delta, dq, b, sq, sk, h, kvh, d,
                          scale, causal, window, offset, s);
  return (int)launch<2>(q, k, v, dout, lse, delta, dq, b, sq, sk, h, kvh, d,
                        scale, causal, window, offset, s);
}
