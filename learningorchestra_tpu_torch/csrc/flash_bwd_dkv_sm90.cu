// Flash-attention backward, dK and dV, on Hopper's tensor cores
// (sm_90a): bf16 inputs, warpgroup MMA (wgmma) from shared memory that
// TMA fills through an mbarrier ring, hand-written CUDA C++.
//
// Replaces: learningorchestra_tpu/ops/attention.py `_bwd_dkv_kernel` (the
// second Pallas TPU kernel of `_bwd_pallas`) for bf16 q/k/v/dO whose
// head_dim is a multiple of 8 up to 128; flash_bwd_dkv_tf32x3.cu takes
// every other float32 or bf16 input. Same function: with the forward's saved log-sum-exp `lse`
// and `delta = rowsum(dO * O) - dlse`, for every visible (row, col) pair
//   p  = exp(q.k * scale - lse),  dp = dO.v,
//   ds = p * (dp - delta) * scale,
//   dV[col] += p * dO[row],  dK[col] += ds * q[row],
// summed over every query head of the kv head's group, under the
// forward's masks (causal row >= col + offset, window col + offset > row
// - window, ragged sk). Masked pairs are zeroed before the exp, which
// overflows on a row with no visible key (lse = -1e30). dK and dV are
// float32.
//
// Bound on an H100 SXM at the training shape (b 8, sq = sk = 2048, h 8,
// kvh 4, d 64, causal, window 1024): 1,573,376 visible pairs per query
// head over b * h = 64, so 8 * d * pairs = 51.6 GFLOP per call against
// about 85 MB of inputs and outputs: bound by operations, 0.052 ms at
// the 989 TFLOP/s bf16 tensor-core rate (the bytes take 0.025 ms).
//
// Design. One block per (batch * kv head, 128-key tile): a producer
// warpgroup (one thread issues every load; setmaxnreg hands most of its
// registers to the consumers) and two consumer warpgroups of 64 keys
// each; K and V stay resident in shared memory. The producer walks
// every query head of the group and, for each, only the 64-row q tiles
// whose rows see the key tile (causal: from the diagonal down; window:
// up to window - 1 rows past the tile), and streams each tile's Q and
// dO (TMA, zero-filled past sq and d) with its 64 lse and delta values
// through a two-stage ring of full/empty mbarriers. lse and delta
// arrive (b, sq, h) with h innermost, so a head's 64 rows are 4 bytes
// apart, below TMA's 16-byte box minimum: the wrapper passes them
// transposed to (b, h, sq_pad), sq_pad a multiple of 64, and the
// producer copies each tile's 256 bytes with one bulk copy.
// Per q tile each consumer warpgroup computes S^T = K.Q^T and dP^T =
// V.dO^T with wgmma (all operands K-major), P^T and dS^T on the
// accumulator registers (exp2 with scale * log2(e) folded in; the mask
// only on tiles that cross the diagonal, the window edge, sq or sk), and
// adds dV += P^T.dO and dK += dS^T.Q with P^T and dS^T as register A
// operands and dO and Q read MN-major (the transpose flag) from the same
// swizzled tiles. dK and dV accumulate in f32 registers across the whole
// group and are written once: no atomics, deterministic.
//
// Precision. The Pallas kernel multiplies p and ds by float32 dO and q.
// Here P^T and dS^T go to the tensor cores split as bf16 hi + bf16 lo
// (two products each), which carries them to about 2^-16 of themselves,
// where bf16 alone departs by up to 2^-8 * sum |p dO| (|ds q|) per
// element; the split costs half again the tensor work of the two
// accumulations (12 d FLOP per pair, not 8).

#include "sm90_common.cuh"

namespace {

using namespace sm90;

constexpr int kBlockN = 128;  // keys per block: 2 warpgroups x 64
constexpr int kBlockM = 64;   // q rows per streamed tile
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
  static constexpr int kKVBytes = NB * kBlockN * kRowBytes;  // K or V
  static constexpr int kQBytes = NB * kBlockM * kRowBytes;   // Q or dO
  static constexpr int kRowVals = kBlockM * 4;               // lse or delta
  static constexpr int kK = 0;
  static constexpr int kV = kK + kKVBytes;
  static constexpr int kQ = kV + kKVBytes;            // + stage * kQBytes
  static constexpr int kDO = kQ + kStages * kQBytes;  // + stage * kQBytes
  static constexpr int kL = kDO + kStages * kQBytes;  // + stage * kRowVals
  static constexpr int kD = kL + kStages * kRowVals;  // + stage * kRowVals
  static constexpr int kBar = kD + kStages * kRowVals;
  // barriers: kv, full[kStages], empty[kStages]
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kStages);
};

template <int NB>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              const __grid_constant__ CUtensorMap tdo,
                              const float* __restrict__ lse_t,
                              const float* __restrict__ delta_t,
                              float* __restrict__ dk, float* __restrict__ dv,
                              int sq, int sk, int h, int kvh, int d,
                              int sq_pad, float scale, int causal, int window,
                              int offset) {
  using L = Smem<NB>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint8_t* smem = smem_raw + (base - raw);  // generic view of base
  const uint32_t kv_bar = base + L::kBar;
  const uint32_t full0 = kv_bar + 8;
  const uint32_t empty0 = full0 + 8 * kStages;

  const int tid = threadIdx.x;
  const int bi = blockIdx.y / kvh;
  const int kvi = blockIdx.y % kvh;
  const int group = h / kvh;
  const int kv0 = blockIdx.x * kBlockN;
  const int col_last = min(kv0 + kBlockN, sk) - 1;

  // rows that can see some key of the tile: causal bounds the top, the
  // window the bottom; q tiles outside [row_lo, row_hi) are never loaded
  int row_lo = 0, row_hi = sq;
  if (causal) row_lo = max(0, kv0 + offset);
  if (window > 0) row_hi = min(sq, col_last + offset + window);
  const int start = (row_lo / kBlockM) * kBlockM;
  const int n_rows =
      row_hi > start ? (row_hi - start + kBlockM - 1) / kBlockM : 0;
  const int n_tiles = group * n_rows;

  if (tid == 0) {
    mbar_init(kv_bar, 1);
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
      mbar_expect_tx(kv_bar, 2 * L::kKVBytes);
      for (int bx = 0; bx < NB; ++bx) {
        const int off = bx * kBlockN * kRowBytes;
        tma_load_4d(base + L::kK + off, &tk, kv_bar, bx * kBoxCols, kvi, kv0,
                    bi);
        tma_load_4d(base + L::kV + off, &tv, kv_bar, bx * kBoxCols, kvi, kv0,
                    bi);
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        const int hq = kvi * group + t / n_rows;
        const int row0 = start + (t % n_rows) * kBlockM;
        mbar_wait(empty0 + 8 * s, ((t / kStages) & 1) ^ 1);
        const uint32_t full = full0 + 8 * s;
        mbar_expect_tx(full, 2 * L::kQBytes + 2 * L::kRowVals);
        for (int bx = 0; bx < NB; ++bx) {
          const int off = s * L::kQBytes + bx * kBlockM * kRowBytes;
          tma_load_4d(base + L::kQ + off, &tq, full, bx * kBoxCols, hq, row0,
                      bi);
          tma_load_4d(base + L::kDO + off, &tdo, full, bx * kBoxCols, hq,
                      row0, bi);
        }
        const int64_t ri = ((int64_t)bi * h + hq) * sq_pad + row0;
        bulk_load(base + L::kL + s * L::kRowVals, lse_t + ri, L::kRowVals,
                  full);
        bulk_load(base + L::kD + s * L::kRowVals, delta_t + ri, L::kRowVals,
                  full);
      }
    }
    return;
  }
  reg_alloc<232>();

  // consumer warpgroup wg owns keys kv0 + 64 wg .. + 63; this thread keys
  // c0 and c0 + 8, and (in S^T) q rows 8 j + cq + {0, 1} of the tile
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int wg_col0 = kv0 + 64 * wg;
  const int c0 = wg_col0 + 16 * warp + lane / 4;
  const int cq = 2 * (lane % 4);
  const float scale_log2 = scale * kLog2e;

  float acc_k[NB][32], acc_v[NB][32];
#pragma unroll
  for (int bx = 0; bx < NB; ++bx)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc_k[bx][i] = acc_v[bx][i] = 0.f;

  const uint32_t k_tile = base + L::kK + wg * 64 * kRowBytes;
  const uint32_t v_tile = base + L::kV + wg * 64 * kRowBytes;
  mbar_wait(kv_bar, 0);

  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages;
    const int row0 = start + (t % n_rows) * kBlockM;
    mbar_wait(full0 + 8 * s, (t / kStages) & 1);
    const uint32_t q_tile = base + L::kQ + s * L::kQBytes;
    const uint32_t do_tile = base + L::kDO + s * L::kQBytes;
    const float* s_lse =
        reinterpret_cast<const float*>(smem + L::kL + s * L::kRowVals);
    const float* s_delta =
        reinterpret_cast<const float*>(smem + L::kD + s * L::kRowVals);

    // S^T = K . Q^T and dP^T = V . dO^T: 64 keys x 64 q rows each (the
    // first k-step overwrites the zeros, which only keep them defined)
    float st[32], dpt[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.f;
    fence_acc(st);
    fence_acc(dpt);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * NB; ++kk) {
      const int ka = (kk / 4) * kBlockN * kRowBytes + (kk % 4) * 32;
      const int kb = (kk / 4) * kBlockM * kRowBytes + (kk % 4) * 32;
      wgmma_ss<0>(st, desc_sw128(k_tile + ka), desc_sw128(q_tile + kb),
                  kk > 0);
      wgmma_ss<0>(dpt, desc_sw128(v_tile + ka), desc_sw128(do_tile + kb),
                  kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(st);
    fence_acc(dpt);

    // P^T and dS^T in place of S^T and dP^T; the mask only where the
    // tile crosses an edge of what the warpgroup's keys are seen from
    bool edge = row0 + kBlockM > sq || wg_col0 + 63 >= sk;
    if (causal) edge = edge || row0 < wg_col0 + 63 + offset;
    if (window > 0)
      edge = edge || wg_col0 + offset <= row0 + kBlockM - 1 - window;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int rr = 8 * (i / 4) + cq + (i % 2);  // q row in the tile
      const int col = c0 + 8 * ((i / 2) % 2);
      const int row = row0 + rr;
      bool ok = true;
      if (edge) {
        ok = row < sq && col < sk;
        if (causal) ok = ok && row >= col + offset;
        if (window > 0) ok = ok && col + offset > row - window;
      }
      const float x = ok ? fmaf(st[i], scale_log2, -s_lse[rr] * kLog2e)
                         : -INFINITY;
      const float p = exp2f(x);
      st[i] = p;
      dpt[i] = p * (dpt[i] - s_delta[rr]) * scale;
    }

    // dV += P^T . dO and dK += dS^T . Q, as bf16 hi + lo fragments
    uint32_t p_hi[4][4], p_lo[4][4], ds_hi[4][4], ds_lo[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      split_fragment(st, kk, p_hi[kk], p_lo[kk]);
      split_fragment(dpt, kk, ds_hi[kk], ds_lo[kk]);
      fence_frag(p_hi[kk]);
      fence_frag(p_lo[kk]);
      fence_frag(ds_hi[kk]);
      fence_frag(ds_lo[kk]);
    }
#pragma unroll
    for (int bx = 0; bx < NB; ++bx) {
      fence_acc(acc_k[bx]);
      fence_acc(acc_v[bx]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int bx = 0; bx < NB; ++bx) {
        const int off = bx * kBlockM * kRowBytes + kk * 16 * kRowBytes;
        const uint64_t b_do = desc_sw128(do_tile + off);
        const uint64_t b_q = desc_sw128(q_tile + off);
        wgmma_rs<1>(acc_v[bx], p_hi[kk], b_do);
        wgmma_rs<1>(acc_v[bx], p_lo[kk], b_do);
        wgmma_rs<1>(acc_k[bx], ds_hi[kk], b_q);
        wgmma_rs<1>(acc_k[bx], ds_lo[kk], b_q);
      }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int bx = 0; bx < NB; ++bx) {
      fence_acc(acc_k[bx]);
      fence_acc(acc_v[bx]);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      fence_frag(p_hi[kk]);
      fence_frag(p_lo[kk]);
      fence_frag(ds_hi[kk]);
      fence_frag(ds_lo[kk]);
    }
    mbar_arrive(empty0 + 8 * s);
  }

  // every element of the tile's valid keys written once
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int col = c0 + 8 * rr;
    if (col >= sk) continue;
    const int64_t off = (((int64_t)bi * sk + col) * kvh + kvi) * d;
#pragma unroll
    for (int bx = 0; bx < NB; ++bx)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = bx * kBoxCols + 8 * j + cq;
        if (c < d) {
          const int i = 4 * j + 2 * rr;
          *reinterpret_cast<float2*>(dk + off + c) =
              make_float2(acc_k[bx][i], acc_k[bx][i + 1]);
          *reinterpret_cast<float2*>(dv + off + c) =
              make_float2(acc_v[bx][i], acc_v[bx][i + 1]);
        }
      }
  }
}

template <int NB>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse_t, const void* delta_t,
                   void* dk, void* dv, int b, int sq, int sk, int h, int kvh,
                   int d, int sq_pad, float scale, int causal, int window,
                   int offset, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err = make_map(&tq, q, b, sq, h, d, kBlockM);
  if (err == cudaSuccess) err = make_map(&tdo, dout, b, sq, h, d, kBlockM);
  if (err == cudaSuccess) err = make_map(&tk, k, b, sk, kvh, d, kBlockN);
  if (err == cudaSuccess) err = make_map(&tv, v, b, sk, kvh, d, kBlockN);
  if (err != cudaSuccess) return err;
  constexpr int smem = Smem<NB>::kBytes + 1024;  // + alignment slack
  auto kernel = flash_bwd_dkv_sm90_kernel<NB>;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((sk + kBlockN - 1) / kBlockN, b * kvh);
  kernel<<<grid, kThreads, smem, stream>>>(
      tq, tk, tv, tdo, static_cast<const float*>(lse_t),
      static_cast<const float*>(delta_t), static_cast<float*>(dk),
      static_cast<float*>(dv), sq, sk, h, kvh, d, sq_pad, scale, causal,
      window, offset);
  return cudaGetLastError();
}

}  // namespace

// q and dout (b, sq, h, d), k and v (b, sk, kvh, d): contiguous bf16 with
// d a multiple of 8 up to 128 and 16-byte aligned bases; lse_t and
// delta_t (b, h, sq_pad) float32 with sq_pad a multiple of 64 at least sq
// (the tail never read as data); dk and dv (b, sk, kvh, d) float32, every
// element written. Launches on `stream` and returns cudaGetLastError().
extern "C" int lo_flash_bwd_dkv_sm90(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const void* lse_t, const void* delta_t,
                                     void* dk, void* dv, int b, int sq,
                                     int sk, int h, int kvh, int d,
                                     int sq_pad, float scale, int causal,
                                     int window, int offset, void* stream) {
  if (b < 1 || sq < 1 || sk < 1 || h < 1 || kvh < 1 || h % kvh != 0 ||
      d < 8 || d > 128 || d % 8 != 0 || (int64_t)b * kvh > 65535 ||
      sq_pad < sq || sq_pad % kBlockM != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 64)
    return (int)launch<1>(q, k, v, dout, lse_t, delta_t, dk, dv, b, sq, sk,
                          h, kvh, d, sq_pad, scale, causal, window, offset, s);
  return (int)launch<2>(q, k, v, dout, lse_t, delta_t, dk, dv, b, sq, sk, h,
                        kvh, d, sq_pad, scale, causal, window, offset, s);
}
