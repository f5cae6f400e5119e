// Flash-attention forward on Hopper's tensor cores (sm_90a) as split
// TF32 (3xTF32), for float32 and bf16 inputs: warp-level mma.sync,
// cp.async double-buffered tiles, hand-written CUDA C++.
//
// Replaces: learningorchestra_tpu/ops/attention.py `_fwd_kernel` (the
// Pallas TPU kernel launched by `_fwd_pallas`) for float32 q/k/v at any
// head_dim up to 128, and for bf16 at every head_dim up to 128 that is
// not a multiple of 8 (bf16 at a multiple of 8 takes flash_fwd_sm90.cu).
// Same function: the exact softmax attention output O (in q's dtype)
// plus a per-row log-sum-exp, with causal masking (row >= col + offset),
// a sliding window (col + offset > row - window), a ragged key edge (col
// < sk) and grouped-query heads (query head i reads kv head i / (h /
// kvh)). A row that sees no key gets o = 0 and lse = -1e30, exactly.
//
// Bound on an H100 SXM. Training shape (b 8, sq = sk = 2048, h 8, kvh 4,
// d 64, causal, window 1024): 1,573,376 visible pairs per head over b *
// h = 64, so 4 * d * pairs = 25.8 GFLOP per call against about 84 MB of
// float32 inputs and outputs. Bound by operations: 0.385 ms at the 67
// TFLOP/s float32 rate of the CUDA cores; as three TF32 products (12 * d
// * pairs = 77.3 GFLOP) 0.156 ms at the 495 TFLOP/s TF32 tensor-core
// rate. The bytes take 0.025 ms at 3.35 TB/s. The serving prefill shape
// (b 1, 1536 tokens) is a tenth of that work: 0.032 ms fp32, 0.013 ms
// 3xTF32. bf16 inputs run 6 * d TF32 FLOP per pair (Q.K^T one product, P.V
// two), and their bound is 4 * d FLOP per pair at the 989 TFLOP/s bf16
// rate.
//
// Design. Every product runs on the tensor cores, and loads overlap the
// products. The structure is that of flash_bwd_dq_tf32x3.cu less dO, dP
// and delta, plus the online softmax.
// - One block per (batch * head, 64-row q tile), four warps of 16 rows.
//   Q stays resident in shared memory; the block walks only the kv band
//   its rows can see.
// - K and V tiles stream through two shared-memory stages with cp.async:
//   the next tile's copies are in flight while the warps multiply the
//   current one. The loop inside the block takes the place of the TPU's
//   sequential kv grid axis.
// - Per kv tile each warp computes S = Q.K^T (16 rows x N keys) on
//   m16n8k8 tf32 mma.sync, then the online softmax in registers: in log2
//   units with scale * log2(e) folded in (exp2), the row max reduced over
//   the quad of lanes that holds a row (__shfl_xor_sync over offsets 1
//   and 2), O rescaled by exp2(m_prev - m_new). Each lane keeps its own
//   share of the row sum l, reduced over the quad once at the end.
// - O += P.V with P fed straight from the S accumulators as A fragments
//   (the permuted k order of tf32x3_common.cuh) and V read from its
//   row-major tile in that order.
// - Every product is 3xTF32 for float32 inputs; each operand is split as
//   its fragment is read, which keeps one float32 copy of each tile in
//   shared memory. bf16 tiles stay bf16 in shared memory and are widened
//   at the fragment read, exactly: Q.K^T is one product (mma_inputs) and
//   P.V two (mma_mixed: P is float32 and split, V exact).
// - Any head_dim up to 128: variants 16, 32, 64 and 128 columns wide (the
//   smallest that holds d), columns past d and rows past sq or sk
//   zero-filled, so every loop runs over the variant's full width and no
//   NaN reaches a product; rows past sq are never written. Float32 rows at
//   d % 4 == 0 from 16-byte aligned bases load in 16-byte cp.async chunks
//   and store float2 pairs (kWide: the float32 code of the d % 8 route,
//   operation for operation); any other row loads in the widest granule
//   that fits, or element by element (load_rows_any), and stores a pair
//   only where both columns lie before d and the address is aligned
//   (store_pair), since at odd d a pair would cross into the next head's
//   row.
// - Masks only on tiles that cross an edge (causal diagonal, window,
//   ragged sq or sk) of what the warp's rows see. A masked element gets
//   p = 0 explicitly, so a row that has seen no key keeps m = -1e30, l =
//   0 and o = 0.
// - O and lse are written once from registers: no atomics, the same bits
//   on every run.
// - Tiles: 32 keys per stage (N), registers capped for 3 blocks per SM at
//   d <= 64. At the training shape 32 keys at 3 blocks beat 64 keys by 5%
//   and 32 keys at the uncapped 2 blocks by 10%; at the serving shape (192
//   blocks, under two waves) 64 keys are 5% faster and the cap does not
//   matter. At width 16 (the d-12 LM's 512 blocks, float32 and bf16) 32
//   keys beat 64 by 4-11% and 16 by 15-16%, and a cap of 2, 3 or 4 blocks
//   gives the same time within 1%: the variant needs 127 registers
//   (float32) or 107 (bf16), which fit 4 blocks uncapped
//   (scripts/tf32x3_tile_sweep.py). Registers: O takes d / 2 per thread
//   and S N / 2; ptxas must report no spills.

#include "tf32x3_common.cuh"

namespace {

using namespace tf32x3;

constexpr int kBlockM = 64;  // q rows per block: 4 warps x 16
constexpr int kThreads = 128;

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kNegInf = -1e30f;

template <typename T, int DMAX>
struct Tile {
  static constexpr int kN = 32;  // keys per stage
  // blocks per SM ptxas must fit (a register cap) at d <= 64
  static constexpr int kMinBlocks = DMAX == 128 ? 1 : 3;
  // row pitch, elements: 16 bytes past the width
  static constexpr int kP = DMAX + 16 / static_cast<int>(sizeof(T));
  static constexpr int kQ = kBlockM * kP;  // Q
  static constexpr int kKV = kN * kP;      // K or V, one stage
  static constexpr size_t kBytes = sizeof(T) * (kQ + 4 * kKV);
};

// kWide: float32 rows at d % 4 == 0 from 16-byte aligned bases (16-byte
// loads, float2 stores); `gran` is the other variants' load granule
template <typename T, int DMAX, bool kWide>
__global__ void __launch_bounds__(kThreads, Tile<T, DMAX>::kMinBlocks)
    flash_fwd_tf32x3_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, T* __restrict__ o,
                            float* __restrict__ lse, int sq, int sk, int h,
                            int kvh, int d, float scale, int causal,
                            int window, int offset, int gran) {
  using Tl = Tile<T, DMAX>;
  constexpr int N = Tl::kN, P = Tl::kP;
  constexpr int NT = N / 8;     // 8-key n-tiles of S per kv tile
  constexpr int DT = DMAX / 8;  // 8-column tiles of head_dim
  extern __shared__ float4 smem4[];
  T* sQ = reinterpret_cast<T*>(smem4);
  T* sK = sQ + Tl::kQ;        // + stage * kKV
  T* sV = sK + 2 * Tl::kKV;   // + stage * kKV

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int bi = blockIdx.y / h;
  const int hi = blockIdx.y % h;
  const int kvi = hi / (h / kvh);
  const int row0 = blockIdx.x * kBlockM;
  const int row_last = min(row0 + kBlockM, sq) - 1;

  const int64_t q_stride = (int64_t)h * d;  // between sequence rows
  const int64_t kv_stride = (int64_t)kvh * d;
  const int64_t q_off = (int64_t)bi * sq * q_stride + (int64_t)hi * d;
  const int64_t kv_off = (int64_t)bi * sk * kv_stride + (int64_t)kvi * d;

  // the kv band the tile's rows can see
  int lo = 0, hi_col = sk;
  if (causal) hi_col = min(sk, row_last - offset + 1);
  if (window > 0) lo = max(0, row0 - window - offset + 1);
  const int start = (lo / N) * N;
  const int n_tiles = hi_col > start ? (hi_col - start + N - 1) / N : 0;

  // stage `tile % 2` <- K and V of tile `tile`
  auto issue = [&](int tile) {
    const int s = tile % 2;
    const int kv0 = start + tile * N;
    load_tile<N, DMAX, kThreads, kWide>(sK + s * Tl::kKV, k + kv_off,
                                        kv_stride, kv0, sk, d, P, gran);
    load_tile<N, DMAX, kThreads, kWide>(sV + s * Tl::kKV, v + kv_off,
                                        kv_stride, kv0, sk, d, P, gran);
  };

  load_tile<kBlockM, DMAX, kThreads, kWide>(sQ, q + q_off, q_stride, row0,
                                            sq, d, P, gran);
  if (n_tiles > 0) issue(0);
  cp_async_commit();

  // this thread's rows: row_a and row_a + 8 (C rows g, g + 8)
  const int rr = 16 * warp + g;
  const int row_a = row0 + rr;
  const int w_row0 = row0 + 16 * warp;  // the warp's rows: w_row0 .. + 15
  const float scale_log2 = scale * kLog2e;
  const T* qw = sQ + rr * P + t;

  // running max (log2 units, the whole row's) and this lane's share of
  // the running sum, per row
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int tile = 0; tile < n_tiles; ++tile) {
    if (tile + 1 < n_tiles) issue(tile + 1);
    cp_async_commit();
    cp_async_wait<1>();  // this tile's copies (and Q) have landed
    __syncthreads();
    const int s = tile % 2;
    const int kv0 = start + tile * N;
    const T* tk = sK + s * Tl::kKV;
    const T* tv = sV + s * Tl::kKV;

    // S = Q.K^T: 16 rows x N keys per warp
    float st[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = 0.f;
    for (int c = 0; c < DMAX; c += 8) {
      uint32_t qa_hi[4], qa_lo[4];
      load_a(qw + c, P, qa_hi, qa_lo);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const T* kr = tk + (8 * j + g) * P + c + t;
        uint32_t b_hi[2], b_lo[2];
        load_b(kr[0], kr[4], b_hi, b_lo);
        mma_inputs<T>(st[j], qa_hi, qa_lo, b_hi, b_lo);
      }
    }

    // scores in log2 units; element e is row row_a + 8 (e / 2), key kv0 +
    // 8 j + 2 t + e % 2; the mask only where the tile crosses an edge of
    // what the warp's rows see
    bool edge = w_row0 + 15 >= sq || kv0 + N > sk;
    if (causal) edge = edge || w_row0 < kv0 + N - 1 + offset;
    if (window > 0) edge = edge || kv0 + offset <= w_row0 + 15 - window;
    float tile_max[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        bool ok = true;
        if (edge) {
          const int row = row_a + 8 * r;
          const int col = kv0 + 8 * j + 2 * t + (e & 1);
          ok = row < sq && col < sk;
          if (causal) ok = ok && row >= col + offset;
          if (window > 0) ok = ok && col + offset > row - window;
        }
        st[j][e] = ok ? st[j][e] * scale_log2 : kNegInf;
        tile_max[r] = fmaxf(tile_max[r], st[j][e]);
      }

    // online softmax: the row's max over its quad, O and l rescaled by
    // exp2(m_prev - m_new); a masked key (score kNegInf) gets p = 0
    // explicitly, since exp2(kNegInf - kNegInf) = 1 on a row that has seen
    // nothing yet
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      tile_max[r] = fmaxf(tile_max[r],
                          __shfl_xor_sync(0xffffffffu, tile_max[r], 1));
      tile_max[r] = fmaxf(tile_max[r],
                          __shfl_xor_sync(0xffffffffu, tile_max[r], 2));
      const float m_new = fmaxf(m[r], tile_max[r]);
      alpha[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float p =
            st[j][e] > kNegInf ? exp2f(st[j][e] - m[r]) : 0.f;
        st[j][e] = p;
        l[r] += p;
      }
#pragma unroll
    for (int n = 0; n < DT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];

    // O += P.V: k-step j runs over keys 8 j .. 8 j + 7 in the permuted
    // order, so B takes V rows 8 j + 2 t (+ 1)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      uint32_t p_hi[4], p_lo[4];
      c_to_a(st[j], p_hi, p_lo);
      const T* v0 = tv + (8 * j + 2 * t) * P + g;
#pragma unroll
      for (int n = 0; n < DT; ++n) {
        uint32_t b_hi[2], b_lo[2];
        load_b(v0[8 * n], v0[P + 8 * n], b_hi, b_lo);
        mma_mixed<T>(acc[n], p_hi, p_lo, b_hi, b_lo);
      }
    }
    __syncthreads();  // the stage is read; the next issue may refill it
  }

  // the row sum over the quad; C layout: acc[n][2 r + i] is row row_a +
  // 8 r, column 8 n + 2 t + i
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = row_a + 8 * r;
    if (row >= sq) continue;
    const bool seen = l[r] > 0.f;
    const float inv = seen ? 1.f / l[r] : 0.f;
    T* orow = o + q_off + (int64_t)row * q_stride;
#pragma unroll
    for (int n = 0; n < DT; ++n) {
      const int c = 8 * n + 2 * t;
      if constexpr (kWide) {
        if (c < d)
          *reinterpret_cast<float2*>(orow + c) =
              make_float2(acc[n][2 * r] * inv, acc[n][2 * r + 1] * inv);
      } else {
        store_pair(orow, c, d, acc[n][2 * r] * inv, acc[n][2 * r + 1] * inv);
      }
    }
    if (t == 0)
      lse[((int64_t)bi * sq + row) * h + hi] =
          seen ? (m[r] + log2f(l[r])) * kLn2 : kNegInf;
  }
}

template <typename T, int DMAX, bool kWide>
cudaError_t launch(const T* q, const T* k, const T* v, T* o, float* lse,
                   int b, int sq, int sk, int h, int kvh, int d, float scale,
                   int causal, int window, int offset, int gran,
                   cudaStream_t stream) {
  constexpr size_t smem = Tile<T, DMAX>::kBytes;
  auto kernel = flash_fwd_tf32x3_kernel<T, DMAX, kWide>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + kBlockM - 1) / kBlockM, b * h);
  kernel<<<grid, kThreads, smem, stream>>>(q, k, v, o, lse, sq, sk, h, kvh,
                                           d, scale, causal, window, offset,
                                           gran);
  return cudaGetLastError();
}

// the variant whose width (16, 32, 64 or 128 columns) is the smallest
// that holds d
template <typename T, bool kWide>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     void* lse, int b, int sq, int sk, int h, int kvh, int d,
                     float scale, int causal, int window, int offset,
                     int gran, cudaStream_t s) {
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  T* to = static_cast<T*>(o);
  float* fl = static_cast<float*>(lse);
  if (d <= 16)
    return launch<T, 16, kWide>(tq, tk, tv, to, fl, b, sq, sk, h, kvh, d,
                                scale, causal, window, offset, gran, s);
  if (d <= 32)
    return launch<T, 32, kWide>(tq, tk, tv, to, fl, b, sq, sk, h, kvh, d,
                                scale, causal, window, offset, gran, s);
  if (d <= 64)
    return launch<T, 64, kWide>(tq, tk, tv, to, fl, b, sq, sk, h, kvh, d,
                                scale, causal, window, offset, gran, s);
  return launch<T, 128, kWide>(tq, tk, tv, to, fl, b, sq, sk, h, kvh, d,
                               scale, causal, window, offset, gran, s);
}

}  // namespace

// q (b, sq, h, d), k and v (b, sk, kvh, d), o like q: contiguous, float32
// (dtype 0) or bf16 (dtype 1), 1 <= d <= 128, any base aligned to the
// element; lse (b, sq, h) float32, every element of o and lse written.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int lo_flash_fwd_tf32x3(const void* q, const void* k,
                                   const void* v, void* o, void* lse, int b,
                                   int sq, int sk, int h, int kvh, int d,
                                   float scale, int causal, int window,
                                   int offset, int dtype, void* stream) {
  if (b < 1 || sq < 1 || sk < 1 || h < 1 || kvh < 1 || h % kvh != 0 ||
      d < 1 || d > 128 || (dtype != 0 && dtype != 1) ||
      (int64_t)b * h > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* bases[] = {q, k, v};
  const int gran = granule(d * (dtype == 1 ? 2 : 4), bases, 3);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16, false>(q, k, v, o, lse, b, sq, sk, h,
                                               kvh, d, scale, causal, window,
                                               offset, gran, s);
  if (gran == 16)
    return (int)dispatch<float, true>(q, k, v, o, lse, b, sq, sk, h, kvh, d,
                                      scale, causal, window, offset, gran, s);
  return (int)dispatch<float, false>(q, k, v, o, lse, b, sq, sk, h, kvh, d,
                                     scale, causal, window, offset, gran, s);
}
