// Flash-attention backward, dQ, on Hopper's tensor cores (sm_90a) as
// split TF32 (3xTF32), for float32 and bf16 inputs: warp-level mma.sync,
// cp.async double-buffered tiles, hand-written CUDA C++.
//
// Replaces: learningorchestra_tpu/ops/attention.py `_bwd_dq_kernel` (the
// first Pallas TPU kernel of `_bwd_pallas`) for float32 q/k/v/dO whose
// head_dim is a multiple of 8 up to 128, and for float32 or bf16 at every
// other head_dim up to 128 (bf16 at a multiple of 8 takes
// flash_bwd_dq_sm90.cu). Same function: with the forward's saved
// log-sum-exp `lse` and `delta = rowsum(dO * O) - dlse`, for every
// visible (row, col) pair
//   p  = exp(q.k * scale - lse),  dp = dO.v,
//   ds = p * (dp - delta) * scale,  dQ[row] += ds * k[col],
// under the forward's masks: causal (row >= col + offset), a sliding
// window (col + offset > row - window), a ragged key edge (col < sk) and
// grouped-query heads (query head i reads kv head i / (h / kvh)). A row
// that sees no key (lse = -1e30) gets dQ = 0: masked pairs are zeroed
// before the exp, which would overflow there. dQ is float32 in both.
//
// Bound on an H100 SXM at the training shape (b 8, sq = sk = 2048, h 8,
// kvh 4, d 64, causal, window 1024): 1,573,376 visible pairs per head
// over b * h = 64, so 6 * d * pairs = 38.7 GFLOP per call against about
// 135 MB of float32 inputs and outputs. Bound by operations: 0.577 ms at
// the 67 TFLOP/s float32 rate of the CUDA cores; as three TF32 products
// (18 * d * pairs = 116.0 GFLOP) 0.234 ms at the 495 TFLOP/s TF32
// tensor-core rate. The bytes take 0.04 ms at 3.35 TB/s. bf16 inputs run
// 8 * d TF32 FLOP per pair (Q.K^T and dO.V^T one product each, dS.K two).
//
// Design. Every product runs on the tensor cores, and loads overlap the
// products.
// - One block per (batch * head, 64-row q tile), four warps of 16 rows.
//   Q and dO stay resident in shared memory and each thread keeps the lse
//   and delta of its two rows in registers; the block walks only the kv
//   band its rows can see.
// - K and V tiles stream through two shared-memory stages with cp.async:
//   the next tile's copies are in flight while the warps multiply the
//   current one. The loop inside the block takes the place of the TPU's
//   sequential kv grid axis.
// - Per kv tile each warp computes S = Q.K^T and dP = dO.V^T (16 rows x N
//   keys) on m16n8k8 tf32 mma.sync, P and dS in the accumulator
//   registers, then dQ += dS.K with dS fed straight from the accumulators
//   as A fragments (the permuted k order of tf32x3_common.cuh) and K read
//   from the same row-major tile.
// - Every product is 3xTF32 for float32 inputs; each operand is split as
//   its fragment is read, which keeps one float32 copy of each tile in
//   shared memory. (Splitting the streamed K and V once per tile into hi
//   and lo planes, as the dK/dV kernel does with Q and dO, was no faster
//   here.) bf16 tiles stay bf16 in shared memory and are widened at the
//   fragment read, exactly; their lo terms drop out (mma_inputs,
//   mma_mixed).
// - Any head_dim up to 128: variants 16, 32, 64 and 128 columns wide (the
//   smallest that holds d), columns past d zero-filled, so every loop
//   runs over the variant's full width (at d 12 the width-16 variant
//   multiplies 16/12 of the products). Float32 rows at d % 4 == 0 with
//   16-byte aligned bases load in 16-byte cp.async chunks (the wide
//   variants); any other row in the widest granule that fits, or element
//   by element (load_rows_any). dQ is stored as float2 only where both
//   columns lie before d and the address is 8-byte aligned.
// - Masks only on tiles that cross an edge (causal diagonal, window,
//   ragged sq or sk) of what the warp's rows see; exp2 with scale *
//   log2(e) folded in.
// - dQ sums in float32 registers over the band and is written once: no
//   atomics, the same bits on every run.
// - Tiles: 32 keys per stage (N); 64- and 16-key stages were no faster
//   (scripts/tf32x3_tile_sweep.py). Registers: dQ takes d / 2 per thread
//   and S, dP N / 2 each; ptxas reports no spills.

#include "tf32x3_common.cuh"

namespace {

using namespace tf32x3;

constexpr int kBlockM = 64;  // q rows per block: 4 warps x 16
constexpr int kThreads = 128;

constexpr float kLog2e = 1.4426950408889634f;

template <typename T, int DMAX>
struct Tile {
  static constexpr int kN = 32;        // keys per stage
  static constexpr int kMinBlocks = 1;  // per SM
  // row pitch, elements: 16 bytes past the width
  static constexpr int kP = DMAX + 16 / static_cast<int>(sizeof(T));
  static constexpr int kQ = kBlockM * kP;           // Q or dO
  static constexpr int kKV = kN * kP;               // K or V, one stage
  static constexpr size_t kBytes = sizeof(T) * (2 * kQ + 4 * kKV);
};

// kWide: float32 rows at d % 4 == 0 from 16-byte aligned bases (16-byte
// loads, float2 stores); `gran` is the other variants' load granule
template <typename T, int DMAX, bool kWide>
__global__ void __launch_bounds__(kThreads, Tile<T, DMAX>::kMinBlocks)
    flash_bwd_dq_tf32x3_kernel(const T* __restrict__ q,
                               const T* __restrict__ k,
                               const T* __restrict__ v,
                               const T* __restrict__ dout,
                               const float* __restrict__ lse,
                               const float* __restrict__ delta,
                               float* __restrict__ dq, int sq, int sk, int h,
                               int kvh, int d, float scale, int causal,
                               int window, int offset, int gran) {
  using Tl = Tile<T, DMAX>;
  constexpr int N = Tl::kN, P = Tl::kP;
  constexpr int NT = N / 8;     // 8-key n-tiles of S per kv tile
  constexpr int DT = DMAX / 8;  // 8-column tiles of head_dim
  extern __shared__ float4 smem4[];
  T* sQ = reinterpret_cast<T*>(smem4);
  T* sDO = sQ + Tl::kQ;
  T* sK = sDO + Tl::kQ;          // + stage * kKV
  T* sV = sK + 2 * Tl::kKV;      // + stage * kKV

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
  load_tile<kBlockM, DMAX, kThreads, kWide>(sDO, dout + q_off, q_stride,
                                            row0, sq, d, P, gran);
  if (n_tiles > 0) issue(0);
  cp_async_commit();

  // this thread's rows: row_a and row_a + 8 (C rows g, g + 8)
  const int rr = 16 * warp + g;
  const int row_a = row0 + rr;
  const int w_row0 = row0 + 16 * warp;  // the warp's rows: w_row0 .. + 15
  const float scale_log2 = scale * kLog2e;
  float row_lse[2], row_delta[2];  // lse in log2 units
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + 8 * r;
    const int64_t ri = ((int64_t)bi * sq + row) * h + hi;
    row_lse[r] = row < sq ? lse[ri] * kLog2e : 0.f;
    row_delta[r] = row < sq ? delta[ri] : 0.f;
  }
  const T* qw = sQ + rr * P + t;
  const T* dw = sDO + rr * P + t;

  float acc[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int tile = 0; tile < n_tiles; ++tile) {
    if (tile + 1 < n_tiles) issue(tile + 1);
    cp_async_commit();
    cp_async_wait<1>();  // this tile's copies (and Q, dO) have landed
    __syncthreads();
    const int s = tile % 2;
    const int kv0 = start + tile * N;
    const T* tk = sK + s * Tl::kKV;
    const T* tv = sV + s * Tl::kKV;

    // S = Q.K^T and dP = dO.V^T: 16 rows x N keys per warp
    float st[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dp[j][e] = 0.f;
    for (int c = 0; c < DMAX; c += 8) {
      uint32_t qa_hi[4], qa_lo[4], da_hi[4], da_lo[4];
      load_a(qw + c, P, qa_hi, qa_lo);
      load_a(dw + c, P, da_hi, da_lo);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const T* kr = tk + (8 * j + g) * P + c + t;
        const T* vr = tv + (8 * j + g) * P + c + t;
        uint32_t b_hi[2], b_lo[2];
        load_b(kr[0], kr[4], b_hi, b_lo);
        mma_inputs<T>(st[j], qa_hi, qa_lo, b_hi, b_lo);
        load_b(vr[0], vr[4], b_hi, b_lo);
        mma_inputs<T>(dp[j], da_hi, da_lo, b_hi, b_lo);
      }
    }

    // dS in place of dP: element e is row row_a + 8 (e / 2), key kv0 +
    // 8 j + 2 t + e % 2; the mask only where the tile crosses an edge of
    // what the warp's rows see (exp2 with scale * log2(e) folded in)
    bool edge = w_row0 + 15 >= sq || kv0 + N > sk;
    if (causal) edge = edge || w_row0 < kv0 + N - 1 + offset;
    if (window > 0) edge = edge || kv0 + offset <= w_row0 + 15 - window;
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
        const float p =
            ok ? exp2f(fmaf(st[j][e], scale_log2, -row_lse[r])) : 0.f;
        dp[j][e] = ok ? p * (dp[j][e] - row_delta[r]) * scale : 0.f;
      }

    // dQ += dS.K: k-step j runs over keys 8 j .. 8 j + 7 in the permuted
    // order, so B takes K rows 8 j + 2 t (+ 1)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      uint32_t ds_hi[4], ds_lo[4];
      c_to_a(dp[j], ds_hi, ds_lo);
      const T* k0 = tk + (8 * j + 2 * t) * P + g;
#pragma unroll
      for (int n = 0; n < DT; ++n) {
        uint32_t b_hi[2], b_lo[2];
        load_b(k0[8 * n], k0[P + 8 * n], b_hi, b_lo);
        mma_mixed<T>(acc[n], ds_hi, ds_lo, b_hi, b_lo);
      }
    }
    __syncthreads();  // the stage is read; the next issue may refill it
  }

  // C layout: acc[n][2 r + i] is row row_a + 8 r, column 8 n + 2 t + i
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + 8 * r;
    if (row >= sq) continue;
    float* drow = dq + q_off + (int64_t)row * q_stride;
#pragma unroll
    for (int n = 0; n < DT; ++n) {
      const int c = 8 * n + 2 * t;
      if constexpr (kWide) {
        if (c < d)
          *reinterpret_cast<float2*>(drow + c) =
              make_float2(acc[n][2 * r], acc[n][2 * r + 1]);
      } else {
        store_pair(drow, c, d, acc[n][2 * r], acc[n][2 * r + 1]);
      }
    }
  }
}

template <typename T, int DMAX, bool kWide>
cudaError_t launch(const T* q, const T* k, const T* v, const T* dout,
                   const float* lse, const float* delta, float* dq, int b,
                   int sq, int sk, int h, int kvh, int d, float scale,
                   int causal, int window, int offset, int gran,
                   cudaStream_t stream) {
  constexpr size_t smem = Tile<T, DMAX>::kBytes;
  auto kernel = flash_bwd_dq_tf32x3_kernel<T, DMAX, kWide>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + kBlockM - 1) / kBlockM, b * h);
  kernel<<<grid, kThreads, smem, stream>>>(q, k, v, dout, lse, delta, dq, sq,
                                           sk, h, kvh, d, scale, causal,
                                           window, offset, gran);
  return cudaGetLastError();
}

// the variant whose width (16, 32, 64 or 128 columns) is the smallest
// that holds d
template <typename T, bool kWide>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dq, int b, int sq, int sk, int h, int kvh, int d,
                     float scale, int causal, int window, int offset,
                     int gran, cudaStream_t s) {
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tdo = static_cast<const T*>(dout);
  const float* fl = static_cast<const float*>(lse);
  const float* fd = static_cast<const float*>(delta);
  float* odq = static_cast<float*>(dq);
  if (d <= 16)
    return launch<T, 16, kWide>(tq, tk, tv, tdo, fl, fd, odq, b, sq, sk, h,
                                kvh, d, scale, causal, window, offset, gran,
                                s);
  if (d <= 32)
    return launch<T, 32, kWide>(tq, tk, tv, tdo, fl, fd, odq, b, sq, sk, h,
                                kvh, d, scale, causal, window, offset, gran,
                                s);
  if (d <= 64)
    return launch<T, 64, kWide>(tq, tk, tv, tdo, fl, fd, odq, b, sq, sk, h,
                                kvh, d, scale, causal, window, offset, gran,
                                s);
  return launch<T, 128, kWide>(tq, tk, tv, tdo, fl, fd, odq, b, sq, sk, h,
                               kvh, d, scale, causal, window, offset, gran,
                               s);
}

}  // namespace

// q and dout (b, sq, h, d), k and v (b, sk, kvh, d): contiguous, float32
// (dtype 0) or bf16 (dtype 1), 1 <= d <= 128, any base aligned to the
// element; lse and delta (b, sq, h) float32; dq (b, sq, h, d) float32,
// every element written. Launches on `stream` and returns
// cudaGetLastError().
extern "C" int lo_flash_bwd_dq_tf32x3(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* delta,
                                      void* dq, int b, int sq, int sk, int h,
                                      int kvh, int d, float scale, int causal,
                                      int window, int offset, int dtype,
                                      void* stream) {
  if (b < 1 || sq < 1 || sk < 1 || h < 1 || kvh < 1 || h % kvh != 0 ||
      d < 1 || d > 128 || (dtype != 0 && dtype != 1) ||
      (int64_t)b * h > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* bases[] = {q, k, v, dout};
  const int gran = granule(d * (dtype == 1 ? 2 : 4), bases, 4);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16, false>(q, k, v, dout, lse, delta, dq,
                                               b, sq, sk, h, kvh, d, scale,
                                               causal, window, offset, gran,
                                               s);
  if (gran == 16)
    return (int)dispatch<float, true>(q, k, v, dout, lse, delta, dq, b, sq,
                                      sk, h, kvh, d, scale, causal, window,
                                      offset, gran, s);
  return (int)dispatch<float, false>(q, k, v, dout, lse, delta, dq, b, sq, sk,
                                     h, kvh, d, scale, causal, window, offset,
                                     gran, s);
}
