// Flash-attention backward, dK and dV, for Hopper (sm_90a), hand-written
// CUDA C++.
//
// Replaces: learningorchestra_tpu/ops/attention.py `_bwd_dkv_kernel` (the
// second Pallas TPU kernel of `_bwd_pallas`). Same function: with the
// forward's saved log-sum-exp `lse` and `delta = rowsum(dO * O) - dlse`,
// for every visible (row, col) pair
//   p  = exp(q.k * scale - lse),  dp = dO.v,
//   ds = p * (dp - delta) * scale,
//   dV[col] += p * dO[row],  dK[col] += ds * q[row],
// summed over every query head of the kv head's group, under the
// forward's masks: causal (row >= col + offset), a sliding window
// (col + offset > row - window), a ragged key edge (col < sk). Masked
// pairs are zeroed before the exp, which overflows on a row with no
// visible key (lse = -1e30).
//
// Bound on an H100 SXM at the training shape (b 8, sq = sk = 2048, h 8,
// kvh 4, d 64, causal, window 1024): 1,573,376 visible pairs per query
// head over b * h = 64, so 8 * d * pairs = 51.6 GFLOP per call against
// about 135 MB of fp32 inputs and outputs. That is compute bound: 0.770 ms
// at the 67 TFLOP/s fp32 rate (0.052 ms at the 989 TFLOP/s bf16
// tensor-core rate), while the bytes take 0.04 ms at 3.35 TB/s.
//
// What the design does about it. All four products run as fp32 FMAs on
// the CUDA cores, so the ceiling is the fp32 rate; tensor cores, TMA and
// pipelined loads are later work. One block owns one (batch * kv head,
// 64-key tile) and keeps K and V resident in shared memory; the loop
// inside the block walks every query head of the group and, for each,
// only the q tiles whose rows can see the kv tile (causal: from the
// diagonal down; window: up to window - 1 rows past the tile), streaming
// Q, dO, lse and delta through shared memory. The TPU accumulated over a
// sequential grid axis; here the whole sum stays inside one block, in
// registers, so dK and dV are written once, without atomics, and the
// result does not depend on scheduling. Four threads share a key: each
// scores 16 of the q tile's 64 rows and owns a quarter of the key's dK
// and dV columns.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockM = 64;     // q rows per streamed tile
constexpr int kBlockN = 64;     // keys per block
constexpr int kThreadsPerKey = 4;
constexpr int kThreads = kBlockN * kThreadsPerKey;
constexpr int kRowsPerThread = kBlockM / kThreadsPerKey;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <int DMAX>
constexpr size_t smem_bytes() {
  // K, V, Q, dO tiles with an odd row pitch (different banks for the rows
  // a warp reads together), P and dS transposed (key-major), lse, delta
  return sizeof(float) * (4 * kBlockN * (DMAX + 1) +
                          2 * kBlockN * (kBlockM + 1) + 2 * kBlockM);
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv,
                         int sq, int sk, int h, int kvh, int d, float scale,
                         int causal, int window, int offset) {
  constexpr int P = DMAX + 1;
  constexpr int PP = kBlockM + 1;
  constexpr int kAcc = DMAX / kThreadsPerKey;
  extern __shared__ float smem[];
  float* sK = smem;                 // kBlockN x P
  float* sV = sK + kBlockN * P;     // kBlockN x P
  float* sQ = sV + kBlockN * P;     // kBlockM x P
  float* sDO = sQ + kBlockM * P;    // kBlockM x P
  float* sP = sDO + kBlockM * P;    // kBlockN x PP: p, key-major
  float* sDS = sP + kBlockN * PP;   // kBlockN x PP: ds, key-major
  float* sL = sDS + kBlockN * PP;   // kBlockM lse
  float* sD = sL + kBlockM;         // kBlockM delta

  const int tid = threadIdx.x;
  const int j = tid / kThreadsPerKey;  // this thread's key in the tile
  const int sub = tid % kThreadsPerKey;
  const int bi = blockIdx.y / kvh;
  const int kvi = blockIdx.y % kvh;
  const int group = h / kvh;
  const int kv0 = blockIdx.x * kBlockN;
  const int col = kv0 + j;
  const int col_last = min(kv0 + kBlockN, sk) - 1;

  const int64_t q_stride = (int64_t)h * d;  // between sequence rows
  const int64_t kv_stride = (int64_t)kvh * d;
  const int64_t kv_off = (int64_t)bi * sk * kv_stride + (int64_t)kvi * d;

  for (int i = tid; i < kBlockN * DMAX; i += kThreads) {
    const int jj = i / DMAX, c = i % DMAX;
    const int gc = kv0 + jj;
    const bool in = gc < sk && c < d;
    const int64_t off = kv_off + (int64_t)gc * kv_stride + c;
    sK[jj * P + c] = in ? to_float(k[off]) : 0.f;
    sV[jj * P + c] = in ? to_float(v[off]) : 0.f;
  }

  // rows that can see some key of the tile: causal bounds the top, the
  // window the bottom; q tiles outside [row_lo, row_hi) are never loaded
  int row_lo = 0, row_hi = sq;
  if (causal) row_lo = max(0, kv0 + offset);
  if (window > 0) row_hi = min(sq, col_last + offset + window);
  const int start = (row_lo / kBlockM) * kBlockM;

  float acc_k[kAcc], acc_v[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc_k[i] = acc_v[i] = 0.f;

  for (int g = 0; g < group; ++g) {
    const int hq = kvi * group + g;
    const int64_t q_off = (int64_t)bi * sq * q_stride + (int64_t)hq * d;
    for (int row0 = start; row0 < row_hi; row0 += kBlockM) {
      __syncthreads();  // the previous q tile is no longer read
      for (int i = tid; i < kBlockM * DMAX; i += kThreads) {
        const int rr = i / DMAX, c = i % DMAX;
        const int gr = row0 + rr;
        const bool in = gr < sq && c < d;
        const int64_t off = q_off + (int64_t)gr * q_stride + c;
        sQ[rr * P + c] = in ? to_float(q[off]) : 0.f;
        sDO[rr * P + c] = in ? to_float(dout[off]) : 0.f;
      }
      if (tid < kBlockM) {
        const int gr = row0 + tid;
        const int64_t ri = ((int64_t)bi * sq + gr) * h + hq;
        sL[tid] = gr < sq ? lse[ri] : 0.f;
        sD[tid] = gr < sq ? delta[ri] : 0.f;
      }
      __syncthreads();

      float s[kRowsPerThread], dp[kRowsPerThread];
#pragma unroll
      for (int t = 0; t < kRowsPerThread; ++t) s[t] = dp[t] = 0.f;
#pragma unroll 4
      for (int c = 0; c < DMAX; ++c) {
        const float kc = sK[j * P + c];
        const float vc = sV[j * P + c];
#pragma unroll
        for (int t = 0; t < kRowsPerThread; ++t) {
          const int rr = sub + kThreadsPerKey * t;
          s[t] = fmaf(kc, sQ[rr * P + c], s[t]);
          dp[t] = fmaf(vc, sDO[rr * P + c], dp[t]);
        }
      }
#pragma unroll
      for (int t = 0; t < kRowsPerThread; ++t) {
        const int rr = sub + kThreadsPerKey * t;
        const int row = row0 + rr;
        bool ok = row < sq && col < sk;
        if (causal) ok = ok && row >= col + offset;
        if (window > 0) ok = ok && col + offset > row - window;
        // mask before the exp: on a row with no visible key lse = -1e30
        // and exp(s - lse) is inf
        const float p = ok ? expf(s[t] * scale - sL[rr]) : 0.f;
        sP[j * PP + rr] = p;
        sDS[j * PP + rr] = p * (dp[t] - sD[rr]) * scale;
      }
      __syncwarp();  // the key's four threads share a warp

#pragma unroll 4
      for (int rr = 0; rr < kBlockM; ++rr) {
        const float p = sP[j * PP + rr];
        const float ds = sDS[j * PP + rr];
#pragma unroll
        for (int i = 0; i < kAcc; ++i) {
          const int c = sub + kThreadsPerKey * i;
          acc_v[i] = fmaf(p, sDO[rr * P + c], acc_v[i]);
          acc_k[i] = fmaf(ds, sQ[rr * P + c], acc_k[i]);
        }
      }
    }
  }

  if (col < sk) {
    const int64_t off = kv_off + (int64_t)col * kv_stride;
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      const int c = sub + kThreadsPerKey * i;
      if (c < d) {
        dk[off + c] = acc_k[i];
        dv[off + c] = acc_v[i];
      }
    }
  }
}

template <typename T, int DMAX>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dk, void* dv, int b, int sq, int sk, int h, int kvh,
                   int d, float scale, int causal, int window, int offset,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DMAX>();
  auto kernel = flash_bwd_dkv_kernel<T, DMAX>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((sk + kBlockN - 1) / kBlockN, b * kvh);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), sq, sk, h, kvh, d,
      scale, causal, window, offset);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int b, int sq, int sk, int h,
                       int kvh, int d, float scale, int causal, int window,
                       int offset, cudaStream_t stream) {
  if (d <= 32)
    return launch<T, 32>(q, k, v, dout, lse, delta, dk, dv, b, sq, sk, h, kvh,
                         d, scale, causal, window, offset, stream);
  if (d <= 64)
    return launch<T, 64>(q, k, v, dout, lse, delta, dk, dv, b, sq, sk, h, kvh,
                         d, scale, causal, window, offset, stream);
  return launch<T, 128>(q, k, v, dout, lse, delta, dk, dv, b, sq, sk, h, kvh,
                        d, scale, causal, window, offset, stream);
}

}  // namespace

// q and dout (b, sq, h, d), k and v (b, sk, kvh, d), all contiguous in the
// dtype given by `dtype` (0 float32, 1 bfloat16); lse and delta (b, sq, h)
// float32; dk and dv (b, sk, kvh, d) float32, every element written.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int lo_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dk, void* dv, int b,
                                int sq, int sk, int h, int kvh, int d,
                                float scale, int causal, int window,
                                int offset, int dtype, void* stream) {
  if (b < 1 || sq < 1 || sk < 1 || h < 1 || kvh < 1 || h % kvh != 0 ||
      d < 1 || d > 128 || (int64_t)b * kvh > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch_d<float>(q, k, v, dout, lse, delta, dk, dv, b, sq, sk, h,
                            kvh, d, scale, causal, window, offset, s);
  else if (dtype == 1)
    err = dispatch_d<__nv_bfloat16>(q, k, v, dout, lse, delta, dk, dv, b, sq,
                                    sk, h, kvh, d, scale, causal, window,
                                    offset, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}
