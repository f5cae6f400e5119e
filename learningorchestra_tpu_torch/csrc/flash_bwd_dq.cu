// Flash-attention backward, dQ, for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces: learningorchestra_tpu/ops/attention.py `_bwd_dq_kernel` (the
// first Pallas TPU kernel of `_bwd_pallas`). Same function: with the
// forward's saved log-sum-exp `lse` and `delta = rowsum(dO * O) - dlse`,
// for every visible (row, col) pair
//   p  = exp(q.k * scale - lse),  dp = dO.v,
//   ds = p * (dp - delta) * scale,  dQ[row] += ds * k[col],
// under the forward's masks: causal (row >= col + offset), a sliding
// window (col + offset > row - window), a ragged key edge (col < sk) and
// grouped-query heads (query head i reads kv head i / (h / kvh)). A row
// that sees no key (lse = -1e30) gets dQ = 0: masked pairs are zeroed
// before the exp, which would overflow there.
//
// Bound on an H100 SXM at the training shape (b 8, sq = sk = 2048, h 8,
// kvh 4, d 64, causal, window 1024): 1,573,376 visible pairs per head
// over b * h = 64, so 6 * d * pairs = 38.7 GFLOP per call against about
// 135 MB of fp32 inputs and outputs. That is compute bound: 0.577 ms at
// the 67 TFLOP/s fp32 rate (0.039 ms at the 989 TFLOP/s bf16 tensor-core
// rate), while the bytes take 0.04 ms at 3.35 TB/s.
//
// What the design does about it. Like flash_fwd.cu, this first version
// runs all three products as fp32 FMAs on the CUDA cores, so its ceiling
// is the fp32 rate; tensor cores, TMA and pipelined loads are later work.
// It spends nothing on tiles the q tile cannot see: the kv loop covers
// only the band [lo, hi) of the tile. One block owns one (batch * head,
// 64-row q tile) and keeps Q, dO, lse and delta resident; K and V tiles
// of 64 keys stream through shared memory and the loop inside the block
// takes the place of the TPU's sequential kv grid axis, so dQ sums in
// registers and is written once, without atomics. Four threads share a q
// row: each scores 16 of the tile's 64 keys and owns a quarter of dQ's
// columns.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockM = 64;     // q rows per block
constexpr int kBlockN = 64;     // keys per kv tile
constexpr int kThreadsPerRow = 4;
constexpr int kThreads = kBlockM * kThreadsPerRow;
constexpr int kColsPerThread = kBlockN / kThreadsPerRow;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <int DMAX>
constexpr size_t smem_bytes() {
  // rows read together by a warp use an odd pitch so they fall in
  // different banks
  return sizeof(float) *
         (4 * kBlockM * (DMAX + 1) + kBlockM * (kBlockN + 1));
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        float* __restrict__ dq, int sq, int sk, int h,
                        int kvh, int d, float scale, int causal, int window,
                        int offset) {
  constexpr int P = DMAX + 1;
  constexpr int PP = kBlockN + 1;
  constexpr int kAcc = DMAX / kThreadsPerRow;
  extern __shared__ float smem[];
  float* sQ = smem;               // kBlockM x P
  float* sDO = sQ + kBlockM * P;  // kBlockM x P
  float* sK = sDO + kBlockM * P;  // kBlockN x P
  float* sV = sK + kBlockN * P;   // kBlockN x P
  float* sS = sV + kBlockN * P;   // kBlockM x PP: ds of the tile

  const int tid = threadIdx.x;
  const int r = tid / kThreadsPerRow;
  const int sub = tid % kThreadsPerRow;
  const int bi = blockIdx.y / h;
  const int hi = blockIdx.y % h;
  const int kvi = hi / (h / kvh);
  const int row0 = blockIdx.x * kBlockM;
  const int row = row0 + r;
  const int row_last = min(row0 + kBlockM, sq) - 1;

  const int64_t q_stride = (int64_t)h * d;  // between sequence rows
  const int64_t kv_stride = (int64_t)kvh * d;
  const int64_t q_off = (int64_t)bi * sq * q_stride + (int64_t)hi * d;
  const T* kb = k + (int64_t)bi * sk * kv_stride + (int64_t)kvi * d;
  const T* vb = v + (int64_t)bi * sk * kv_stride + (int64_t)kvi * d;

  for (int i = tid; i < kBlockM * DMAX; i += kThreads) {
    const int rr = i / DMAX, c = i % DMAX;
    const int gr = row0 + rr;
    const bool in = gr < sq && c < d;
    const int64_t off = q_off + (int64_t)gr * q_stride + c;
    sQ[rr * P + c] = in ? to_float(q[off]) : 0.f;
    sDO[rr * P + c] = in ? to_float(dout[off]) : 0.f;
  }
  float row_lse = 0.f, row_delta = 0.f;
  if (row < sq) {
    const int64_t ri = ((int64_t)bi * sq + row) * h + hi;
    row_lse = lse[ri];
    row_delta = delta[ri];
  }

  int lo = 0, hi_col = sk;
  if (causal) hi_col = min(sk, row_last - offset + 1);
  if (window > 0) lo = max(0, row0 - window - offset + 1);
  const int start = (lo / kBlockN) * kBlockN;

  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;

  for (int kv0 = start; kv0 < hi_col; kv0 += kBlockN) {
    __syncthreads();  // the previous tile is no longer read
    for (int i = tid; i < kBlockN * DMAX; i += kThreads) {
      const int j = i / DMAX, c = i % DMAX;
      const int col = kv0 + j;
      const bool in = col < sk && c < d;
      const int64_t off = (int64_t)col * kv_stride + c;
      sK[j * P + c] = in ? to_float(kb[off]) : 0.f;
      sV[j * P + c] = in ? to_float(vb[off]) : 0.f;
    }
    __syncthreads();

    float s[kColsPerThread], dp[kColsPerThread];
#pragma unroll
    for (int t = 0; t < kColsPerThread; ++t) s[t] = dp[t] = 0.f;
#pragma unroll 4
    for (int c = 0; c < DMAX; ++c) {
      const float qv = sQ[r * P + c];
      const float gv = sDO[r * P + c];
#pragma unroll
      for (int t = 0; t < kColsPerThread; ++t) {
        const int j = sub + kThreadsPerRow * t;
        s[t] = fmaf(qv, sK[j * P + c], s[t]);
        dp[t] = fmaf(gv, sV[j * P + c], dp[t]);
      }
    }
#pragma unroll
    for (int t = 0; t < kColsPerThread; ++t) {
      const int j = sub + kThreadsPerRow * t;
      const int col = kv0 + j;
      bool ok = row < sq && col < sk;
      if (causal) ok = ok && row >= col + offset;
      if (window > 0) ok = ok && col + offset > row - window;
      // mask before the exp: on a row with no visible key lse = -1e30
      // and exp(s - lse) is inf
      const float p = ok ? expf(s[t] * scale - row_lse) : 0.f;
      sS[r * PP + j] = p * (dp[t] - row_delta) * scale;
    }
    __syncwarp();  // the row's four threads share a warp

#pragma unroll 4
    for (int j = 0; j < kBlockN; ++j) {
      const float ds = sS[r * PP + j];
#pragma unroll
      for (int i = 0; i < kAcc; ++i)
        acc[i] = fmaf(ds, sK[j * P + sub + kThreadsPerRow * i], acc[i]);
    }
  }

  if (row < sq) {
    float* drow = dq + q_off + (int64_t)row * q_stride;
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      const int c = sub + kThreadsPerRow * i;
      if (c < d) drow[c] = acc[i];
    }
  }
}

template <typename T, int DMAX>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dq, int b, int sq, int sk, int h, int kvh, int d,
                   float scale, int causal, int window, int offset,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DMAX>();
  auto kernel = flash_bwd_dq_kernel<T, DMAX>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + kBlockM - 1) / kBlockM, b * h);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq), sq, sk, h, kvh, d, scale, causal, window,
      offset);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dq, int b, int sq, int sk, int h, int kvh, int d,
                       float scale, int causal, int window, int offset,
                       cudaStream_t stream) {
  if (d <= 32)
    return launch<T, 32>(q, k, v, dout, lse, delta, dq, b, sq, sk, h, kvh, d,
                         scale, causal, window, offset, stream);
  if (d <= 64)
    return launch<T, 64>(q, k, v, dout, lse, delta, dq, b, sq, sk, h, kvh, d,
                         scale, causal, window, offset, stream);
  return launch<T, 128>(q, k, v, dout, lse, delta, dq, b, sq, sk, h, kvh, d,
                        scale, causal, window, offset, stream);
}

}  // namespace

// q and dout (b, sq, h, d), k and v (b, sk, kvh, d), all contiguous in the
// dtype given by `dtype` (0 float32, 1 bfloat16); lse and delta (b, sq, h)
// float32; dq (b, sq, h, d) float32, every element written. Launches on
// `stream` and returns cudaGetLastError().
extern "C" int lo_flash_bwd_dq(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, void* dq, int b, int sq,
                               int sk, int h, int kvh, int d, float scale,
                               int causal, int window, int offset, int dtype,
                               void* stream) {
  if (b < 1 || sq < 1 || sk < 1 || h < 1 || kvh < 1 || h % kvh != 0 ||
      d < 1 || d > 128 || (int64_t)b * h > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch_d<float>(q, k, v, dout, lse, delta, dq, b, sq, sk, h, kvh,
                            d, scale, causal, window, offset, s);
  else if (dtype == 1)
    err = dispatch_d<__nv_bfloat16>(q, k, v, dout, lse, delta, dq, b, sq, sk,
                                    h, kvh, d, scale, causal, window, offset,
                                    s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}
