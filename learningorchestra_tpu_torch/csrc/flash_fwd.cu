// Flash-attention forward for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces: learningorchestra_tpu/ops/attention.py `_fwd_kernel` (the
// Pallas TPU kernel launched by `_fwd_pallas`) for a head_dim that is not
// a multiple of 8, float32 and bf16 (flash_fwd_tf32x3.cu takes float32 and
// flash_fwd_sm90.cu bf16 at the other head dims). Same function: the
// exact softmax attention output O plus a per-row log-sum-exp, with
// causal masking (row >= col + offset), a sliding window
// (col + offset > row - window), a ragged key edge (col < sk) and
// grouped-query heads (query head i reads kv head i / (h / kvh)). A row
// that sees no key gets o = 0 and lse = -1e30.
//
// Bound on an H100 SXM at the shape of a head_dim-12 LM's micro-step (b
// 2, sq = sk = 2048, h 8, kvh 4, d 12, causal, window 1024): 1,573,376
// visible (q, k) pairs per head, so 4 * d * pairs * b * h = 1.21 GFLOP
// per call against about 4.9 MB of fp32 inputs and outputs. That is
// compute bound: 1.21 GFLOP at the 67 TFLOP/s fp32 rate is 18 us, the
// bytes at 3.35 TB/s take 1.4 us.
//
// What the design does about it. This first version runs both products
// on the CUDA cores in fp32 FMAs, for fp32 and bf16 inputs alike, so the
// best it can reach is the 67 TFLOP/s fp32 rate; tensor cores (mma or
// wgmma), TMA and pipelined loads are later work. It spends no FLOP on
// tiles that no row of the q tile can see: the kv loop runs only over
// the visible band [lo, hi) of the tile, which halves causal work and
// keeps windowed work O(s * W). One block owns one (batch * head, 64-row
// q tile); K and V tiles of 64 keys are staged in shared memory and the
// kv loop inside the block takes the place of the TPU's sequential grid
// axis, with an online softmax (running max and sum) so the scores
// never reach device memory. Four threads share a q row: each scores 16
// of the tile's 64 keys and owns a quarter of the output columns.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockM = 64;     // q rows per block
constexpr int kBlockN = 64;     // keys per kv tile
constexpr int kThreadsPerRow = 4;
constexpr int kThreads = kBlockM * kThreadsPerRow;
constexpr int kColsPerThread = kBlockN / kThreadsPerRow;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <int DMAX>
constexpr size_t smem_bytes() {
  // Q and K rows use an odd pitch so that the rows read together by a
  // warp fall in different banks
  return sizeof(float) * (kBlockM * (DMAX + 1) + kBlockN * (DMAX + 1) +
                          kBlockN * DMAX + kBlockM * (kBlockN + 1));
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int sq, int sk, int h, int kvh,
                     int d, float scale, int causal, int window, int offset) {
  constexpr int QP = DMAX + 1;
  constexpr int VP = DMAX;
  constexpr int PP = kBlockN + 1;
  constexpr int kAcc = DMAX / kThreadsPerRow;
  extern __shared__ float smem[];
  float* sQ = smem;                 // kBlockM x QP
  float* sK = sQ + kBlockM * QP;    // kBlockN x QP
  float* sV = sK + kBlockN * QP;    // kBlockN x VP
  float* sP = sV + kBlockN * VP;    // kBlockM x PP

  const int tid = threadIdx.x;
  const int r = tid / kThreadsPerRow;
  const int sub = tid % kThreadsPerRow;
  const int bi = blockIdx.y / h;
  const int hi = blockIdx.y % h;
  const int kvi = hi / (h / kvh);
  const int row0 = blockIdx.x * kBlockM;
  const int row = row0 + r;
  const int row_last = min(row0 + kBlockM, sq) - 1;

  const int64_t q_stride = (int64_t)h * d;     // between sequence rows
  const int64_t kv_stride = (int64_t)kvh * d;
  const T* qb = q + (int64_t)bi * sq * q_stride + (int64_t)hi * d;
  const T* kb = k + (int64_t)bi * sk * kv_stride + (int64_t)kvi * d;
  const T* vb = v + (int64_t)bi * sk * kv_stride + (int64_t)kvi * d;

  for (int i = tid; i < kBlockM * DMAX; i += kThreads) {
    const int rr = i / DMAX, c = i % DMAX;
    const int gr = row0 + rr;
    sQ[rr * QP + c] =
        (gr < sq && c < d) ? to_float(qb[(int64_t)gr * q_stride + c]) : 0.f;
  }

  // keys the tile's rows can see: causal bounds the top, the window the
  // bottom; tiles outside [lo, hi) are never loaded
  int lo = 0, hi_col = sk;
  if (causal) hi_col = min(sk, row_last - offset + 1);
  if (window > 0) lo = max(0, row0 - window - offset + 1);
  const int start = (lo / kBlockN) * kBlockN;

  float m = kNegInf, l = 0.f;
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
      sK[j * QP + c] = in ? to_float(kb[off]) : 0.f;
      sV[j * VP + c] = in ? to_float(vb[off]) : 0.f;
    }
    __syncthreads();

    float s[kColsPerThread];
#pragma unroll
    for (int t = 0; t < kColsPerThread; ++t) s[t] = 0.f;
#pragma unroll 8
    for (int c = 0; c < DMAX; ++c) {
      const float qv = sQ[r * QP + c];
#pragma unroll
      for (int t = 0; t < kColsPerThread; ++t)
        s[t] = fmaf(qv, sK[(sub + kThreadsPerRow * t) * QP + c], s[t]);
    }

    uint32_t valid = 0;
    float tile_max = kNegInf;
#pragma unroll
    for (int t = 0; t < kColsPerThread; ++t) {
      const int col = kv0 + sub + kThreadsPerRow * t;
      bool ok = col < sk;
      if (causal) ok = ok && row >= col + offset;
      if (window > 0) ok = ok && col + offset > row - window;
      s[t] = ok ? s[t] * scale : kNegInf;
      valid |= (uint32_t)ok << t;
      tile_max = fmaxf(tile_max, s[t]);
    }
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 2));
    const float m_new = fmaxf(m, tile_max);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int t = 0; t < kColsPerThread; ++t) {
      // a row with nothing visible yet has m_new = -1e30 and
      // exp(s - m_new) = 1 on masked keys: zero them explicitly
      const float p = ((valid >> t) & 1u) ? expf(s[t] - m_new) : 0.f;
      sP[r * PP + sub + kThreadsPerRow * t] = p;
      psum += p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * alpha + psum;
    m = m_new;
    __syncwarp();  // the row's four threads share a warp

#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] *= alpha;
#pragma unroll 4
    for (int j = 0; j < kBlockN; ++j) {
      const float p = sP[r * PP + j];
#pragma unroll
      for (int i = 0; i < kAcc; ++i)
        acc[i] = fmaf(p, sV[j * VP + sub + kThreadsPerRow * i], acc[i]);
    }
  }

  if (row < sq) {
    const float safe_l = l > 0.f ? l : 1.f;
    T* orow = o + (int64_t)bi * sq * q_stride + (int64_t)row * q_stride +
              (int64_t)hi * d;
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      const int c = sub + kThreadsPerRow * i;
      if (c < d) orow[c] = from_float<T>(acc[i] / safe_l);
    }
    if (sub == 0)
      lse[((int64_t)bi * sq + row) * h + hi] =
          l > 0.f ? m + logf(safe_l) : kNegInf;
  }
}

template <typename T, int DMAX>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int b, int sq, int sk, int h, int kvh, int d,
                   float scale, int causal, int window, int offset,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DMAX>();
  auto kernel = flash_fwd_kernel<T, DMAX>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + kBlockM - 1) / kBlockM, b * h);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      sq, sk, h, kvh, d, scale, causal, window, offset);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o,
                       void* lse, int b, int sq, int sk, int h, int kvh,
                       int d, float scale, int causal, int window, int offset,
                       cudaStream_t stream) {
  if (d <= 32)
    return launch<T, 32>(q, k, v, o, lse, b, sq, sk, h, kvh, d, scale, causal,
                         window, offset, stream);
  if (d <= 64)
    return launch<T, 64>(q, k, v, o, lse, b, sq, sk, h, kvh, d, scale, causal,
                         window, offset, stream);
  return launch<T, 128>(q, k, v, o, lse, b, sq, sk, h, kvh, d, scale, causal,
                        window, offset, stream);
}

}  // namespace

// q (b, sq, h, d), k and v (b, sk, kvh, d), o like q, all contiguous in
// the dtype given by `dtype` (0 float32, 1 bfloat16); lse (b, sq, h)
// float32. Launches on `stream` and returns cudaGetLastError().
extern "C" int lo_flash_fwd(const void* q, const void* k, const void* v,
                            void* o, void* lse, int b, int sq, int sk, int h,
                            int kvh, int d, float scale, int causal,
                            int window, int offset, int dtype, void* stream) {
  if (b < 1 || sq < 1 || sk < 1 || h < 1 || kvh < 1 || h % kvh != 0 ||
      d < 1 || d > 128 || (int64_t)b * h > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch_d<float>(q, k, v, o, lse, b, sq, sk, h, kvh, d, scale,
                            causal, window, offset, s);
  else if (dtype == 1)
    err = dispatch_d<__nv_bfloat16>(q, k, v, o, lse, b, sq, sk, h, kvh, d,
                                    scale, causal, window, offset, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}
