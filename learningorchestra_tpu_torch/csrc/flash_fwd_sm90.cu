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
// Design. One block per (batch * head, 128-row q tile): a producer
// warpgroup (one thread issues every load; setmaxnreg hands most of its
// registers to the consumers) and two consumer warpgroups of 64 q rows
// each. The producer loads the Q tile once and walks the tile's visible
// kv band [lo, hi) (causal bounds the top, the window the bottom), one
// TMA load of a 128-key K tile and one of V per stage into a two-stage
// ring of full/empty mbarriers; TMA zero-fills rows past sk and columns
// past d, so ragged edges need no load code. Each consumer warpgroup
// computes S = Q.K^T with wgmma (both
// operands K-major in shared memory), runs the online softmax on the
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
  if (d <= 64)
    return (int)launch<1>(q, k, v, o, lse, b, sq, sk, h, kvh, d, scale,
                          causal, window, offset, s);
  return (int)launch<2>(q, k, v, o, lse, b, sq, sk, h, kvh, d, scale, causal,
                        window, offset, s);
}
