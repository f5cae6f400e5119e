// Flash-attention backward, dK and dV, on Hopper's tensor cores
// (sm_90a) as split TF32 (3xTF32), for float32 and bf16 inputs: warp-level
// mma.sync, cp.async double-buffered tiles, hand-written CUDA C++.
//
// Replaces: learningorchestra_tpu/ops/attention.py `_bwd_dkv_kernel` (the
// second Pallas TPU kernel of `_bwd_pallas`) for float32 q/k/v/dO whose
// head_dim is a multiple of 8 up to 128, and for float32 or bf16 at every
// other head_dim up to 128 (bf16 at a multiple of 8 takes
// flash_bwd_dkv_sm90.cu). Same function: with the forward's saved
// log-sum-exp `lse` and `delta = rowsum(dO * O) - dlse`, for every
// visible (row, col) pair
//   p  = exp(q.k * scale - lse),  dp = dO.v,
//   ds = p * (dp - delta) * scale,
//   dV[col] += p * dO[row],  dK[col] += ds * q[row],
// summed over every query head of the kv head's group, under the
// forward's masks (causal row >= col + offset, window col + offset > row
// - window, ragged sq and sk). Masked pairs are zeroed before the exp,
// which overflows on a row with no visible key (lse = -1e30). dK and dV
// are float32 in both.
//
// Bound on an H100 SXM at the training shape (b 8, sq = sk = 2048, h 8,
// kvh 4, d 64, causal, window 1024): 1,573,376 visible pairs per query
// head over b * h = 64, so 8 * d * pairs = 51.6 GFLOP per call against
// about 135 MB of float32 inputs and outputs. Bound by operations: 0.770
// ms at the 67 TFLOP/s float32 rate of the CUDA cores; as three TF32
// products (24 * d * pairs = 154.7 GFLOP) 0.313 ms at the 495 TFLOP/s
// TF32 tensor-core rate. The bytes take 0.04 ms at 3.35 TB/s. bf16 inputs
// run 12 * d TF32 FLOP per pair (K.Q^T and V.dO^T one product each,
// P^T.dO and dS^T.Q two).
//
// Design. Every product runs on the tensor cores, and loads overlap the
// products.
// - One block per (batch * kv head, 64-key tile), four warps of 16 keys.
//   K and V stay resident in shared memory; the block walks every query
//   head of the group and, for each, only the q tiles whose rows see the
//   key tile (causal: from the diagonal down; window: up to window - 1
//   rows past the tile).
// - Q, dO, lse and delta tiles stream through two shared-memory stages
//   with cp.async: the next tile's copies are in flight while the warps
//   multiply the current one.
// - Per q tile each warp computes S^T = K.Q^T and dP^T = V.dO^T (16 keys
//   x M rows) on m16n8k8 tf32 mma.sync, P^T and dS^T in the accumulator
//   registers, then dV += P^T.dO and dK += dS^T.Q with P^T and dS^T fed
//   straight from the accumulators as A fragments (the permuted k order
//   of tf32x3_common.cuh) and dO, Q read from the same row-major tiles.
// - Every product is 3xTF32 for float32 inputs. A split costs several ALU
//   instructions (two cvt.rna and a subtraction, and cvt.rna.tf32 is not
//   a single instruction on sm_90), so the streamed Q and dO, which all
//   four warps read as B operands, are split once per tile into hi and lo
//   planes in shared memory; the resident K and V are split as their A
//   fragments are read (once per 8 columns, reused across the tile's
//   rows). On the card the planes were faster than splitting Q and dO at
//   every read (PERF.md). bf16 tiles need no split: they stay bf16 in
//   shared memory, are widened at the fragment read, exactly, and their
//   lo terms drop out (mma_inputs, mma_mixed), so the planes and their
//   shared memory go.
// - Any head_dim up to 128: variants 16, 32, 64 and 128 columns wide (the
//   smallest that holds d), columns past d zero-filled, so every loop
//   runs over the variant's full width. Float32 rows at d % 4 == 0 with
//   16-byte aligned bases load in 16-byte cp.async chunks (the wide
//   variants); any other row in the widest granule that fits, or element
//   by element (load_rows_any). dK and dV are stored as float2 only where
//   both columns lie before d and the address is 8-byte aligned.
// - Masks only on tiles that cross an edge (causal diagonal, window,
//   ragged sq or sk) of what the warp's keys are seen from; exp2 with
//   scale * log2(e) folded in.
// - No long sum rides in the tensor cores' accumulator, whose float32
//   additions are not rounded to nearest and drift with the length of
//   the run (tf32x3_common.cuh, mma_mixed_add). dK sums the whole group in
//   float32 registers, each k-step's products added on the CUDA cores
//   (mma_mixed_add), up to width 64; dV the same up to width 32. Where
//   that does not fit, the accumulator sums a run of kRun q tiles from
//   zero (8 at width 64, 4 at 128), and each thread then adds its
//   partial on the CUDA cores into its own elements of dk and dv in
//   device memory, which the first run stores. That master costs no
//   registers and no shared memory, and stays in L2 (16 or 64 KB a
//   block). Why not otherwise: dV's fresh fragment at width 64 (float32)
//   took ptxas to 255 registers and spills, and 24-row stages that fit
//   were 19% slower (scripts/tf32x3_tile_sweep.py); a master in shared
//   memory would cost the width-64 variant its second block per SM, and
//   the width-128 one does not fit beside its 198.5 KB of tiles (227 KB a
//   block). On an H100 (PERF.md, section 6) at 2048 keys the runs keep dV
//   within 1.45x of the 3xTF32 emulation at d 64 and dK, dV within 1.6x
//   at d 128, where the whole group in the accumulator was 17x. Each
//   element has one owner thread, so there are no atomics, and every run
//   gives the same bits.
// - Tiles: 32 q rows per stage (M), 2 blocks of 4 warps per SM at d 64;
//   64-row and 16-row stages were slower there. At width 16 (the d-12
//   LM's 256 blocks) 64-row stages were about 9% faster than 32-row ones
//   (scripts/tf32x3_tile_sweep.py, PERF.md). Registers: dK and dV take
//   d / 2 each per thread and S^T, dP^T M / 2 each; ptxas reports no
//   spills.

#include "tf32x3_common.cuh"

namespace {

using namespace tf32x3;

constexpr int kBlockN = 64;   // keys per block: 4 warps x 16
constexpr int kThreads = 128;

constexpr float kLog2e = 1.4426950408889634f;

template <typename T, int DMAX>
struct Tile {
  // q rows per stage: 64 at width 16, where 32 leaves the few warps of
  // the grid short of work between syncs
  static constexpr int kM = DMAX == 16 ? 64 : 32;
  static constexpr int kMinBlocks = 1;  // per SM
  // row pitch, elements: 16 bytes past the width
  static constexpr int kP = DMAX + 16 / static_cast<int>(sizeof(T));
  static constexpr int kKV = kBlockN * kP;  // K or V
  static constexpr int kQ = kM * kP;        // Q or dO: a stage, or a plane
  // hi and lo planes of Q and dO: float32 inputs only
  static constexpr bool kPlanes = !kExact<T>;
  // K, V; Q and dO stages; their planes; lse and delta stages
  static constexpr size_t kBytes =
      sizeof(T) * (2 * kKV + 4 * kQ) +
      sizeof(float) * ((kPlanes ? 4 * kQ : 0) + 4 * kM);
};

// row[c], row[c + 1] <- (add ? themselves + : ) x0, x1, the columns
// before d only: one float2 in the wide variants (c < d implies c + 1 <
// d, 8-byte aligned), else store_pair's access
template <bool kWide>
__device__ __forceinline__ void put_pair(float* row, int c, int d, float x0,
                                         float x1, bool add) {
  if (c >= d) return;
  if constexpr (kWide) {
    float2* p = reinterpret_cast<float2*>(row + c);
    if (add) {
      const float2 old = *p;
      x0 += old.x;
      x1 += old.y;
    }
    *p = make_float2(x0, x1);
  } else {
    if (add) {
      x0 += row[c];
      if (c + 1 < d) x1 += row[c + 1];
    }
    store_pair(row, c, d, x0, x1);
  }
}

// kWide: float32 rows at d % 4 == 0 from 16-byte aligned bases (16-byte
// loads, float2 stores); `gran` is the other variants' load granule
template <typename T, int DMAX, bool kWide>
__global__ void __launch_bounds__(kThreads, Tile<T, DMAX>::kMinBlocks)
    flash_bwd_dkv_tf32x3_kernel(const T* __restrict__ q,
                                const T* __restrict__ k,
                                const T* __restrict__ v,
                                const T* __restrict__ dout,
                                const float* __restrict__ lse,
                                const float* __restrict__ delta,
                                float* __restrict__ dk,
                                float* __restrict__ dv, int sq, int sk, int h,
                                int kvh, int d, float scale, int causal,
                                int window, int offset, int gran) {
  using Tl = Tile<T, DMAX>;
  constexpr int M = Tl::kM, P = Tl::kP;
  // How each sum avoids a long run in the tensor cores' accumulator
  // (header): dK adds each k-step's products to its registers on the
  // CUDA cores (mma_mixed_add) up to width 64, dV up to width 32; beyond,
  // the accumulator sums a run of kRun q tiles from zero, which is then
  // added to the master in device memory
  constexpr bool kStepK = DMAX <= 64;
  constexpr bool kStepV = DMAX <= 32;
  constexpr int kRun = DMAX == 128 ? 4 : 8;
  constexpr int NT = M / 8;     // 8-row n-tiles of S^T per q tile
  constexpr int DT = DMAX / 8;  // 8-column tiles of head_dim
  constexpr int kPlane = Tl::kPlanes ? Tl::kQ : 0;
  extern __shared__ float4 smem4[];
  T* sK = reinterpret_cast<T*>(smem4);
  T* sV = sK + Tl::kKV;
  T* sQ = sV + Tl::kKV;          // + stage * kQ
  T* sDO = sQ + 2 * Tl::kQ;      // + stage * kQ
  // the current tile split (float32 inputs): Q hi, Q lo, dO hi, dO lo
  float* sQh = reinterpret_cast<float*>(sDO + 2 * Tl::kQ);
  float* sQl = sQh + kPlane;
  float* sDh = sQl + kPlane;
  float* sDl = sDh + kPlane;
  float* sL = sDl + kPlane;      // + stage * M
  float* sD = sL + 2 * M;        // + stage * M

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int bi = blockIdx.y / kvh;
  const int kvi = blockIdx.y % kvh;
  const int group = h / kvh;
  const int kv0 = blockIdx.x * kBlockN;
  const int col_last = min(kv0 + kBlockN, sk) - 1;

  const int64_t q_stride = (int64_t)h * d;  // between sequence rows
  const int64_t kv_stride = (int64_t)kvh * d;
  const int64_t kv_off = (int64_t)bi * sk * kv_stride + (int64_t)kvi * d;

  // rows that can see some key of the tile: causal bounds the top, the
  // window the bottom; q tiles outside [row_lo, row_hi) are never loaded
  int row_lo = 0, row_hi = sq;
  if (causal) row_lo = max(0, kv0 + offset);
  if (window > 0) row_hi = min(sq, col_last + offset + window);
  const int start = (row_lo / M) * M;
  const int n_rows = row_hi > start ? (row_hi - start + M - 1) / M : 0;
  const int n_tiles = group * n_rows;

  // stage `tile % 2` <- Q, dO, lse and delta of tile `tile`
  auto issue = [&](int tile) {
    const int s = tile % 2;
    const int hq = kvi * group + tile / n_rows;
    const int row0 = start + (tile % n_rows) * M;
    const int64_t q_off = (int64_t)bi * sq * q_stride + (int64_t)hq * d;
    load_tile<M, DMAX, kThreads, kWide>(sQ + s * Tl::kQ, q + q_off, q_stride,
                                        row0, sq, d, P, gran);
    load_tile<M, DMAX, kThreads, kWide>(sDO + s * Tl::kQ, dout + q_off,
                                        q_stride, row0, sq, d, P, gran);
    if (threadIdx.x < M) {
      const int row = row0 + threadIdx.x;
      const bool ok = row < sq;
      const int64_t ri = ok ? ((int64_t)bi * sq + row) * h + hq : 0;
      cp_async4(sL + s * M + threadIdx.x, lse + ri, ok);
      cp_async4(sD + s * M + threadIdx.x, delta + ri, ok);
    }
  };

  load_tile<kBlockN, DMAX, kThreads, kWide>(sK, k + kv_off, kv_stride, kv0,
                                            sk, d, P, gran);
  load_tile<kBlockN, DMAX, kThreads, kWide>(sV, v + kv_off, kv_stride, kv0,
                                            sk, d, P, gran);
  if (n_tiles > 0) issue(0);
  cp_async_commit();

  // this thread's keys in the tile: key and key + 8 (C rows g, g + 8)
  const int key = 16 * warp + g;
  const int col_a = kv0 + key;
  const int w_col0 = kv0 + 16 * warp;  // the warp's keys: w_col0 .. + 15
  const float scale_log2 = scale * kLog2e;
  const T* kw = sK + key * P + t;
  const T* vw = sV + key * P + t;

  float acc_k[DT][4], acc_v[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.f;

  // dk (with_k) and dv (with_v) <- (add ? themselves + : ) the
  // accumulators, and the written accumulators <- 0. C layout:
  // acc[n][2 r + i] is key col_a + 8 r, column 8 n + 2 t + i; each
  // element has this one thread as its owner
  auto write_out = [&](bool with_k, bool with_v, bool add) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int col = col_a + 8 * r;
      if (col >= sk) continue;
      const int64_t off = kv_off + (int64_t)col * kv_stride;
#pragma unroll
      for (int n = 0; n < DT; ++n) {
        const int c = 8 * n + 2 * t;
        if (with_k)
          put_pair<kWide>(dk + off, c, d, acc_k[n][2 * r],
                          acc_k[n][2 * r + 1], add);
        if (with_v)
          put_pair<kWide>(dv + off, c, d, acc_v[n][2 * r],
                          acc_v[n][2 * r + 1], add);
      }
    }
#pragma unroll
    for (int n = 0; n < DT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (with_k) acc_k[n][e] = 0.f;
        if (with_v) acc_v[n][e] = 0.f;
      }
  };

  // runs of kRun q tiles where a sum rides the accumulator; one run of
  // every tile where neither does
  const int run = kStepK && kStepV ? max(n_tiles, 1) : kRun;
  for (int tile0 = 0; tile0 < n_tiles; tile0 += run) {
    const int tile_end = min(tile0 + run, n_tiles);
    for (int tile = tile0; tile < tile_end; ++tile) {
      if (tile + 1 < n_tiles) issue(tile + 1);
      cp_async_commit();
      cp_async_wait<1>();  // this tile's copies (and K, V) have landed
      __syncthreads();
      const int s = tile % 2;
      const int row0 = start + (tile % n_rows) * M;
      const float* tl = sL + s * M;
      const float* td = sD + s * M;
      const T* tq = sQ + s * Tl::kQ;
      const T* tdo = sDO + s * Tl::kQ;
      if constexpr (Tl::kPlanes) {
        split_tile<Tl::kQ, kThreads>(tq, sQh, sQl);
        split_tile<Tl::kQ, kThreads>(tdo, sDh, sDl);
        __syncthreads();
      }

      // S^T = K.Q^T and dP^T = V.dO^T: 16 keys x M rows per warp
      float st[NT][4], dpt[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
      for (int c = 0; c < DMAX; c += 8) {
        uint32_t ka_hi[4], ka_lo[4], va_hi[4], va_lo[4];
        load_a(kw + c, P, ka_hi, ka_lo);
        load_a(vw + c, P, va_hi, va_lo);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int o = (8 * j + g) * P + c + t;
          uint32_t b_hi[2], b_lo[2];
          if constexpr (Tl::kPlanes)
            load_b_planes(sQh, sQl, o, o + 4, b_hi, b_lo);
          else
            load_b(tq[o], tq[o + 4], b_hi, b_lo);
          mma_inputs<T>(st[j], ka_hi, ka_lo, b_hi, b_lo);
          if constexpr (Tl::kPlanes)
            load_b_planes(sDh, sDl, o, o + 4, b_hi, b_lo);
          else
            load_b(tdo[o], tdo[o + 4], b_hi, b_lo);
          mma_inputs<T>(dpt[j], va_hi, va_lo, b_hi, b_lo);
        }
      }

      // P^T and dS^T in place: element e is key col_a + 8 (e / 2), q row
      // row0 + 8 j + 2 t + e % 2; the mask only where the tile crosses an
      // edge of what the warp's keys are seen from (exp2 with scale *
      // log2(e) folded in)
      bool edge = row0 + M > sq || w_col0 + 15 >= sk;
      if (causal) edge = edge || row0 < w_col0 + 15 + offset;
      if (window > 0) edge = edge || w_col0 + offset <= row0 + M - 1 - window;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int rr = 8 * j + 2 * t + (e & 1);
          bool ok = true;
          if (edge) {
            const int row = row0 + rr;
            const int col = col_a + 8 * (e >> 1);
            ok = row < sq && col < sk;
            if (causal) ok = ok && row >= col + offset;
            if (window > 0) ok = ok && col + offset > row - window;
          }
          const float p =
              ok ? exp2f(fmaf(st[j][e], scale_log2, -tl[rr] * kLog2e)) : 0.f;
          st[j][e] = p;
          dpt[j][e] = ok ? p * (dpt[j][e] - td[rr]) * scale : 0.f;
        }

      // dV += P^T.dO, then dK += dS^T.Q: k-step j runs over q rows 8 j ..
      // 8 j + 7 in the permuted order, so B takes rows 8 j + 2 t (+ 1).
      // One A fragment at a time (P^T's, then dS^T's) keeps the registers
      // for mma_mixed_add's fresh fragment at width 64
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        uint32_t a_hi[4], a_lo[4];
        const int o = (8 * j + 2 * t) * P + g;
        c_to_a(st[j], a_hi, a_lo);
#pragma unroll
        for (int n = 0; n < DT; ++n) {
          uint32_t b_hi[2], b_lo[2];
          if constexpr (Tl::kPlanes)
            load_b_planes(sDh, sDl, o + 8 * n, o + P + 8 * n, b_hi, b_lo);
          else
            load_b(tdo[o + 8 * n], tdo[o + P + 8 * n], b_hi, b_lo);
          if constexpr (kStepV)
            mma_mixed_add<T>(acc_v[n], a_hi, a_lo, b_hi, b_lo);
          else
            mma_mixed<T>(acc_v[n], a_hi, a_lo, b_hi, b_lo);
        }
        c_to_a(dpt[j], a_hi, a_lo);
#pragma unroll
        for (int n = 0; n < DT; ++n) {
          uint32_t b_hi[2], b_lo[2];
          if constexpr (Tl::kPlanes)
            load_b_planes(sQh, sQl, o + 8 * n, o + P + 8 * n, b_hi, b_lo);
          else
            load_b(tq[o + 8 * n], tq[o + P + 8 * n], b_hi, b_lo);
          if constexpr (kStepK)
            mma_mixed_add<T>(acc_k[n], a_hi, a_lo, b_hi, b_lo);
          else
            mma_mixed<T>(acc_k[n], a_hi, a_lo, b_hi, b_lo);
        }
      }
      __syncthreads();  // the tile is read; the next issue may refill it
    }
    // the run's partials into the master (the first run stores them)
    if constexpr (!kStepK || !kStepV) write_out(!kStepK, !kStepV, tile0 > 0);
  }

  // the sums kept in registers, written once; zeros where no q row sees
  // the tile's keys
  if (n_tiles == 0)
    write_out(true, true, false);
  else if constexpr (kStepK || kStepV)
    write_out(kStepK, kStepV, false);
}

template <typename T, int DMAX, bool kWide>
cudaError_t launch(const T* q, const T* k, const T* v, const T* dout,
                   const float* lse, const float* delta, float* dk,
                   float* dv, int b, int sq, int sk, int h, int kvh, int d,
                   float scale, int causal, int window, int offset, int gran,
                   cudaStream_t stream) {
  constexpr size_t smem = Tile<T, DMAX>::kBytes;
  auto kernel = flash_bwd_dkv_tf32x3_kernel<T, DMAX, kWide>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((sk + kBlockN - 1) / kBlockN, b * kvh);
  kernel<<<grid, kThreads, smem, stream>>>(q, k, v, dout, lse, delta, dk, dv,
                                           sq, sk, h, kvh, d, scale, causal,
                                           window, offset, gran);
  return cudaGetLastError();
}

// the variant whose width (16, 32, 64 or 128 columns) is the smallest
// that holds d
template <typename T, bool kWide>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dk, void* dv, int b, int sq, int sk, int h,
                     int kvh, int d, float scale, int causal, int window,
                     int offset, int gran, cudaStream_t s) {
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tdo = static_cast<const T*>(dout);
  const float* fl = static_cast<const float*>(lse);
  const float* fd = static_cast<const float*>(delta);
  float* odk = static_cast<float*>(dk);
  float* odv = static_cast<float*>(dv);
  if (d <= 16)
    return launch<T, 16, kWide>(tq, tk, tv, tdo, fl, fd, odk, odv, b, sq, sk,
                                h, kvh, d, scale, causal, window, offset,
                                gran, s);
  if (d <= 32)
    return launch<T, 32, kWide>(tq, tk, tv, tdo, fl, fd, odk, odv, b, sq, sk,
                                h, kvh, d, scale, causal, window, offset,
                                gran, s);
  if (d <= 64)
    return launch<T, 64, kWide>(tq, tk, tv, tdo, fl, fd, odk, odv, b, sq, sk,
                                h, kvh, d, scale, causal, window, offset,
                                gran, s);
  return launch<T, 128, kWide>(tq, tk, tv, tdo, fl, fd, odk, odv, b, sq, sk,
                               h, kvh, d, scale, causal, window, offset, gran,
                               s);
}

}  // namespace

// q and dout (b, sq, h, d), k and v (b, sk, kvh, d): contiguous, float32
// (dtype 0) or bf16 (dtype 1), 1 <= d <= 128, any base aligned to the
// element; lse and delta (b, sq, h) float32; dk and dv (b, sk, kvh, d)
// float32, every element written. Launches on `stream` and returns
// cudaGetLastError().
extern "C" int lo_flash_bwd_dkv_tf32x3(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* delta,
                                       void* dk, void* dv, int b, int sq,
                                       int sk, int h, int kvh, int d,
                                       float scale, int causal, int window,
                                       int offset, int dtype, void* stream) {
  if (b < 1 || sq < 1 || sk < 1 || h < 1 || kvh < 1 || h % kvh != 0 ||
      d < 1 || d > 128 || (dtype != 0 && dtype != 1) ||
      (int64_t)b * kvh > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* bases[] = {q, k, v, dout};
  const int gran = granule(d * (dtype == 1 ? 2 : 4), bases, 4);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16, false>(q, k, v, dout, lse, delta, dk,
                                               dv, b, sq, sk, h, kvh, d,
                                               scale, causal, window, offset,
                                               gran, s);
  if (gran == 16)
    return (int)dispatch<float, true>(q, k, v, dout, lse, delta, dk, dv, b,
                                      sq, sk, h, kvh, d, scale, causal,
                                      window, offset, gran, s);
  return (int)dispatch<float, false>(q, k, v, dout, lse, delta, dk, dv, b, sq,
                                     sk, h, kvh, d, scale, causal, window,
                                     offset, gran, s);
}
