// Hopper (sm_90a) building blocks shared by the tensor-core kernels
// (flash_fwd_sm90.cu, flash_bwd_dq_sm90.cu, flash_bwd_dkv_sm90.cu):
// shared-memory mbarriers, TMA loads, warpgroup MMA (wgmma) on bf16
// tiles, and the host-side TMA map of a (batch, seq, heads, head_dim)
// bf16 tensor.
//
// Every bf16 tile lives in shared memory as TMA writes it with 128-byte
// swizzle: boxes of 64 head-dim columns (128 bytes) by `rows` rows, each
// box `rows * 128` bytes and 1024-byte aligned; head_dim 128 takes two
// boxes. One layout serves both operand orders of wgmma: read along
// head_dim it is K-major (Q.K^T and friends), read along the rows it is
// MN-major with the transpose flag (P.V, dS.K, P^T.dO, dS^T.Q).
//
// The narrow instances (head_dim <= 32) take boxes of 32 columns
// (64-byte rows) with 64-byte swizzle instead (desc_sw64): half the
// shared memory of a tile, and no zero columns in the products.
//
// Accumulators are f32, m64n64k16 or (the narrow instances' O and
// gradients) m64n32k16.
// Accumulator fragment of a warpgroup thread t (warp w = t / 32, lane
// l = t % 32), for column chunk j (0..7 at n64, 0..3 at n32): d[4j + e]
// holds row 16w + l/4 + 8 * (e / 2), column 8j + 2 * (l % 4) + e % 2.
// The bf16 A-from-registers fragment of k-step kk is then four packed
// pairs of that layout: pack(d[8kk + 2i], d[8kk + 2i + 1]) for i = 0..3,
// so a product's scores become the next product's A operand without a
// shuffle.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace sm90 {

constexpr int kBoxCols = 64;     // head-dim columns per TMA box (128 B)
constexpr int kRowBytes = 128;   // bytes of one box row
// the narrow instances' box: head_dim <= 32 in one 64-byte row
constexpr int kNarrowCols = 32;
constexpr int kNarrowRowBytes = 64;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers ------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also announces `bytes` of TMA traffic to come
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// returns once the phase of parity `parity` has completed. A wait of
// more than about 20 s (a lost arrival) traps, so that the fault reaches
// the caller as a launch error instead of a hung card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  long long t0 = 0;
  for (uint32_t spins = 0;; ++spins) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spins == 0) t0 = clock64();
    else if ((spins & 0xFFFF) == 0 && clock64() - t0 > (1ll << 35)) __trap();
  }
}

// registers of the calling warpgroup; every warp of it calls, and the
// two roles of a warp-specialized block never reconverge
template <int N>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ---- TMA --------------------------------------------------------------

// box of the 4-D map at (column, head, row, batch) into shared `dst`;
// completion counts `bytes` of the box on `bar`. Coordinates past the
// tensor read as zeros.
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

// `bytes` (a multiple of 16, 16-byte aligned both ends) from global
// `src` into shared `dst`, counted on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// ---- wgmma ------------------------------------------------------------

// descriptor of a 128-byte-swizzled tile at shared address `addr`: eight
// 128-byte rows make one 1024-byte swizzle atom (stride byte offset);
// the leading byte offset is unused by the m64n64k16 shapes taken here
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// the same for a 64-byte-swizzled tile: eight 64-byte rows make one
// 512-byte swizzle atom. K-major it steps 32 bytes (16 columns) along a
// row; MN-major (n32: one atom wide) the leading byte offset is unused.
__device__ __forceinline__ uint64_t desc_sw64(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(512 >> 4) << 32) |
         (static_cast<uint64_t>(2) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// returns once at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator reads or writes across an
// asynchronous wgmma
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void fence_acc(float (&d)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define LO_SM90_D32                                                          \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),      \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),      \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),      \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31])

#define LO_SM90_REGS32                                                       \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"

// d (64x64 f32) = A (64x16, shared) . B (16x64, shared) + (accumulate ?
// d : 0). TRANS_B 0: B is K-major (rows of B^T contiguous), 1: MN-major.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a,
                                         uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " LO_SM90_REGS32
      ", %32, %33, p, 1, 1, 0, %35;\n"
      "}\n"
      : LO_SM90_D32
      : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(TRANS_B));
}

// d (64x64 f32) += A (64x16 bf16, registers a[0..3]) . B (16x64, shared)
template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " LO_SM90_REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
      "}\n"
      : LO_SM90_D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1),
        "n"(TRANS_B));
}

#define LO_SM90_D16                                                          \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])

// d (64x32 f32) += A (64x16 bf16, registers a[0..3]) . B (16x32, shared):
// the narrow instances' P.V and gradient products
template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n"
      "}\n"
      : LO_SM90_D16
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1),
        "n"(TRANS_B));
}

#undef LO_SM90_D16
#undef LO_SM90_D32
#undef LO_SM90_REGS32

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// x = hi + lo with hi = bf16(x) and lo = bf16(x - hi): two bf16 products
// carry x to about 2^-16 of itself, where bf16(x) alone keeps 2^-8
__device__ __forceinline__ void split_bf16(float x, __nv_bfloat16& hi,
                                           __nv_bfloat16& lo) {
  hi = __float2bfloat16_rn(x);
  lo = __float2bfloat16_rn(x - __bfloat162float(hi));
}

// the A fragments (hi and lo) of the accumulator's columns 16 kk ..
// 16 kk + 15 (kk in 0..3; a compile-time constant once unrolled)
__device__ __forceinline__ void split_fragment(const float (&d)[32], int kk,
                                               uint32_t (&hi)[4],
                                               uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat16 h0, l0, h1, l1;
    split_bf16(d[8 * kk + 2 * i], h0, l0);
    split_bf16(d[8 * kk + 2 * i + 1], h1, l1);
    hi[i] = pack_bf16(h0, h1);
    lo[i] = pack_bf16(l0, l1);
  }
}

// 2^x on the special-function unit, subnormal results flushed to zero
// (a weight below 2^-126 adds nothing a float32 gradient keeps)
__device__ __forceinline__ float ex2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// split_bf16 of a pair with packed conversions: the A fragments (hi and
// lo) of two neighbouring accumulator values, as split_fragment packs
// them
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// the bf16 A fragments (k-steps 0 and 1) of a 64-row, 32-column tile in
// a 64-byte-swizzled box at generic address `tile` (512-byte aligned),
// for a warpgroup thread of warp `warp`, lane `lane`: the layout
// split_fragment packs, read from the 16-byte chunk the swizzle moved
// each pair to
__device__ __forceinline__ void load_fragments_sw64(const uint8_t* tile,
                                                    int warp, int lane,
                                                    uint32_t (&a)[2][4]) {
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 16 * warp + lane / 4 + 8 * (i % 2);
      const int chunk = (2 * kk + i / 2) ^ ((r >> 1) & 3);
      a[kk][i] = *reinterpret_cast<const uint32_t*>(
          tile + r * kNarrowRowBytes + chunk * 16 + 4 * (lane % 4));
    }
}

// keeps A fragments alive, unmoved, until the wgmma reading them is done
__device__ __forceinline__ void fence_frag(uint32_t (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// ---- host: TMA maps ---------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled (a libcuda entry point) looked up through the
// runtime, so that the library needs no -lcuda
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// 4-D map over a contiguous (batch, seq, heads, dim) bf16 tensor: dims
// (dim, heads, seq, batch), box (box_cols, 1, rows, 1), zero fill past
// every edge; by default 64-column boxes with 128-byte swizzle, for the
// narrow instances 32 columns with 64-byte swizzle. Needs dim % 8 == 0
// (16-byte strides) and a 16-byte aligned base. Returns cudaSuccess or
// an error.
inline cudaError_t make_map(
    CUtensorMap* map, const void* base, int batch, int seq, int heads,
    int dim, int rows, int box_cols = kBoxCols,
    CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  if (dim % 8 != 0 || reinterpret_cast<uintptr_t>(base) % 16 != 0)
    return cudaErrorInvalidValue;
  const cuuint64_t dims[4] = {(cuuint64_t)dim, (cuuint64_t)heads,
                              (cuuint64_t)seq, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {
      (cuuint64_t)dim * 2, (cuuint64_t)heads * dim * 2,
      (cuuint64_t)seq * heads * dim * 2};
  const cuuint32_t box[4] = {(cuuint32_t)box_cols, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult res =
      fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
         dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
         swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace sm90
