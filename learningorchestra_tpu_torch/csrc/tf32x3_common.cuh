// Building blocks shared by the float32 tensor-core kernels
// (flash_fwd_tf32x3.cu, flash_bwd_dq_tf32x3.cu, flash_bwd_dkv_tf32x3.cu):
// split TF32 products on warp-level mma.sync, hi and lo planes of a tile,
// and cp.async tile loads.
//
// Split TF32 (3xTF32). A float32 x is cut into hi = tf32(x) and lo =
// tf32(x - hi), tf32 being cvt.rna (round to nearest, ties away from
// zero, 10 explicit mantissa bits); hi + lo is within 2^-22 |x| of x. A
// product x.y runs as x_lo.y_hi + x_hi.y_lo + x_hi.y_hi, small terms
// first, into float32 accumulators; the dropped x_lo.y_lo is below 2^-22
// of the product. So three TF32 products give float32's accuracy for
// three times the tensor work of one (ops/attention.py `_tf32_split` is
// the plain version of the split).
//
// mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32, lane l, g = l / 4,
// t = l % 4:
//   A (16 x 8): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
//   B (8 x 8):  b0 (k t, n g), b1 (k t + 4, n g)
//   C (16 x 8): c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
// Both fragments come from registers, so the thread loads them from
// shared memory in whatever order a product needs: no tile is stored
// transposed. A C fragment becomes the A fragment of the next product
// without a trip through shared memory by reading the n-tile's columns as
// k positions in the order (0, 2, 4, 6, 1, 3, 5, 7): C's columns (2t, 2t
// + 1) are then A's k indices (t, t + 4), i.e. (a0, a1, a2, a3) = (c0, c2,
// c1, c3), and the B fragment takes rows 2t and 2t + 1 of the 8 in place
// of t and t + 4. The sum runs over all 8, so the order does not matter.
//
// Tiles live in shared memory as float32 rows at a pitch of the kernel
// variant's width (32, 64 or 128 columns) + 4 floats: the rows a fragment
// load reads together then fall in distinct banks (pitch % 32 == 4).

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace tf32x3 {

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo, each a TF32 value in a 32-bit register
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a.b as three TF32 products, small terms first
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&a_hi)[4],
                                     const uint32_t (&a_lo)[4],
                                     const uint32_t (&b_hi)[2],
                                     const uint32_t (&b_lo)[2]) {
  mma_tf32(c, a_lo, b_hi);
  mma_tf32(c, a_hi, b_lo);
  mma_tf32(c, a_hi, b_hi);
}

// A fragment of a 16 x 8 block read from a row-major tile at `p` (row g,
// column t already added), `pitch` floats between rows, split hi + lo
__device__ __forceinline__ void load_a(const float* p, int pitch,
                                       uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split(p[0], hi[0], lo[0]);
  split(p[8 * pitch], hi[1], lo[1]);
  split(p[4], hi[2], lo[2]);
  split(p[8 * pitch + 4], hi[3], lo[3]);
}

// A fragment from a C fragment (the permuted k order above), split
__device__ __forceinline__ void c_to_a(const float (&c)[4], uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
  split(c[0], hi[0], lo[0]);
  split(c[2], hi[1], lo[1]);
  split(c[1], hi[2], lo[2]);
  split(c[3], hi[3], lo[3]);
}

// B fragment from two values (k index t and t + 4), split
__device__ __forceinline__ void load_b(float x0, float x1, uint32_t (&hi)[2],
                                       uint32_t (&lo)[2]) {
  split(x0, hi[0], lo[0]);
  split(x1, hi[1], lo[1]);
}

// B fragment from hi and lo planes (split_tile) at offsets o0 (k index t)
// and o1 (t + 4): no conversion at the read
__device__ __forceinline__ void load_b_planes(const float* hi, const float* lo,
                                              int o0, int o1,
                                              uint32_t (&b_hi)[2],
                                              uint32_t (&b_lo)[2]) {
  b_hi[0] = __float_as_uint(hi[o0]);
  b_hi[1] = __float_as_uint(hi[o1]);
  b_lo[0] = __float_as_uint(lo[o0]);
  b_lo[1] = __float_as_uint(lo[o1]);
}

// hi and lo planes of the first COUNT floats of a tile (COUNT a multiple
// of 4, all three 16-byte aligned): each element split once for the whole
// block, so the warps that read it as a B operand do not each convert it
template <int COUNT, int THREADS>
__device__ __forceinline__ void split_tile(const float* raw, float* hi,
                                           float* lo) {
  for (int i = 4 * threadIdx.x; i < COUNT; i += 4 * THREADS) {
    const float4 x = *reinterpret_cast<const float4*>(raw + i);
    uint32_t h[4], l[4];
    split(x.x, h[0], l[0]);
    split(x.y, h[1], l[1]);
    split(x.z, h[2], l[2]);
    split(x.w, h[3], l[3]);
    *reinterpret_cast<uint4*>(hi + i) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(lo + i) = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

// ---- cp.async --------------------------------------------------------

// 16 bytes from global to shared; `valid` false writes zeros and reads
// nothing (src must still be a legal address)
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows [row0, row0 + ROWS) of a (seq, heads, head_dim) float32 slice at
// `src` (head offset applied, `stride` floats between sequence rows) into
// a tile of COLS columns at pitch `pitch`: the first d columns of each
// row, zeros past d and in rows at or past `n_valid`, so every product
// can run over all COLS columns. d is a multiple of 4.
template <int ROWS, int COLS, int THREADS>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int64_t stride, int row0,
                                          int n_valid, int d, int pitch) {
  constexpr int kChunks = COLS / 4;
  for (int i = threadIdx.x; i < ROWS * kChunks; i += THREADS) {
    const int r = i / kChunks, c = 4 * (i % kChunks);
    const bool ok = row0 + r < n_valid && c < d;
    cp_async16(dst + r * pitch + c,
               src + (ok ? (int64_t)(row0 + r) * stride + c : 0), ok);
  }
}

}  // namespace tf32x3
