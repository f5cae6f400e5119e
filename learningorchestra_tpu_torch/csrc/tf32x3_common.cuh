// Building blocks shared by the tensor-core kernels in split TF32
// (flash_fwd_tf32x3.cu, flash_bwd_dq_tf32x3.cu, flash_bwd_dkv_tf32x3.cu):
// split TF32 products on warp-level mma.sync, hi and lo planes of a tile,
// cp.async tile loads at any row width, and stores at any head_dim.
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
// bf16 inputs. A bf16 value is exact in TF32 (8 significant bits against
// 11, the same exponent range): widened to float it is its own hi and its
// lo is 0. The kernels are templates on the input type T (float or
// __nv_bfloat16); for bf16 the lo terms of an input drop out at compile
// time: a product of two inputs (Q.K^T, dO.V^T) is one mma_tf32, a product
// of a float32 intermediate (P, dS; split hi + lo) and an input two
// (mma_inputs, mma_mixed). Widening at the fragment read is a shift.
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
// Tiles live in shared memory as rows of T at a pitch of the kernel
// variant's width (16, 32, 64 or 128 columns) + 16 bytes (4 floats, 8
// bf16), and every row starts 16-byte aligned for cp.async. The rows a
// fragment load reads together then fall in distinct banks: the pitch is
// 4 words mod 32, or 20 (float32 at width 16, bf16 at 32) or 12 (bf16 at
// 16), which still puts the 8 rows g of an A read, or the 4 rows 2t of a
// B read, on disjoint banks. Two lanes reading the two halves of one
// 32-bit word do not conflict.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

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

// true for an input type that is exact in TF32 (bf16): its lo is 0
template <typename T>
inline constexpr bool kExact = !std::is_same_v<T, float>;

// c += a.b for two inputs: three TF32 products for float32, one for bf16
template <typename T>
__device__ __forceinline__ void mma_inputs(float (&c)[4],
                                           const uint32_t (&a_hi)[4],
                                           const uint32_t (&a_lo)[4],
                                           const uint32_t (&b_hi)[2],
                                           const uint32_t (&b_lo)[2]) {
  if constexpr (kExact<T>)
    mma_tf32(c, a_hi, b_hi);
  else
    mma3(c, a_hi, a_lo, b_hi, b_lo);
}

// c += a.b for a float32 intermediate a (P or dS, split hi + lo) and an
// input b: three TF32 products for float32 inputs, two for bf16 (b_lo is
// 0), small terms first
template <typename T>
__device__ __forceinline__ void mma_mixed(float (&c)[4],
                                          const uint32_t (&a_hi)[4],
                                          const uint32_t (&a_lo)[4],
                                          const uint32_t (&b_hi)[2],
                                          const uint32_t (&b_lo)[2]) {
  if constexpr (kExact<T>) {
    mma_tf32(c, a_lo, b_hi);
    mma_tf32(c, a_hi, b_hi);
  } else {
    mma3(c, a_hi, a_lo, b_hi, b_lo);
  }
}

// acc += a.b as mma_mixed computes it, but summed in a fresh fragment
// (from zero) and added to acc on the CUDA cores. The tensor cores do
// not round their float32 accumulation to nearest: each mma.sync leaves
// an error biased toward zero of about an ulp of its accumulator, so a
// sum carried in one accumulator over a long run of k-steps drifts in
// proportion to its length, where round-to-nearest errors grow as its
// square root. That matters where a sum cancels: dQ = dS.K and dK =
// dS^T.Q, since each row of dS sums to zero, and O, whose drift reaches
// every dS through delta = rowsum(dO * O). On an H100 (PERF.md), at 2048
// keys, d 32 and inputs with a common mean, dq carried in the accumulator
// was 36 times further from the float32 plain version than the 3xTF32
// emulation, and a classifier's float32 weight gradient read 7e-4
// against the dense path; summed here, dq came within 2.3 times of the
// emulation and the gradient to 2.3e-5. dV's sum does not cancel but
// drifts the same way (2.9e-5 at 2048 keys), so it is summed here too.
// Where the dK/dV kernel has no registers for the fresh fragment (dV at
// width 64, dK and dV at 128), its accumulator sums a short run of q
// tiles and the long sum runs on the CUDA cores in device memory
// (flash_bwd_dkv_tf32x3.cu).
template <typename T>
__device__ __forceinline__ void mma_mixed_add(float (&acc)[4],
                                              const uint32_t (&a_hi)[4],
                                              const uint32_t (&a_lo)[4],
                                              const uint32_t (&b_hi)[2],
                                              const uint32_t (&b_lo)[2]) {
  float c[4];
  // the first product starts from zero (no registers to clear)
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
      : "r"(a_lo[0]), "r"(a_lo[1]), "r"(a_lo[2]), "r"(a_lo[3]),
        "r"(b_hi[0]), "r"(b_hi[1]), "f"(0.f));
  if constexpr (!kExact<T>) mma_tf32(c, a_hi, b_lo);
  mma_tf32(c, a_hi, b_hi);
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += c[e];
}

// a bf16 value as a TF32 operand: widened to float, exactly
__device__ __forceinline__ uint32_t tf32_of(__nv_bfloat16 x) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(x)) << 16;
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

// load_a and load_b for bf16 tiles: hi only, the lo terms are 0 and the
// products never read them (mma_inputs, mma_mixed)
__device__ __forceinline__ void load_a(const __nv_bfloat16* p, int pitch,
                                       uint32_t (&hi)[4], uint32_t (&)[4]) {
  hi[0] = tf32_of(p[0]);
  hi[1] = tf32_of(p[8 * pitch]);
  hi[2] = tf32_of(p[4]);
  hi[3] = tf32_of(p[8 * pitch + 4]);
}

__device__ __forceinline__ void load_b(__nv_bfloat16 x0, __nv_bfloat16 x1,
                                       uint32_t (&hi)[2], uint32_t (&)[2]) {
  hi[0] = tf32_of(x0);
  hi[1] = tf32_of(x1);
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

__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 8 : 0)
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

// load_rows for T = float or bf16 at any d and base alignment: chunks of
// BYTES (16, 8 or 4), each wholly inside or wholly past column d since the
// chunk divides d * sizeof(T); zeros past d and in rows at or past n_valid.
// The loop is not unrolled: at width 128 an unrolled loop's addresses
// push the dK/dV kernel, whose accumulators hold 128 registers, into
// spills
template <int ROWS, int COLS, int THREADS, int BYTES, typename T>
__device__ __forceinline__ void load_chunks(T* dst, const T* src,
                                            int64_t stride, int row0,
                                            int n_valid, int d, int pitch) {
  constexpr int kElems = BYTES / static_cast<int>(sizeof(T));
  constexpr int kChunks = COLS / kElems;
#pragma unroll 1
  for (int i = threadIdx.x; i < ROWS * kChunks; i += THREADS) {
    const int r = i / kChunks, c = kElems * (i % kChunks);
    const bool ok = row0 + r < n_valid && c < d;
    const T* from = src + (ok ? (int64_t)(row0 + r) * stride + c : 0);
    if constexpr (BYTES == 16)
      cp_async16(reinterpret_cast<float*>(dst + r * pitch + c),
                 reinterpret_cast<const float*>(from), ok);
    else if constexpr (BYTES == 8)
      cp_async8(dst + r * pitch + c, from, ok);
    else
      cp_async4(reinterpret_cast<float*>(dst + r * pitch + c),
                reinterpret_cast<const float*>(from), ok);
  }
}

// load_rows at any row width and base alignment: cp.async granules of
// `gran` bytes (16, 8 or 4: the widest that divides d * sizeof(T) and
// every input base address, chosen once per launch by `granule`), or,
// where none does (gran 0: a bf16 row of odd length; a float32 row
// always takes 4), element by element with plain loads and stores, which
// nothing overlaps
template <int ROWS, int COLS, int THREADS, typename T>
__device__ __forceinline__ void load_rows_any(T* dst, const T* src,
                                              int64_t stride, int row0,
                                              int n_valid, int d, int pitch,
                                              int gran) {
  if (gran == 16) {
    load_chunks<ROWS, COLS, THREADS, 16>(dst, src, stride, row0, n_valid, d,
                                         pitch);
  } else if (gran == 8) {
    load_chunks<ROWS, COLS, THREADS, 8>(dst, src, stride, row0, n_valid, d,
                                        pitch);
  } else if (sizeof(T) == 4 || gran == 4) {
    load_chunks<ROWS, COLS, THREADS, 4>(dst, src, stride, row0, n_valid, d,
                                        pitch);
  } else {
    const uint16_t* from = reinterpret_cast<const uint16_t*>(src);
    uint16_t* to = reinterpret_cast<uint16_t*>(dst);
#pragma unroll 4
    for (int i = threadIdx.x; i < ROWS * COLS; i += THREADS) {
      const int r = i / COLS, c = i % COLS;
      to[r * pitch + c] = row0 + r < n_valid && c < d
                              ? from[(int64_t)(row0 + r) * stride + c]
                              : uint16_t(0);
    }
  }
}

// a kernel variant's tile load: the 16-byte load_rows where the variant
// is wide (float32, d % 4 == 0, 16-byte aligned bases), else
// load_rows_any at the launch's granule
template <int ROWS, int COLS, int THREADS, bool kWide, typename T>
__device__ __forceinline__ void load_tile(T* dst, const T* src,
                                          int64_t stride, int row0,
                                          int n_valid, int d, int pitch,
                                          int gran) {
  if constexpr (kWide)
    load_rows<ROWS, COLS, THREADS>(dst, src, stride, row0, n_valid, d,
                                   pitch);
  else
    load_rows_any<ROWS, COLS, THREADS>(dst, src, stride, row0, n_valid, d,
                                       pitch, gran);
}

// the widest cp.async granule (16, 8 or 4 bytes) that divides a row's
// bytes and each of the `n` base addresses, or 0 where none does; every
// tile row starts at a multiple of the row's bytes from its base
inline int granule(int row_bytes, const void* const* bases, int n) {
  uintptr_t bits = static_cast<uintptr_t>(row_bytes);
  for (int i = 0; i < n; ++i) bits |= reinterpret_cast<uintptr_t>(bases[i]);
  for (int g = 16; g >= 4; g /= 2)
    if (bits % g == 0) return g;
  return 0;
}

// columns c and c + 1 (c even) of a float32 output row: one float2 where
// both lie before column d and the address is 8-byte aligned, else
// scalars; nothing at or past column d is written
__device__ __forceinline__ void store_pair(float* row, int c, int d, float x0,
                                           float x1) {
  if (c >= d) return;
  float* p = row + c;
  if (c + 1 < d && (reinterpret_cast<uintptr_t>(p) & 7) == 0) {
    *reinterpret_cast<float2*>(p) = make_float2(x0, x1);
  } else {
    p[0] = x0;
    if (c + 1 < d) p[1] = x1;
  }
}

// store_pair for a bf16 output row (the forward's o in q's dtype): each
// value rounded to nearest even, as torch rounds float32 to bf16; one
// __nv_bfloat162 where both columns lie before d and the address is
// 4-byte aligned, else scalars
__device__ __forceinline__ void store_pair(__nv_bfloat16* row, int c, int d,
                                           float x0, float x1) {
  if (c >= d) return;
  __nv_bfloat16* p = row + c;
  if (c + 1 < d && (reinterpret_cast<uintptr_t>(p) & 3) == 0) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x0, x1);
  } else {
    p[0] = __float2bfloat16_rn(x0);
    if (c + 1 < d) p[1] = __float2bfloat16_rn(x1);
  }
}

}  // namespace tf32x3
