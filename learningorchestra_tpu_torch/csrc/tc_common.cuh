// Tensor-core building blocks shared by the flash-attention kernels
// (flash_fwd.cu, flash_bwd.cu): 16-byte cp.async tile loads into a
// shared-memory ring, ldmatrix, mma.sync in bf16 and TF32, and the
// fragment-index helpers.  Every tile is 64 rows, loaded by a block of 4
// warps; each warp owns 16 rows of the output tile.
//
// Fragment layout reminders (PTX ISA, "Matrix fragments for mma"), with
// g = lane / 4 and t = lane % 4:
// - f32 accumulator of an n8 tile: c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t),
//   c3 (g+8, 2t+1);
// - bf16 A of m16n8k16: a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..),
//   a3 (g+8, 2t+8..) -- so two adjacent n8 accumulator tiles, packed
//   pairwise, are one k16 A fragment;
// - tf32 A of m16n8k8: a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4);
//   tf32 B: b0 (k = t, n = g), b1 (k = t+4, n = g).

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kTileRows = 64;    // rows of every q / k tile
constexpr int kTcThreads = 128;  // 4 warps x 16 rows of a 64-row tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
// The -1e30 of a masked key and the 1e30 LSE of an empty row, in the
// exp2 domain: exp2(x * log2e) = exp(x).
constexpr float kBig2 = 1e30f * kLog2e;

// Row pitch, in elements, of a shared-memory tile DMAX wide: 16 bytes of
// padding a row, so that the eight row addresses of an ldmatrix (bf16), or
// the 8 x 4 lanes of a 32-bit fragment load (f32), fall in distinct banks.
template <typename T, int DMAX>
__host__ __device__ constexpr int tile_pitch() {
  return DMAX + 16 / static_cast<int>(sizeof(T));
}

// cp.async moves 16-byte chunks: q, k, v and the fourth strided operand
// (O in the forward, dO in the backward; its strides are P's o_*) must
// have 16-byte-aligned bases and batch, head and row strides (the wrapper
// checks first and names the tensor).  The stride of a dimension of size 1
// is never used.
template <typename P>
bool misaligned(const P& p, const void* fourth, int elem_bytes) {
  const void* ptrs[4] = {p.q, p.k, p.v, fourth};
  for (const void* ptr : ptrs)
    if (reinterpret_cast<uintptr_t>(ptr) % 16) return true;
  const long long st[12] = {p.q_sb, p.q_sh, p.q_st, p.k_sb, p.k_sh, p.k_st,
                            p.v_sb, p.v_sh, p.v_st, p.o_sb, p.o_sh, p.o_st};
  const int len[12] = {p.B, p.H, p.Tq, p.B, p.H, p.Tk,
                       p.B, p.H, p.Tk, p.B, p.H, p.Tq};
  for (int i = 0; i < 12; ++i)
    if (len[i] > 1 && st[i] * elem_bytes % 16) return true;
  return false;
}

__device__ __forceinline__ bool causal_live(int qrow, int kcol, int window) {
  return kcol <= qrow && (window == 0 || kcol > qrow - window);
}

__device__ __forceinline__ unsigned smem_u32(const void* ptr) {
  return static_cast<unsigned>(__cvta_generic_to_shared(ptr));
}

// 16-byte global -> shared copy; src_bytes = 0 zero-fills the destination.
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(unsigned dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's committed copy groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Issues the copies of a (64, DMAX) tile: rows row0.. of src (row stride
// ld elements) into dst (row pitch tile_pitch<T, DMAX>()).  Rows at or
// past nrows and columns at or past D are zero-filled.
template <int DMAX, typename T>
__device__ __forceinline__ void load_tile_async(T* dst, const T* src,
                                                long long ld, int row0,
                                                int nrows, int D) {
  constexpr int kPer = 16 / static_cast<int>(sizeof(T));  // per chunk
  constexpr int kChunks = DMAX / kPer;                     // in a row
  constexpr int kPitch = tile_pitch<T, DMAX>();
#pragma unroll
  for (int i = 0; i < kTileRows * kChunks / kTcThreads; ++i) {
    const int idx = threadIdx.x + i * kTcThreads;
    const int r = idx / kChunks;
    const int c = idx % kChunks;
    const int row = row0 + r;
    const bool in = row < nrows && c * kPer < D;
    cp_async16(smem_u32(dst + r * kPitch + c * kPer),
               in ? src + (long long)row * ld + c * kPer : src, in ? 16 : 0);
  }
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4],
                                              unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a . b for one m16n8k16 tile: a row-major 16x16 bf16, b 16x8 bf16
// (k-major pairs), d 16x8 f32.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a . b for one m16n8k8 tile in TF32: a 16x8, b 8x8, d 16x8 f32.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// cvt.rna.tf32.f32's rounding (to nearest, ties away from zero, 10
// mantissa bits) on the bits: add half a unit of the 13 dropped bits to the
// magnitude (the bits are sign-magnitude), then clear them.  Two integer
// operations; the cvt instruction compiles to a longer sequence guarded for
// NaN and infinity.  Finite inputs round as cvt.rna does, infinity stays
// infinity, and a NaN stays NaN unless its payload lies only in the
// dropped bits (it then reads as infinity, and the products still give NaN).
__device__ __forceinline__ unsigned tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x as hi + lo, both TF32: hi carries x's top 11 significant bits, lo the
// next 11, so hi*hi' + hi*lo' + lo*hi' keeps about 21 bits of a product.
__device__ __forceinline__ void split_tf32(float x, unsigned& hi,
                                           unsigned& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// d += a . b in split TF32: the small cross products first, then hi.hi.
__device__ __forceinline__ void mma_tf32x3(float (&d)[4],
                                           const unsigned (&ah)[4],
                                           const unsigned (&al)[4],
                                           unsigned bh0, unsigned bh1,
                                           unsigned bl0, unsigned bl1) {
  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}

// 2^x in one MUFU op.  Subnormal results (below 2^-126) flush to 0, far
// below the bf16 tolerance; -1e30-scale inputs give exactly 0.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two f32 rounded to bf16 and packed, `lo` in the low half (the lower
// column index of an mma fragment pair).
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// Shared-memory offsets (in elements, rows of pitch P) of this lane's
// ldmatrix.x4 row address.  A operand, 16x16 at (row0, col0): matrices
// (rows 0-7, cols 0-7), (8-15, 0-7), (0-7, 8-15), (8-15, 8-15) -- a0..a3.
template <int P>
__device__ __forceinline__ int a_off(int lane, int row0, int col0) {
  return (row0 + (lane & 15)) * P + col0 + ((lane >> 4) << 3);
}
// B operand of two n8 tiles stored n-major ([n][k], k contiguous), without
// .trans: matrices (n 0-7, k 0-7), (n 0-7, k 8-15), (n 8-15, k 0-7),
// (n 8-15, k 8-15) -- b0, b1 of the first tile, then of the second.
template <int P>
__device__ __forceinline__ int bn_off(int lane, int n0, int k0) {
  return (n0 + (lane & 7) + ((lane >> 4) << 3)) * P + k0 +
         (((lane >> 3) & 1) << 3);
}
// B operand of two n8 tiles stored k-major ([k][n], n contiguous), with
// .trans: matrices (k 0-7, n 0-7), (k 8-15, n 0-7), (k 0-7, n 8-15),
// (k 8-15, n 8-15) -- the same register order as bn_off's.
template <int P>
__device__ __forceinline__ int bk_off(int lane, int k0, int n0) {
  return (k0 + (lane & 7) + (((lane >> 3) & 1) << 3)) * P + n0 +
         ((lane >> 4) << 3);
}

}  // namespace
