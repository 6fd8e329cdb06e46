// Row-wise int8 quantize (K4) / dequantize (K5) for Hopper, CUDA C++, with
// one grouped launch over every leaf of an artifact.
//
// Replaces: learningorchestra_tpu/ops/quant.py::_quantize_kernel (via
// quantize_rowwise) and ::_dequantize_kernel (via dequantize_rowwise).
//
// What bounds them on the H100: one max-reduction per row plus one
// elementwise pass, about 1 operation per byte and no tensor-core work, so
// both are bound by memory (3.35 TB/s): quantize reads 4 bytes and writes 1
// per element, dequantize reads 1 and writes 4.  A BERT-base artifact is 51
// leaves, 50 of which move under 12 MB (a few microseconds each), so one
// launch per leaf spends much of its time on launch edges and host pacing.
//
// What the design does about it:
// - One launch takes up to kMaxLeaves leaves.  Each leaf is a descriptor
//   (pointers, n, d, row class, first block) in the kernel's parameters
//   (__grid_constant__, under the classic 4 KB limit); a block finds its
//   leaf by a binary search over the first blocks.  Row indices, and so
//   the stochastic mode's Philox keys, stay leaf-local.
// - Quantize reads each row from HBM once, in 16-byte loads, and holds it
//   in registers (kSlots float4 a thread) through the max and the quantize
//   pass; it writes 4 packed int8 per 32-bit store and one scale per row.
//   Row classes, by width d (a multiple of 4, 16-byte aligned source):
//   d <= 128 shares a warp between 32 / lanes rows (lanes = the power of
//   two >= d / 4; each lane holds one float4 of kSlots rows, a sub-warp
//   shuffle finds each row's max); d <= 1024 takes one warp per row and
//   d <= 4096 one block (4 warps) per row.  Other rows (wider, not a
//   multiple of 4, or a misaligned source) take the general class: a warp
//   per row, scalar loads, the row read a second time (from L1/L2).
// - Stochastic mode runs one Philox4x32-10 per 4 consecutive columns and
//   uses all four words: key (seed, row), counter col / 4, word col % 4.
// - Dequantize gives a block a contiguous run of rows of one leaf (about
//   2,048 chunks); a thread knows its chunk's row by stepping from one
//   division made at its start, so there is no integer division per
//   element.  A chunk is 4 int8 (one 4-byte load, one float4 store) where
//   d is a multiple of 4, else one element: consecutive lanes take
//   consecutive chunks, so every load and store instruction of a warp is
//   one contiguous span.  (With 16 int8 a lane, each of a lane's four
//   float4 stores would write half of every 32-byte sector the warp
//   touches; that measured at a third of the bound.)
//
// Deterministic mode is bit-identical to the Pallas kernel as XLA compiles
// it: scale = max(|x|max, 1e-12) * f32(1/127), then IEEE division x / scale
// (this file must not be built with fast-math), round half to even
// (rintf), clip to +-127.  Stochastic mode floors x / scale + u with u made
// of 23 bits of Philox4x32-10; it is unbiased but does not reproduce the
// TPU's bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;   // 4 warps per block, both kernels
constexpr int kSlots = 8;       // float4 a quantize thread holds
constexpr int kMaxLeaves = 64;  // descriptors in one launch's parameters

// Quantize row classes (ops/quant.py plans them).
enum : int { kSubWarp = 0, kWarp = 1, kBlock = 2, kGeneral = 3 };

struct LeafDesc {
  const void* src;    // K4: f32 (n, d); K5: int8 (n, d)
  void* dst;          // K4: int8 (n, d); K5: f32 (n, d)
  float* scales;      // (n,) f32: K4 writes, K5 reads
  long long n;
  long long first_block;  // this leaf's first block in the launch
  int d;
  int cls;             // K4: row class; K5: chunk width (4 or 1)
  int lanes;           // K4 sub-warp: lanes per row; K5: chunks per row
  int rows_per_block;
};

struct Group {
  LeafDesc leaf[kMaxLeaves];
  int count;
  int stochastic;
  uint32_t seed;
};
static_assert(sizeof(Group) <= 4096, "descriptors must fit 4 KB of params");

__device__ __forceinline__ int find_leaf(const Group& g, long long block) {
  int lo = 0, hi = g.count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (g.leaf[mid].first_block <= block) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

__device__ __forceinline__ void philox4x32_10(uint32_t c[4], uint32_t k0,
                                              uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t lo0 = 0xD2511F53u * c[0];
    const uint32_t hi0 = __umulhi(0xD2511F53u, c[0]);
    const uint32_t lo1 = 0xCD9E8D57u * c[2];
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c[2]);
    const uint32_t n0 = hi1 ^ c[1] ^ k0;
    const uint32_t n2 = hi0 ^ c[3] ^ k1;
    c[0] = n0;
    c[1] = lo1;
    c[2] = n2;
    c[3] = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
}

// Uniforms in [0, 1) from 23 bits of each Philox word of counter col4.
__device__ __forceinline__ void uniforms(float u[4], int stochastic,
                                         uint32_t seed, uint32_t row,
                                         uint32_t col4) {
  u[0] = u[1] = u[2] = u[3] = 0.0f;
  if (!stochastic) return;
  uint32_t c[4] = {col4, 0u, 0u, 0u};
  philox4x32_10(c, seed, row);
#pragma unroll
  for (int k = 0; k < 4; ++k)
    u[k] = (float)(int)(c[k] >> 9) * (1.0f / 8388608.0f);
}

__device__ __forceinline__ float row_scale(float amax) {
  // XLA compiles the reference's `/ 127.0` into a multiply by the f32
  // reciprocal; that product, not a division, is the reference's scale.
  return fmaxf(amax, 1e-12f) * (1.0f / 127.0f);
}

__device__ __forceinline__ int quant1(float x, float scale, float u,
                                      int stochastic) {
  const float s = x / scale;
  const float q = stochastic ? floorf(s + u) : rintf(s);
  return (int)fminf(fmaxf(q, -127.0f), 127.0f);
}

__device__ __forceinline__ uint32_t quant4(float4 v, float scale,
                                           int stochastic, uint32_t seed,
                                           uint32_t row, uint32_t col4) {
  float u[4];
  uniforms(u, stochastic, seed, row, col4);
  const int q0 = quant1(v.x, scale, u[0], stochastic);
  const int q1 = quant1(v.y, scale, u[1], stochastic);
  const int q2 = quant1(v.z, scale, u[2], stochastic);
  const int q3 = quant1(v.w, scale, u[3], stochastic);
  return ((uint32_t)q0 & 0xFFu) | (((uint32_t)q1 & 0xFFu) << 8) |
         (((uint32_t)q2 & 0xFFu) << 16) | ((uint32_t)q3 << 24);
}

__device__ __forceinline__ float amax4(float m, float4 v) {
  return fmaxf(fmaxf(m, fmaxf(fabsf(v.x), fabsf(v.y))),
               fmaxf(fabsf(v.z), fabsf(v.w)));
}

__device__ __forceinline__ float warp_max(float m) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  return m;
}

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldcs(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ void store4(int8_t* p, uint32_t w) {
  __stcs(reinterpret_cast<unsigned int*>(p), w);
}

// d <= 128: 32 / lanes rows share a warp; each lane holds one float4 of
// kSlots rows (a warp covers kSlots * 32 / lanes rows).
__device__ __forceinline__ void quant_subwarp(const Group& g,
                                              const LeafDesc& L,
                                              long long blk) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int shift = __ffs(L.lanes) - 1;  // lanes is a power of two
  const int rpw = 32 >> shift;
  const int c4 = lane & (L.lanes - 1);
  const bool live_col = c4 < (L.d >> 2);
  const long long row0 = blk * L.rows_per_block +
                         (long long)warp * kSlots * rpw + (lane >> shift);
  const float* src = static_cast<const float*>(L.src);
  float4 v[kSlots];
  float m[kSlots];
#pragma unroll
  for (int i = 0; i < kSlots; ++i) {
    const long long row = row0 + (long long)i * rpw;
    v[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (live_col && row < L.n) v[i] = load4(src + row * L.d + 4 * c4);
    m[i] = amax4(0.0f, v[i]);
  }
  // Lanes of one row are an aligned group of `lanes`: xor stays inside.
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    if (off < L.lanes) {
#pragma unroll
      for (int i = 0; i < kSlots; ++i)
        m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], off));
    }
  }
  int8_t* dst = static_cast<int8_t*>(L.dst);
#pragma unroll
  for (int i = 0; i < kSlots; ++i) {
    const long long row = row0 + (long long)i * rpw;
    if (live_col && row < L.n) {
      const float scale = row_scale(m[i]);
      store4(dst + row * L.d + 4 * c4,
             quant4(v[i], scale, g.stochastic, g.seed, (uint32_t)row, c4));
      if (c4 == 0) L.scales[row] = scale;
    }
  }
}

// 128 < d <= 1024 (one warp a row) or 1024 < d <= 4096 (a block a row):
// the row lives in registers, kSlots float4 a thread at most.
template <int kLanes>
__device__ __forceinline__ void quant_wide(const Group& g, const LeafDesc& L,
                                           long long blk) {
  const int lane = kLanes == 32 ? (threadIdx.x & 31) : threadIdx.x;
  const long long row =
      kLanes == 32 ? blk * L.rows_per_block + (threadIdx.x >> 5) : blk;
  if (row >= L.n) return;  // warp-uniform; the block class has n rows
  const int d4 = L.d >> 2;
  const float* src = static_cast<const float*>(L.src) + row * L.d;
  float4 v[kSlots];
  float m = 0.0f;
#pragma unroll
  for (int i = 0; i < kSlots; ++i) {
    const int c4 = i * kLanes + lane;
    v[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (c4 < d4) v[i] = load4(src + 4 * c4);
    m = amax4(m, v[i]);
  }
  m = warp_max(m);
  if (kLanes > 32) {
    __shared__ float red[kThreads / 32];
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = m;
    __syncthreads();
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) m = fmaxf(m, red[w]);
  }
  const float scale = row_scale(m);
  int8_t* dst = static_cast<int8_t*>(L.dst) + row * L.d;
#pragma unroll
  for (int i = 0; i < kSlots; ++i) {
    const int c4 = i * kLanes + lane;
    if (c4 < d4)
      store4(dst + 4 * c4, quant4(v[i], scale, g.stochastic, g.seed,
                                  (uint32_t)row, (uint32_t)c4));
  }
  if (threadIdx.x % kLanes == 0) L.scales[row] = scale;
}

// Any d and alignment: a warp a row, scalar loads, the row read twice
// (the second time from L1/L2), columns taken 4 at a time so that one
// Philox call serves 4 of them.
__device__ __forceinline__ void quant_general(const Group& g,
                                              const LeafDesc& L,
                                              long long blk) {
  const int lane = threadIdx.x & 31;
  const long long row = blk * L.rows_per_block + (threadIdx.x >> 5);
  if (row >= L.n) return;
  const int d = L.d;
  const float* xr = static_cast<const float*>(L.src) + row * d;
  float m = 0.0f;
  for (int c = lane; c < d; c += 32) m = fmaxf(m, fabsf(xr[c]));
  const float scale = row_scale(warp_max(m));
  int8_t* vr = static_cast<int8_t*>(L.dst) + row * d;
  const int d4 = (d + 3) >> 2;
  for (int c4 = lane; c4 < d4; c4 += 32) {
    float u[4];
    uniforms(u, g.stochastic, g.seed, (uint32_t)row, (uint32_t)c4);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int c = 4 * c4 + k;
      if (c < d) vr[c] = (int8_t)quant1(xr[c], scale, u[k], g.stochastic);
    }
  }
  if (lane == 0) L.scales[row] = scale;
}

__global__ void __launch_bounds__(kThreads)
    quantize_group_kernel(const __grid_constant__ Group g) {
  const long long block = blockIdx.x;
  const LeafDesc& L = g.leaf[find_leaf(g, block)];
  const long long blk = block - L.first_block;
  switch (L.cls) {
    case kSubWarp: quant_subwarp(g, L, blk); break;
    case kWarp: quant_wide<32>(g, L, blk); break;
    case kBlock: quant_wide<kThreads>(g, L, blk); break;
    default: quant_general(g, L, blk); break;
  }
}

__device__ __forceinline__ float4 widen4(uint32_t w, float s) {
  // Sign-extend each byte: shift it to the top, then arithmetic right.
  return make_float4((float)((int)(w << 24) >> 24) * s,
                     (float)((int)(w << 16) >> 24) * s,
                     (float)((int)(w << 8) >> 24) * s,
                     (float)((int)w >> 24) * s);
}

// A block's run of rows of one leaf is one contiguous span of chunks (W
// elements each); consecutive threads take consecutive chunks, so a warp
// loads 32 * W contiguous int8 and stores 32 * W contiguous floats per
// instruction.  A thread gathers kGather chunks (and their rows' scales)
// before it stores any, and steps its chunk's (row, col) from one division
// made at its start.
template <int W>
__device__ __forceinline__ void dequant_run(const LeafDesc& L,
                                            long long blk) {
  constexpr int kGather = 8;
  const long long r0 = blk * L.rows_per_block;
  const long long left = L.n - r0;
  const int rows = left < L.rows_per_block ? (int)left : L.rows_per_block;
  const int cpr = L.lanes;
  const int total = rows * cpr;
  int row = threadIdx.x / cpr;
  int col = threadIdx.x - row * cpr;
  const int dr = kThreads / cpr, dc = kThreads - dr * cpr;
  const int8_t* __restrict__ src =
      static_cast<const int8_t*>(L.src) + r0 * L.d;
  float* __restrict__ dst = static_cast<float*>(L.dst) + r0 * L.d;
  const float* __restrict__ scales = L.scales + r0;
  for (int k0 = threadIdx.x; k0 < total; k0 += kThreads * kGather) {
    uint32_t w[kGather];
    float s[kGather];
#pragma unroll
    for (int u = 0; u < kGather; ++u) {
      const int k = k0 + u * kThreads;
      w[u] = 0u;
      s[u] = 0.0f;
      if (k < total) {
        if (W == 4) w[u] = __ldcs(reinterpret_cast<const unsigned int*>(
                             src + (long long)k * W));
        else w[u] = (uint32_t)(int)src[k];
        s[u] = __ldg(scales + row);
      }
      col += dc;
      row += dr;
      if (col >= cpr) {
        col -= cpr;
        ++row;
      }
    }
#pragma unroll
    for (int u = 0; u < kGather; ++u) {
      const int k = k0 + u * kThreads;
      if (k >= total) break;
      if (W == 4)
        __stcs(reinterpret_cast<float4*>(dst + (long long)k * W),
               widen4(w[u], s[u]));
      else
        dst[k] = (float)(int)w[u] * s[u];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    dequantize_group_kernel(const __grid_constant__ Group g) {
  const long long block = blockIdx.x;
  const LeafDesc& L = g.leaf[find_leaf(g, block)];
  const long long blk = block - L.first_block;
  if (L.cls == 4) dequant_run<4>(L, blk);
  else dequant_run<1>(L, blk);
}

bool aligned(const void* p, unsigned a) {
  return (reinterpret_cast<uintptr_t>(p) & (a - 1)) == 0;
}

// The plan's invariants, checked before a launch: a descriptor the kernel
// would read out of bounds with is refused, not run.
bool quantize_leaf_ok(const LeafDesc& L) {
  if (L.cls == kGeneral) return L.rows_per_block == 4;
  if (L.d % 4 || !aligned(L.src, 16) || !aligned(L.dst, 4)) return false;
  const int d4 = L.d / 4;
  switch (L.cls) {
    case kSubWarp:
      return L.lanes >= 1 && L.lanes <= 32 && !(L.lanes & (L.lanes - 1)) &&
             d4 <= L.lanes && L.rows_per_block == 4 * kSlots * (32 / L.lanes);
    case kWarp: return d4 <= 32 * kSlots && L.rows_per_block == 4;
    case kBlock: return d4 <= kThreads * kSlots && L.rows_per_block == 1;
    default: return false;
  }
}

bool dequantize_leaf_ok(const LeafDesc& L) {
  if (L.cls != 4 && L.cls != 1) return false;
  if (L.d % L.cls || L.lanes != L.d / L.cls || L.rows_per_block < 1 ||
      (long long)L.rows_per_block * L.lanes > 2147483647LL)
    return false;
  return L.cls == 1 || (aligned(L.src, 4) && aligned(L.dst, 16));
}

int launch(void (*kernel)(Group), bool (*leaf_ok)(const LeafDesc&),
           const LeafDesc* leaves, int count, int stochastic, uint32_t seed,
           void* stream) {
  if (count < 1 || count > kMaxLeaves) return (int)cudaErrorInvalidValue;
  Group g;
  long long blocks = 0;
  for (int i = 0; i < count; ++i) {
    const LeafDesc& L = leaves[i];
    if (L.n < 1 || L.d < 1 || L.first_block != blocks || !leaf_ok(L))
      return (int)cudaErrorInvalidValue;
    blocks += (L.n + L.rows_per_block - 1) / L.rows_per_block;
    g.leaf[i] = L;
  }
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  g.count = count;
  g.stochastic = stochastic;
  g.seed = seed;
  kernel<<<(unsigned)blocks, kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(g);
  return (int)cudaGetLastError();
}

}  // namespace

// One launch over `count` leaves (descriptors in leaf order, first blocks
// a prefix sum): f32 (n, d) -> int8 (n, d) + f32 scales (n,), each
// contiguous.
extern "C" int lo_quantize_group(const void* leaves, int count,
                                 int stochastic, unsigned int seed,
                                 void* stream) {
  return launch(quantize_group_kernel, quantize_leaf_ok,
                static_cast<const LeafDesc*>(leaves), count, stochastic,
                seed, stream);
}

// int8 (n, d) x f32 scales (n,) -> f32 (n, d), each contiguous.
extern "C" int lo_dequantize_group(const void* leaves, int count,
                                   void* stream) {
  return launch(dequantize_group_kernel, dequantize_leaf_ok,
                static_cast<const LeafDesc*>(leaves), count, 0, 0u, stream);
}
