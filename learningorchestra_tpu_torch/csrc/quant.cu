// Row-wise int8 quantize / dequantize for Hopper, CUDA C++.
//
// Replaces: learningorchestra_tpu/ops/quant.py::_quantize_kernel (via
// quantize_rowwise) and ::_dequantize_kernel (via dequantize_rowwise).
//
// What bounds them on the H100: each is one max-reduction per row plus
// one elementwise pass, about 1 FLOP per byte and no tensor-core work, so
// both are bound by memory (3.35 TB/s): quantize reads 4 bytes and writes
// 1 per element, dequantize reads 1 and writes 4.
//
// What this simple design does about it: quantize gives each row to one
// warp (8 rows per block); lanes stride the row so loads coalesce, a warp
// shuffle finds the row's max, and the second pass re-reads the row (from
// L1/L2 for the rows on the serving path, which are at most 12 KB).
// Dequantize is a flat grid-stride loop.  Neither stages through shared
// memory: there is nothing to reuse.
//
// Deterministic mode is bit-identical to the Pallas kernel as XLA compiles
// it: scale = max(|x|max, 1e-12) * f32(1/127), then IEEE division x / scale
// (this file must not be built with fast-math), round half to even
// (rintf), clip to +-127.  Stochastic mode floors x / scale + u with u
// made of 23 bits of Philox4x32-10, keyed by (seed, row) and counted by
// column / 4; it is unbiased but does not reproduce the TPU's bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowsPerBlock = 8;

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

__global__ void quantize_kernel(const float* __restrict__ x,
                                int8_t* __restrict__ values,
                                float* __restrict__ scales, long long n, int d,
                                int stochastic, uint32_t seed) {
  const int lane = threadIdx.x & 31;
  const long long row =
      (long long)blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= n) return;
  const float* xr = x + row * d;
  float amax = 0.0f;
  for (int c = lane; c < d; c += 32) amax = fmaxf(amax, fabsf(xr[c]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  // XLA compiles the reference's `/ 127.0` into a multiply by the f32
  // reciprocal; that product, not a division, is the reference's scale.
  const float scale = fmaxf(amax, 1e-12f) * (1.0f / 127.0f);
  int8_t* vr = values + row * d;
  for (int c = lane; c < d; c += 32) {
    const float s = xr[c] / scale;
    float q;
    if (stochastic) {
      uint32_t ctr[4] = {(uint32_t)(c >> 2), 0u, 0u, 0u};
      philox4x32_10(ctr, seed, (uint32_t)row);
      const uint32_t bits = ctr[c & 3];
      const float u = (float)(int)(bits >> 9) * (1.0f / 8388608.0f);
      q = floorf(s + u);
    } else {
      q = rintf(s);
    }
    vr[c] = (int8_t)fminf(fmaxf(q, -127.0f), 127.0f);
  }
  if (lane == 0) scales[row] = scale;
}

__global__ void dequantize_kernel(const int8_t* __restrict__ values,
                                  const float* __restrict__ scales,
                                  float* __restrict__ out, long long total,
                                  int d) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += stride)
    out[i] = (float)values[i] * scales[i / d];
}

}  // namespace

// x (n, d) f32 contiguous -> values (n, d) int8, scales (n) f32.
extern "C" int lo_quantize_rowwise(const void* x, void* values, void* scales,
                                   long long n, int d, int stochastic,
                                   unsigned int seed, void* stream) {
  if (n <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  const long long blocks = (n + kRowsPerBlock - 1) / kRowsPerBlock;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  quantize_kernel<<<(unsigned)blocks, 32 * kRowsPerBlock, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<int8_t*>(values),
      static_cast<float*>(scales), n, d, stochastic, seed);
  return (int)cudaGetLastError();
}

// values (n, d) int8, scales (n) f32 -> out (n, d) f32, all contiguous.
extern "C" int lo_dequantize_rowwise(const void* values, const void* scales,
                                     void* out, long long n, int d,
                                     void* stream) {
  if (n <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  const long long total = n * (long long)d;
  long long blocks = (total + 255) / 256;
  if (blocks > 132LL * 32) blocks = 132LL * 32;
  dequantize_kernel<<<(unsigned)blocks, 256, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(values), static_cast<const float*>(scales),
      static_cast<float*>(out), total, d);
  return (int)cudaGetLastError();
}
