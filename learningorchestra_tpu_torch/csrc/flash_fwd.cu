// Flash-attention forward (online softmax) for Hopper, CUDA C++.
//
// Replaces: learningorchestra_tpu/ops/attention.py::_fwd_kernel (the
// Pallas TPU kernel reached through _fwd_call / flash_attention).
//
// What bounds it on the H100: at the serving shape (B<=64, H=12, T=512,
// D=64, f32) the work is 4*B*H*Tq*Tk*D FLOPs against O(B*H*T*D) bytes, so
// it is bound by arithmetic, not by memory.  float32 inputs have no
// full-rate tensor-core path (TF32 would change the numbers), so the
// ceiling is the 67 TFLOP/s of the CUDA cores.
//
// What this simple design does about it: one thread block per (64-row
// q tile, head, batch); K/V tiles of 64 rows stream through shared memory
// in a loop that takes the place of the TPU's sequential grid axis; the
// running max / sum / accumulator stay in registers in f32.  Each thread
// owns a 4x4 register tile of S = Q K^T and a 4 x D/16 tile of O, so every
// shared-memory load feeds two or more FMAs.  Tiles that causal / window
// masking kills are skipped, and the ragged tail is masked in the kernel
// (zero-filled tiles, keep = 0) instead of padding copies.  No wgmma/TMA
// yet: those are later work.
//
// Numerical contract (same as the Pallas kernel):
// - S is accumulated in f32 and scaled by 1/sqrt(D) afterwards;
// - masked keys add -1e30 and their probabilities are multiplied by keep,
//   never -inf (exp(m_prev - m_new) of a fully masked tile stays finite);
// - in bf16 mode P is rounded to bf16 before P.V (l keeps the f32 P);
// - rows with no live key give O = 0 and LSE = +1e30.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // q rows per block
constexpr int kBK = 64;        // k rows per streamed tile
constexpr int kThreads = 256;  // 16 row groups x 16 column lanes
constexpr float kNegBig = -1e30f;
constexpr float kLseEmpty = 1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* km;  // (B, Tk) keep mask, or null for "keep all"
  void* o;
  float* lse;       // (B, H, Tq) contiguous
  long long q_sb, q_sh, q_st;
  long long k_sb, k_sh, k_st;
  long long v_sb, v_sh, v_st;
  long long o_sb, o_sh, o_st;
  int B, H, Tq, Tk, D;
  int causal;
  int window;  // 0 = no window
  float scale;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Loads a (64, D) tile starting at row `row0` into shared memory with row
// stride `ld`, as f32; rows at or past `nrows` are zero-filled.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          long long row_stride, int row0,
                                          int nrows, int D) {
  for (int idx = threadIdx.x; idx < 64 * D; idx += kThreads) {
    const int r = idx / D;
    const int d = idx - r * D;
    const int row = row0 + r;
    dst[r * ld + d] =
        row < nrows ? to_f32(src[(long long)row * row_stride + d]) : 0.0f;
  }
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const Params p) {
  constexpr int LDQ = DMAX + 1;  // padded: row-group lanes hit distinct banks
  constexpr int LDP = kBK + 1;
  constexpr int NJ = DMAX / 16;  // O columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;                // kBQ x LDQ
  float* sK = sQ + kBQ * LDQ;      // kBK x LDQ
  float* sV = sK + kBK * LDQ;      // kBK x DMAX
  float* sP = sV + kBK * DMAX;     // kBQ x LDP
  float* sKeep = sP + kBQ * LDP;   // kBK

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int D = p.D;
  const int rg = threadIdx.x >> 4;  // rows rg*4 .. rg*4+3
  const int cg = threadIdx.x & 15;  // S columns cg+16j, O columns cg+16j

  const T* qp = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kp = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vp = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  load_tile<T>(sQ, LDQ, qp, p.q_st, q0, p.Tq, D);

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegBig;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.0f;
  }

  const int nk = (p.Tk + kBK - 1) / kBK;
  int kt_end = nk;
  int kt_begin = 0;
  if (p.causal) {
    // Live tiles: j*bk < (i+1)*bq  (the Pallas kernel's _block_live).
    kt_end = min(nk, (q0 + kBQ + kBK - 1) / kBK);
    if (p.window > 0) {
      const int lo = q0 - (p.window - 1);
      kt_begin = lo > 0 ? lo / kBK : 0;
    }
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBK;
    if (p.window > 0 && !((k0 + kBK) + p.window - 1 > q0)) continue;
    __syncthreads();  // previous tile fully consumed
    load_tile<T>(sK, LDQ, kp, p.k_st, k0, p.Tk, D);
    load_tile<T>(sV, DMAX, vp, p.v_st, k0, p.Tk, D);
    if (threadIdx.x < kBK) {
      const int col = k0 + threadIdx.x;
      sKeep[threadIdx.x] =
          col < p.Tk ? (p.km ? p.km[(long long)b * p.Tk + col] : 1.0f) : 0.0f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(rg * 4 + i) * LDQ + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = sK[(cg + 16 * j) * LDQ + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + rg * 4 + i;
      float keep[4];
      float mx = kNegBig;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + cg + 16 * j;
        float kk = sKeep[cg + 16 * j];
        if (p.causal) {
          bool live = col <= row;
          if (p.window > 0) live = live && (col > row - p.window);
          kk = live ? kk : 0.0f;
        }
        keep[j] = kk;
        s[i][j] = s[i][j] * p.scale + (kk - 1.0f) * 1e30f;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pv = expf(s[i][j] - m_new) * keep[j];
        rs += pv;
        // bf16 mode rounds P to the storage type before P.V.
        sP[(rg * 4 + i) * LDP + cg + 16 * j] = to_f32(from_f32<T>(pv));
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
    // A row group's 16 lanes share one warp: they alone read the P rows
    // they just wrote.
    __syncwarp();

    for (int kk = 0; kk < kBK; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sP[(rg * 4 + i) * LDP + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float vv = sV[kk * DMAX + cg + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
    __syncwarp();
  }

  T* op = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + rg * 4 + i;
    if (row >= p.Tq) continue;
    const bool nonempty = l[i] > 0.0f;
    const float denom = nonempty ? l[i] : 1.0f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = cg + 16 * j;
      if (d < D)
        op[(long long)row * p.o_st + d] =
            from_f32<T>(nonempty ? acc[i][j] / denom : 0.0f);
    }
    if (cg == 0)
      p.lse[((long long)b * p.H + h) * p.Tq + row] =
          nonempty ? m[i] + logf(fmaxf(l[i], 1e-30f)) : kLseEmpty;
  }
}

template <typename T, int DMAX>
int launch(const Params& p, cudaStream_t stream) {
  constexpr int LDQ = DMAX + 1;
  const size_t smem =
      sizeof(float) * (size_t)(kBQ * LDQ + kBK * LDQ + kBK * DMAX +
                               kBQ * (kBK + 1) + kBK);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.Tq + kBQ - 1) / kBQ, p.H, p.B);
  flash_fwd_kernel<T, DMAX><<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// strides: 12 int64 in elements, (batch, head, row) for q, k, v, o; the
// last dimension of every tensor is contiguous.  dtype: 0 = f32, 1 = bf16.
// Returns 0 or the cudaError_t of the launch.
extern "C" int lo_flash_fwd(const void* q, const void* k, const void* v,
                            const float* km, void* o, float* lse,
                            const long long* strides, int B, int H, int Tq,
                            int Tk, int D, int dtype, int causal, int window,
                            float scale, void* stream) {
  if (D <= 0 || D > 128 || D % 8 != 0 || Tq <= 0 || Tk <= 0 || B <= 0 ||
      H <= 0 || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q; p.k = k; p.v = v; p.km = km; p.o = o; p.lse = lse;
  p.q_sb = strides[0]; p.q_sh = strides[1]; p.q_st = strides[2];
  p.k_sb = strides[3]; p.k_sh = strides[4]; p.k_st = strides[5];
  p.v_sb = strides[6]; p.v_sh = strides[7]; p.v_st = strides[8];
  p.o_sb = strides[9]; p.o_sh = strides[10]; p.o_st = strides[11];
  p.B = B; p.H = H; p.Tq = Tq; p.Tk = Tk; p.D = D;
  p.causal = causal; p.window = window; p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return D <= 64 ? launch<float, 64>(p, s) : launch<float, 128>(p, s);
  if (dtype == 1)
    return D <= 64 ? launch<__nv_bfloat16, 64>(p, s)
                   : launch<__nv_bfloat16, 128>(p, s);
  return (int)cudaErrorInvalidValue;
}
