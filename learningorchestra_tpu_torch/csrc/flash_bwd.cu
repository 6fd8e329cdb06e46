// Flash-attention backward for Hopper, CUDA C++: K2 (dQ) and K3 (dK, dV).
//
// Replaces: learningorchestra_tpu/ops/attention.py::_bwd_dq_kernel (K2) and
// ::_bwd_dkv_kernel (K3), the Pallas TPU kernels that _bwd_call launches
// from flash_attention's custom_vjp backward.
//
// What bounds them on the H100: at the training shape (B=32, H=12, T=128,
// D=64, bf16) K2 does 6*B*H*Tq*Tk*D and K3 8*B*H*Tq*Tk*D FLOPs (2.4 and
// 3.2 GFLOP) against ~32 and ~38 MB of q/k/v/dO/dQ/dK/dV traffic, so both
// are bound by bytes at the card's peaks (~10 us each).  This first design
// computes in f32 on the CUDA cores (no wgmma yet), so in practice the FMA
// issue rate of the recomputed S and dP products is what limits it.
//
// What the design does about it: the TPU kernels' two-pass split is kept.
// K2: one thread block owns one 64-row q tile (its Q, dO, LSE and delta
// stay in shared memory / registers) and loops over the live K/V tiles;
// dQ accumulates in registers.  K3: one block owns one 64-row K/V tile and
// loops over the live q tiles; dK and dV accumulate in registers.  Each
// pass recomputes S = Q K^T and dP = dO V^T, so S, P and dS never touch
// device memory: they live in registers and one 64x64 shared-memory tile.
// No atomics: every output element has one owner, so results are the same
// from run to run.  Loops visit only live tiles under causal / window
// masking (the Pallas kernels' _block_live / _win_lo / nq_total band), and
// ragged tails are masked in the kernel (zero-filled tiles) instead of
// padding copies.  q, k, v and dO are read through their strides, so the
// fused qkv projection's views and the transposed dO need no copy.  Each
// thread owns a 4x4 register tile of S/dP and a 4 x D/16 tile of its
// output(s); a row's 16 owner lanes sit in one warp, so the dS/P tile is
// shared through shared memory with only __syncwarp.
//
// Numerical contract (the Pallas kernels'):
// - S is accumulated in f32 and scaled by 1/sqrt(D) afterwards; masked
//   keys add -1e30 and P is multiplied by keep, never -inf;
// - P = exp(S - LSE) * keep in f32; dS = P * (dP - delta) * scale;
// - K2 rounds dS to k's storage type before dS.K; K3 rounds P to dO's type
//   before P^T.dO and dS to q's type before dS^T.Q (one storage type T
//   here: q, k, v and dO share it);
// - a fully masked q row has LSE = 1e30, so P = 0 and its dQ is exactly 0;
//   a masked key has keep = 0, so its dK and dV are exactly 0.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kB = 64;         // rows per tile, q and k alike
constexpr int kThreads = 256;  // 16 row groups x 16 column lanes
constexpr float kLseEmpty = 1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* km;     // (B, Tk) keep mask, or null for "keep all"
  const void* dout;
  const float* lse;    // (B, H, Tq) contiguous
  const float* delta;  // (B, H, Tq) contiguous
  void* dq;
  void* dk;
  void* dv;
  long long q_sb, q_sh, q_st;
  long long k_sb, k_sh, k_st;
  long long v_sb, v_sh, v_st;
  long long o_sb, o_sh, o_st;    // dO
  long long a_sb, a_sh, a_st;    // dQ (K2) or dK (K3)
  long long c_sb, c_sh, c_st;    // dV (K3)
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

// Rounds through the storage type: the reference's .astype(dtype) before a
// product.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// Loads a (64, D) tile starting at row `row0` into shared memory with row
// stride `ld`, as f32; rows at or past `nrows` are zero-filled.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          long long row_stride, int row0,
                                          int nrows, int D) {
  for (int idx = threadIdx.x; idx < kB * D; idx += kThreads) {
    const int r = idx / D;
    const int d = idx - r * D;
    const int row = row0 + r;
    dst[r * ld + d] =
        row < nrows ? to_f32(src[(long long)row * row_stride + d]) : 0.0f;
  }
}

__device__ __forceinline__ bool causal_live(int qrow, int kcol, int window) {
  return kcol <= qrow && (window == 0 || kcol > qrow - window);
}

// K2: dQ for one 64-row q tile, streaming the live K/V tiles.
template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const Params p) {
  constexpr int LD = DMAX + 1;  // padded: column lanes hit distinct banks
  constexpr int LDS = kB + 1;
  constexpr int NJ = DMAX / 16;  // dQ columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;              // kB x LD
  float* sDO = sQ + kB * LD;     // kB x LD
  float* sK = sDO + kB * LD;     // kB x LD
  float* sV = sK + kB * LD;      // kB x LD
  float* sDS = sV + kB * LD;     // kB x LDS
  float* sKeep = sDS + kB * LDS; // kB

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * kB;
  const int D = p.D;
  const int rg = threadIdx.x >> 4;  // q rows rg*4 .. rg*4+3
  const int cg = threadIdx.x & 15;  // key columns / dQ columns cg+16j

  const T* qp = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kp = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vp = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* op = static_cast<const T*>(p.dout) + b * p.o_sb + h * p.o_sh;
  load_tile<T>(sQ, LD, qp, p.q_st, q0, p.Tq, D);
  load_tile<T>(sDO, LD, op, p.o_st, q0, p.Tq, D);

  const long long rbase = ((long long)b * p.H + h) * p.Tq;
  float lse[4], delta[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + rg * 4 + i;
    lse[i] = row < p.Tq ? p.lse[rbase + row] : kLseEmpty;
    delta[i] = row < p.Tq ? p.delta[rbase + row] : 0.0f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.0f;
  }

  const int nk = (p.Tk + kB - 1) / kB;
  int kt_begin = 0;
  int kt_end = nk;
  if (p.causal) {
    // Live tiles: j*bk < (i+1)*bq and, with a window,
    // (j+1)*bk + window - 1 > i*bq  (_block_live / _win_lo).
    kt_end = min(nk, (q0 + kB + kB - 1) / kB);
    if (p.window > 0) {
      const int lo = q0 - (p.window - 1);
      kt_begin = lo > 0 ? lo / kB : 0;
    }
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kB;
    if (p.window > 0 && !((k0 + kB) + p.window - 1 > q0)) continue;
    __syncthreads();  // previous K/V tile fully consumed
    load_tile<T>(sK, LD, kp, p.k_st, k0, p.Tk, D);
    load_tile<T>(sV, LD, vp, p.v_st, k0, p.Tk, D);
    if (threadIdx.x < kB) {
      const int col = k0 + threadIdx.x;
      sKeep[threadIdx.x] =
          col < p.Tk ? (p.km ? p.km[(long long)b * p.Tk + col] : 1.0f) : 0.0f;
    }
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.0f;
    for (int d = 0; d < D; ++d) {
      float qv[4], ov[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = sQ[(rg * 4 + i) * LD + d];
        ov[i] = sDO[(rg * 4 + i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = sK[(cg + 16 * j) * LD + d];
        vv[j] = sV[(cg + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + rg * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + cg + 16 * j;
        float kk = sKeep[cg + 16 * j];
        if (p.causal) kk = causal_live(row, col, p.window) ? kk : 0.0f;
        const float sc = s[i][j] * p.scale + (kk - 1.0f) * 1e30f;
        const float pv = expf(sc - lse[i]) * kk;
        const float ds = pv * (dp[i][j] - delta[i]) * p.scale;
        sDS[(rg * 4 + i) * LDS + cg + 16 * j] = round_to<T>(ds);
      }
    }
    // A row group's 16 lanes share one warp: they alone read the dS rows
    // they just wrote.
    __syncwarp();

    for (int kk = 0; kk < kB; ++kk) {
      float dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = sDS[(rg * 4 + i) * LDS + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float kv = sK[kk * LD + cg + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(dsv[i], kv, acc[i][j]);
      }
    }
    __syncwarp();
  }

  T* dqp = static_cast<T*>(p.dq) + b * p.a_sb + h * p.a_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + rg * 4 + i;
    if (row >= p.Tq) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = cg + 16 * j;
      if (d < D) dqp[(long long)row * p.a_st + d] = from_f32<T>(acc[i][j]);
    }
  }
}

// K3: dK and dV for one 64-row K/V tile, streaming the live q tiles.
template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const Params p) {
  constexpr int LD = DMAX + 1;
  constexpr int LDS = kB + 1;
  constexpr int NJ = DMAX / 16;
  extern __shared__ float smem[];
  float* sK = smem;                 // kB x LD
  float* sV = sK + kB * LD;         // kB x LD
  float* sQ = sV + kB * LD;         // kB x LD
  float* sDO = sQ + kB * LD;        // kB x LD
  float* sPt = sDO + kB * LD;       // kB x LDS: P^T, rounded to T
  float* sDSt = sPt + kB * LDS;     // kB x LDS: dS^T, rounded to T
  float* sLse = sDSt + kB * LDS;    // kB
  float* sDelta = sLse + kB;        // kB

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int k0 = blockIdx.x * kB;
  const int D = p.D;
  const int rg = threadIdx.x >> 4;  // key rows rg*4 .. rg*4+3
  const int cg = threadIdx.x & 15;  // q columns / dK,dV columns cg+16j

  const T* qp = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kp = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vp = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* op = static_cast<const T*>(p.dout) + b * p.o_sb + h * p.o_sh;
  load_tile<T>(sK, LD, kp, p.k_st, k0, p.Tk, D);
  load_tile<T>(sV, LD, vp, p.v_st, k0, p.Tk, D);

  float keep[4], dk[4][NJ], dv[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int col = k0 + rg * 4 + i;
    keep[i] =
        col < p.Tk ? (p.km ? p.km[(long long)b * p.Tk + col] : 1.0f) : 0.0f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) dk[i][j] = dv[i][j] = 0.0f;
  }

  const long long rbase = ((long long)b * p.H + h) * p.Tq;
  const int nq = (p.Tq + kB - 1) / kB;
  int it_begin = 0;
  int it_end = nq;
  if (p.causal) {
    // The q band of this K/V tile: j*bk < (i+1)*bq and, with a window,
    // i*bq < (j+1)*bk + window - 1  (_block_live; _bwd_call's q_map).
    it_begin = k0 / kB;
    if (p.window > 0)
      it_end = min(nq, (k0 + kB + p.window - 1 + kB - 1) / kB);
  }

  for (int it = it_begin; it < it_end; ++it) {
    const int q0 = it * kB;
    __syncthreads();  // previous q tile fully consumed
    load_tile<T>(sQ, LD, qp, p.q_st, q0, p.Tq, D);
    load_tile<T>(sDO, LD, op, p.o_st, q0, p.Tq, D);
    if (threadIdx.x < kB) {
      const int row = q0 + threadIdx.x;
      // Rows past Tq get LSE = 1e30, so their P is exactly 0.
      sLse[threadIdx.x] = row < p.Tq ? p.lse[rbase + row] : kLseEmpty;
      sDelta[threadIdx.x] = row < p.Tq ? p.delta[rbase + row] : 0.0f;
    }
    __syncthreads();

    // S^T and dP^T for this thread's 4 keys x 4 queries.
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.0f;
    for (int d = 0; d < D; ++d) {
      float kv[4], vv[4], qv[4], ov[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        kv[i] = sK[(rg * 4 + i) * LD + d];
        vv[i] = sV[(rg * 4 + i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        qv[j] = sQ[(cg + 16 * j) * LD + d];
        ov[j] = sDO[(cg + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
          dp[i][j] = fmaf(vv[i], ov[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int col = k0 + rg * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qc = cg + 16 * j;
        float kk = keep[i];
        if (p.causal) kk = causal_live(q0 + qc, col, p.window) ? kk : 0.0f;
        const float sc = s[i][j] * p.scale + (kk - 1.0f) * 1e30f;
        const float pv = expf(sc - sLse[qc]) * kk;
        const float ds = pv * (dp[i][j] - sDelta[qc]) * p.scale;
        sPt[(rg * 4 + i) * LDS + qc] = round_to<T>(pv);
        sDSt[(rg * 4 + i) * LDS + qc] = round_to<T>(ds);
      }
    }
    __syncwarp();

    for (int qq = 0; qq < kB; ++qq) {
      float pt[4], dst[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pt[i] = sPt[(rg * 4 + i) * LDS + qq];
        dst[i] = sDSt[(rg * 4 + i) * LDS + qq];
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float ov = sDO[qq * LD + cg + 16 * j];
        const float qv = sQ[qq * LD + cg + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          dv[i][j] = fmaf(pt[i], ov, dv[i][j]);
          dk[i][j] = fmaf(dst[i], qv, dk[i][j]);
        }
      }
    }
    __syncwarp();
  }

  T* dkp = static_cast<T*>(p.dk) + b * p.a_sb + h * p.a_sh;
  T* dvp = static_cast<T*>(p.dv) + b * p.c_sb + h * p.c_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + rg * 4 + i;
    if (row >= p.Tk) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = cg + 16 * j;
      if (d < D) {
        dkp[(long long)row * p.a_st + d] = from_f32<T>(dk[i][j]);
        dvp[(long long)row * p.c_st + d] = from_f32<T>(dv[i][j]);
      }
    }
  }
}

template <typename T, int DMAX>
int launch_dq(const Params& p, cudaStream_t stream) {
  constexpr int LD = DMAX + 1;
  const size_t smem =
      sizeof(float) * (size_t)(4 * kB * LD + kB * (kB + 1) + kB);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, DMAX>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.Tq + kB - 1) / kB, p.H, p.B);
  flash_bwd_dq_kernel<T, DMAX><<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, int DMAX>
int launch_dkv(const Params& p, cudaStream_t stream) {
  constexpr int LD = DMAX + 1;
  const size_t smem =
      sizeof(float) * (size_t)(4 * kB * LD + 2 * kB * (kB + 1) + 2 * kB);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, DMAX>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.Tk + kB - 1) / kB, p.H, p.B);
  flash_bwd_dkv_kernel<T, DMAX><<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

bool bad_shape(int B, int H, int Tq, int Tk, int D) {
  return D <= 0 || D > 128 || D % 8 != 0 || Tq <= 0 || Tk <= 0 || B <= 0 ||
         H <= 0 || B > 65535 || H > 65535;
}

Params make_params(const void* q, const void* k, const void* v,
                   const float* km, const void* dout, const float* lse,
                   const float* delta, const long long* st, int nstrides,
                   int B, int H, int Tq, int Tk, int D, int causal,
                   int window, float scale) {
  Params p = {};
  p.q = q; p.k = k; p.v = v; p.km = km; p.dout = dout;
  p.lse = lse; p.delta = delta;
  p.q_sb = st[0]; p.q_sh = st[1]; p.q_st = st[2];
  p.k_sb = st[3]; p.k_sh = st[4]; p.k_st = st[5];
  p.v_sb = st[6]; p.v_sh = st[7]; p.v_st = st[8];
  p.o_sb = st[9]; p.o_sh = st[10]; p.o_st = st[11];
  p.a_sb = st[12]; p.a_sh = st[13]; p.a_st = st[14];
  if (nstrides > 15) {
    p.c_sb = st[15]; p.c_sh = st[16]; p.c_st = st[17];
  }
  p.B = B; p.H = H; p.Tq = Tq; p.Tk = Tk; p.D = D;
  p.causal = causal; p.window = window; p.scale = scale;
  return p;
}

}  // namespace

// strides: int64 in elements, (batch, head, row) for q, k, v, dO, dQ (15);
// the last dimension of every tensor is contiguous.  dtype: 0 = f32,
// 1 = bf16.  Returns 0 or the cudaError_t of the launch.
extern "C" int lo_flash_bwd_dq(const void* q, const void* k, const void* v,
                               const float* km, const void* dout,
                               const float* lse, const float* delta,
                               void* dq, const long long* strides, int B,
                               int H, int Tq, int Tk, int D, int dtype,
                               int causal, int window, float scale,
                               void* stream) {
  if (bad_shape(B, H, Tq, Tk, D)) return (int)cudaErrorInvalidValue;
  Params p = make_params(q, k, v, km, dout, lse, delta, strides, 15, B, H,
                         Tq, Tk, D, causal, window, scale);
  p.dq = dq;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return D <= 64 ? launch_dq<float, 64>(p, s) : launch_dq<float, 128>(p, s);
  if (dtype == 1)
    return D <= 64 ? launch_dq<__nv_bfloat16, 64>(p, s)
                   : launch_dq<__nv_bfloat16, 128>(p, s);
  return (int)cudaErrorInvalidValue;
}

// strides: as lo_flash_bwd_dq's with dK and dV in place of dQ (18).
extern "C" int lo_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                const float* km, const void* dout,
                                const float* lse, const float* delta,
                                void* dk, void* dv, const long long* strides,
                                int B, int H, int Tq, int Tk, int D,
                                int dtype, int causal, int window,
                                float scale, void* stream) {
  if (bad_shape(B, H, Tq, Tk, D)) return (int)cudaErrorInvalidValue;
  Params p = make_params(q, k, v, km, dout, lse, delta, strides, 18, B, H,
                         Tq, Tk, D, causal, window, scale);
  p.dk = dk;
  p.dv = dv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return D <= 64 ? launch_dkv<float, 64>(p, s)
                   : launch_dkv<float, 128>(p, s);
  if (dtype == 1)
    return D <= 64 ? launch_dkv<__nv_bfloat16, 64>(p, s)
                   : launch_dkv<__nv_bfloat16, 128>(p, s);
  return (int)cudaErrorInvalidValue;
}
