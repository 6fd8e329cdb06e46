// Flash-attention backward for Hopper, CUDA C++: K2 (dQ) and K3 (dK, dV).
//
// Replaces: learningorchestra_tpu/ops/attention.py::_bwd_dq_kernel (K2) and
// ::_bwd_dkv_kernel (K3), the Pallas TPU kernels that _bwd_call launches
// from flash_attention's custom_vjp backward.
//
// What bounds them on the H100: at the training shape (B=32, H=12, T=128,
// D=64, bf16) K2 does 6*B*H*Tq*Tk*D and K3 8*B*H*Tq*Tk*D FLOPs (2.4 and
// 3.2 GFLOP: 2.4 and 3.3 us at 989 TFLOP/s) against ~32 and ~38 MB of
// q/k/v/dO/dQ/dK/dV traffic (9.5 and 11.4 us at 3.35 TB/s), so both are
// bound by bytes.
//
// Two routes, chosen by dtype:
// - bf16 (the training path): tensor cores.  Every product -- S = Q K^T,
//   dP = dO V^T, dQ = dS K in K2; S^T = K Q^T, dP^T = V dO^T, dV = P^T dO,
//   dK = dS^T Q in K3 -- is mma.sync.m16n8k16 bf16 -> f32, with operands
//   read from shared memory by ldmatrix (.trans where the contraction runs
//   along the tile's rows).  Four warps own 16 rows each of a 64-row tile.
//   As in FlashAttention-2, the f32 accumulator fragment of two adjacent
//   n8 tiles of S (or S^T) has the layout of an A fragment of k16, so P
//   and dS are formed in registers and packed to bf16 A fragments -- the
//   packing IS the reference's rounding of dS (and P) to the storage type
//   -- and never touch shared memory.  Tiles sit in shared memory as bf16
//   (rows padded by 16 bytes, so ldmatrix's eight row addresses fall in
//   distinct banks), loaded by 16-byte cp.async.cg into a two-stage ring:
//   the next K/V tile (K2) or Q/dO/LSE/delta tile (K3) is in flight while
//   the current one is multiplied.  Not wgmma: at this shape the operation
//   bound is a quarter of the bytes bound, so mma.sync at half the card's
//   peak still leaves the kernels bound by bytes, and wgmma's 64-row
//   warpgroup tiles and shared-memory descriptors buy nothing at T=128.
//   Not TMA: its descriptors are encoded on the host per tensor, and the
//   q/k/v views change pointer every call on a host-bound step.  cp.async
//   needs 16-byte-aligned base pointers and strides; the wrapper checks.
//   The helpers (cp.async, ldmatrix, mma, fragment offsets) are K1's too:
//   tc_common.cuh.
// - f32: the first design, SIMT f32 on the CUDA cores: a TF32 mma
//   would not hold the f32 bar (5e-5).  Each thread owns a 4x4 register
//   tile of S/dP and a 4 x D/16 tile of its output(s); a row's 16 owner
//   lanes sit in one warp, so the dS/P tile is shared through shared
//   memory with only __syncwarp.
//
// Both routes keep the TPU kernels' two-pass split.  K2: one thread block
// owns one 64-row q tile and loops over the live K/V tiles; dQ
// accumulates in registers.  K3: one block owns one 64-row K/V tile and
// loops over the live q tiles; dK and dV accumulate in registers.  Each
// pass recomputes S and dP, so S, P and dS never touch device memory.  No
// atomics: every output element has one owner and every sum runs in a
// fixed order, so results are bitwise the same from run to run.  Loops
// visit only live tiles under causal / window masking (the Pallas
// kernels' _block_live / _win_lo / nq_total band), and ragged tails are
// masked in the kernel (zero-filled tiles; D below the template width
// reads zero-filled columns) instead of padding copies.  q, k, v and dO
// are read through their strides, so the fused qkv projection's views and
// the transposed dO need no copy.
//
// Numerical contract (the Pallas kernels'):
// - S is accumulated in f32 and scaled by 1/sqrt(D) afterwards; masked
//   keys add -1e30 and P is multiplied by keep, never -inf;
// - P = exp(S - LSE) * keep in f32; dS = P * (dP - delta) * scale;
// - K2 rounds dS to k's storage type before dS.K; K3 rounds P to dO's type
//   before P^T.dO and dS to q's type before dS^T.Q (one storage type T
//   here: q, k, v and dO share it).  The bf16 route sums in another order
//   than the plain version (mma fragments), so it agrees with it to the
//   bf16 tolerance, not bit for bit;
// - a fully masked q row has LSE = 1e30, so P = 0 and its dQ is exactly 0;
//   a masked key has keep = 0, so its dK and dV are exactly 0.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "tc_common.cuh"

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

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }

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

// ---------------------------------------------------------------------------
// bf16 route: tensor cores (mma.sync), ldmatrix, cp.async ring.
// ---------------------------------------------------------------------------

// K2 on tensor cores: dQ for one 64-row q tile, streaming the live K/V
// tiles through a two-stage ring.  CAUSAL compiles the causal / window
// test in or out.
template <int DMAX, bool CAUSAL>
__global__ void __launch_bounds__(kTcThreads)
flash_bwd_dq_tc_kernel(const Params p) {
  constexpr int kPitch = DMAX + 8;
  constexpr int kTile = kB * kPitch;
  constexpr int kSteps = DMAX / 16;  // k16 steps over D
  // The contraction over D is unrolled only at D = 64: at D = 128, ptxas
  // hoisting every step's fragments beside the accumulators would spill.
  constexpr int kUnrollD = DMAX > 64 ? 1 : kSteps;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sDO = sQ + kTile;
  bf16* sK = sDO + kTile;      // 2 stages
  bf16* sV = sK + 2 * kTile;   // 2 stages
  float* sKeep = reinterpret_cast<float*>(sV + 2 * kTile);  // 2 x kB

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * kB;
  const int D = p.D;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // fragment row (and row + 8)
  const int t2 = (lane & 3) * 2;  // fragment column pair

  const bf16* qp = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* kp = static_cast<const bf16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const bf16* vp = static_cast<const bf16*>(p.v) + b * p.v_sb + h * p.v_sh;
  const bf16* op = static_cast<const bf16*>(p.dout) + b * p.o_sb +
                   h * p.o_sh;
  const float* kmp = p.km ? p.km + (long long)b * p.Tk : nullptr;

  const int nk = (p.Tk + kB - 1) / kB;
  int kt_begin = 0;
  int kt_end = nk;
  if (p.causal) {
    // Live tiles: j*bk < (i+1)*bq and, with a window,
    // (j+1)*bk + window - 1 > i*bq  (_block_live / _win_lo): contiguous.
    kt_end = min(nk, (q0 + kB + kB - 1) / kB);
    if (p.window > 0) {
      const int lo = q0 - (p.window - 1);
      kt_begin = lo > 0 ? lo / kB : 0;
    }
  }

  auto load_kv = [&](int kt, int stage) {
    const int k0 = kt * kB;
    load_tile_async<DMAX>(sK + stage * kTile, kp, p.k_st, k0, p.Tk, D);
    load_tile_async<DMAX>(sV + stage * kTile, vp, p.v_st, k0, p.Tk, D);
    if (kmp && threadIdx.x < kB) {
      const int col = k0 + threadIdx.x;
      // Keys past Tk read as keep = 0.
      cp_async4(smem_u32(sKeep + stage * kB + threadIdx.x),
                col < p.Tk ? kmp + col : kmp, col < p.Tk ? 4 : 0);
    }
  };
  load_tile_async<DMAX>(sQ, qp, p.q_st, q0, p.Tq, D);
  load_tile_async<DMAX>(sDO, op, p.o_st, q0, p.Tq, D);
  if (kt_begin < kt_end) load_kv(kt_begin, 0);
  cp_async_commit();

  // This thread's two rows; rows past Tq get LSE = 1e30, so P = 0.
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  const long long rbase = ((long long)b * p.H + h) * p.Tq;
  float lse2[2], delta[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    lse2[i] = row[i] < p.Tq ? p.lse[rbase + row[i]] * kLog2e : kBig2;
    // Pre-scaled: dS = P (dP - delta) scale = P (dP scale - delta scale).
    delta[i] = row[i] < p.Tq ? p.delta[rbase + row[i]] * p.scale : 0.0f;
  }
  const float scale2 = p.scale * kLog2e;

  float acc[DMAX / 8][4];
#pragma unroll
  for (int n = 0; n < DMAX / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int stage = (kt - kt_begin) & 1;
    if (kt + 1 < kt_end) load_kv(kt + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // this tile (and Q, dO) has landed
    __syncthreads();
    const bf16* cK = sK + stage * kTile;
    const bf16* cV = sV + stage * kTile;
    const float* cKeep = sKeep + stage * kB;
    const int k0 = kt * kB;

    // S and dP for this warp's 16 rows x 64 keys: 8 n8 tiles each.
    float s[8][4], dp[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.0f;
#pragma unroll(kUnrollD)
    for (int kd = 0; kd < kSteps; ++kd) {
      unsigned aq[4], ado[4];
      ldsm_x4(aq, smem_u32(sQ + a_off<kPitch>(lane, warp * 16, kd * 16)));
      ldsm_x4(ado, smem_u32(sDO + a_off<kPitch>(lane, warp * 16, kd * 16)));
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        const int off = bn_off<kPitch>(lane, np * 16, kd * 16);
        unsigned bk[4], bv[4];
        ldsm_x4(bk, smem_u32(cK + off));
        ldsm_x4(bv, smem_u32(cV + off));
        mma_bf16(s[2 * np], aq, bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], aq, bk[2], bk[3]);
        mma_bf16(dp[2 * np], ado, bv[0], bv[1]);
        mma_bf16(dp[2 * np + 1], ado, bv[2], bv[3]);
      }
    }

    // P = exp(S*scale - 1e30*(1-keep) - LSE) * keep; dS = P (dP - delta)
    // scale, packed to bf16 A fragments over the 64 keys (4 k16 steps).
    unsigned ads[4][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int cl = n * 8 + t2 + (e & 1);
        const int col = k0 + cl;
        const int i = e >> 1;
        float kk = kmp ? cKeep[cl] : (col < p.Tk ? 1.0f : 0.0f);
        if (CAUSAL) kk = causal_live(row[i], col, p.window) ? kk : 0.0f;
        const float x = fmaf(s[n][e], scale2, -lse2[i]);
        const float pv = exp2_ftz(fmaf(kk - 1.0f, kBig2, x)) * kk;
        ds[e] = pv * fmaf(dp[n][e], p.scale, -delta[i]);
      }
      ads[n >> 1][(n & 1) * 2] = pack_bf16(ds[0], ds[1]);
      ads[n >> 1][(n & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }

    // dQ += dS . K: K read k-major (keys are the contraction).
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int dn = 0; dn < DMAX / 16; ++dn) {
        unsigned bk[4];
        ldsm_x4_trans(bk, smem_u32(cK + bk_off<kPitch>(lane, j * 16,
                                                       dn * 16)));
        mma_bf16(acc[2 * dn], ads[j], bk[0], bk[1]);
        mma_bf16(acc[2 * dn + 1], ads[j], bk[2], bk[3]);
      }
    __syncthreads();  // this stage is free for the tile two ahead
  }
  cp_async_wait<0>();

  bf16* dqp = static_cast<bf16*>(p.dq) + b * p.a_sb + h * p.a_sh;
#pragma unroll
  for (int n = 0; n < DMAX / 8; ++n) {
    const int d = n * 8 + t2;
    if (d >= D) continue;
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (row[i] < p.Tq)
        *reinterpret_cast<unsigned*>(dqp + (long long)row[i] * p.a_st + d) =
            pack_bf16(acc[n][2 * i], acc[n][2 * i + 1]);
  }
}

// K3 on tensor cores: dK and dV for one 64-row K/V tile, streaming the
// live q tiles (Q, dO, LSE, delta) through a two-stage ring.  Each q tile
// is taken in sub-tiles of NSUB queries, which bounds the S^T / dP^T
// fragments a thread holds beside its dK and dV accumulators; CAUSAL as
// K2's.
template <int DMAX, int NSUB, bool CAUSAL>
__global__ void __launch_bounds__(kTcThreads)
flash_bwd_dkv_tc_kernel(const Params p) {
  constexpr int kPitch = DMAX + 8;
  constexpr int kTile = kB * kPitch;
  constexpr int kSteps = DMAX / 16;
  constexpr int kUnrollD = DMAX > 64 ? 1 : kSteps;  // as in K2
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + kTile;
  bf16* sQ = sV + kTile;        // 2 stages
  bf16* sDO = sQ + 2 * kTile;   // 2 stages
  float* sLse = reinterpret_cast<float*>(sDO + 2 * kTile);  // 2 x kB
  float* sDelta = sLse + 2 * kB;                            // 2 x kB

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int k0 = blockIdx.x * kB;
  const int D = p.D;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t2 = (lane & 3) * 2;

  const bf16* qp = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* kp = static_cast<const bf16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const bf16* vp = static_cast<const bf16*>(p.v) + b * p.v_sb + h * p.v_sh;
  const bf16* op = static_cast<const bf16*>(p.dout) + b * p.o_sb +
                   h * p.o_sh;
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

  auto load_q = [&](int it, int stage) {
    const int q0 = it * kB;
    load_tile_async<DMAX>(sQ + stage * kTile, qp, p.q_st, q0, p.Tq, D);
    load_tile_async<DMAX>(sDO + stage * kTile, op, p.o_st, q0, p.Tq, D);
    // Threads 0-63 copy LSE, 64-127 delta; rows past Tq read 0 (and
    // their P is zeroed below).
    const int r = threadIdx.x & (kB - 1);
    const float* src = threadIdx.x < kB ? p.lse : p.delta;
    float* dst = (threadIdx.x < kB ? sLse : sDelta) + stage * kB + r;
    const bool in = q0 + r < p.Tq;
    cp_async4(smem_u32(dst), in ? src + rbase + q0 + r : src, in ? 4 : 0);
  };
  load_tile_async<DMAX>(sK, kp, p.k_st, k0, p.Tk, D);
  load_tile_async<DMAX>(sV, vp, p.v_st, k0, p.Tk, D);
  if (it_begin < it_end) load_q(it_begin, 0);
  cp_async_commit();

  // This thread's two key rows; keys past Tk have keep = 0.
  const int key[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};
  float keep[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    keep[i] = key[i] < p.Tk
                  ? (p.km ? p.km[(long long)b * p.Tk + key[i]] : 1.0f)
                  : 0.0f;
  const float scale2 = p.scale * kLog2e;

  float dk[DMAX / 8][4], dv[DMAX / 8][4];
#pragma unroll
  for (int n = 0; n < DMAX / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.0f;

  for (int it = it_begin; it < it_end; ++it) {
    const int stage = (it - it_begin) & 1;
    if (it + 1 < it_end) load_q(it + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // this q tile (and K, V) has landed
    __syncthreads();
    const bf16* cQ = sQ + stage * kTile;
    const bf16* cDO = sDO + stage * kTile;
    const float* cLse = sLse + stage * kB;
    const float* cDelta = sDelta + stage * kB;
    const int q0 = it * kB;

#pragma unroll
    for (int qs = 0; qs < kB; qs += NSUB) {
      // S^T and dP^T for this warp's 16 keys x NSUB queries.
      float s[NSUB / 8][4], dp[NSUB / 8][4];
#pragma unroll
      for (int n = 0; n < NSUB / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.0f;
#pragma unroll(kUnrollD)
      for (int kd = 0; kd < kSteps; ++kd) {
        unsigned ak[4], av[4];
        ldsm_x4(ak, smem_u32(sK + a_off<kPitch>(lane, warp * 16, kd * 16)));
        ldsm_x4(av, smem_u32(sV + a_off<kPitch>(lane, warp * 16, kd * 16)));
#pragma unroll
        for (int np = 0; np < NSUB / 16; ++np) {
          const int off = bn_off<kPitch>(lane, qs + np * 16, kd * 16);
          unsigned bq[4], bo[4];
          ldsm_x4(bq, smem_u32(cQ + off));
          ldsm_x4(bo, smem_u32(cDO + off));
          mma_bf16(s[2 * np], ak, bq[0], bq[1]);
          mma_bf16(s[2 * np + 1], ak, bq[2], bq[3]);
          mma_bf16(dp[2 * np], av, bo[0], bo[1]);
          mma_bf16(dp[2 * np + 1], av, bo[2], bo[3]);
        }
      }

      // P^T and dS^T packed to bf16 A fragments over the NSUB queries.
      unsigned ap[NSUB / 16][4], ads[NSUB / 16][4];
#pragma unroll
      for (int n = 0; n < NSUB / 8; ++n) {
        float pv[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ql = qs + n * 8 + t2 + (e & 1);
          const int qrow = q0 + ql;
          const int i = e >> 1;
          float kk = keep[i];
          if (CAUSAL) kk = causal_live(qrow, key[i], p.window) ? kk : 0.0f;
          const float l2 = qrow < p.Tq ? cLse[ql] * kLog2e : kBig2;
          const float x = fmaf(s[n][e], scale2, -l2);
          pv[e] = exp2_ftz(fmaf(kk - 1.0f, kBig2, x)) * kk;
          ds[e] = pv[e] * fmaf(dp[n][e], p.scale, -cDelta[ql] * p.scale);
        }
        ap[n >> 1][(n & 1) * 2] = pack_bf16(pv[0], pv[1]);
        ap[n >> 1][(n & 1) * 2 + 1] = pack_bf16(pv[2], pv[3]);
        ads[n >> 1][(n & 1) * 2] = pack_bf16(ds[0], ds[1]);
        ads[n >> 1][(n & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
      }

      // dV += P^T . dO and dK += dS^T . Q: dO and Q read k-major (the
      // queries are the contraction).
#pragma unroll
      for (int j = 0; j < NSUB / 16; ++j)
#pragma unroll
        for (int dn = 0; dn < DMAX / 16; ++dn) {
          const int off = bk_off<kPitch>(lane, qs + j * 16, dn * 16);
          unsigned bo[4], bq[4];
          ldsm_x4_trans(bo, smem_u32(cDO + off));
          ldsm_x4_trans(bq, smem_u32(cQ + off));
          mma_bf16(dv[2 * dn], ap[j], bo[0], bo[1]);
          mma_bf16(dv[2 * dn + 1], ap[j], bo[2], bo[3]);
          mma_bf16(dk[2 * dn], ads[j], bq[0], bq[1]);
          mma_bf16(dk[2 * dn + 1], ads[j], bq[2], bq[3]);
        }
    }
    __syncthreads();  // this stage is free for the tile two ahead
  }
  cp_async_wait<0>();

  bf16* dkp = static_cast<bf16*>(p.dk) + b * p.a_sb + h * p.a_sh;
  bf16* dvp = static_cast<bf16*>(p.dv) + b * p.c_sb + h * p.c_sh;
#pragma unroll
  for (int n = 0; n < DMAX / 8; ++n) {
    const int d = n * 8 + t2;
    if (d >= D) continue;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (key[i] >= p.Tk) continue;
      *reinterpret_cast<unsigned*>(dkp + (long long)key[i] * p.a_st + d) =
          pack_bf16(dk[n][2 * i], dk[n][2 * i + 1]);
      *reinterpret_cast<unsigned*>(dvp + (long long)key[i] * p.c_st + d) =
          pack_bf16(dv[n][2 * i], dv[n][2 * i + 1]);
    }
  }
}

template <int DMAX>
int launch_dq_tc(const Params& p, cudaStream_t stream) {
  const size_t smem = sizeof(bf16) * 6 * kB * (DMAX + 8) +
                      sizeof(float) * 2 * kB;
  void (*kernel)(const Params) =
      p.causal ? flash_bwd_dq_tc_kernel<DMAX, true>
               : flash_bwd_dq_tc_kernel<DMAX, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.Tq + kB - 1) / kB, p.H, p.B);
  kernel<<<grid, kTcThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int DMAX, int NSUB>
int launch_dkv_tc(const Params& p, cudaStream_t stream) {
  const size_t smem = sizeof(bf16) * 6 * kB * (DMAX + 8) +
                      sizeof(float) * 4 * kB;
  void (*kernel)(const Params) =
      p.causal ? flash_bwd_dkv_tc_kernel<DMAX, NSUB, true>
               : flash_bwd_dkv_tc_kernel<DMAX, NSUB, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.Tk + kB - 1) / kB, p.H, p.B);
  kernel<<<grid, kTcThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
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
  if (dtype == 1) {
    if (misaligned(p, p.dout, sizeof(bf16)))
      return (int)cudaErrorMisalignedAddress;
    return D <= 64 ? launch_dq_tc<64>(p, s) : launch_dq_tc<128>(p, s);
  }
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
  if (dtype == 1) {
    if (misaligned(p, p.dout, sizeof(bf16)))
      return (int)cudaErrorMisalignedAddress;
    // D = 128 takes 16-query sub-tiles: its dK and dV accumulators alone
    // hold 128 f32 registers a thread.
    return D <= 64 ? launch_dkv_tc<64, 64>(p, s)
                   : launch_dkv_tc<128, 16>(p, s);
  }
  return (int)cudaErrorInvalidValue;
}
