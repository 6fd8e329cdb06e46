// Flash-attention forward (online softmax) for Hopper, CUDA C++: K1.
//
// Replaces: learningorchestra_tpu/ops/attention.py::_fwd_kernel (the
// Pallas TPU kernel reached through _fwd_call / flash_attention).
//
// What bounds it on the H100:
// - bf16 (the training path, B=32, H=12, T=128, D=64): 4*B*H*T*T*D =
//   1.6 GFLOP (1.6 us at 989 TFLOP/s) against 25 MB of q/k/v/O traffic
//   (7.6 us at 3.35 TB/s): bytes.
// - f32 (the serving bucket, B=64, H=12, T=512, D=64): 51.5 GFLOP against
//   0.40 GB.  f32 products have no tensor-core instruction; this route
//   runs each as three TF32 products (below), 155 GFLOP at 495 TFLOP/s =
//   0.31 ms against 0.12 ms of bytes: operations.
//
// Design: FlashAttention-2's forward on mma.sync, one template for both
// routes.  A block of 4 warps owns a 64-row q tile of one (batch, head);
// each warp owns 16 rows.  The Q tile is copied to shared memory once (the
// bf16 route holds its A fragments in registers for the whole loop, the
// f32 route re-reads them each step); 64-row K/V tiles and the key-mask
// row stream through a two-stage cp.async ring (16-byte copies; rows past
// Tk and columns past D zero-filled by a zero source size, so D = 40 runs
// as 48 with zero columns).  S = Q K^T for the warp's 16 x 64 scores sits
// in 32 f32 accumulator registers a thread; scale, mask and the online
// softmax run there (each thread owns rows g and g+8, the row max takes
// two shfl_xor across the quad, l is summed per thread and across the
// quad once at the end); P goes from the S accumulators straight into the
// A fragments of O += P V.  Only tiles that the causal diagonal or the
// window's lower edge cuts take the per-element causal test.  Tiles that
// causal / window masking kills are never loaded.
// - bf16 route: mma.sync.m16n8k16 bf16 -> f32; K's B fragments by
//   ldmatrix, V's by ldmatrix.trans; two adjacent n8 accumulator tiles of S
//   are one k16 A fragment, so P is packed pairwise to bf16 -- the
//   reference's rounding of P to the storage type -- after l has summed the
//   f32 P.  exp is one ex2.approx.ftz on log2e-prescaled scores.
// - f32 route: split TF32 on mma.sync.m16n8k8.  Each operand element x is
//   hi = tf32(x) plus lo = tf32(x - hi), and a product a.b is taken as
//   lo.hi' + hi.lo' + hi.hi' with f32 accumulation: about 21 significant
//   bits per product, ~1e-6 on scores of order 1 (one TF32 product, ~5e-4,
//   would miss the 2e-5 f32 bar).  The m16n8k8 tf32 A fragment holds columns
//   (t, t+4) where the accumulator holds (2t, 2t+1); a contraction runs in
//   any order of its index, so P's accumulator columns 2t, 2t+1 serve as
//   A's k = t, t+4 and V's B fragment reads rows 2t and 2t+1 to match.
//   Q's and K's fragments come by ldmatrix (an 8-row x 16-byte matrix is
//   the tf32 fragment layout); there is no 32-bit ldmatrix.trans, so V's
//   are 32-bit shared loads from tiles whose 16-byte row padding puts the
//   8 x 4 lanes of a fragment in distinct banks.  The split rounds on the
//   bits with two integer operations (tc_common.cuh: the cvt instruction
//   costs several times that).  P stays f32 (rounding it to f32 is the
//   identity); exp and log are the full-precision expf / logf.
//
// No atomics: every output element has one owner and every sum runs in a
// fixed order, so results are bitwise the same from run to run.
//
// Numerical contract (the Pallas kernel's):
// - S is accumulated in f32 and scaled by 1/sqrt(D) afterwards;
// - masked keys add -1e30 and their probabilities are multiplied by keep,
//   never -inf (exp(m_prev - m_new) of a fully masked tile stays finite);
// - l sums the f32 P; in bf16 P is rounded to bf16 before P.V;
// - rows with no live key give O = 0 and LSE = +1e30 exactly.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "tc_common.cuh"

namespace {

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

// The products of one route: Q's A fragments, S = Q K^T and O += P V for
// one warp's 16 rows against a 64-row K/V tile, the softmax's exponential
// and the epilogue's store.
template <typename T, int DMAX>
struct Route;

template <int DMAX>
struct Route<bf16, DMAX> {
  static constexpr int kPitch = tile_pitch<bf16, DMAX>();
  // Scores are prescaled by log2e: exp(x) = exp2(x * log2e).
  static constexpr float kBase = kLog2e;
  static constexpr float kBig = kBig2;

  struct QFrag {
    unsigned a[DMAX / 16][4];
  };

  __device__ static void load_q(QFrag& q, const bf16* sQ, int warp,
                                int lane) {
#pragma unroll
    for (int kd = 0; kd < DMAX / 16; ++kd)
      ldsm_x4(q.a[kd], smem_u32(sQ + a_off<kPitch>(lane, warp * 16,
                                                   kd * 16)));
  }

  __device__ static void qk(float (&s)[8][4], const QFrag& q, const bf16*,
                            const bf16* cK, int, int lane) {
#pragma unroll
    for (int kd = 0; kd < DMAX / 16; ++kd)
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        unsigned bk[4];
        ldsm_x4(bk, smem_u32(cK + bn_off<kPitch>(lane, np * 16, kd * 16)));
        mma_bf16(s[2 * np], q.a[kd], bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], q.a[kd], bk[2], bk[3]);
      }
  }

  // p: the f32 P in S's accumulator layout.  V read k-major (the keys are
  // the contraction).
  __device__ static void pv(float (&acc)[DMAX / 8][4], const float (&p)[8][4],
                            const bf16* cV, int lane) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const unsigned ap[4] = {
          pack_bf16(p[2 * j][0], p[2 * j][1]),
          pack_bf16(p[2 * j][2], p[2 * j][3]),
          pack_bf16(p[2 * j + 1][0], p[2 * j + 1][1]),
          pack_bf16(p[2 * j + 1][2], p[2 * j + 1][3])};
#pragma unroll
      for (int dn = 0; dn < DMAX / 16; ++dn) {
        unsigned bv[4];
        ldsm_x4_trans(bv, smem_u32(cV + bk_off<kPitch>(lane, j * 16,
                                                       dn * 16)));
        mma_bf16(acc[2 * dn], ap, bv[0], bv[1]);
        mma_bf16(acc[2 * dn + 1], ap, bv[2], bv[3]);
      }
    }
  }

  __device__ static float ex(float x) { return exp2_ftz(x); }
  __device__ static float lse(float m, float l) {
    return m * kLn2 + logf(fmaxf(l, 1e-30f));
  }
  __device__ static void store2(bf16* dst, float a, float b) {
    *reinterpret_cast<unsigned*>(dst) = pack_bf16(a, b);
  }
};

template <int DMAX>
struct Route<float, DMAX> {
  static constexpr int kPitch = tile_pitch<float, DMAX>();
  static constexpr float kBase = 1.0f;
  static constexpr float kBig = 1e30f;

  // Q's split fragments would take 8 registers a k8 step (64 at D = 64)
  // beside S and O, and spilled: they are re-read from shared memory and
  // split each step instead.
  struct QFrag {};
  __device__ static void load_q(QFrag&, const float*, int, int) {}

  // Q's A and K's B fragments by ldmatrix: an 8-row x 16-byte matrix gives
  // lane (g, t) the 32-bit word (g, t), the tf32 fragment layout.  Q:
  // matrices (rows 0-7, cols 0-3), (8-15, 0-3), (0-7, 4-7), (8-15, 4-7) =
  // a0..a3.  K, stored [key][d]: (keys 0-7, d 0-3), (0-7, 4-7), (8-15,
  // 0-3), (8-15, 4-7) = b0, b1 of two n8 tiles.
  __device__ static void qk(float (&s)[8][4], const QFrag&, const float* sQ,
                            const float* cK, int warp, int lane) {
    const float* qa =
        sQ + (warp * 16 + (lane & 15)) * kPitch + ((lane >> 4) << 2);
    const float* kb = cK + ((lane & 7) + ((lane >> 4) << 3)) * kPitch +
                      (((lane >> 3) & 1) << 2);
    // At D = 128 the contraction over D is unrolled by 2 only: ptxas
    // hoisting every step's loads beside the 64 O accumulators would spill.
    constexpr int kUnrollD = DMAX > 64 ? 2 : DMAX / 8;
#pragma unroll(kUnrollD)
    for (int kd = 0; kd < DMAX / 8; ++kd) {
      unsigned a[4], ah[4], al[4];
      ldsm_x4(a, smem_u32(qa + kd * 8));
#pragma unroll
      for (int e = 0; e < 4; ++e)
        split_tf32(__uint_as_float(a[e]), ah[e], al[e]);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        unsigned b[4], bh[4], bl[4];
        ldsm_x4(b, smem_u32(kb + np * 16 * kPitch + kd * 8));
#pragma unroll
        for (int e = 0; e < 4; ++e)
          split_tf32(__uint_as_float(b[e]), bh[e], bl[e]);
        mma_tf32x3(s[2 * np], ah, al, bh[0], bh[1], bl[0], bl[1]);
        mma_tf32x3(s[2 * np + 1], ah, al, bh[2], bh[3], bl[2], bl[3]);
      }
    }
  }

  // Keys j*8 .. +7 are one k8 step, taken in the order 0, 2, 4, 6, 1, 3,
  // 5, 7: A's k = t, t+4 are P's accumulator columns 2t, 2t+1, and V's
  // B fragment reads rows 2t, 2t+1 (b0 = V[j*8 + 2t][dn*8 + g]).
  __device__ static void pv(float (&acc)[DMAX / 8][4], const float (&p)[8][4],
                            const float* cV, int lane) {
    const float* vb = cV + 2 * (lane & 3) * kPitch + (lane >> 2);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      unsigned ah[4], al[4];
      split_tf32(p[j][0], ah[0], al[0]);
      split_tf32(p[j][2], ah[1], al[1]);
      split_tf32(p[j][1], ah[2], al[2]);
      split_tf32(p[j][3], ah[3], al[3]);
#pragma unroll
      for (int dn = 0; dn < DMAX / 8; ++dn) {
        unsigned bh0, bl0, bh1, bl1;
        split_tf32(vb[j * 8 * kPitch + dn * 8], bh0, bl0);
        split_tf32(vb[(j * 8 + 1) * kPitch + dn * 8], bh1, bl1);
        mma_tf32x3(acc[dn], ah, al, bh0, bh1, bl0, bl1);
      }
    }
  }

  __device__ static float ex(float x) { return expf(x); }
  __device__ static float lse(float m, float l) {
    return m + logf(fmaxf(l, 1e-30f));
  }
  __device__ static void store2(float* dst, float a, float b) {
    *reinterpret_cast<float2*>(dst) = make_float2(a, b);
  }
};

// K1 on tensor cores: O and LSE for one 64-row q tile of one (batch,
// head), streaming the live K/V tiles.  CAUSAL compiles the causal /
// window test in or out.
template <typename T, int DMAX, bool CAUSAL>
__global__ void __launch_bounds__(kTcThreads)
flash_fwd_tc_kernel(const Params p) {
  using R = Route<T, DMAX>;
  constexpr int kTile = kTileRows * R::kPitch;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);
  T* sK = sQ + kTile;         // 2 stages
  T* sV = sK + 2 * kTile;     // 2 stages
  float* sKeep = reinterpret_cast<float*>(sV + 2 * kTile);  // 2 x 64

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * kTileRows;
  const int D = p.D;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int t2 = (lane & 3) * 2;  // fragment column pair

  const T* qp = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kp = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vp = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* kmp = p.km ? p.km + (long long)b * p.Tk : nullptr;

  const int nk = (p.Tk + kTileRows - 1) / kTileRows;
  int kt_begin = 0;
  int kt_end = nk;
  if (CAUSAL) {
    // Live tiles: j*bk < (i+1)*bq and, with a window,
    // (j+1)*bk + window - 1 > i*bq  (_block_live / _win_lo): contiguous.
    kt_end = min(nk, (q0 + 2 * kTileRows - 1) / kTileRows);
    if (p.window > 0) {
      const int lo = q0 - (p.window - 1);
      kt_begin = lo > 0 ? lo / kTileRows : 0;
    }
  }

  auto load_kv = [&](int kt, int stage) {
    const int k0 = kt * kTileRows;
    load_tile_async<DMAX>(sK + stage * kTile, kp, p.k_st, k0, p.Tk, D);
    load_tile_async<DMAX>(sV + stage * kTile, vp, p.v_st, k0, p.Tk, D);
    if (kmp && threadIdx.x < kTileRows) {
      const int col = k0 + threadIdx.x;
      // Keys past Tk read as keep = 0.
      cp_async4(smem_u32(sKeep + stage * kTileRows + threadIdx.x),
                col < p.Tk ? kmp + col : kmp, col < p.Tk ? 4 : 0);
    }
  };
  load_tile_async<DMAX>(sQ, qp, p.q_st, q0, p.Tq, D);
  load_kv(kt_begin, 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  typename R::QFrag qf;
  R::load_q(qf, sQ, warp, lane);

  // This thread's two rows.  Rows past Tq compute on zero-filled Q and
  // are not stored.
  const int row[2] = {q0 + warp * 16 + (lane >> 2),
                      q0 + warp * 16 + (lane >> 2) + 8};
  const float scale = p.scale * R::kBase;
  float m[2] = {-R::kBig, -R::kBig};
  float l[2] = {0.0f, 0.0f};  // this thread's columns; the quad's at the end
  float acc[DMAX / 8][4];
#pragma unroll
  for (int n = 0; n < DMAX / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int stage = (kt - kt_begin) & 1;
    if (kt + 1 < kt_end) load_kv(kt + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // this tile has landed
    __syncthreads();
    const T* cK = sK + stage * kTile;
    const T* cV = sV + stage * kTile;
    const float* cKeep = sKeep + stage * kTileRows;
    const int k0 = kt * kTileRows;

    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
    R::qk(s, qf, sQ, cK, warp, lane);

    // keep of this thread's 16 key columns: the key mask and the Tk tail,
    // held for both passes below (reading shared memory in each pass
    // instead measured slower).
    float2 kc[8];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int cl = n * 8 + t2;
      kc[n] = kmp ? *reinterpret_cast<const float2*>(cKeep + cl)
                  : make_float2(k0 + cl < p.Tk ? 1.0f : 0.0f,
                                k0 + cl + 1 < p.Tk ? 1.0f : 0.0f);
    }
    // Only a tile that the diagonal or the window's lower edge cuts needs
    // the per-element causal test.
    const bool edge =
        CAUSAL && !(k0 + kTileRows - 1 <= q0 &&
                    (p.window == 0 || k0 + p.window > q0 + kTileRows - 1));
    auto keep = [&](int n, int e) {
      float kk = (e & 1) ? kc[n].y : kc[n].x;
      if (CAUSAL && edge)
        kk = causal_live(row[e >> 1], k0 + n * 8 + t2 + (e & 1), p.window)
                 ? kk
                 : 0.0f;
      return kk;
    };

    // s * scale - 1e30 (1 - keep), and the row max.
    float mx[2] = {-R::kBig, -R::kBig};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = fmaf(keep(n, e) - 1.0f, R::kBig, s[n][e] * scale);
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = R::ex(m[i] - m_new);
      m[i] = m_new;
      l[i] *= alpha[i];
    }
    // P = exp(s - m) * keep in f32, summed into l before P.V rounds it.
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = R::ex(s[n][e] - m[e >> 1]) * keep(n, e);
        l[e >> 1] += s[n][e];
      }
#pragma unroll
    for (int n = 0; n < DMAX / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];
    R::pv(acc, s, cV, lane);
    __syncthreads();  // this stage is free for the tile two ahead
  }
  cp_async_wait<0>();

  T* op = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    if (row[i] >= p.Tq) continue;
    const bool nonempty = l[i] > 0.0f;
    const float denom = nonempty ? l[i] : 1.0f;
#pragma unroll
    for (int n = 0; n < DMAX / 8; ++n) {
      const int d = n * 8 + t2;
      if (d < D)
        R::store2(op + (long long)row[i] * p.o_st + d,
                  nonempty ? acc[n][2 * i] / denom : 0.0f,
                  nonempty ? acc[n][2 * i + 1] / denom : 0.0f);
    }
    if ((lane & 3) == 0)
      p.lse[((long long)b * p.H + h) * p.Tq + row[i]] =
          nonempty ? R::lse(m[i], l[i]) : kLseEmpty;
  }
}

template <typename T, int DMAX>
int launch(const Params& p, cudaStream_t stream) {
  const size_t smem =
      sizeof(T) * 5 * kTileRows * Route<T, DMAX>::kPitch +
      sizeof(float) * 2 * kTileRows;
  void (*kernel)(const Params) = p.causal
                                     ? flash_fwd_tc_kernel<T, DMAX, true>
                                     : flash_fwd_tc_kernel<T, DMAX, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.Tq + kTileRows - 1) / kTileRows, p.H, p.B);
  kernel<<<grid, kTcThreads, smem, stream>>>(p);
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
      H <= 0 || B > 65535 || H > 65535 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q; p.k = k; p.v = v; p.km = km; p.o = o; p.lse = lse;
  p.q_sb = strides[0]; p.q_sh = strides[1]; p.q_st = strides[2];
  p.k_sb = strides[3]; p.k_sh = strides[4]; p.k_st = strides[5];
  p.v_sb = strides[6]; p.v_sh = strides[7]; p.v_st = strides[8];
  p.o_sb = strides[9]; p.o_sh = strides[10]; p.o_st = strides[11];
  p.B = B; p.H = H; p.Tq = Tq; p.Tk = Tk; p.D = D;
  p.causal = causal; p.window = window; p.scale = scale;
  if (misaligned(p, p.o, dtype == 0 ? 4 : 2))
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return D <= 64 ? launch<float, 64>(p, s) : launch<float, 128>(p, s);
  return D <= 64 ? launch<bf16, 64>(p, s) : launch<bf16, 128>(p, s);
}
