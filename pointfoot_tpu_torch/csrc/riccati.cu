// Fused SRB-LQR solve, one scenario per thread: the backward Riccati sweep
// with an m x m Cholesky and 13 solves per step, then the forward force
// rollout.
//
// Replaces the TPU kernel _kernel of pointfoot_tpu/ops/pallas/riccati.py:32
// (pallas_srb_lqr, :151).  Plain PyTorch version:
// ops/cuda/riccati.py srb_lqr_lanes_plain.
//
// Problem (mpc/srb.py).  Per scenario, time-invariant over the horizon:
// x' = F x + c + L u with n = 12 states and m = 3 nf foot-force inputs,
// diagonal state cost Xd (terminal XTd) and diagonal input cost Ud.
// Backward, t = T-1 .. 0, from P = diag(XTd), p = 0:
//     G = diag(Ud) + L'P L,  H = L'P F,  K = G^-1 H,  d = G^-1 L'(P c - p)
//     p <- (F - L K)'(p - P c),  P <- diag(Xd) + F'P (F - L K)
// Forward from x0: du = -K_t x - d_t, force_t = f_ff + du,
// x <- F x + c + L du.  The output is the force sequence.
//
// Layout.  The batch is the minor axis, as on the TPU: every matrix is
// staged (rows, B) with F[i][j] in row i*12 + j and L[i][a] in row i*m + a,
// so the threads of a warp read neighbouring addresses.  The TPU padded the
// batch with identity problems to its 1024-lane block; here the tail
// block's threads with e >= B return.  The gains K_t, d_t of the backward
// sweep go to a global work space (T, m*12 + m, B) that the caller
// allocates, the counterpart of the TPU kernel's VMEM scratch, and come
// back in the forward rollout (from L2: 15 MB at B = 4096, m = 6, T = 12).
//
// Arithmetic.  As the TPU kernel's, in its order: every sum left to right,
// the factor's diagonal sqrt(max(s, 1e-12)), the entries below it times
// the reciprocal of the diagonal, a true division in the two substitutions,
// P not symmetrised, F dense.  The n and m loops unroll at compile time
// (template on M: 6 for PointFoot, 12 for the quadrupeds); T is a run-time
// argument.
//
// Bound.  A scenario reads 144 + 12 m + 48 + 2 m floats and writes T m:
// about 350 floats at m = 6, T = 12, 5.7 MB at B = 4096, 1.7 us of HBM time
// at 3.35 TB/s, against about 0.18 Mflop, 0.74 Gflop at 4096, 11 us at the
// float32 peak: bound by operations.  The kernel is far from either: one
// thread walks a dependent chain of some 10^5 instructions, with 4096
// threads on 132 SMs (one warp per block, so the warps spread over all
// SMs).  This is the simple version.

#include <cuda_runtime.h>

namespace {

constexpr int N = 12;
constexpr int THREADS = 32;

// Solves G x = b in place given the factor Lc (lower, row-major packed).
template <int M>
__device__ __forceinline__ void chol_solve_vec(const float* Lc, float* b) {
#pragma unroll
  for (int i = 0; i < M; ++i) {
    float s = b[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s = s - Lc[i * (i + 1) / 2 + k] * b[k];
    b[i] = s / Lc[i * (i + 1) / 2 + i];
  }
#pragma unroll
  for (int i = M - 1; i >= 0; --i) {
    float s = b[i];
#pragma unroll
    for (int k = i + 1; k < M; ++k) s = s - Lc[k * (k + 1) / 2 + i] * b[k];
    b[i] = s / Lc[i * (i + 1) / 2 + i];
  }
}

template <int M>
__global__ void __launch_bounds__(THREADS) srb_lqr_kernel(
    const float* __restrict__ F, const float* __restrict__ c,
    const float* __restrict__ L, const float* __restrict__ Xd,
    const float* __restrict__ Ud, const float* __restrict__ XTd,
    const float* __restrict__ x0, const float* __restrict__ fff,
    float* __restrict__ gains, float* __restrict__ out, int T, int B) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= B) return;
  const size_t Bs = static_cast<size_t>(B);
  constexpr int GROWS = M * N + M;  // gain rows per step: K then d

  float Fm[N * N], Lm[N * M], cv[N];
#pragma unroll
  for (int r = 0; r < N * N; ++r) Fm[r] = F[r * Bs + e];
#pragma unroll
  for (int r = 0; r < N * M; ++r) Lm[r] = L[r * Bs + e];
#pragma unroll
  for (int r = 0; r < N; ++r) cv[r] = c[r * Bs + e];

  // ---- init: P = diag(XTd), p = 0 ----
  float P[N * N], p[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < N; ++j) P[i * N + j] = 0.0f;
    P[i * N + i] = XTd[i * Bs + e];
    p[i] = 0.0f;
  }

  // ---- backward sweep (t runs T-1 .. 0; gains stored at step t) ----
#pragma unroll 1
  for (int t = T - 1; t >= 0; --t) {
    // LP[a][j] = sum_k L[k][a] P[k][j]
    float LP[M * N];
#pragma unroll
    for (int a = 0; a < M; ++a)
#pragma unroll
      for (int j = 0; j < N; ++j) {
        float s = Lm[a] * P[j];
#pragma unroll
        for (int k = 1; k < N; ++k) s = s + Lm[k * M + a] * P[k * N + j];
        LP[a * N + j] = s;
      }
    // Cholesky of G = diag(Ud) + LP L, the lower triangle only
    float Lc[M * (M + 1) / 2];
#pragma unroll
    for (int jj = 0; jj < M; ++jj) {
#pragma unroll
      for (int ii = jj; ii < M; ++ii) {
        float g = LP[ii * N] * Lm[jj];
#pragma unroll
        for (int j = 1; j < N; ++j) g = g + LP[ii * N + j] * Lm[j * M + jj];
        if (ii == jj) g = Ud[jj * Bs + e] + g;
#pragma unroll
        for (int kk = 0; kk < jj; ++kk)
          g = g - Lc[ii * (ii + 1) / 2 + kk] * Lc[jj * (jj + 1) / 2 + kk];
        if (ii == jj) {
          Lc[jj * (jj + 1) / 2 + jj] =
              sqrtf(g > 1e-12f || g != g ? g : 1e-12f);
        } else {
          // the reciprocal of the diagonal, as the TPU kernel's `inv`
          Lc[ii * (ii + 1) / 2 + jj] =
              g * (1.0f / Lc[jj * (jj + 1) / 2 + jj]);
        }
      }
    }
    // Pc = P c; d = G^-1 L'(Pc - p)
    float Pc[N];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      float s = P[j * N] * cv[0];
#pragma unroll
      for (int k = 1; k < N; ++k) s = s + P[j * N + k] * cv[k];
      Pc[j] = s;
    }
    float* g_t = gains + static_cast<size_t>(t) * GROWS * Bs + e;
    {
      float dv[M];
#pragma unroll
      for (int a = 0; a < M; ++a) {
        float s = Lm[a] * (Pc[0] - p[0]);
#pragma unroll
        for (int j = 1; j < N; ++j) s = s + Lm[j * M + a] * (Pc[j] - p[j]);
        dv[a] = s;
      }
      chol_solve_vec<M>(Lc, dv);
#pragma unroll
      for (int a = 0; a < M; ++a) g_t[(M * N + a) * Bs] = dv[a];
    }
    // K = G^-1 H with H = LP F, column by column; FKL = F - L K
    float FKL[N * N];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      float col[M];
#pragma unroll
      for (int a = 0; a < M; ++a) {
        float s = LP[a * N] * Fm[j];
#pragma unroll
        for (int k = 1; k < N; ++k) s = s + LP[a * N + k] * Fm[k * N + j];
        col[a] = s;
      }
      chol_solve_vec<M>(Lc, col);
#pragma unroll
      for (int a = 0; a < M; ++a) g_t[(a * N + j) * Bs] = col[a];
#pragma unroll
      for (int i = 0; i < N; ++i) {
        float s = Lm[i * M] * col[0];
#pragma unroll
        for (int a = 1; a < M; ++a) s = s + Lm[i * M + a] * col[a];
        FKL[i * N + j] = Fm[i * N + j] - s;
      }
    }
    // p' = FKL'(p - Pc)
    {
      float pm[N];
#pragma unroll
      for (int k = 0; k < N; ++k) pm[k] = p[k] - Pc[k];
#pragma unroll
      for (int i = 0; i < N; ++i) {
        float s = FKL[i] * pm[0];
#pragma unroll
        for (int k = 1; k < N; ++k) s = s + FKL[k * N + i] * pm[k];
        p[i] = s;
      }
    }
    // P' = diag(Xd) + (F'P) FKL, a row of F'P at a time
    float Pn[N * N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      float FtP[N];
#pragma unroll
      for (int k = 0; k < N; ++k) {
        float s = Fm[i] * P[k];
#pragma unroll
        for (int l = 1; l < N; ++l) s = s + Fm[l * N + i] * P[l * N + k];
        FtP[k] = s;
      }
#pragma unroll
      for (int j = 0; j < N; ++j) {
        float v = FtP[0] * FKL[j];
#pragma unroll
        for (int k = 1; k < N; ++k) v = v + FtP[k] * FKL[k * N + j];
        Pn[i * N + j] = (i == j) ? Xd[i * Bs + e] + v : v;
      }
    }
#pragma unroll
    for (int r = 0; r < N * N; ++r) P[r] = Pn[r];
  }

  // ---- forward rollout: x' = F x + c + L du, du = -K x - d ----
  float x[N];
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = x0[i * Bs + e];
  float ff[M];
#pragma unroll
  for (int a = 0; a < M; ++a) ff[a] = fff[a * Bs + e];
#pragma unroll 1
  for (int t = 0; t < T; ++t) {
    const float* g_t = gains + static_cast<size_t>(t) * GROWS * Bs + e;
    float du[M];
#pragma unroll
    for (int a = 0; a < M; ++a) {
      float acc = -g_t[(M * N + a) * Bs];
#pragma unroll
      for (int j = 0; j < N; ++j) acc = acc - g_t[(a * N + j) * Bs] * x[j];
      du[a] = acc;
      out[(static_cast<size_t>(t) * M + a) * Bs + e] = ff[a] + acc;
    }
    float xn[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      float acc = cv[i];
#pragma unroll
      for (int j = 0; j < N; ++j) acc = acc + Fm[i * N + j] * x[j];
#pragma unroll
      for (int a = 0; a < M; ++a) acc = acc + Lm[i * M + a] * du[a];
      xn[i] = acc;
    }
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = xn[i];
  }
}

template <int M>
int launch(const float* F, const float* c, const float* L, const float* Xd,
           const float* Ud, const float* XTd, const float* x0,
           const float* fff, float* gains, float* out, int T, int B,
           cudaStream_t stream) {
  srb_lqr_kernel<M><<<(B + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
      F, c, L, Xd, Ud, XTd, x0, fff, gains, out, T, B);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Planned forces out (T, m, B) for B scenarios with n = 12 and m = 6 or 12
// on `stream`; gains is a work space of (T, m*12 + m, B) floats.  Returns
// the cudaError_t of the launch, or cudaErrorInvalidValue for another m.
int pf_srb_lqr(const float* F, const float* c, const float* L,
               const float* Xd, const float* Ud, const float* XTd,
               const float* x0, const float* fff, float* gains, float* out,
               int m, int T, int B, void* stream) {
  if (B <= 0 || T <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (m) {
    case 6:
      return launch<6>(F, c, L, Xd, Ud, XTd, x0, fff, gains, out, T, B, s);
    case 12:
      return launch<12>(F, c, L, Xd, Ud, XTd, x0, fff, gains, out, T, B, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
