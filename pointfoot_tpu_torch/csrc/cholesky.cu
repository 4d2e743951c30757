// Batched small-matrix Cholesky solve, one system per thread.
//
// Replaces the TPU kernel _chol_solve_kernel of
// pointfoot_tpu/ops/pallas/cholesky.py:35 (pallas_chol_solve_lanes, :72).
// Plain PyTorch version: ops/linalg.py chol_solve, reached through
// ops/cuda/cholesky.py chol_solve_lanes_plain.
//
// Layout.  The batch is the minor axis, as on the TPU: A is (n·n, B) with
// A[i][j] in row i·n + j, b and x are (n, B).  Thread e reads column e of
// every row, so the threads of a warp read neighbouring addresses.  The
// TPU padded the batch with identity systems to its 128-lane block; here
// the tail block's threads with e >= B return.
//
// Arithmetic.  The factor is unrolled over the compile-time N and kept in
// registers (N(N+1)/2 entries: 78 at N = 12, 171 at N = 18, where some
// spill to local memory).  The diagonal is sqrt(max(s, 1e-12)) and the
// entries below it are multiplied by the exact reciprocal of the diagonal,
// as cholesky.py:45-47 do; the substitutions divide.
//
// Bound.  At N = 18 a system moves (324 + 18 + 18) · 4 B = 1440 B and needs
// about N³/6 + N² ≈ 1300 multiply-adds: at B = 2048 about 2.9 MB, 0.88 µs
// of HBM time at 3.35 TB/s, against a few tenths of a µs at the FP32 peak.
// It is bound by one thread's dependent chain, with
// 2048 threads on 132 SMs.  This is the simple version.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;

template <int N>
__global__ void __launch_bounds__(THREADS) chol_solve_kernel(
    const float* __restrict__ A, const float* __restrict__ b,
    float* __restrict__ x, int B) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= B) return;
  const size_t Bs = static_cast<size_t>(B);
  // lower triangle, row-major: L[i][j] at i(i+1)/2 + j
  float L[N * (N + 1) / 2];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    float s = A[(j * N + j) * Bs + e];
#pragma unroll
    for (int k = 0; k < j; ++k) {
      const float l = L[j * (j + 1) / 2 + k];
      s = s - l * l;
    }
    const float d = sqrtf(s > 1e-12f || s != s ? s : 1e-12f);
    L[j * (j + 1) / 2 + j] = d;
    const float inv_d = 1.0f / d;
#pragma unroll
    for (int i = j + 1; i < N; ++i) {
      float t = A[(i * N + j) * Bs + e];
#pragma unroll
      for (int k = 0; k < j; ++k)
        t = t - L[i * (i + 1) / 2 + k] * L[j * (j + 1) / 2 + k];
      L[i * (i + 1) / 2 + j] = t * inv_d;
    }
  }
  // forward substitution L y = b
  float y[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float s = b[i * Bs + e];
#pragma unroll
    for (int k = 0; k < i; ++k) s = s - L[i * (i + 1) / 2 + k] * y[k];
    y[i] = s / L[i * (i + 1) / 2 + i];
  }
  // back substitution Lᵀ x = y
  float xs[N];
#pragma unroll
  for (int i = N - 1; i >= 0; --i) {
    float s = y[i];
#pragma unroll
    for (int k = i + 1; k < N; ++k) s = s - L[k * (k + 1) / 2 + i] * xs[k];
    xs[i] = s / L[i * (i + 1) / 2 + i];
  }
#pragma unroll
  for (int i = 0; i < N; ++i) x[i * Bs + e] = xs[i];
}

template <int N>
int launch(const float* A, const float* b, float* x, int B,
           cudaStream_t stream) {
  chol_solve_kernel<N><<<(B + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
      A, b, x, B);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x = A⁻¹ b for B systems of size n (12 or 18) on `stream`.  Returns the
// cudaError_t of the launch, or cudaErrorInvalidValue for another n.
int pf_chol_solve(const float* A, const float* b, float* x, int n, int B,
                  void* stream) {
  if (B <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 12:
      return launch<12>(A, b, x, B, s);
    case 18:
      return launch<18>(A, b, x, B, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
