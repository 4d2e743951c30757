// Batched small-matrix Cholesky solve, a group of lanes per system.
//
// Replaces the TPU kernel _chol_solve_kernel of
// pointfoot_tpu/ops/pallas/cholesky.py:35 (pallas_chol_solve_lanes, :72).
// Plain PyTorch version: ops/linalg.py chol_solve, reached through
// ops/cuda/cholesky.py chol_solve_lanes_plain.
//
// Layout.  The batch is the minor axis, as on the TPU: A is (n·n, B) with
// A[i][j] in row i·n + j, b and x are (n, B).
//
// Bound.  At N = 18 a system reads A's lower triangle and b and writes x,
// (171 + 18 + 18) · 4 B = 828 B, and needs about N³/6 + N² ≈ 1300
// multiply-adds: at B = 2048 about 1.7 MB, 0.51 µs of HBM time at
// 3.35 TB/s, against under a tenth of a µs at the float32 peak.  What it
// costs is latency: a factor and two substitutions are chains of
// dependent operations.  One system per thread (the simple
// version) ran 2048 threads on 16 of the 132 SMs with the factor in 205
// registers: 0.0122 ms a launch at N = 18, B = 2048 (H100 80GB HBM3, 700 W,
// CUDA graph replay).
//
// Design.  A group of L lanes works on one system (L = 16 at N = 18, 8 at
// N = 12), 16 systems a block; a group never straddles a warp.  The block
// sweeps its systems' rows of b and of A's lower triangle into slabs of
// shared memory (a warp's loads of one row are contiguous across
// systems), meets once at __syncthreads(), and from there each group
// synchronises with __syncwarp() only; no lane leaves early (the tail block
// clamps its system index to B - 1 and skips the stores).  In the slab, A's
// rows are padded to an odd stride (19, 13), and slabs are L mod 32 floats
// apart, so the lanes of a warp reading neighbouring rows, or one address
// per group, fall on different banks.
//   - Factor and forward substitution by columns, right-looking: lane l
//     keeps in registers the entries below the diagonal of its rows l,
//     l + L, ...; every lane keeps the whole diagonal's running sums and
//     the forward substitution's.  Pass k takes column k - 1 of the factor
//     off every entry not yet final (one subtraction each, so every sum
//     still runs in ascending k), forms the diagonal d_k and y_k (every
//     lane, same operations, same bits), scales the lane's entries of
//     column k and leaves them in the slab: one __syncwarp() a column, and
//     the chain from one column to the next is one load, sqrt and
//     reciprocal, not a sum of k terms.
//   - Back substitution by one lane: row i's first term is the row solved
//     just before it, a true chain.  The diagonal and y reach it through
//     the slab, which leaves its registers to the factor's column entries.
// Measured (H100 80GB HBM3, 700 W, CUDA graph replay, B = 2048; each pair
// in one call): 0.0077 ms at N = 18 against 0.0121 one system a thread,
// 0.0052 at N = 12 against 0.0072; 128 and 80 registers, no spills.  The
// left-looking factor (every lane summing the diagonal and its entries
// over k, column by column) took 0.0087 at 16 lanes; 4 and 8 lanes took
// 0.0110 and 0.0087 at N = 18 (at N = 12, 8 and 16 tie at 0.0051); a cap
// of 128 registers by __launch_bounds__ spilled and cost 7-11%.  Staging
// only the lower triangle costs 1-2% against staging every row (0.0079
// against 0.0078 at N = 18) when the sweep skips the upper rows by a
// predicate, and 15% (0.0090) when it walks the packed triangle: the
// walk's data-dependent steps serialise the loads.
// No sum is split across lanes or reordered, and every operation is the
// simple version's (sqrt(max(s, 1e-12)) on the diagonal, the exact
// reciprocal below it, division in the substitutions; built with
// -fmad=false), so the result is bit-identical to it and to the plain
// version on the card.  Tensor cores do not apply: wgmma and mma.sync take
// float32 only as TF32, which rounds differently, and the port pins full
// float32 (device.resolve_device).

#include <cuda_runtime.h>

namespace {

constexpr int SYSTEMS = 16;  // systems a block

// lanes a system, by size: the fastest of 4, 8 and 16 on the card (at
// N = 12, 8 and 16 tie)
constexpr int lanes(int N) { return N == 18 ? 16 : 8; }

// Slab of one system, in floats: A (then the factor) with rows AST apart,
// b, the factor's diagonal, y, x.
template <int N, int L>
struct Slab {
  static constexpr int AST = N % 2 ? N : N + 1;  // odd row stride
  static constexpr int B = N * AST, DIAG = B + N, Y = DIAG + N, X = Y + N;
  static constexpr int END = X + N;
  // the least stride >= END that is L mod 32
  static constexpr int STRIDE = (END + 31 - L) / 32 * 32 + L;
};

template <int N, int L>
constexpr int smem_bytes() {
  return SYSTEMS * Slab<N, L>::STRIDE * 4;
}

template <int N, int L>
__global__ void __launch_bounds__(SYSTEMS * L) chol_solve_kernel(
    const float* __restrict__ A, const float* __restrict__ b,
    float* __restrict__ x, int B) {
  static_assert(32 % L == 0, "a group must not straddle a warp");
  using S = Slab<N, L>;
  constexpr int AST = S::AST;
  constexpr int THREADS = SYSTEMS * L;
  constexpr int SWEEP = THREADS / SYSTEMS;  // rows a sweep pass covers
  extern __shared__ float smem[];
  const size_t Bs = static_cast<size_t>(B);
  const int tid = threadIdx.x;
  const int e0 = blockIdx.x * SYSTEMS;
  // sweeping: column `es` of rows r0, r0 + SWEEP, ...
  const int r0 = tid / SYSTEMS;
  const bool store = e0 + tid % SYSTEMS < B;
  const int es = min(e0 + tid % SYSTEMS, B - 1);
  float* ss = smem + (tid % SYSTEMS) * S::STRIDE;
  // only A's lower triangle is read (the slab's upper triangle stays
  // unset); a sweep over every row that skips those above the diagonal
  // keeps the loads independent of each other
  for (int r = r0; r < N * N; r += SWEEP)
    if (r % N <= r / N) ss[(r / N) * AST + r % N] = A[r * Bs + es];
  for (int r = r0; r < N; r += SWEEP) ss[S::B + r] = b[r * Bs + es];
  __syncthreads();

  // computing: lane `lane` of the group of slab `sl`.  Every lane keeps the
  // running sums of the whole diagonal (s) and of the forward substitution
  // (acc) in registers, and the entries below the diagonal of its own rows
  // i = lane, lane + L, ... (t); only the finished columns of the factor
  // pass through the slab.
  const int lane = tid % L;
  float* sl = smem + (tid / L) * S::STRIDE;
  float* Am = sl;
  constexpr int ROWS = (N + L - 1) / L;
  float s[N], acc[N], t[ROWS][N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    s[j] = Am[j * AST + j];
    acc[j] = sl[S::B + j];
  }
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int i = lane + L * r;
#pragma unroll
    for (int j = 0; j < N - 1; ++j)
      t[r][j] = j < i && i < N ? Am[i * AST + j] : 0.0f;
  }

  // ---- factor and forward substitution, a column a pass.  Entry (i, j)
  // takes L[i][k] L[j][k] off for k = 0, 1, ... j - 1, one k a pass, so each
  // sum still runs in ascending k; so do the diagonal and the forward
  // substitution's rows.  Column k's entries are final once pass k has
  // taken column k - 1 off them.
#pragma unroll
  for (int k = 0; k < N; ++k) {
    if (k > 0) {
      float c[N];
#pragma unroll
      for (int j = k; j < N; ++j) {
        c[j] = Am[j * AST + k - 1];
        s[j] = s[j] - c[j] * c[j];
        acc[j] = acc[j] - c[j] * acc[k - 1];
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const int i = lane + L * r;
#pragma unroll
        for (int j = k; j < N - 1; ++j)
          if (j < i && i < N) t[r][j] = t[r][j] - t[r][k - 1] * c[j];
      }
    }
    const float d = sqrtf(s[k] > 1e-12f || s[k] != s[k] ? s[k] : 1e-12f);
    const float inv_d = 1.0f / d;
    acc[k] = acc[k] / d;
    if (lane == 0) {
      sl[S::DIAG + k] = d;
      sl[S::Y + k] = acc[k];
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int i = lane + L * r;
      if (k < N - 1 && k < i && i < N) {
        t[r][k] = t[r][k] * inv_d;
        Am[i * AST + k] = t[r][k];
      }
    }
    __syncwarp();
  }

  // ---- back substitution Lᵀ x = y, one lane: row i's first term is the
  // row solved just before it, a true chain
  if (lane == 0) {
    float xs[N];
#pragma unroll
    for (int i = N - 1; i >= 0; --i) {
      float v = sl[S::Y + i];
#pragma unroll
      for (int k = i + 1; k < N; ++k) v = v - Am[k * AST + i] * xs[k];
      xs[i] = v / sl[S::DIAG + i];
      sl[S::X + i] = xs[i];
    }
  }
  __syncthreads();
  if (store)
    for (int r = r0; r < N; r += SWEEP) x[r * Bs + es] = ss[S::X + r];
}

template <int N>
int launch(const float* A, const float* b, float* x, int B,
           cudaStream_t stream) {
  constexpr int L = lanes(N);
  chol_solve_kernel<N, L>
      <<<(B + SYSTEMS - 1) / SYSTEMS, SYSTEMS * L, smem_bytes<N, L>(),
         stream>>>(A, b, x, B);
  return static_cast<int>(cudaGetLastError());
}

template <int N>
int resident_warps() {
  constexpr int L = lanes(N);
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, chol_solve_kernel<N, L>, SYSTEMS * L,
          smem_bytes<N, L>()) != cudaSuccess)
    return -1;
  return blocks * SYSTEMS * L / 32;
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

// Lanes a system, dynamic shared memory of a block in bytes, and warps one
// SM holds (cudaOccupancyMaxActiveBlocksPerMultiprocessor) for size n; -1
// for another n or on an error.
int pf_chol_lanes(int n) { return n == 12 || n == 18 ? lanes(n) : -1; }

int pf_chol_smem_bytes(int n) {
  return n == 12   ? smem_bytes<12, lanes(12)>()
         : n == 18 ? smem_bytes<18, lanes(18)>()
                   : -1;
}

int pf_chol_resident_warps(int n) {
  return n == 12 ? resident_warps<12>() : n == 18 ? resident_warps<18>() : -1;
}

}  // extern "C"
