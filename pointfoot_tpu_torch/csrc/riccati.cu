// Fused SRB-LQR solve, a group of 16 lanes per scenario: the backward
// Riccati sweep with an m x m Cholesky and 13 solves per step, then the
// forward force rollout.
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
// Bound.  A scenario reads 144 + 12 m + 48 + 2 m floats and writes T m:
// about 350 floats at m = 6, T = 12, 5.7 MB at B = 4096, 1.7 us of HBM time
// at 3.35 TB/s, against about 0.18 Mflop, 0.74 Gflop at 4096, 11 us at the
// float32 peak of the CUDA cores: bound by operations.  Tensor cores are
// not the tool: TF32 keeps three digits and the recursion is held to 2e-3.
// What the kernel has to beat is latency: the recursion is a chain of
// T (m + 4) dependent phases, so it needs many resident warps and a working
// set that never leaves the SM.
//
// Design.
//   - A group of 16 lanes works on one scenario, two scenarios a warp,
//     eight a 128-thread block.  Lane j < 12 owns column j of the
//     12-column matrices (P, H and K, F - L K, the new P) in registers, a
//     dozen floats each; lane 12 carries d, the 13th right-hand side.
//   - What every lane reads (F, L, c, L'P, the Cholesky factor, F'P, P by
//     rows, p - P c) lies in shared memory, one slab per scenario.  Reads
//     are broadcasts or neighbouring addresses within a group; rows that
//     lanes read side by side are padded to 13 floats and the slab stride
//     is 16 mod 32 floats, so the two groups of a warp fall on different
//     banks.  Phases are separated by __syncwarp(): a group never straddles
//     a warp and no thread leaves before the end.
//   - The Cholesky runs column by column across the lanes (lane i owns row
//     i of the factor; the entries of one column are independent), the 12
//     columns of H and the vector d are 13 independent solves, one a lane.
//   - The gains K_t, d_t live in the slab when the whole block's slabs fit
//     in the 227 KB of an SM, else in a global work space (the caller
//     decides from the sizes and passes `gains`: null or the work space).
//   - Loads: in the (rows, B) layout the eight scenarios of a block are 32
//     contiguous bytes of every row; the block sweeps the rows, 16 rows x 8
//     scenarios a pass, into the slabs.  The tail block clamps its
//     scenario index to B - 1 and skips the store, so every thread reaches
//     every barrier.
//
// Arithmetic.  As the TPU kernel's, in its order: every sum left to right
// over k by one lane, the factor's diagonal sqrt(max(s, 1e-12)), the
// entries below it times the reciprocal of the diagonal, a true division
// in the two substitutions, P not symmetrised, F dense.  No sum is split
// across lanes, so with -fmad=false the kernel equals its plain version
// bit for bit on the card.  The n and m loops unroll at compile time
// (template on M: 6 for PointFoot, 12 for the quadrupeds); T is a run-time
// argument.

#include <cuda_runtime.h>

namespace {

constexpr int N = 12;
constexpr int LANES = 16;            // lanes per scenario
constexpr int SPB = 8;               // scenarios per block
constexpr int THREADS = LANES * SPB;
constexpr int PAD = N + 1;           // row stride of rows read side by side
constexpr int MAX_SMEM = 232448;     // bytes a block may use on sm_90

// Slab layout, in floats from the slab's start.
template <int M>
struct Slab {
  static constexpr int F = 0;                 // F[i][j] at i*12 + j
  static constexpr int L = F + N * N;         // L[i][a] at i*M + a
  static constexpr int C = L + N * M;
  static constexpr int XD = C + N;
  static constexpr int UD = XD + N;
  static constexpr int P = UD + M;            // P[i][j] at i*13 + j
  static constexpr int LP = P + N * PAD;      // (L'P)[a][j] at a*13 + j
  static constexpr int LC = LP + M * PAD;     // factor [i][k] at i*13 + k
  static constexpr int FTP = LC + M * PAD;    // (F'P)[i][k] at i*12 + k
  static constexpr int W = FTP + N * N;       // P c - p; forward: x, buffer 0
  static constexpr int PM = W + N;            // p - P c; forward: du
  static constexpr int GD = PM + N;           // G's diagonal; forward: x, 1
  static constexpr int FIXED = GD + N;
  // gain rows of one step: K[a][j] at a*13 + j, then d[a]
  static constexpr int GROWS = M * PAD + M;
};

__host__ __device__ constexpr int slab_stride(int floats) {
  // the least stride >= floats that is 16 mod 32
  return (floats + 15) / 32 * 32 + 16;
}

template <int M>
__global__ void __launch_bounds__(THREADS) srb_lqr_kernel(
    const float* __restrict__ F, const float* __restrict__ c,
    const float* __restrict__ L, const float* __restrict__ Xd,
    const float* __restrict__ Ud, const float* __restrict__ XTd,
    const float* __restrict__ x0, const float* __restrict__ fff,
    float* __restrict__ gains, float* __restrict__ out, int T, int B,
    int stride) {
  using S = Slab<M>;
  extern __shared__ float smem[];
  const size_t Bs = static_cast<size_t>(B);
  const int tid = threadIdx.x;
  const int e0 = blockIdx.x * SPB;

  // ---- sweep the block's problems into the slabs
  {
    const int s = tid % SPB, r0 = tid / SPB;
    const int es = min(e0 + s, B - 1);
    float* sl = smem + s * stride;
    for (int r = r0; r < N * N; r += THREADS / SPB)
      sl[S::F + r] = F[r * Bs + es];
    for (int r = r0; r < N * M; r += THREADS / SPB)
      sl[S::L + r] = L[r * Bs + es];
    if (r0 < N) {
      sl[S::C + r0] = c[r0 * Bs + es];
      sl[S::XD + r0] = Xd[r0 * Bs + es];
    }
    if (r0 < M) sl[S::UD + r0] = Ud[r0 * Bs + es];
  }
  __syncthreads();

  const int grp = tid / LANES, j = tid % LANES;
  const bool live = e0 + grp < B;
  const int e = min(e0 + grp, B - 1);
  float* sl = smem + grp * stride;
  const float* Fs = sl + S::F;
  const float* Ls = sl + S::L;
  // K_t and d_t: behind the slab's fixed part, or this scenario's piece of
  // the global work space (padded to whole blocks)
  float* gn = gains == nullptr
                  ? sl + S::FIXED
                  : gains + static_cast<size_t>(e0 + grp) * T * S::GROWS;
  const bool col_lane = j < N;       // owns a column of the 12-column matrices
  const bool rhs_lane = j <= N;      // solves a right-hand side (12: d)
  const bool row_lane = j < M;       // owns a row of the Cholesky factor

  // ---- init: P = diag(XTd), p = 0
  float Pcol[N], p = 0.0f;
  if (col_lane) {
    const float xt = XTd[j * Bs + e];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      Pcol[i] = i == j ? xt : 0.0f;
      sl[S::P + i * PAD + j] = Pcol[i];
    }
  }
  __syncwarp();

  // ---- backward sweep (t runs T-1 .. 0; gains stored at step t)
#pragma unroll 1
  for (int t = T - 1; t >= 0; --t) {
    // A: column j of LP = L'P; Pc[j] = (P c)[j]; P c - p and p - P c
    if (col_lane) {
#pragma unroll
      for (int a = 0; a < M; ++a) {
        float s = Ls[a] * Pcol[0];
#pragma unroll
        for (int k = 1; k < N; ++k) s = s + Ls[k * M + a] * Pcol[k];
        sl[S::LP + a * PAD + j] = s;
      }
      float pc = sl[S::P + j * PAD] * sl[S::C];
#pragma unroll
      for (int k = 1; k < N; ++k)
        pc = pc + sl[S::P + j * PAD + k] * sl[S::C + k];
      sl[S::W + j] = pc - p;
      sl[S::PM + j] = p - pc;
    }
    __syncwarp();

    // B: right-hand sides.  Lane j < 12: column j of H = LP F; lane 12:
    // L'(P c - p).
    float col[M];
    if (col_lane) {
#pragma unroll
      for (int a = 0; a < M; ++a) {
        float s = sl[S::LP + a * PAD] * Fs[j];
#pragma unroll
        for (int k = 1; k < N; ++k)
          s = s + sl[S::LP + a * PAD + k] * Fs[k * N + j];
        col[a] = s;
      }
    } else if (j == N) {
#pragma unroll
      for (int a = 0; a < M; ++a) {
        float s = Ls[a] * sl[S::W];
#pragma unroll
        for (int k = 1; k < N; ++k) s = s + Ls[k * M + a] * sl[S::W + k];
        col[a] = s;
      }
    }
    // Row j of the lower triangle of G = diag(Ud) + LP L, before the
    // factorisation's subtractions.
    float grow[M];
    if (row_lane) {
      float lp[N];
#pragma unroll
      for (int k = 0; k < N; ++k) lp[k] = sl[S::LP + j * PAD + k];
#pragma unroll
      for (int jj = 0; jj < M; ++jj) {
        float g = lp[0] * Ls[jj];
#pragma unroll
        for (int k = 1; k < N; ++k) g = g + lp[k] * Ls[k * M + jj];
        if (jj == j) {
          g = sl[S::UD + jj] + g;
          sl[S::GD + jj] = g;
        }
        grow[jj] = g;
      }
    }
    __syncwarp();
    // Cholesky, a column a pass: lane i >= jj takes entry (i, jj).  Every
    // lane forms the diagonal itself (the same operations in the same
    // order give the same bits), so a column costs one barrier.
    float lrow[M];
#pragma unroll
    for (int jj = 0; jj < M; ++jj) {
      if (row_lane && j >= jj) {
        float gd = sl[S::GD + jj];
        float g = grow[jj];
#pragma unroll
        for (int kk = 0; kk < jj; ++kk) {
          const float ljk = sl[S::LC + jj * PAD + kk];
          gd = gd - ljk * ljk;
          g = g - lrow[kk] * ljk;
        }
        const float dg = sqrtf(gd > 1e-12f || gd != gd ? gd : 1e-12f);
        // the reciprocal of the diagonal, as the TPU kernel's `inv`
        lrow[jj] = j == jj ? dg : g * (1.0f / dg);
        sl[S::LC + j * PAD + jj] = lrow[jj];
      }
      __syncwarp();
    }

    // C: 13 solves; K's column and d go to the gains; column j of
    // FKL = F - L K, p, and column j of F'P
    float FKL[N];
    if (rhs_lane) {
#pragma unroll
      for (int i = 0; i < M; ++i) {
        float s = col[i];
#pragma unroll
        for (int k = 0; k < i; ++k) s = s - sl[S::LC + i * PAD + k] * col[k];
        col[i] = s / sl[S::LC + i * PAD + i];
      }
#pragma unroll
      for (int i = M - 1; i >= 0; --i) {
        float s = col[i];
#pragma unroll
        for (int k = i + 1; k < M; ++k)
          s = s - sl[S::LC + k * PAD + i] * col[k];
        col[i] = s / sl[S::LC + i * PAD + i];
      }
      float* g_t = gn + t * S::GROWS;
      if (col_lane) {
#pragma unroll
        for (int a = 0; a < M; ++a) g_t[a * PAD + j] = col[a];
#pragma unroll
        for (int i = 0; i < N; ++i) {
          float s = Ls[i * M] * col[0];
#pragma unroll
          for (int a = 1; a < M; ++a) s = s + Ls[i * M + a] * col[a];
          FKL[i] = Fs[i * N + j] - s;
        }
        // p' = FKL'(p - Pc)
        float s = FKL[0] * sl[S::PM];
#pragma unroll
        for (int k = 1; k < N; ++k) s = s + FKL[k] * sl[S::PM + k];
        p = s;
        // (F'P)[i][j] = sum_l F[l][i] P[l][j]
#pragma unroll
        for (int i = 0; i < N; ++i) {
          float v = Fs[i] * Pcol[0];
#pragma unroll
          for (int l = 1; l < N; ++l) v = v + Fs[l * N + i] * Pcol[l];
          sl[S::FTP + i * N + j] = v;
        }
      } else {
#pragma unroll
        for (int a = 0; a < M; ++a) g_t[M * PAD + a] = col[a];
      }
    }
    __syncwarp();

    // D: column j of P' = diag(Xd) + (F'P) FKL
    if (col_lane) {
#pragma unroll
      for (int i = 0; i < N; ++i) {
        float v = sl[S::FTP + i * N] * FKL[0];
#pragma unroll
        for (int k = 1; k < N; ++k) v = v + sl[S::FTP + i * N + k] * FKL[k];
        Pcol[i] = i == j ? sl[S::XD + i] + v : v;
        sl[S::P + i * PAD + j] = Pcol[i];
      }
    }
    __syncwarp();
  }

  // ---- forward rollout: x' = F x + c + L du, du = -K x - d.  Lane a < m
  // forms du[a] and the force, lane i < 12 the new x[i]; x alternates
  // between two buffers so that a step needs two barriers.
  float Frow[N], Lrow[M], ci = 0.0f, ff = 0.0f;
  if (col_lane) {
#pragma unroll
    for (int k = 0; k < N; ++k) Frow[k] = Fs[j * N + k];
#pragma unroll
    for (int a = 0; a < M; ++a) Lrow[a] = Ls[j * M + a];
    ci = sl[S::C + j];
    sl[S::W + j] = x0[j * Bs + e];
  }
  if (row_lane) ff = fff[j * Bs + e];
  __syncwarp();
#pragma unroll 1
  for (int t = 0; t < T; ++t) {
    const float* x = sl + (t & 1 ? S::GD : S::W);
    float* xn = sl + (t & 1 ? S::W : S::GD);
    if (row_lane) {
      const float* g_t = gn + t * S::GROWS;
      float acc = -g_t[M * PAD + j];
#pragma unroll
      for (int k = 0; k < N; ++k) acc = acc - g_t[j * PAD + k] * x[k];
      sl[S::PM + j] = acc;
      if (live) out[(static_cast<size_t>(t) * M + j) * Bs + e] = ff + acc;
    }
    __syncwarp();
    if (col_lane) {
      float acc = ci;
#pragma unroll
      for (int k = 0; k < N; ++k) acc = acc + Frow[k] * x[k];
#pragma unroll
      for (int a = 0; a < M; ++a) acc = acc + Lrow[a] * sl[S::PM + a];
      xn[j] = acc;
    }
    __syncwarp();
  }
}

template <int M>
int slab_floats(int T, bool shared_gains) {
  return slab_stride(Slab<M>::FIXED + (shared_gains ? T * Slab<M>::GROWS : 0));
}

template <int M>
int launch(const float* F, const float* c, const float* L, const float* Xd,
           const float* Ud, const float* XTd, const float* x0,
           const float* fff, float* gains, float* out, int T, int B,
           cudaStream_t stream) {
  const int stride = slab_floats<M>(T, gains == nullptr);
  const int bytes = SPB * stride * static_cast<int>(sizeof(float));
  if (bytes > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      srb_lqr_kernel<M>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  srb_lqr_kernel<M><<<(B + SPB - 1) / SPB, THREADS, bytes, stream>>>(
      F, c, L, Xd, Ud, XTd, x0, fff, gains, out, T, B, stride);
  return static_cast<int>(cudaGetLastError());
}

template <int M>
int resident_warps(int T, bool shared_gains) {
  const int bytes =
      SPB * slab_floats<M>(T, shared_gains) * static_cast<int>(sizeof(float));
  if (bytes > MAX_SMEM) return 0;
  if (cudaFuncSetAttribute(srb_lqr_kernel<M>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes) != cudaSuccess)
    return -1;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, srb_lqr_kernel<M>, THREADS, bytes) != cudaSuccess)
    return -1;
  return blocks * THREADS / 32;
}

}  // namespace

extern "C" {

// Planned forces out (T, m, B) for B scenarios with n = 12 and m = 6 or 12
// on `stream`.  `gains` is null when the gains fit in shared memory, else a
// work space of ceil(B / 8) * 8 * T * (13 m + m) floats.  Returns the
// cudaError_t of the launch, or cudaErrorInvalidValue for another m or a
// block that does not fit in shared memory.
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

// Dynamic shared memory of one block, in bytes, with the gains in shared
// memory or not; 0 for an m the kernel is not built for.
int pf_srb_lqr_smem_bytes(int m, int T, int shared_gains) {
  const bool sg = shared_gains != 0;
  const int floats = m == 6 ? slab_floats<6>(T, sg)
                            : m == 12 ? slab_floats<12>(T, sg) : 0;
  return SPB * floats * static_cast<int>(sizeof(float));
}

// Warps of the kernel that one SM holds at that size
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor); 0 if a block does not
// fit, -1 on an error.
int pf_srb_lqr_resident_warps(int m, int T, int shared_gains) {
  const bool sg = shared_gains != 0;
  return m == 6 ? resident_warps<6>(T, sg)
                : m == 12 ? resident_warps<12>(T, sg) : -1;
}

}  // extern "C"
