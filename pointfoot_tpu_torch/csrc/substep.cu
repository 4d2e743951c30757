// Physics substep and collision-sphere FK kernels for the legged robots.
//
// Replaces the four TPU kernels of pointfoot_tpu/ops/pallas/substep.py:
//   rollout_substep_kernel <- _rollout_kernel        (substep.py:273)
//   fk_from_state_kernel   <- _fk_from_state_kernel  (substep.py:328)
//   substep_kernel         <- _kernel                (substep.py:65)
//   fk_contact_xy_kernel   <- _fk_kernel             (substep.py:201)
// Plain PyTorch versions: physics/rowdyn.py, driven row by row from
// ops/cuda/substep.py (rollout_step_plain, fk_rows_plain, step_rows_plain,
// fk_xy_rows_plain).  The substep itself is rowdyn.cuh's substep_group.
//
// Design.  Tensors are rows x envs (SoA, each row B contiguous floats).
// The two substep kernels give each env a group of four lanes and a slab
// of shared memory (rowdyn.cuh, substep_group): a block is one warp, eight
// envs, so 4096 envs are 512 blocks, four resident on each of the 132 SMs.
// The warp sweeps the block's rows into the slabs (the eight envs of a
// block are 32 contiguous bytes of every row, four rows a pass), runs the
// substep in phases, and sweeps the outputs back.  The tail block clamps
// its env index to B - 1 and skips the stores, so every lane reaches every
// barrier (the TPU kernels padded with copies of env 0).
//   - rollout_substep_kernel: PD torque, the substep with the queued push on
//     substep 0, FK of the new state (the fused decimation rollout);
//   - substep_kernel: the substep with torque, base force and surface rows
//     as inputs; the force applies on every call (step_batched passes the
//     push on substep 0 only);
//   - fk_contact_xy_kernel and fk_from_state_kernel: sphere xy from the FK
//     rows and sphere xyz from the rollout state rows, one walk
//     (branch_fk) templated on the input row layout and the output width:
//     32 envs a block, warp w of the block walks branch w (a leg) of each
//     env and places the leg's spheres (branch 0 those on the base too),
//     straight-line code with the model folded in.  The branch is the same
//     across a warp, so no lanes diverge.  The xy kernel at 4096 ANYmal envs
//     (H100 80GB HBM3, 700 W, CUDA graph replay): 0.0028 ms against 0.0033
//     one env a thread; a launch alone takes 0.0010, the one-env-a-thread
//     kernel with the FK taken out 0.0014.  Four lanes of a warp an env, a
//     lane a leg on the run-time tables pfr_* with the frames in a slab,
//     took 0.0045-0.0048: the tables' loads and the slab's round trips
//     cost more than the lanes gained.
//
// Bound.  PointFoot's rollout substep moves (31 + 42 + 36 + 31 + 60) * 4 B
// = 800 B per env and ANYmal's substep (83 + 52 + 76) * 4 B = 844 B: at
// 4096 envs about 3.3-3.5 MB, 1 us of HBM time at 3.35 TB/s, and about as
// much at the float32 peak.  The kernels are bound by latency, not by
// either: see rowdyn.cuh for what the group-of-lanes design does about it.
// The sphere-xy FK moves (18 + 26) * 4 B = 176 B an ANYmal env, 0.22 us of
// HBM time at 4096 envs, the sphere-xyz FK (19 + 39) * 4 B = 232 B: a
// launch and one round trip to memory set their time.

#include "rowdyn.cuh"

namespace {

using namespace pf;

// rollout state rows: base_pos 3, base_quat 4, base_lin_vel 3,
// base_ang_vel 3, qpos, qvel, last_qvel
constexpr int S_POS = 0, S_QUAT = 3, S_LIN = 7, S_ANG = 10, S_QPOS = 13;
constexpr int S_QVEL = S_QPOS + NJ, S_LQVEL = S_QVEL + NJ;
constexpr int R_STATE = S_LQVEL + NJ;
// rollout control rows: actions, kp, kd, friction[nc], joint_friction,
// added_mass, com_offset 3, k_contact, d_contact, push 3
constexpr int C_ACT = 0, C_KP = NJ, C_KD = 2 * NJ, C_FRIC = 3 * NJ;
constexpr int C_JFRIC = C_FRIC + NC, C_AMASS = C_JFRIC + NJ;
constexpr int C_COM = C_AMASS + 1, C_KC = C_COM + 3, C_DC = C_KC + 1;
constexpr int C_PUSH = C_DC + 1, R_CTRL = C_PUSH + 3;
// surface rows: height[nc], then normal xyz of each sphere
constexpr int R_SURF = 4 * NC;
// rollout extra output rows: tau, contact force xyz, sphere world xyz
constexpr int X_TAU = 0, X_FORCE = NJ, X_XYZ = NJ + 3 * NC;
constexpr int R_EXTRA = NJ + 6 * NC;
// substep input rows: base_pos 3, base_quat 4, base_lin_vel 3,
// base_ang_vel 3, qpos, qvel, tau, ext_force 3, friction[nc],
// joint_friction, added_mass, com_offset 3, k_contact, d_contact
constexpr int I_TAU = S_QVEL + NJ, I_EXT = I_TAU + NJ, I_FRIC = I_EXT + 3;
constexpr int I_JFRIC = I_FRIC + NC, I_AMASS = I_JFRIC + NJ;
constexpr int I_COM = I_AMASS + 1, I_KC = I_COM + 3, I_DC = I_KC + 1;
constexpr int R_SUB_IN = I_DC + 1;
// substep output rows: base_pos 3, base_quat 4, base_lin_vel 3,
// base_ang_vel 3, qpos, qvel, contact force xyz of each sphere
constexpr int O_FORCE = S_QVEL + NJ, R_SUB_OUT = O_FORCE + 3 * NC;
// FK input rows: base_pos 3, base_quat 4, qpos
constexpr int K_POS = 0, K_QUAT = 3, K_QPOS = 7, R_FK_IN = K_QPOS + NJ;

// Where the sphere FK finds base_pos, base_quat and the first qpos row.
template <int P, int Q, int J>
struct PoseRows {
  static constexpr int POS = P, QUAT = Q, QPOS = J;
};
using FkInRows = PoseRows<K_POS, K_QUAT, K_QPOS>;  // fk_contact_xy_kernel
using StateRows = PoseRows<S_POS, S_QUAT, S_QPOS>;  // fk_from_state_kernel

constexpr int SUB_THREADS = LANES * ENVS_PER_BLOCK;  // the substep kernels
constexpr int SUB_SMEM = ENVS_PER_BLOCK * slab::STRIDE * 4;  // bytes a block
// rows a warp sweeps in one pass
constexpr int SWEEP = SUB_THREADS / ENVS_PER_BLOCK;

// the slab's input part is substep_kernel's input rows, its output part
// the output rows; the rollout's control rows are staged in the slab's
// sphere records
static_assert(slab::I_SURF == R_SUB_IN && slab::I_TAU == S_LQVEL &&
                  slab::O_FORCE == O_FORCE && slab::I_TAU == I_TAU &&
                  slab::I_DC == I_DC,
              "slab layout and row layout differ");
static_assert(slab::A - slab::SPH >= R_CTRL, "no room to stage the controls");
static_assert(SUB_SMEM <= 232448, "a block's slabs exceed shared memory");

// The sphere FK kernels: a warp a branch below the base, 32 envs a block
constexpr int FK_THREADS = 32 * PF_NBR;

// nrows rows of column es into dst, a row every SWEEP lanes
__device__ __forceinline__ void sweep_in(const float* __restrict__ rows,
                                         int nrows, size_t Bs, int es, int r0,
                                         float* dst) {
  for (int r = r0; r < nrows; r += SWEEP) dst[r] = rows[r * Bs + es];
}

__device__ __forceinline__ void sweep_out(float* __restrict__ rows, int nrows,
                                          size_t Bs, int es, int r0,
                                          const float* src) {
  for (int r = r0; r < nrows; r += SWEEP) rows[r * Bs + es] = src[r];
}

// Surface rows into the slab; flat ground at z = 0 without them.
__device__ __forceinline__ void sweep_surface(const float* __restrict__ surf,
                                              size_t Bs, int es, int r0,
                                              float* dst) {
  if (surf != nullptr) {
    sweep_in(surf, R_SURF, Bs, es, r0, dst);
  } else {
    for (int r = r0; r < R_SURF; r += SWEEP)
      dst[r] = r >= NC && (r - NC) % 3 == 2 ? 1.0f : 0.0f;
  }
}

__global__ void __launch_bounds__(SUB_THREADS) rollout_substep_kernel(
    const float* __restrict__ state, const float* __restrict__ ctrl,
    const float* __restrict__ surf, float* __restrict__ out_state,
    float* __restrict__ out_extra, int B, int with_push, int control_type,
    PfJointVec default_qpos, float action_scale, float dt, float gravity) {
  extern __shared__ float smem[];
  const size_t Bs = static_cast<size_t>(B);
  const int tid = threadIdx.x;
  const int e0 = blockIdx.x * ENVS_PER_BLOCK;
  // sweeping: column `es` of row r0, r0 + SWEEP, ...
  const int r0 = tid / ENVS_PER_BLOCK;
  const bool store = e0 + tid % ENVS_PER_BLOCK < B;
  const int es = min(e0 + tid % ENVS_PER_BLOCK, B - 1);
  float* ss = smem + (tid % ENVS_PER_BLOCK) * slab::STRIDE;
  // computing: lane `lane` of the group of slab `sl`
  const int lane = tid % LANES;
  float* sl = smem + (tid / LANES) * slab::STRIDE;

  // the state rows fill the slab's state part; last_qvel lands in tau's
  // place until the torque replaces it
  sweep_in(state, R_STATE, Bs, es, r0, ss);
  sweep_in(ctrl, R_CTRL, Bs, es, r0, ss + slab::SPH);
  sweep_surface(surf, Bs, es, r0, ss + slab::I_SURF);
  __syncwarp();

  // ---- PD torque (control type 0 P, 1 V, 2 T), clipped to the effort
  // limit, and the per-env parameters
  const float* in_c = sl + slab::SPH;
  for (int j = lane; j < NJ; j += LANES) {
    const float scaled = in_c[C_ACT + j] * action_scale;
    const float qp = sl[slab::I_QPOS + j], qv = sl[slab::I_QVEL + j];
    float t;
    if (control_type == 0) {
      // the default angle last, as the plain version folds its constant
      t = in_c[C_KP + j] * ((scaled - qp) + default_qpos.v[j]) -
          in_c[C_KD + j] * qv;
    } else if (control_type == 1) {
      t = in_c[C_KP + j] * (scaled - qv) -
          in_c[C_KD + j] * ((qv - sl[slab::I_TAU + j]) * (1.0f / dt));
    } else {
      t = scaled;
    }
    sl[slab::I_TAU + j] =
        clipp(t, -pfr_effort_limit[j], pfr_effort_limit[j]);
    sl[slab::I_JFRIC + j] = in_c[C_JFRIC + j];
  }
  for (int c = lane; c < NC; c += LANES)
    sl[slab::I_FRIC + c] = in_c[C_FRIC + c];
  if (lane == LANES - 1) {
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      sl[slab::I_EXT + r] = with_push ? in_c[C_PUSH + r] : 0.0f;
      sl[slab::I_COM + r] = in_c[C_COM + r];
    }
    sl[slab::I_AMASS] = in_c[C_AMASS];
    sl[slab::I_KC] = in_c[C_KC];
    sl[slab::I_DC] = in_c[C_DC];
  }
  __syncwarp();

  substep_group(sl, lane, dt, gravity);
  const float* o = sl + slab::OUT;
  sphere_world_group(sl, lane, o + slab::I_POS, o + slab::I_QUAT,
                     o + slab::I_QPOS, sl + slab::OUT + slab::O_XYZ);
  __syncwarp();

  // ---- outputs: new state (last_qvel <- this substep's input qvel),
  // torque, contact forces, sphere positions of the new state
  if (store) {
    sweep_out(out_state, S_LQVEL, Bs, es, r0, ss + slab::OUT);
    sweep_out(out_state + S_LQVEL * Bs, NJ, Bs, es, r0, ss + slab::I_QVEL);
    sweep_out(out_extra + X_TAU * Bs, NJ, Bs, es, r0, ss + slab::I_TAU);
    sweep_out(out_extra + X_FORCE * Bs, 6 * NC, Bs, es, r0,
              ss + slab::OUT + slab::O_FORCE);
  }
}

__global__ void __launch_bounds__(SUB_THREADS) substep_kernel(
    const float* __restrict__ rows, const float* __restrict__ surf,
    float* __restrict__ out_rows, int B, float dt, float gravity) {
  extern __shared__ float smem[];
  const size_t Bs = static_cast<size_t>(B);
  const int tid = threadIdx.x;
  const int e0 = blockIdx.x * ENVS_PER_BLOCK;
  const int r0 = tid / ENVS_PER_BLOCK;
  const bool store = e0 + tid % ENVS_PER_BLOCK < B;
  const int es = min(e0 + tid % ENVS_PER_BLOCK, B - 1);
  float* ss = smem + (tid % ENVS_PER_BLOCK) * slab::STRIDE;

  sweep_in(rows, R_SUB_IN, Bs, es, r0, ss);
  sweep_surface(surf, Bs, es, r0, ss + slab::I_SURF);
  __syncwarp();
  substep_group(smem + (tid / LANES) * slab::STRIDE, tid % LANES, dt,
                gravity);
  if (store) sweep_out(out_rows, R_SUB_OUT, Bs, es, r0, ss + slab::OUT);
}

// Body b (not the base) lies on branch BR.
__host__ __device__ constexpr bool in_branch(int BR, int b) {
  for (int n = 0; n < pf_br_len(BR); ++n)
    if (pf_br_body(BR, n) == b) return true;
  return false;
}

// World position (the first W of x, y, z) of sphere C, and of the spheres
// after it, that branch BR places: its own, and for branch 0 those on the
// base.  Output row W·c + i holds coordinate i of sphere c.
template <int W, int BR, int C>
__device__ __forceinline__ void place_spheres(const float R[NB][3][3],
                                              const float pos[NB][3],
                                              const float base[W],
                                              float* __restrict__ out,
                                              size_t Bs, int e, bool store) {
  if constexpr (C < NC) {
    constexpr int b = pf_coll_body(C);
    if constexpr (b == 0 ? BR == 0 : in_branch(BR, b)) {
      float p[3];
      sphere_rel(C, R, pos, p);
#pragma unroll
      for (int i = 0; i < W; ++i)
        if (store) out[(W * C + i) * Bs + e] = base[i] + p[i];
    }
    place_spheres<W, BR, C + 1>(R, pos, base, out, Bs, e, store);
  }
}

// World position of the spheres of branch BR (a leg), and for branch 0 of
// the spheres on the base, for env e of the pose rows laid out as L: the
// body frames of the branch alone and sphere_rel, straight-line code with
// the model folded in.  Base z is read only for W = 3.
template <class L, int W, int BR>
__device__ __forceinline__ void branch_fk(const float* __restrict__ rows,
                                          float* __restrict__ out, size_t Bs,
                                          int e, bool store) {
  float quat[4], base[W], qpos[NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) quat[i] = rows[(L::QUAT + i) * Bs + e];
#pragma unroll
  for (int i = 0; i < W; ++i) base[i] = rows[(L::POS + i) * Bs + e];
#pragma unroll
  for (int n = 0; n < pf_br_len(BR); ++n) {
    const int j = pf_br_body(BR, n) - 1;
    qpos[j] = rows[(L::QPOS + j) * Bs + e];
  }
  // the branch's bodies are in ascending order, so parents come first
  float R[NB][3][3], pos[NB][3];
  quat_to_mat(quat, R[0]);
  pos[0][0] = pos[0][1] = pos[0][2] = 0.0f;
#pragma unroll
  for (int n = 0; n < pf_br_len(BR); ++n) {
    const int b = pf_br_body(BR, n);
    fk_child(b, qpos[b - 1], R, pos);
  }
  place_spheres<W, BR, 0>(R, pos, base, out, Bs, e, store);
}

// Warp `warp` of the block runs branch `warp`: the branch is the same for
// the whole warp, so no lanes diverge.
template <class L, int W, int BR>
__device__ __forceinline__ void branch_fk_of(int warp,
                                             const float* __restrict__ rows,
                                             float* __restrict__ out,
                                             size_t Bs, int e, bool store) {
  if (warp == BR) {
    branch_fk<L, W, BR>(rows, out, Bs, e, store);
  } else if constexpr (BR + 1 < PF_NBR) {
    branch_fk_of<L, W, BR + 1>(warp, rows, out, Bs, e, store);
  }
}

// A group of PF_NBR threads an env, one in each warp of the block, a thread
// a leg; 32 envs a block, each row a warp loads or stores is 128 B.  The
// tail block clamps its env to B - 1 and skips the stores.
__global__ void __launch_bounds__(FK_THREADS) fk_contact_xy_kernel(
    const float* __restrict__ rows, float* __restrict__ out, int B) {
  const int e = blockIdx.x * 32 + threadIdx.x % 32;
  const bool store = e < B;
  branch_fk_of<FkInRows, 2, 0>(threadIdx.x / 32, rows, out,
                               static_cast<size_t>(B), min(e, B - 1), store);
}

// The same walk on the rollout state rows, x, y and z of every sphere.
__global__ void __launch_bounds__(FK_THREADS) fk_from_state_kernel(
    const float* __restrict__ state, float* __restrict__ out, int B) {
  const int e = blockIdx.x * 32 + threadIdx.x % 32;
  const bool store = e < B;
  branch_fk_of<StateRows, 3, 0>(threadIdx.x / 32, state, out,
                                static_cast<size_t>(B), min(e, B - 1), store);
}

int fk_blocks_for(int B) { return (B + 31) / 32; }
int sub_blocks_for(int B) {
  return (B + ENVS_PER_BLOCK - 1) / ENVS_PER_BLOCK;
}

// Lets a substep kernel use its slabs (above the 48 KB default).
template <class Kernel>
cudaError_t allow_slabs(Kernel kernel) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SUB_SMEM);
}

template <class Kernel>
int resident_warps(Kernel kernel) {
  int blocks = 0;
  if (allow_slabs(kernel) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, kernel, SUB_THREADS, SUB_SMEM) != cudaSuccess)
    return -1;
  return blocks * SUB_THREADS / 32;
}

template <class Kernel>
int fk_resident_warps(Kernel kernel) {
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                    FK_THREADS, 0) !=
      cudaSuccess)
    return -1;
  return blocks * FK_THREADS / 32;
}

}  // namespace

extern "C" {

// Row counts the kernels were built for: nj, nc, rollout state, rollout
// control, surface, rollout extra, substep input, substep output and FK
// input rows.  The wrapper checks them against its own layouts.
void pf_layout(int* out) {
  out[0] = NJ;
  out[1] = NC;
  out[2] = R_STATE;
  out[3] = R_CTRL;
  out[4] = R_SURF;
  out[5] = R_EXTRA;
  out[6] = R_SUB_IN;
  out[7] = R_SUB_OUT;
  out[8] = R_FK_IN;
}

// Dynamic shared memory of one block of the two substep kernels, in bytes.
int pf_substep_smem_bytes() { return SUB_SMEM; }

// Warps that one SM holds of the rollout substep kernel (which = 0) or the
// substep kernel (1), by cudaOccupancyMaxActiveBlocksPerMultiprocessor; -1
// on an error.
int pf_substep_resident_warps(int which) {
  return which == 0 ? resident_warps(rollout_substep_kernel)
                    : resident_warps(substep_kernel);
}

// Warps that one SM holds of the sphere-xy FK kernel (no shared memory);
// -1 on an error.
int pf_fk_xy_resident_warps() {
  return fk_resident_warps(fk_contact_xy_kernel);
}

// Warps that one SM holds of the sphere-xyz FK kernel (no shared memory);
// -1 on an error.
int pf_fk_xyz_resident_warps() {
  return fk_resident_warps(fk_from_state_kernel);
}

// One decimation substep for B envs on `stream`.  `surf` may be null (flat
// ground at z = 0).  Returns the cudaError_t of the launch.
int pf_rollout_substep(const float* state, const float* ctrl,
                       const float* surf, float* out_state, float* out_extra,
                       int B, int with_push, int control_type,
                       PfJointVec default_qpos, float action_scale, float dt,
                       float gravity, void* stream) {
  if (B <= 0) return 0;
  cudaError_t err = allow_slabs(rollout_substep_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  rollout_substep_kernel<<<sub_blocks_for(B), SUB_THREADS, SUB_SMEM,
                           static_cast<cudaStream_t>(stream)>>>(
      state, ctrl, surf, out_state, out_extra, B, with_push, control_type,
      default_qpos, action_scale, dt, gravity);
  return static_cast<int>(cudaGetLastError());
}

// One substep (torque and base force given) for B envs.  `surf` may be
// null (flat ground at z = 0).
int pf_substep(const float* rows, const float* surf, float* out_rows, int B,
               float dt, float gravity, void* stream) {
  if (B <= 0) return 0;
  cudaError_t err = allow_slabs(substep_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  substep_kernel<<<sub_blocks_for(B), SUB_THREADS, SUB_SMEM,
                   static_cast<cudaStream_t>(stream)>>>(rows, surf, out_rows,
                                                        B, dt, gravity);
  return static_cast<int>(cudaGetLastError());
}

// World xyz of every collision sphere (3·nc rows) from the state rows.
int pf_fk_from_state(const float* state, float* out, int B, void* stream) {
  if (B <= 0) return 0;
  fk_from_state_kernel<<<fk_blocks_for(B), FK_THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(state, out, B);
  return static_cast<int>(cudaGetLastError());
}

// World xy of every collision sphere (2·nc rows) from base_pos, base_quat
// and qpos rows.
int pf_fk_contact_xy(const float* rows, float* out, int B, void* stream) {
  if (B <= 0) return 0;
  fk_contact_xy_kernel<<<fk_blocks_for(B), FK_THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(rows, out, B);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
