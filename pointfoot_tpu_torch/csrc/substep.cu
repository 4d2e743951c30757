// Physics substep and collision-sphere FK kernels for the legged robots.
//
// Replaces the four TPU kernels of pointfoot_tpu/ops/pallas/substep.py:
//   rollout_substep_kernel <- _rollout_kernel        (substep.py:273)
//   fk_from_state_kernel   <- _fk_from_state_kernel  (substep.py:328)
//   substep_kernel         <- _kernel                (substep.py:65)
//   fk_contact_xy_kernel   <- _fk_kernel             (substep.py:201)
// Plain PyTorch versions: physics/rowdyn.py, driven row by row from
// ops/cuda/substep.py (rollout_step_plain, fk_rows_plain, step_rows_plain,
// fk_xy_rows_plain).  The substep itself is rowdyn.cuh's substep_body.
//
// Design.  One thread per env runs the whole straight-line program.
// Tensors are rows × envs (SoA, each row B contiguous floats), so the
// threads of a warp read and write neighbouring addresses.  The tail block
// returns early for e >= B (the TPU kernels padded with copies of env 0).
//   - rollout_substep_kernel: PD torque, the substep with the queued push on
//     substep 0, FK of the new state (the fused decimation rollout);
//   - substep_kernel: the substep with torque, base force and surface rows
//     as inputs; the force applies on every call (step_batched passes the
//     push on substep 0 only);
//   - fk_from_state_kernel / fk_contact_xy_kernel: sphere xyz / xy.
//
// Bound.  PointFoot's rollout substep moves (31 + 42 + 36 + 31 + 60) · 4 B
// = 800 B per env and ANYmal's substep (83 + 52 + 76) · 4 B = 844 B: at
// 4096 envs about 3.3-3.5 MB, 1 µs of HBM time at 3.35 TB/s, and a few
// tenths of a µs at the FP32 peak — far below what a 4096-thread launch
// (32 blocks of 128 on 132 SMs) can reach.  The kernels are bound by
// latency: each thread runs a long dependent chain whose arrays (mass
// matrix, Cholesky factor; 171 entries at ANYmal's nv = 18) spill to local
// memory.  Occupancy and spills are the work of a later change; this one
// is right and simple.

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

constexpr int THREADS = 128;

// The state rows shared by the rollout state, the substep input and the
// substep output (the first 13 + 2·nj rows of each).
__device__ __forceinline__ void read_state(const float* __restrict__ rows,
                                           size_t Bs, int e, SubstepIn& in) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    in.base_pos[i] = rows[(S_POS + i) * Bs + e];
    in.lin[i] = rows[(S_LIN + i) * Bs + e];
    in.ang[i] = rows[(S_ANG + i) * Bs + e];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) in.quat[i] = rows[(S_QUAT + i) * Bs + e];
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    in.qpos[j] = rows[(S_QPOS + j) * Bs + e];
    in.qvel[j] = rows[(S_QVEL + j) * Bs + e];
  }
}

__device__ __forceinline__ void write_state(float* __restrict__ rows,
                                            size_t Bs, int e,
                                            const SubstepOut& out) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    rows[(S_POS + i) * Bs + e] = out.base_pos[i];
    rows[(S_LIN + i) * Bs + e] = out.lin[i];
    rows[(S_ANG + i) * Bs + e] = out.ang[i];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) rows[(S_QUAT + i) * Bs + e] = out.quat[i];
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    rows[(S_QPOS + j) * Bs + e] = out.qpos[j];
    rows[(S_QVEL + j) * Bs + e] = out.qvel[j];
  }
}

// World xyz of every sphere of the pose (base_pos, quat, qpos).
__device__ __forceinline__ void sphere_world(const float base_pos[3],
                                             const float quat[4],
                                             const float qpos[NJ],
                                             float xyz[NC][3]) {
  float R[NB][3][3], pos[NB][3];
  forward_kinematics(quat, qpos, R, pos, nullptr);
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    float p[3];
    sphere_rel(c, R, pos, p);
#pragma unroll
    for (int i = 0; i < 3; ++i) xyz[c][i] = base_pos[i] + p[i];
  }
}

__global__ void __launch_bounds__(THREADS) rollout_substep_kernel(
    const float* __restrict__ state, const float* __restrict__ ctrl,
    const float* __restrict__ surf, float* __restrict__ out_state,
    float* __restrict__ out_extra, int B, int with_push, int control_type,
    PfJointVec default_qpos, float action_scale, float dt, float gravity) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= B) return;
  const size_t Bs = static_cast<size_t>(B);
  auto in_c = [&](int r) { return ctrl[r * Bs + e]; };

  SubstepIn in;
  read_state(state, Bs, e, in);

  // ---- PD torque (control type 0 P, 1 V, 2 T), clipped to the effort limit
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const float scaled = in_c(C_ACT + j) * action_scale;
    float t;
    if (control_type == 0) {
      t = in_c(C_KP + j) * (scaled + default_qpos.v[j] - in.qpos[j]) -
          in_c(C_KD + j) * in.qvel[j];
    } else if (control_type == 1) {
      t = in_c(C_KP + j) * (scaled - in.qvel[j]) -
          in_c(C_KD + j) *
              ((in.qvel[j] - state[(S_LQVEL + j) * Bs + e]) / dt);
    } else {
      t = scaled;
    }
    in.tau[j] = clipp(t, -pf_effort_limit(j), pf_effort_limit(j));
  }
#pragma unroll
  for (int r = 0; r < 3; ++r) in.ext[r] = with_push ? in_c(C_PUSH + r) : 0.0f;
#pragma unroll
  for (int c = 0; c < NC; ++c) in.friction[c] = in_c(C_FRIC + c);
#pragma unroll
  for (int j = 0; j < NJ; ++j) in.jfric[j] = in_c(C_JFRIC + j);
  in.added_mass = in_c(C_AMASS);
#pragma unroll
  for (int i = 0; i < 3; ++i) in.com_offset[i] = in_c(C_COM + i);
  in.k_c = in_c(C_KC);
  in.d_c = in_c(C_DC);

  SubstepOut out;
  substep_body(in, surf, Bs, e, dt, gravity, out);

  // ---- outputs: new state (last_qvel <- this substep's input qvel),
  // torque, contact forces, sphere positions of the new state
  write_state(out_state, Bs, e, out);
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    out_state[(S_LQVEL + j) * Bs + e] = in.qvel[j];
    out_extra[(X_TAU + j) * Bs + e] = in.tau[j];
  }
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int r = 0; r < 3; ++r)
      out_extra[(X_FORCE + 3 * c + r) * Bs + e] = out.force[c][r];
  float xyz[NC][3];
  sphere_world(out.base_pos, out.quat, out.qpos, xyz);
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < 3; ++i)
      out_extra[(X_XYZ + 3 * c + i) * Bs + e] = xyz[c][i];
}

__global__ void __launch_bounds__(THREADS) substep_kernel(
    const float* __restrict__ rows, const float* __restrict__ surf,
    float* __restrict__ out_rows, int B, float dt, float gravity) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= B) return;
  const size_t Bs = static_cast<size_t>(B);
  auto in_r = [&](int r) { return rows[r * Bs + e]; };

  SubstepIn in;
  read_state(rows, Bs, e, in);
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    in.tau[j] = in_r(I_TAU + j);
    in.jfric[j] = in_r(I_JFRIC + j);
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    in.ext[i] = in_r(I_EXT + i);
    in.com_offset[i] = in_r(I_COM + i);
  }
#pragma unroll
  for (int c = 0; c < NC; ++c) in.friction[c] = in_r(I_FRIC + c);
  in.added_mass = in_r(I_AMASS);
  in.k_c = in_r(I_KC);
  in.d_c = in_r(I_DC);

  SubstepOut out;
  substep_body(in, surf, Bs, e, dt, gravity, out);

  write_state(out_rows, Bs, e, out);
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int r = 0; r < 3; ++r)
      out_rows[(O_FORCE + 3 * c + r) * Bs + e] = out.force[c][r];
}

__global__ void __launch_bounds__(THREADS) fk_from_state_kernel(
    const float* __restrict__ state, float* __restrict__ out, int B) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= B) return;
  const size_t Bs = static_cast<size_t>(B);
  float base_pos[3], quat[4], qpos[NJ];
#pragma unroll
  for (int i = 0; i < 3; ++i) base_pos[i] = state[(S_POS + i) * Bs + e];
#pragma unroll
  for (int i = 0; i < 4; ++i) quat[i] = state[(S_QUAT + i) * Bs + e];
#pragma unroll
  for (int j = 0; j < NJ; ++j) qpos[j] = state[(S_QPOS + j) * Bs + e];
  float xyz[NC][3];
  sphere_world(base_pos, quat, qpos, xyz);
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < 3; ++i) out[(3 * c + i) * Bs + e] = xyz[c][i];
}

__global__ void __launch_bounds__(THREADS) fk_contact_xy_kernel(
    const float* __restrict__ rows, float* __restrict__ out, int B) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= B) return;
  const size_t Bs = static_cast<size_t>(B);
  float base_pos[3], quat[4], qpos[NJ];
#pragma unroll
  for (int i = 0; i < 3; ++i) base_pos[i] = rows[(K_POS + i) * Bs + e];
#pragma unroll
  for (int i = 0; i < 4; ++i) quat[i] = rows[(K_QUAT + i) * Bs + e];
#pragma unroll
  for (int j = 0; j < NJ; ++j) qpos[j] = rows[(K_QPOS + j) * Bs + e];
  float xyz[NC][3];
  sphere_world(base_pos, quat, qpos, xyz);
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < 2; ++i) out[(2 * c + i) * Bs + e] = xyz[c][i];
}

int blocks_for(int B) { return (B + THREADS - 1) / THREADS; }

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

// One decimation substep for B envs on `stream`.  `surf` may be null (flat
// ground at z = 0).  Returns the cudaError_t of the launch.
int pf_rollout_substep(const float* state, const float* ctrl,
                       const float* surf, float* out_state, float* out_extra,
                       int B, int with_push, int control_type,
                       PfJointVec default_qpos, float action_scale, float dt,
                       float gravity, void* stream) {
  if (B <= 0) return 0;
  rollout_substep_kernel<<<blocks_for(B), THREADS, 0,
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
  substep_kernel<<<blocks_for(B), THREADS, 0,
                   static_cast<cudaStream_t>(stream)>>>(rows, surf, out_rows,
                                                        B, dt, gravity);
  return static_cast<int>(cudaGetLastError());
}

// World xyz of every collision sphere (3·nc rows) from the state rows.
int pf_fk_from_state(const float* state, float* out, int B, void* stream) {
  if (B <= 0) return 0;
  fk_from_state_kernel<<<blocks_for(B), THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(state, out, B);
  return static_cast<int>(cudaGetLastError());
}

// World xy of every collision sphere (2·nc rows) from base_pos, base_quat
// and qpos rows.
int pf_fk_contact_xy(const float* rows, float* out, int B, void* stream) {
  if (B <= 0) return 0;
  fk_contact_xy_kernel<<<blocks_for(B), THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(rows, out, B);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
