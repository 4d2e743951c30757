// Per-env physics substep as device code, shared by the kernels of
// substep.cu.  The device counterpart of physics/rowdyn.py (substep_rows,
// fk_contact_pos, fk_contact_xy), replacing the body of the TPU kernel
// _kernel of pointfoot_tpu/ops/pallas/substep.py:65: the same float32
// operations, each sum in the same order, so a kernel and its plain version
// on the card agree bit for bit.  "The same order" is the plain version's
// as torch runs it: its rows fold python constants (zero terms drop out,
// constant terms are summed in float64 and added last, subtree masses are
// float64 sums rounded once: pfr_cmass), it adds the terms of a sum one at
// a time (the 6 x 6 inertia product, J'f0, D v), and CUDA's torch divides
// by a python float as a product with its float32 reciprocal.  Stiff
// contact amplifies a one-ulp difference in one substep to 1e-3 in qvel
// three substeps on, so no sum is reordered.
//
// Bound.  A substep is about 18,000 float operations and 850 bytes an env
// (ANYmal): a microsecond for 4096 envs at the card's float32 peak or its
// memory rate.  What it costs is latency: the operations form long
// dependent chains over a working set of some 1,600 floats, far more than
// a thread's 255 registers.
//
// Design: `substep_group`.  A group of LANES = 4 lanes works on one env,
// eight envs a warp, and the env's working set (inputs, body frames,
// motion subspaces, velocities, inertias, the 18 x 18 system, the
// per-sphere Jacobians and damping, outputs) lies in a slab of shared
// memory; registers hold what a lane is working on.  The program runs in
// phases separated by __syncwarp() (a group never straddles a warp and no
// lane leaves early):
//   - tree quantities by branch: a lane walks one subtree below the base
//     (a leg) down for FK, velocities, inertias and RNEA forces, and up for
//     the composite inertias, the mass-matrix entries and the bias forces;
//     one lane then folds the branch roots into the base, in the serial
//     order;
//   - contact by sphere, one sphere a lane a pass, writing the sphere's
//     Jacobian columns, D J and spring force to the slab;
//   - the system by entry: the owner of an entry of A or of J'f0 sums the
//     spheres' terms in ascending sphere order, as the serial program did
//     (stiff contact amplifies roundoff, so no sum is reordered);
//   - the Cholesky by column, the entries of a column over the lanes, each
//     entry's sum over k in order; the forward substitution by columns
//     too (a lane keeps the running sums of its rows, so each row still
//     subtracts in ascending k); the back substitution stays with one
//     lane, since row i's first term is the row solved just before;
//   - sensors by sphere, integration by joint.
// The lanes of a group run the same instructions on different bodies, so
// the model's constants are device arrays pfr_* indexed at run time; the
// two sphere FK kernels of substep.cu run fk_child a body at a time, a
// thread a branch, on the constexpr accessors pf_*(i), which fold into
// immediates.  Every constant is float: a double would silently promote
// the arithmetic and change both the result and the speed.  Slabs are 4
// mod 32 floats apart and A's rows 19, so the lanes of a warp fall on
// different banks when they read one address per group, neighbouring
// addresses or neighbouring rows.
//
// What is unrolled is chosen by measurement (H100): a block is one warp
// that runs every instruction once, so straight-line code is fetched as it
// runs and long unrolled stretches cost more in instruction fetch than
// they win in overlap.  Unrolling the Cholesky and the back substitution
// (short bodies, long dependent chains) took a quarter off the kernel;
// unrolling the 13-sphere sums of A's base block made it half again as
// slow; eight lanes an env (twice the warps, the tree phases half idle)
// were a tenth slower than four.

#pragma once

#include <cuda_runtime.h>

#include "pf_model.h"

namespace pf {

constexpr int NB = PF_NB;
constexpr int NJ = PF_NJ;
constexpr int NC = PF_NC;
constexpr int NV = 6 + NJ;

// max/min/clip that propagate NaN like jnp.maximum/minimum/clip (fmaxf
// would drop it, and the env's NaN quarantine would never see the state)
__device__ __forceinline__ float maxp(float a, float b) {
  return (a > b || a != a) ? a : b;
}
__device__ __forceinline__ float minp(float a, float b) {
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float clipp(float a, float lo, float hi) {
  return minp(maxp(a, lo), hi);
}

__device__ __forceinline__ void cross3(const float u[3], const float v[3],
                                       float out[3]) {
  out[0] = u[1] * v[2] - u[2] * v[1];
  out[1] = u[2] * v[0] - u[0] * v[2];
  out[2] = u[0] * v[1] - u[1] * v[0];
}

__device__ __forceinline__ float dot3(const float u[3], const float v[3]) {
  return u[0] * v[0] + u[1] * v[1] + u[2] * v[2];
}

__device__ __forceinline__ void quat_to_mat(const float q[4], float R[3][3]) {
  const float x = q[0], y = q[1], z = q[2], w = q[3];
  const float xx = x * x, yy = y * y, zz = z * z;
  const float xy = x * y, xz = x * z, yz = y * z;
  const float wx = w * x, wy = w * y, wz = w * z;
  R[0][0] = 1.0f - 2.0f * (yy + zz);
  R[0][1] = 2.0f * (xy - wz);
  R[0][2] = 2.0f * (xz + wy);
  R[1][0] = 2.0f * (xy + wz);
  R[1][1] = 1.0f - 2.0f * (xx + zz);
  R[1][2] = 2.0f * (yz - wx);
  R[2][0] = 2.0f * (xz - wy);
  R[2][1] = 2.0f * (yz + wx);
  R[2][2] = 1.0f - 2.0f * (xx + yy);
}

// Body b's rotation and position relative to the base origin, from its
// parent's and its joint angle qj.
__device__ __forceinline__ void fk_child(int b, float qj, float R[NB][3][3],
                                         float pos[NB][3]) {
  const int j = b - 1;
  const int p = pf_parent(b);
  float frame0[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    pos[b][i] = pos[p][i] + (R[p][i][0] * pf_joint_pos(j, 0) +
                             R[p][i][1] * pf_joint_pos(j, 1) +
                             R[p][i][2] * pf_joint_pos(j, 2));
#pragma unroll
    for (int k = 0; k < 3; ++k)
      frame0[i][k] = R[p][i][0] * pf_joint_rot(j, 0, k) +
                     R[p][i][1] * pf_joint_rot(j, 1, k) +
                     R[p][i][2] * pf_joint_rot(j, 2, k);
  }
  // Rodrigues about the constant joint axis: I + sin q K + (1 - cos q) K²
  const float ax = pf_joint_axis(j, 0), ay = pf_joint_axis(j, 1),
              az = pf_joint_axis(j, 2);
  const float K[3][3] = {{0.0f, -az, ay}, {az, 0.0f, -ax}, {-ay, ax, 0.0f}};
  float s, c;
  sincosf(qj, &s, &c);
  const float one_c = 1.0f - c;
  float Rj[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float kk = K[i][0] * K[0][k] + K[i][1] * K[1][k] +
                       K[i][2] * K[2][k];
      Rj[i][k] = s * K[i][k] + one_c * kk + (i == k ? 1.0f : 0.0f);
    }
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int k = 0; k < 3; ++k)
      R[b][i][k] = frame0[i][0] * Rj[0][k] + frame0[i][1] * Rj[1][k] +
                   frame0[i][2] * Rj[2][k];
}

// Sphere c relative to the base origin.
__device__ __forceinline__ void sphere_rel(int c, const float R[NB][3][3],
                                           const float pos[NB][3],
                                           float p[3]) {
  const int b = pf_coll_body(c);
#pragma unroll
  for (int i = 0; i < 3; ++i)
    p[i] = pos[b][i] + (R[b][i][0] * pf_coll_offset(c, 0) +
                        R[b][i][1] * pf_coll_offset(c, 1) +
                        R[b][i][2] * pf_coll_offset(c, 2));
}

// ---------------------------------------------------------------------
// The substep of a group of lanes, on a slab of shared memory.

constexpr int LANES = 4;                    // lanes per env
constexpr int ENVS_PER_BLOCK = 32 / LANES;  // a block is one warp
constexpr int ISZ = 13;              // spatial inertia: m, h[3], I[3][3]
constexpr int AST = NV + 1;          // row stride of A
// per-sphere record: p, n, f_spring, d_n, c_t, active, the Jacobian's joint
// columns, D J's base and joint columns
constexpr int SP_P = 0, SP_N = 3, SP_FS = 6, SP_DN = 9, SP_CT = 10;
constexpr int SP_ACT = 11, SP_JC = 12, SP_DJB = SP_JC + 3 * PF_MAXD;
constexpr int SP_DJC = SP_DJB + 18, SPSZ = SP_DJC + 3 * PF_MAXD;

constexpr int cmax(int a, int b) { return a > b ? a : b; }

// Slab layout, in floats.  IN is the substep's input rows (state, tau,
// base force, per-env parameters: the layout of substep_kernel's input),
// then the surface rows.  OUT is the new state, the contact forces and,
// for the rollout, the sphere positions of the new state.  The sphere
// records lie over the body inertias and the RNEA scratch, which are dead
// by then.
namespace slab {
constexpr int I_POS = 0, I_QUAT = 3, I_LIN = 7, I_ANG = 10, I_QPOS = 13;
constexpr int I_QVEL = I_QPOS + NJ, I_TAU = I_QVEL + NJ, I_EXT = I_TAU + NJ;
constexpr int I_FRIC = I_EXT + 3, I_JFRIC = I_FRIC + NC;
constexpr int I_AMASS = I_JFRIC + NJ, I_COM = I_AMASS + 1;
constexpr int I_KC = I_COM + 3, I_DC = I_KC + 1, I_SURF = I_DC + 1;
constexpr int IN_END = I_SURF + 4 * NC;
constexpr int OUT = IN_END;
constexpr int O_FORCE = 13 + 2 * NJ, O_XYZ = O_FORCE + 3 * NC;
constexpr int R = OUT + O_XYZ + 3 * NC;
constexpr int POS = R + 9 * NB;
constexpr int S = POS + 3 * NB;
constexpr int V = S + 6 * NJ;
constexpr int ISP = V + 6 * NB;
constexpr int ACC = ISP + ISZ * NB;
constexpr int FSUB = ACC + 6 * NB;
constexpr int SPH = ISP;
constexpr int A = ISP + cmax(ISZ * NB + 12 * NB, SPSZ * NC);
constexpr int C = A + NV * AST;
constexpr int RHS = C + NV;
constexpr int TAUG = RHS + NV;
constexpr int JTF = TAUG + NV;
constexpr int U = JTF + NV;
constexpr int DIAG = U + NV;
constexpr int UN = DIAG + NV;
constexpr int END = UN + NV;
// the least stride >= END that is LANES mod 32
constexpr int STRIDE = (END + 31 - LANES) / 32 * 32 + LANES;
}  // namespace slab

// I6 [w; v] = [I w + h x v; m v - h x w] for an inertia record
__device__ __forceinline__ void inertia_mul(const float* s, const float x[6],
                                            float out[6]) {
  const float h[3] = {s[1], s[2], s[3]};
  float hw[3];
  cross3(h, x, hw);
  // rows 0-2 add the (h x) v terms one at a time, column by column, as
  // the plain version's 6 x 6 product does
  const float* v = x + 3;
  float t[3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    t[i] = s[4 + 3 * i] * x[0] + s[5 + 3 * i] * x[1] + s[6 + 3 * i] * x[2];
  out[0] = (t[0] - h[2] * v[1]) + h[1] * v[2];
  out[1] = (t[1] + h[2] * v[0]) - h[0] * v[2];
  out[2] = (t[2] - h[1] * v[0]) + h[0] * v[1];
#pragma unroll
  for (int i = 0; i < 3; ++i) out[3 + i] = s[0] * x[3 + i] - hw[i];
}

// [w; v] x [w2; v2] = [w x w2; w x v2 + v x w2]
__device__ __forceinline__ void motion_cross(const float a[6],
                                             const float m[6], float out[6]) {
  float t1[3], t2[3];
  cross3(a, m, out);
  cross3(a, m + 3, t1);
  cross3(a + 3, m, t2);
#pragma unroll
  for (int i = 0; i < 3; ++i) out[3 + i] = t1[i] + t2[i];
}

// [w; v] x* [n; f] = [w x n + v x f; w x f]
__device__ __forceinline__ void force_cross(const float a[6],
                                            const float f[6], float out[6]) {
  float t1[3], t2[3];
  cross3(a, f, t1);
  cross3(a + 3, f + 3, t2);
  cross3(a, f + 3, out + 3);
#pragma unroll
  for (int i = 0; i < 3; ++i) out[i] = t1[i] + t2[i];
}

__device__ __forceinline__ float dot6(const float a[6], const float b[6]) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2] + a[3] * b[3] +
         a[4] * b[4] + a[5] * b[5];
}

__device__ __forceinline__ void load6(const float* src, float out[6]) {
#pragma unroll
  for (int r = 0; r < 6; ++r) out[r] = src[r];
}

// Entry (r, k) of the point Jacobian's base columns [-(p x) | E].
__device__ __forceinline__ float jac_base(const float* p, int r, int k) {
  if (k >= 3) return k - 3 == r ? 1.0f : 0.0f;
  if (k == r) return 0.0f;
  const float v = p[3 - r - k];
  return (k - r + 3) % 3 == 1 ? v : -v;
}

// Body b's frame from its parent's: position, rotation and, when S is
// given, the motion subspace S_j = [axis; anchor x axis] of its joint.
__device__ __forceinline__ void fk_body(int b, const float* qpos, float* Rm,
                                        float* pos, float* S) {
  const int j = b - 1;
  const int p = pfr_parent[b];
  const float* Rp = Rm + 9 * p;
  float frame0[3][3], pb[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    pb[i] = pos[3 * p + i] + (Rp[3 * i] * pfr_joint_pos[j][0] +
                              Rp[3 * i + 1] * pfr_joint_pos[j][1] +
                              Rp[3 * i + 2] * pfr_joint_pos[j][2]);
    pos[3 * b + i] = pb[i];
#pragma unroll
    for (int k = 0; k < 3; ++k)
      frame0[i][k] = Rp[3 * i] * pfr_joint_rot[j][k] +
                     Rp[3 * i + 1] * pfr_joint_rot[j][3 + k] +
                     Rp[3 * i + 2] * pfr_joint_rot[j][6 + k];
  }
  const float ax = pfr_joint_axis[j][0], ay = pfr_joint_axis[j][1],
              az = pfr_joint_axis[j][2];
  if (S != nullptr) {
    float aw[3], lin[3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
      aw[i] = frame0[i][0] * ax + frame0[i][1] * ay + frame0[i][2] * az;
    cross3(pb, aw, lin);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      S[6 * j + i] = aw[i];
      S[6 * j + 3 + i] = lin[i];
    }
  }
  // Rodrigues about the constant joint axis: I + sin q K + (1 - cos q) K^2
  const float K[3][3] = {{0.0f, -az, ay}, {az, 0.0f, -ax}, {-ay, ax, 0.0f}};
  float s, c;
  sincosf(qpos[j], &s, &c);
  const float one_c = 1.0f - c;
  float Rj[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float kk = K[i][0] * K[0][k] + K[i][1] * K[1][k] +
                       K[i][2] * K[2][k];
      Rj[i][k] = s * K[i][k] + one_c * kk + (i == k ? 1.0f : 0.0f);
    }
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int k = 0; k < 3; ++k)
      Rm[9 * b + 3 * i + k] = frame0[i][0] * Rj[0][k] +
                              frame0[i][1] * Rj[1][k] +
                              frame0[i][2] * Rj[2][k];
}

// Spatial inertia record of body b about the base origin:
// I = R Ibar R' + m (c x)(c x)', h = m c, with c the body's CoM.
__device__ __forceinline__ void body_inertia(int b, const float* Rm,
                                             const float* pos, float m,
                                             const float cb[3], float* out) {
  const float* Rb = Rm + 9 * b;
  float cw[3], RI[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    cw[i] = pos[3 * b + i] + (Rb[3 * i] * cb[0] + Rb[3 * i + 1] * cb[1] +
                              Rb[3 * i + 2] * cb[2]);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int k = 0; k < 3; ++k)
      RI[i][k] = Rb[3 * i] * pfr_inertia[b][k] +
                 Rb[3 * i + 1] * pfr_inertia[b][3 + k] +
                 Rb[3 * i + 2] * pfr_inertia[b][6 + k];
  out[0] = m;
  // (c x)(c x)': the diagonal sums the two other squares in the order of
  // the plain version's product, the rest is -c_i c_k
  const float d[3] = {cw[2] * cw[2] + cw[1] * cw[1],
                      cw[2] * cw[2] + cw[0] * cw[0],
                      cw[1] * cw[1] + cw[0] * cw[0]};
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    out[1 + i] = m * cw[i];
#pragma unroll
    for (int k = 0; k < 3; ++k)
      out[4 + 3 * i + k] =
          (RI[i][0] * Rb[3 * k] + RI[i][1] * Rb[3 * k + 1] +
           RI[i][2] * Rb[3 * k + 2]) +
          m * (i == k ? d[i] : -(cw[i] * cw[k]));
  }
}

// RNEA force of body b at zero joint acceleration: I a + v x* (I v).
__device__ __forceinline__ void body_force(const float* isp, const float a[6],
                                           const float v[6], float* out) {
  float Ia[6], Iv[6], fc[6];
  inertia_mul(isp, a, Ia);
  inertia_mul(isp, v, Iv);
  force_cross(v, Iv, fc);
#pragma unroll
  for (int r = 0; r < 6; ++r) out[r] = Ia[r] + fc[r];
}

// Sphere c relative to the base origin, from frames in the slab.
__device__ __forceinline__ void sphere_rel_rt(int c, const float* Rm,
                                              const float* pos, float p[3]) {
  const int b = pfr_coll_body[c];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    p[i] = pos[3 * b + i] + (Rm[9 * b + 3 * i] * pfr_coll_offset[c][0] +
                             Rm[9 * b + 3 * i + 1] * pfr_coll_offset[c][1] +
                             Rm[9 * b + 3 * i + 2] * pfr_coll_offset[c][2]);
}

// The lane that works on the base while the others walk their branches.
constexpr int BASE_LANE = PF_NBR < LANES ? PF_NBR : 0;

// World xyz of every sphere of the pose (base_pos, quat, qpos), all in the
// slab, into out[3 c + i]; the frames go to the slab's R and POS.
__device__ __forceinline__ void sphere_world_group(float* sl, int lane,
                                                   const float* base_pos,
                                                   const float* quat,
                                                   const float* qpos,
                                                   float* out) {
  float* Rm = sl + slab::R;
  float* pos = sl + slab::POS;
  if (lane == BASE_LANE) {
    float R0[3][3];
    quat_to_mat(quat, R0);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      pos[i] = 0.0f;
#pragma unroll
      for (int k = 0; k < 3; ++k) Rm[3 * i + k] = R0[i][k];
    }
  }
  __syncwarp();
  for (int br = lane; br < PF_NBR; br += LANES)
    for (int k = 0; k < pfr_br_len[br]; ++k)
      fk_body(pfr_br_body[br][k], qpos, Rm, pos, nullptr);
  __syncwarp();
  for (int c = lane; c < NC; c += LANES) {
    float p[3];
    sphere_rel_rt(c, Rm, pos, p);
#pragma unroll
    for (int i = 0; i < 3; ++i) out[3 * c + i] = base_pos[i] + p[i];
  }
}

// The substep of physics/rowdyn.substep_rows for the env whose inputs lie
// in the slab `sl` (slab::I_*; the surface rows hold nc heights, then the
// normal xyz of each sphere), by the LANES lanes of its group: forward
// kinematics, CRBA mass matrix, RNEA bias forces, compliant contact, the
// implicit velocity solve
//     (M + dt J'DJ + dt diag(b) + 1e-6 I) u+ = M u + dt (tau + J'f0 - C)
// by an NV x NV Cholesky, contact sensors and integration.  The new state
// and the contact forces go to slab::OUT.  Every lane of the warp must
// call it; on return the outputs are visible to the whole warp.
__device__ __forceinline__ void substep_group(float* sl, int lane, float dt,
                                              float gravity) {
  using namespace slab;
  const float* in = sl;
  float* Rm = sl + R;
  float* pos = sl + POS;
  float* Sm = sl + S;
  float* Vm = sl + V;
  float* Isp = sl + ISP;
  float* acc = sl + ACC;
  float* fsub = sl + FSUB;
  float* Am = sl + A;
  float* out = sl + OUT;

  // ---- 0: the base body's frame, velocity, inertia and RNEA force; the
  // others clear A and J'f0 and set u and the applied generalized force
  if (lane == BASE_LANE) {
    float R0[3][3];
    quat_to_mat(in + I_QUAT, R0);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      pos[i] = 0.0f;
#pragma unroll
      for (int k = 0; k < 3; ++k) Rm[3 * i + k] = R0[i][k];
    }
    float v0[6], a0[6], cb[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      v0[i] = in[I_ANG + i];
      v0[3 + i] = in[I_LIN + i];
      cb[i] = pfr_com[0][i] + in[I_COM + i];
    }
#pragma unroll
    for (int r = 0; r < 6; ++r) {
      Vm[r] = v0[r];
      a0[r] = r == 5 ? gravity : 0.0f;
      acc[r] = a0[r];
    }
    body_inertia(0, Rm, pos, pfr_mass[0] + in[I_AMASS], cb, Isp);
    body_force(Isp, a0, v0, fsub);
  }
  for (int i = lane; i < NV * AST; i += LANES) Am[i] = 0.0f;
  for (int i = lane; i < NV; i += LANES) {
    sl[JTF + i] = 0.0f;
    if (i < 6) {
      sl[U + i] = i < 3 ? in[I_ANG + i] : in[I_LIN + i - 3];
      sl[TAUG + i] = i < 3 ? 0.0f : in[I_EXT + i - 3];
    } else {
      // torque, joint friction, soft joint-limit springs
      const int j = i - 6;
      const float k_lim = 200.0f;
      const float qv = in[I_QVEL + j], qp = in[I_QPOS + j];
      const float t = in[I_TAU + j] - in[I_JFRIC + j] * tanhf(qv * (1.0f / 0.05f));
      const float over = maxp(qp - pfr_q_upper[j], 0.0f);
      const float under = maxp(pfr_q_lower[j] - qp, 0.0f);
      sl[U + i] = qv;
      sl[TAUG + i] = t + (-k_lim * over + k_lim * under);
    }
  }
  __syncwarp();

  // ---- 1: down each branch: frames, motion subspaces, velocities,
  // RNEA accelerations and forces, spatial inertias
  for (int br = lane; br < PF_NBR; br += LANES) {
    const int len = pfr_br_len[br];
    for (int k = 0; k < len; ++k) {
      const int b = pfr_br_body[br][k];
      const int j = b - 1, p = pfr_parent[b];
      fk_body(b, in + I_QPOS, Rm, pos, Sm);
      const float qv = in[I_QVEL + j];
      float Sj[6], Vb[6], vj[6], mc[6], ab[6];
      load6(Sm + 6 * j, Sj);
#pragma unroll
      for (int r = 0; r < 6; ++r) {
        Vb[r] = Vm[6 * p + r] + qv * Sj[r];
        Vm[6 * b + r] = Vb[r];
        vj[r] = qv * Sj[r];
      }
      motion_cross(Vb, vj, mc);
#pragma unroll
      for (int r = 0; r < 6; ++r) {
        ab[r] = acc[6 * p + r] + mc[r];
        acc[6 * b + r] = ab[r];
      }
      // + 0: where the base adds its CoM offset (keeps the sign of zero)
      const float cb[3] = {pfr_com[b][0] + 0.0f, pfr_com[b][1] + 0.0f,
                           pfr_com[b][2] + 0.0f};
      body_inertia(b, Rm, pos, pfr_mass[b], cb, Isp + ISZ * b);
      body_force(Isp + ISZ * b, ab, Vb, fsub + 6 * b);
    }
    // ---- 2: up the branch: bias forces, mass-matrix entries from the
    // composite inertias (CRBA), folding each body into its parent; the
    // branch roots wait for the base lane
    for (int k = len - 1; k >= 0; --k) {
      const int b = pfr_br_body[br][k];
      const int j = b - 1, p = pfr_parent[b];
      float Sj[6], fb[6], Fv[6];
      load6(Sm + 6 * j, Sj);
      load6(fsub + 6 * b, fb);
      sl[C + 6 + j] = dot6(Sj, fb);
      // the subtree's mass as the plain version folds the constant masses,
      // in float64 rounded once (a float32 running sum can differ by an ulp)
      Isp[ISZ * b] = pfr_cmass[b];
      inertia_mul(Isp + ISZ * b, Sj, Fv);
      Am[(6 + j) * AST + 6 + j] = dot6(Sj, Fv);
      for (int i = p; i > 0; i = pfr_parent[i]) {
        float Si[6];
        load6(Sm + 6 * (i - 1), Si);
        const float v = dot6(Si, Fv);
        Am[(6 + j) * AST + 5 + i] = v;
        Am[(5 + i) * AST + 6 + j] = v;
      }
#pragma unroll
      for (int r = 0; r < 6; ++r) {
        Am[r * AST + 6 + j] = Fv[r];
        Am[(6 + j) * AST + r] = Fv[r];
      }
      if (p > 0) {
#pragma unroll
        for (int r = 0; r < 6; ++r) fsub[6 * p + r] += fb[r];
#pragma unroll
        for (int r = 0; r < ISZ; ++r) Isp[ISZ * p + r] += Isp[ISZ * b + r];
      }
    }
  }
  __syncwarp();

  // ---- 3: the base takes the branch roots, last body first, and gives
  // A's base block [[I, h x], [(h x)', m E]] and C's base rows
  if (lane == BASE_LANE) {
    for (int br = PF_NBR - 1; br >= 0; --br) {
      const int b = pfr_br_body[br][0];
#pragma unroll
      for (int r = 0; r < 6; ++r) fsub[r] += fsub[6 * b + r];
#pragma unroll
      for (int r = 0; r < ISZ; ++r) Isp[r] += Isp[ISZ * b + r];
    }
    const float h[3] = {Isp[1], Isp[2], Isp[3]};
    const float hx[3][3] = {{0.0f, -h[2], h[1]}, {h[2], 0.0f, -h[0]},
                            {-h[1], h[0], 0.0f}};
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        Am[i * AST + k] = Isp[4 + 3 * i + k];
        Am[(3 + i) * AST + 3 + k] = i == k ? Isp[0] : 0.0f;
        Am[i * AST + 3 + k] = hx[i][k];
        Am[(3 + k) * AST + i] = hx[i][k];
      }
#pragma unroll
    for (int r = 0; r < 6; ++r) sl[C + r] = fsub[r];
  }
  __syncwarp();

  // ---- 4: rhs = M u by rows (A is still M), and contact by sphere:
  // springs explicit, damping and friction implicit
  for (int i = lane; i < NV; i += LANES) {
    float s = 0.0f;
#pragma unroll
    for (int k = 0; k < NV; ++k) s += Am[i * AST + k] * sl[U + k];
    sl[RHS + i] = s;
  }
  // the sphere records overwrite the inertias and the RNEA scratch
  __syncwarp();
  for (int c = lane; c < NC; c += LANES) {
    float* sp = sl + SPH + SPSZ * c;
    const int b = pfr_coll_body[c];
    const int nd = pfr_anc_count[c];
    float p[3], n[3], Vb[6];
    sphere_rel_rt(c, Rm, pos, p);
    load6(Vm + 6 * b, Vb);
    const float h = in[I_SURF + c];
#pragma unroll
    for (int i = 0; i < 3; ++i) n[i] = in[I_SURF + NC + 3 * c + i];
    const float gap =
        (((in[I_POS + 2] + p[2]) - pfr_coll_radius[c]) - h) * n[2];
    // penetration cap: a deep one-substep tunnel gets a bounded kick
    const float pen = minp(maxp(-gap, 0.0f), 0.2f);
    const bool active = pen > 0.0f;

    // point Jacobian J = [-(p x) | E | joint columns of the ancestors]:
    // column of joint j is S_lin + S_ang x p
    float Jb[3][6];
    Jb[0][0] = 0.0f;  Jb[0][1] = p[2];   Jb[0][2] = -p[1];
    Jb[1][0] = -p[2]; Jb[1][1] = 0.0f;   Jb[1][2] = p[0];
    Jb[2][0] = p[1];  Jb[2][1] = -p[0];  Jb[2][2] = 0.0f;
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int k = 0; k < 3; ++k) Jb[r][3 + k] = r == k ? 1.0f : 0.0f;

    float v_p[3], wxp[3];
    cross3(Vb, p, wxp);
#pragma unroll
    for (int r = 0; r < 3; ++r) v_p[r] = Vb[3 + r] + wxp[r];
    const float v_n = dot3(n, v_p);
    float v_t[3];
#pragma unroll
    for (int r = 0; r < 3; ++r) v_t[r] = v_p[r] - v_n * n[r];
    const float vt_norm = sqrtf(maxp(dot3(v_t, v_t), 1e-12f));

    // depenetration-velocity cap: only the spring of penetration beyond the
    // static-rest band fades as the point exits; the band keeps its load
    const float s_dep = clipp(1.0f - v_n * (1.0f / PF_MAX_DEPENETRATION_VEL), 0.0f,
                              1.0f);
    const float s_band =
        clipp(1.0f - 2.0f * (v_n * (1.0f / PF_MAX_DEPENETRATION_VEL) - 1.0f), 0.0f,
              1.0f);
    const float k_c = in[I_KC], d_c = in[I_DC];
    const float pen_load = minp(pen, PF_PEN_REST);
    const float f_n_spring =
        k_c * (pen_load * s_band + (pen - pen_load) * s_dep);
    const float fs_n = active ? f_n_spring : 0.0f;
    const float d_cap = f_n_spring / maxp(v_n, 0.05f);
    const float d_n = active ? minp(d_c, d_cap) : 0.0f;
    const float f_n_hat = maxp(f_n_spring - d_n * maxp(v_n, 0.0f), 0.0f);
    const float c_t =
        active ? minp(in[I_FRIC + c] * f_n_hat / maxp(vt_norm, 1e-3f), 2e3f)
               : 0.0f;
    float D[3][3];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      sp[SP_P + r] = p[r];
      sp[SP_N + r] = n[r];
      sp[SP_FS + r] = fs_n * n[r];
#pragma unroll
      for (int s = 0; s < 3; ++s) {
        const float nn = n[r] * n[s];
        D[r][s] = d_n * nn + c_t * ((r == s ? 1.0f : 0.0f) - nn);
      }
    }
    sp[SP_DN] = d_n;
    sp[SP_CT] = c_t;
    sp[SP_ACT] = active ? 1.0f : 0.0f;
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int k = 0; k < 6; ++k)
        sp[SP_DJB + 6 * r + k] =
            D[r][0] * Jb[0][k] + D[r][1] * Jb[1][k] + D[r][2] * Jb[2][k];
    for (int d = 0; d < nd; ++d) {
      float Sj[6], col[3];
      load6(Sm + 6 * pfr_anc_joint[c][d], Sj);
      cross3(Sj, p, col);
#pragma unroll
      for (int r = 0; r < 3; ++r) col[r] += Sj[3 + r];
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        sp[SP_JC + PF_MAXD * r + d] = col[r];
        sp[SP_DJC + PF_MAXD * r + d] =
            D[r][0] * col[0] + D[r][1] * col[1] + D[r][2] * col[2];
      }
    }
  }
  __syncwarp();

  // ---- 5: A += dt J'DJ (lower triangle) and J'f0, each entry summed over
  // the spheres in ascending order by its owner.  Base block and base rows
  // of J'f0: entry by entry over the lanes, every sphere reaches them.
  for (int item = lane; item < 27; item += LANES) {
    if (item < 21) {
      // lower-triangle entry (row cj, column ci) of the 6 x 6 block
      int cj = 0;
      while ((cj + 1) * (cj + 2) / 2 <= item) ++cj;
      const int ci = item - cj * (cj + 1) / 2;
      // from the upper entry: the inertia block is symmetric only to
      // roundoff, and the serial program summed above the diagonal
      float a = Am[ci * AST + cj];
      for (int c = 0; c < NC; ++c) {
        const float* sp = sl + SPH + SPSZ * c;
        const float val = jac_base(sp + SP_P, 0, ci) * sp[SP_DJB + cj] +
                          jac_base(sp + SP_P, 1, ci) * sp[SP_DJB + 6 + cj] +
                          jac_base(sp + SP_P, 2, ci) * sp[SP_DJB + 12 + cj];
        a += dt * val;
      }
      Am[cj * AST + ci] = a;
    } else {
      const int ci = item - 21;
      float f = 0.0f;
      for (int c = 0; c < NC; ++c) {
        const float* sp = sl + SPH + SPSZ * c;
        // term by term, as the plain version adds them
        f += jac_base(sp + SP_P, 0, ci) * sp[SP_FS];
        f += jac_base(sp + SP_P, 1, ci) * sp[SP_FS + 1];
        f += jac_base(sp + SP_P, 2, ci) * sp[SP_FS + 2];
      }
      sl[JTF + ci] = f;
    }
  }
  // Joint rows: a branch's joints are reached by its own spheres only.
  for (int br = lane; br < PF_NBR; br += LANES) {
    for (int k = 0; k < pfr_br_nsph[br]; ++k) {
      const int c = pfr_br_sphere[br][k];
      const float* sp = sl + SPH + SPSZ * c;
      const int nd = pfr_anc_count[c];
      const float* p = sp + SP_P;
      const float Jb[3][3] = {{0.0f, p[2], -p[1]}, {-p[2], 0.0f, p[0]},
                              {p[1], -p[0], 0.0f}};
      for (int d = 0; d < nd; ++d) {
        const int cj = 6 + pfr_anc_joint[c][d];
        const float dj[3] = {sp[SP_DJC + d], sp[SP_DJC + PF_MAXD + d],
                             sp[SP_DJC + 2 * PF_MAXD + d]};
        const float jc[3] = {sp[SP_JC + d], sp[SP_JC + PF_MAXD + d],
                             sp[SP_JC + 2 * PF_MAXD + d]};
        sl[JTF + cj] += jc[0] * sp[SP_FS];
        sl[JTF + cj] += jc[1] * sp[SP_FS + 1];
        sl[JTF + cj] += jc[2] * sp[SP_FS + 2];
#pragma unroll
        for (int ci = 0; ci < 3; ++ci) {
          Am[cj * AST + ci] += dt * (Jb[0][ci] * dj[0] + Jb[1][ci] * dj[1] +
                                     Jb[2][ci] * dj[2]);
          Am[cj * AST + 3 + ci] +=
              dt * ((ci == 0 ? 1.0f : 0.0f) * dj[0] +
                    (ci == 1 ? 1.0f : 0.0f) * dj[1] +
                    (ci == 2 ? 1.0f : 0.0f) * dj[2]);
        }
        for (int d2 = 0; d2 <= d; ++d2) {
          const int ci = 6 + pfr_anc_joint[c][d2];
          Am[cj * AST + ci] += dt * (sp[SP_JC + d2] * dj[0] +
                                     sp[SP_JC + PF_MAXD + d2] * dj[1] +
                                     sp[SP_JC + 2 * PF_MAXD + d2] * dj[2]);
        }
      }
    }
  }
  __syncwarp();
  for (int i = lane; i < NV; i += LANES) {
    float a = Am[i * AST + i];
    if (i >= 6) a += dt * pfr_joint_damping[i - 6];
    a += 1e-6f;
    Am[i * AST + i] = a;
    sl[RHS + i] += dt * (sl[TAUG + i] + sl[JTF + i] - sl[C + i]);
  }
  __syncwarp();

  // ---- 6: Cholesky on A's lower triangle, a column a pass: every lane
  // forms the diagonal (same operations, same bits), the entries below it
  // go over the lanes.  The diagonal of the factor goes to DIAG.
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    float rowj[NV];
    float s = Am[j * AST + j];
#pragma unroll
    for (int k = 0; k < j; ++k) {
      rowj[k] = Am[j * AST + k];
      s -= rowj[k] * rowj[k];
    }
    const float dg = sqrtf(maxp(s, 1e-12f));
    const float inv_d = 1.0f / dg;
    if (lane == 0) sl[DIAG + j] = dg;
#pragma unroll
    for (int r = 0; r < (NV - j - 1 + LANES - 1) / LANES; ++r) {
      const int i = j + 1 + lane + LANES * r;
      if (i < NV) {
        float t = Am[i * AST + j];
#pragma unroll
        for (int k = 0; k < j; ++k) t -= Am[i * AST + k] * rowj[k];
        Am[i * AST + j] = t * inv_d;
      }
    }
    __syncwarp();
  }
  // Forward substitution by columns: a lane keeps the running sums of its
  // rows (i = lane, lane + LANES, ...) in registers; once y[k] is out, every
  // lane takes A[i][k] y[k] off its rows below k, so each row still
  // subtracts in ascending k.  y goes to U.
  {
    constexpr int ROWS = (NV + LANES - 1) / LANES;
    float acc[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int i = lane + LANES * r;
      acc[r] = i < NV ? sl[RHS + i] : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      if (lane == k % LANES) sl[U + k] = acc[k / LANES] / sl[DIAG + k];
      __syncwarp();
      const float yk = sl[U + k];
#pragma unroll
      for (int r = k / LANES; r < ROWS; ++r) {
        const int i = lane + LANES * r;
        if (i > k && i < NV) acc[r] -= Am[i * AST + k] * yk;
      }
    }
  }
  // Back substitution: row i subtracts A[k][i] un[k] for k = i + 1 .. in
  // ascending order, and its first term is the row just solved: a chain,
  // left with one lane.
  if (lane == 0) {
    float un[NV];
#pragma unroll
    for (int i = NV - 1; i >= 0; --i) {
      float s = sl[U + i];
#pragma unroll
      for (int k = i + 1; k < NV; ++k) s -= Am[k * AST + i] * un[k];
      un[i] = s / sl[DIAG + i];
      sl[UN + i] = un[i];
    }
  }
  __syncwarp();
  const float* un = sl + UN;

  // ---- 7: contact sensors at the post-solve velocity, by sphere
  for (int c = lane; c < NC; c += LANES) {
    const float* sp = sl + SPH + SPSZ * c;
    const int nd = pfr_anc_count[c];
    const float* n = sp + SP_N;
    float v_new[3], wxp[3];
    cross3(un, sp + SP_P, wxp);
#pragma unroll
    for (int r = 0; r < 3; ++r) v_new[r] = un[3 + r] + wxp[r];
    for (int d = 0; d < nd; ++d) {
      const float uj = un[6 + pfr_anc_joint[c][d]];
#pragma unroll
      for (int r = 0; r < 3; ++r) v_new[r] += sp[SP_JC + PF_MAXD * r + d] * uj;
    }
    // D v with D = d_n n n' + c_t (E - n n') formed as phase 4 formed it
    float f[3];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      float Dv = 0.0f;
#pragma unroll
      for (int s = 0; s < 3; ++s) {
        const float nn = n[r] * n[s];
        const float D = sp[SP_DN] * nn +
                        sp[SP_CT] * ((r == s ? 1.0f : 0.0f) - nn);
        Dv = s == 0 ? D * v_new[0] : Dv + D * v_new[s];
      }
      f[r] = sp[SP_FS + r] - Dv;
    }
    const float f_n = dot3(f, n);
    const float f_n_pos = maxp(f_n, 0.0f);
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const float fc = f_n_pos * n[r] + (f[r] - f_n * n[r]);
      out[O_FORCE + 3 * c + r] = sp[SP_ACT] != 0.0f ? fc : 0.0f;
    }
  }

  // ---- 8: integrate: joints over the lanes; the base with its
  // spatial -> material transport term and Isaac Gym clamps by one lane
  for (int j = lane; j < NJ; j += LANES) {
    const float vl = pfr_velocity_limit[j];
    const float qv = clipp(un[6 + j], -vl, vl);
    out[I_QVEL + j] = qv;
    out[I_QPOS + j] = clipp(in[I_QPOS + j] + dt * qv, pfr_q_lower_stop[j],
                            pfr_q_upper_stop[j]);
  }
  if (lane == BASE_LANE) {
    float am[3], lm[3], t[3], ang[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      am[i] = 0.5f * (in[I_ANG + i] + un[i]);
      lm[i] = 0.5f * (in[I_LIN + i] + un[3 + i]);
    }
    cross3(am, lm, t);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      ang[i] = clipp(un[i], -64.0f, 64.0f);
      const float lin = clipp(un[3 + i] + dt * t[i], -50.0f, 50.0f);
      out[I_ANG + i] = ang[i];
      out[I_LIN + i] = lin;
      out[I_POS + i] = in[I_POS + i] + dt * lin;
    }
    // q' = normalize(q + dt/2 [w, 0] (x) q)
    const float qx = in[I_QUAT], qy = in[I_QUAT + 1], qz = in[I_QUAT + 2],
                qw = in[I_QUAT + 3];
    const float qin[4] = {qx, qy, qz, qw};
    const float dq[4] = {
        ang[0] * qw + ang[1] * qz - ang[2] * qy,
        -ang[0] * qz + ang[1] * qw + ang[2] * qx,
        ang[0] * qy - ang[1] * qx + ang[2] * qw,
        -ang[0] * qx - ang[1] * qy - ang[2] * qz,
    };
    float qo[4], nn = 0.0f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qo[i] = qin[i] + (0.5f * dt) * dq[i];
      nn += qo[i] * qo[i];
    }
    const float qn = sqrtf(maxp(nn, 1e-18f));
#pragma unroll
    for (int i = 0; i < 4; ++i) out[I_QUAT + i] = qo[i] / qn;
  }
  __syncwarp();
}

}  // namespace pf
