// Per-env physics substep as straight-line device code, shared by the
// kernels of substep.cu.  The device counterpart of physics/rowdyn.py
// (substep_rows, fk_contact_pos, fk_contact_xy): the same float32
// operations in the same order, so a kernel and its plain version round
// alike.
//
// Model constants come from the generated header pf_model.h (one robot per
// build) as constexpr float functions, so unrolled loops fold them into
// immediates.  Every constant is float: a double would silently promote the
// arithmetic and change both the result and the speed.

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

// Body rotations and positions relative to the base origin; world joint
// axes when axis_w is given.
__device__ __forceinline__ void forward_kinematics(
    const float quat[4], const float qpos[NJ], float R[NB][3][3],
    float pos[NB][3], float (*axis_w)[3]) {
  quat_to_mat(quat, R[0]);
  pos[0][0] = pos[0][1] = pos[0][2] = 0.0f;
#pragma unroll
  for (int b = 1; b < NB; ++b) {
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
    if (axis_w != nullptr) {
#pragma unroll
      for (int i = 0; i < 3; ++i)
        axis_w[j][i] = frame0[i][0] * pf_joint_axis(j, 0) +
                       frame0[i][1] * pf_joint_axis(j, 1) +
                       frame0[i][2] * pf_joint_axis(j, 2);
    }
    // Rodrigues about the constant joint axis: I + sin q K + (1 - cos q) K²
    const float ax = pf_joint_axis(j, 0), ay = pf_joint_axis(j, 1),
                az = pf_joint_axis(j, 2);
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
        R[b][i][k] = frame0[i][0] * Rj[0][k] + frame0[i][1] * Rj[1][k] +
                     frame0[i][2] * Rj[2][k];
  }
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

// Spatial inertia about the base origin: [[I, h×], [(h×)ᵀ, m E]] with
// h = m·com.  Composite inertias are sums of the four parts.
struct SpatialInertia {
  float m;
  float h[3];
  float I[3][3];
};

// I6 · [w; v] = [I w + h × v; m v − h × w]
__device__ __forceinline__ void inertia_mul(const SpatialInertia& s,
                                            const float x[6], float out[6]) {
  float hv[3], hw[3];
  cross3(s.h, x + 3, hv);
  cross3(s.h, x, hw);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    out[i] = s.I[i][0] * x[0] + s.I[i][1] * x[1] + s.I[i][2] * x[2] + hv[i];
    out[3 + i] = s.m * x[3 + i] - hw[i];
  }
}

__device__ __forceinline__ void inertia_add(SpatialInertia& a,
                                            const SpatialInertia& b) {
  a.m += b.m;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    a.h[i] += b.h[i];
#pragma unroll
    for (int k = 0; k < 3; ++k) a.I[i][k] += b.I[i][k];
  }
}

// [w; v] ×  [w2; v2] = [w × w2; w × v2 + v × w2]
__device__ __forceinline__ void motion_cross(const float a[6],
                                             const float m[6], float out[6]) {
  float t1[3], t2[3];
  cross3(a, m, out);
  cross3(a, m + 3, t1);
  cross3(a + 3, m, t2);
#pragma unroll
  for (int i = 0; i < 3; ++i) out[3 + i] = t1[i] + t2[i];
}

// [w; v] ×* [n; f] = [w × n + v × f; w × f]
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

// Point-Jacobian column of joint j at p (relative to the base origin):
// S_lin + S_ang × p.
__device__ __forceinline__ void joint_point_col(const float S[6],
                                                const float p[3],
                                                float col[3]) {
  cross3(S, p, col);
#pragma unroll
  for (int r = 0; r < 3; ++r) col[r] += S[3 + r];
}

// One env's substep inputs: state, applied torque and base force, and the
// per-env parameters.
struct SubstepIn {
  float base_pos[3], quat[4], lin[3], ang[3];
  float qpos[NJ], qvel[NJ], tau[NJ], ext[3];
  float friction[NC], jfric[NJ];
  float added_mass, com_offset[3], k_c, d_c;
};

struct SubstepOut {
  float base_pos[3], quat[4], lin[3], ang[3];
  float qpos[NJ], qvel[NJ];
  float force[NC][3];
};

// The substep of physics/rowdyn.substep_rows: forward kinematics, CRBA mass
// matrix, RNEA bias forces, compliant contact on the surface rows, the
// implicit velocity solve
//     (M + dt·JᵀDJ + dt·diag(b) + 1e-6 I) u⁺ = M u + dt·(τ + Jᵀf₀ − C)
// by an unrolled NV×NV Cholesky, contact sensors and integration.  `surf`
// points at surface rows (nc heights, then the normal xyz of each sphere)
// with row stride Bs, read at column e; nullptr is flat ground at z = 0.
__device__ __forceinline__ void substep_body(const SubstepIn& in,
                                             const float* __restrict__ surf,
                                             size_t Bs, int e, float dt,
                                             float gravity, SubstepOut& out) {
  const float* w0 = in.ang;
  const float* v0 = in.lin;

  // ---- forward kinematics, relative to the base origin
  float R[NB][3][3], pos[NB][3], axis_w[NJ][3];
  forward_kinematics(in.quat, in.qpos, R, pos, axis_w);

  // ---- motion subspaces S_j = [axis; anchor × axis] and body velocities
  float S[NJ][6], V[NB][6];
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
#pragma unroll
    for (int i = 0; i < 3; ++i) S[j][i] = axis_w[j][i];
    cross3(pos[j + 1], axis_w[j], &S[j][3]);
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    V[0][i] = w0[i];
    V[0][3 + i] = v0[i];
  }
#pragma unroll
  for (int b = 1; b < NB; ++b)
#pragma unroll
    for (int r = 0; r < 6; ++r)
      V[b][r] = V[pf_parent(b)][r] + in.qvel[b - 1] * S[b - 1][r];

  // ---- spatial inertias (the base's mass includes added_mass)
  SpatialInertia Isp[NB];
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    float cb[3], cw[3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
      cb[i] = pf_com(b, i) + (b == 0 ? in.com_offset[i] : 0.0f);
#pragma unroll
    for (int i = 0; i < 3; ++i)
      cw[i] = pos[b][i] + (R[b][i][0] * cb[0] + R[b][i][1] * cb[1] +
                           R[b][i][2] * cb[2]);
    const float m = b == 0 ? pf_mass(0) + in.added_mass : pf_mass(b);
    float RI[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int k = 0; k < 3; ++k)
        RI[i][k] = R[b][i][0] * pf_inertia(b, 0, k) +
                   R[b][i][1] * pf_inertia(b, 1, k) +
                   R[b][i][2] * pf_inertia(b, 2, k);
    Isp[b].m = m;
    // inertia about the origin: R Ī Rᵀ + m (c×)(c×)ᵀ
    const float cc = dot3(cw, cw);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      Isp[b].h[i] = m * cw[i];
#pragma unroll
      for (int k = 0; k < 3; ++k)
        Isp[b].I[i][k] =
            (RI[i][0] * R[b][k][0] + RI[i][1] * R[b][k][1] +
             RI[i][2] * R[b][k][2]) +
            m * ((i == k ? cc : 0.0f) - cw[i] * cw[k]);
    }
  }

  // ---- CRBA mass matrix (A starts as M; the contact and damping terms
  // are added after M u is taken)
  float A[NV][NV];
  {
    SpatialInertia Ic[NB];
#pragma unroll
    for (int b = 0; b < NB; ++b) Ic[b] = Isp[b];
#pragma unroll
    for (int b = NB - 1; b > 0; --b) inertia_add(Ic[pf_parent(b)], Ic[b]);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        A[i][k] = Ic[0].I[i][k];
        A[3 + i][3 + k] = i == k ? Ic[0].m : 0.0f;
      }
    }
    // top-right block (h×), bottom-left its transpose
    const float* h = Ic[0].h;
    const float hx[3][3] = {{0.0f, -h[2], h[1]}, {h[2], 0.0f, -h[0]},
                            {-h[1], h[0], 0.0f}};
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        A[i][3 + k] = hx[i][k];
        A[3 + k][i] = hx[i][k];
      }
    // joints on different branches of the tree do not couple
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) A[6 + j][6 + jj] = 0.0f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int b = j + 1;
      float F[6];
      inertia_mul(Ic[b], S[j], F);
      A[6 + j][6 + j] = dot6(S[j], F);
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        if (!pf_is_ancestor(jj + 1, b)) continue;
        const float v = dot6(S[jj], F);
        A[6 + j][6 + jj] = v;
        A[6 + jj][6 + j] = v;
      }
#pragma unroll
      for (int r = 0; r < 6; ++r) {
        A[r][6 + j] = F[r];
        A[6 + j][r] = F[r];
      }
    }
  }

  // ---- RNEA bias forces (udot = 0, gravity as a pseudo-acceleration)
  float C[NV];
  {
    float f_sub[NB][6];
    float acc[NB][6];
#pragma unroll
    for (int r = 0; r < 6; ++r) acc[0][r] = r == 5 ? gravity : 0.0f;
#pragma unroll
    for (int b = 1; b < NB; ++b) {
      float vj[6], mc[6];
#pragma unroll
      for (int r = 0; r < 6; ++r) vj[r] = in.qvel[b - 1] * S[b - 1][r];
      motion_cross(V[b], vj, mc);
#pragma unroll
      for (int r = 0; r < 6; ++r) acc[b][r] = acc[pf_parent(b)][r] + mc[r];
    }
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      float Ia[6], Iv[6], fc[6];
      inertia_mul(Isp[b], acc[b], Ia);
      inertia_mul(Isp[b], V[b], Iv);
      force_cross(V[b], Iv, fc);
#pragma unroll
      for (int r = 0; r < 6; ++r) f_sub[b][r] = Ia[r] + fc[r];
    }
#pragma unroll
    for (int b = NB - 1; b > 0; --b) {
      C[6 + b - 1] = dot6(S[b - 1], f_sub[b]);
#pragma unroll
      for (int r = 0; r < 6; ++r) f_sub[pf_parent(b)][r] += f_sub[b][r];
    }
#pragma unroll
    for (int r = 0; r < 6; ++r) C[r] = f_sub[0][r];
  }

  // ---- rhs = M u (before A gains its contact terms)
  float u[NV], rhs[NV];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    u[i] = w0[i];
    u[3 + i] = v0[i];
  }
#pragma unroll
  for (int j = 0; j < NJ; ++j) u[6 + j] = in.qvel[j];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    float s = 0.0f;
#pragma unroll
    for (int k = 0; k < NV; ++k) s += A[i][k] * u[k];
    rhs[i] = s;
  }

  // ---- applied generalized force: base force, torque, joint friction,
  // soft joint-limit springs
  float tau_g[NV];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    tau_g[r] = 0.0f;
    tau_g[3 + r] = in.ext[r];
  }
  const float k_lim = 200.0f;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    float t = in.tau[j] - in.jfric[j] * tanhf(in.qvel[j] / 0.05f);
    const float over = maxp(in.qpos[j] - pf_q_upper(j), 0.0f);
    const float under = maxp(pf_q_lower(j) - in.qpos[j], 0.0f);
    tau_g[6 + j] = t + (-k_lim * over + k_lim * under);
  }

  // ---- compliant contact: springs explicit, damping and friction implicit
  float Jt_f0[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) Jt_f0[i] = 0.0f;
  float c_p[NC][3], c_n[NC][3], c_fs[NC][3], c_dn[NC], c_ct[NC];
  bool c_active[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int b = pf_coll_body(c);
    float p[3];
    sphere_rel(c, R, pos, p);
    float h = 0.0f, n[3] = {0.0f, 0.0f, 1.0f};
    if (surf != nullptr) {
      h = surf[c * Bs + e];
#pragma unroll
      for (int i = 0; i < 3; ++i) n[i] = surf[(NC + 3 * c + i) * Bs + e];
    }
    const float gap =
        (((in.base_pos[2] + p[2]) - pf_coll_radius(c)) - h) * n[2];
    // penetration cap: a deep one-substep tunnel gets a bounded kick
    const float pen = minp(maxp(-gap, 0.0f), 0.2f);
    const bool active = pen > 0.0f;

    // point Jacobian J = [-(p×) | E | joint columns of the ancestors]
    float J[3][NV];
    J[0][0] = 0.0f;  J[0][1] = p[2];   J[0][2] = -p[1];
    J[1][0] = -p[2]; J[1][1] = 0.0f;   J[1][2] = p[0];
    J[2][0] = p[1];  J[2][1] = -p[0];  J[2][2] = 0.0f;
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int k = 0; k < 3; ++k) J[r][3 + k] = r == k ? 1.0f : 0.0f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      float col[3] = {0.0f, 0.0f, 0.0f};
      if (pf_uses_joint(c, j)) joint_point_col(S[j], p, col);
#pragma unroll
      for (int r = 0; r < 3; ++r) J[r][6 + j] = col[r];
    }

    float v_p[3], wxp[3];
    cross3(V[b], p, wxp);
#pragma unroll
    for (int r = 0; r < 3; ++r) v_p[r] = V[b][3 + r] + wxp[r];
    const float v_n = dot3(n, v_p);
    float v_t[3];
#pragma unroll
    for (int r = 0; r < 3; ++r) v_t[r] = v_p[r] - v_n * n[r];
    const float vt_norm = sqrtf(maxp(dot3(v_t, v_t), 1e-12f));

    // depenetration-velocity cap: only the spring of penetration beyond the
    // static-rest band fades as the point exits; the band keeps its load
    const float s_dep = clipp(1.0f - v_n / PF_MAX_DEPENETRATION_VEL, 0.0f,
                              1.0f);
    const float s_band =
        clipp(1.0f - 2.0f * (v_n / PF_MAX_DEPENETRATION_VEL - 1.0f), 0.0f,
              1.0f);
    const float pen_load = minp(pen, PF_PEN_REST);
    const float f_n_spring =
        in.k_c * (pen_load * s_band + (pen - pen_load) * s_dep);
    const float fs_n = active ? f_n_spring : 0.0f;
    const float d_cap = f_n_spring / maxp(v_n, 0.05f);
    const float d_n = active ? minp(in.d_c, d_cap) : 0.0f;
    const float f_n_hat = maxp(f_n_spring - d_n * maxp(v_n, 0.0f), 0.0f);
    const float c_t =
        active ? minp(in.friction[c] * f_n_hat / maxp(vt_norm, 1e-3f), 2e3f)
               : 0.0f;
    float D[3][3], f_spring[3];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      f_spring[r] = fs_n * n[r];
#pragma unroll
      for (int s = 0; s < 3; ++s) {
        const float nn = n[r] * n[s];
        D[r][s] = d_n * nn + c_t * ((r == s ? 1.0f : 0.0f) - nn);
      }
    }

    // A += dt Jᵀ D J and Jᵀ f₀ over the columns this sphere reaches
    float DJ[3][NV];
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int k = 0; k < NV; ++k)
        DJ[r][k] = D[r][0] * J[0][k] + D[r][1] * J[1][k] + D[r][2] * J[2][k];
#pragma unroll
    for (int ci = 0; ci < NV; ++ci) {
      if (ci >= 6 && !pf_uses_joint(c, ci - 6)) continue;
      Jt_f0[ci] += J[0][ci] * f_spring[0] + J[1][ci] * f_spring[1] +
                   J[2][ci] * f_spring[2];
#pragma unroll
      for (int cj = ci; cj < NV; ++cj) {
        if (cj >= 6 && !pf_uses_joint(c, cj - 6)) continue;
        const float val = J[0][ci] * DJ[0][cj] + J[1][ci] * DJ[1][cj] +
                          J[2][ci] * DJ[2][cj];
        A[ci][cj] += dt * val;
        A[cj][ci] = A[ci][cj];
      }
    }

#pragma unroll
    for (int r = 0; r < 3; ++r) {
      c_p[c][r] = p[r];
      c_n[c][r] = n[r];
      c_fs[c][r] = f_spring[r];
    }
    c_dn[c] = d_n;
    c_ct[c] = c_t;
    c_active[c] = active;
  }
#pragma unroll
  for (int j = 0; j < NJ; ++j) A[6 + j][6 + j] += dt * pf_joint_damping(j);
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    A[i][i] += 1e-6f;
    rhs[i] += dt * (tau_g[i] + Jt_f0[i] - C[i]);
  }

  // ---- velocity solve: Cholesky in place on A's lower triangle, then
  // forward and back substitution
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    float s = A[j][j];
#pragma unroll
    for (int k = 0; k < j; ++k) s -= A[j][k] * A[j][k];
    const float d = sqrtf(maxp(s, 1e-12f));
    A[j][j] = d;
    const float inv_d = 1.0f / d;
#pragma unroll
    for (int i = j + 1; i < NV; ++i) {
      float t = A[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) t -= A[i][k] * A[j][k];
      A[i][j] = t * inv_d;
    }
  }
  float y[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    float s = rhs[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s -= A[i][k] * y[k];
    y[i] = s / A[i][i];
  }
  float un[NV];
#pragma unroll
  for (int i = NV - 1; i >= 0; --i) {
    float s = y[i];
#pragma unroll
    for (int k = i + 1; k < NV; ++k) s -= A[k][i] * un[k];
    un[i] = s / A[i][i];
  }

  // ---- contact sensors at the post-solve velocity
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    float v_new[3], wxp[3];
    cross3(un, c_p[c], wxp);
#pragma unroll
    for (int r = 0; r < 3; ++r) v_new[r] = un[3 + r] + wxp[r];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      if (!pf_uses_joint(c, j)) continue;
      float col[3];
      joint_point_col(S[j], c_p[c], col);
#pragma unroll
      for (int r = 0; r < 3; ++r) v_new[r] += col[r] * un[6 + j];
    }
    const float* n = c_n[c];
    const float vn = dot3(n, v_new);
    float f[3];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      // D v = d_n n (n·v) + c_t (v − n (n·v))
      const float Dv = c_dn[c] * n[r] * vn + c_ct[c] * (v_new[r] - n[r] * vn);
      f[r] = c_fs[c][r] - Dv;
    }
    const float f_n = dot3(f, n);
    const float f_n_pos = maxp(f_n, 0.0f);
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const float fc = f_n_pos * n[r] + (f[r] - f_n * n[r]);
      out.force[c][r] = c_active[c] ? fc : 0.0f;
    }
  }

  // ---- integrate: spatial -> material transport term, Isaac Gym clamps
  {
    float am[3], lm[3], t[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      am[i] = 0.5f * (w0[i] + un[i]);
      lm[i] = 0.5f * (v0[i] + un[3 + i]);
    }
    cross3(am, lm, t);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      out.ang[i] = clipp(un[i], -64.0f, 64.0f);
      out.lin[i] = clipp(un[3 + i] + dt * t[i], -50.0f, 50.0f);
    }
  }
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const float vl = pf_velocity_limit(j);
    out.qvel[j] = clipp(un[6 + j], -vl, vl);
    out.qpos[j] = clipp(in.qpos[j] + dt * out.qvel[j], pf_q_lower_stop(j),
                        pf_q_upper_stop(j));
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) out.base_pos[i] = in.base_pos[i] + dt * out.lin[i];
  {
    // q' = normalize(q + dt/2 [w, 0] ⊗ q)
    const float* ang = out.ang;
    const float qx = in.quat[0], qy = in.quat[1], qz = in.quat[2],
                qw = in.quat[3];
    const float dq[4] = {
        ang[0] * qw + ang[1] * qz - ang[2] * qy,
        -ang[0] * qz + ang[1] * qw + ang[2] * qx,
        ang[0] * qy - ang[1] * qx + ang[2] * qw,
        -ang[0] * qx - ang[1] * qy - ang[2] * qz,
    };
    float nn = 0.0f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      out.quat[i] = in.quat[i] + (0.5f * dt) * dq[i];
      nn += out.quat[i] * out.quat[i];
    }
    const float qn = sqrtf(maxp(nn, 1e-18f));
#pragma unroll
    for (int i = 0; i < 4; ++i) out.quat[i] = out.quat[i] / qn;
  }
}

}  // namespace pf
