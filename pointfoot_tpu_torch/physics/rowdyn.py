"""Per-env physics substep in scalar-row form
(pointfoot_tpu/physics/rowdyn.py).

A "row" is one per-env scalar: a float32 tensor of any broadcastable shape,
usually (B,).  Static model data enters as python floats and is folded while
the rows are built: `fmul`/`fadd` drop multiplications by 0/±1, exactly as
the JAX module does at trace time, so both produce the same float32 ops in
the same order.

This module is LAYOUT-AGNOSTIC, as its JAX counterpart is: with (B,) rows it
is the plain PyTorch version of the four CUDA kernels in csrc/substep.cu
(`substep_rows` of the two substep kernels, `fk_contact_pos` and
`fk_contact_xy` of the two FK kernels), which the CPU path runs and the
card's kernels are held against.

Semantics: implicit-damping velocity solve
    (M + dt·JᵀDJ + dt·diag(b_joint) + 1e-6 I) u⁺ = M u + dt·(τ + Jᵀf₀ − C)
then integration including the spatial→material transport term.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from pointfoot_tpu_torch.physics.contact import MAX_DEPENETRATION_VEL, PEN_REST

# --------------------------------------------------------------- row algebra


def _isconst(a) -> bool:
    return isinstance(a, (int, float))


def is0(a) -> bool:
    return _isconst(a) and a == 0.0


def fmul(a, b):
    if is0(a) or is0(b):
        return 0.0
    if _isconst(a) and a == 1.0:
        return b
    if _isconst(b) and b == 1.0:
        return a
    return a * b


def fadd(*xs):
    out = None
    const = 0.0
    for x in xs:
        if is0(x):
            continue
        if _isconst(x):
            const += x
            continue
        out = x if out is None else out + x
    if out is None:
        return const
    return out if const == 0.0 else out + const


def fneg(a):
    if is0(a):
        return 0.0
    return -a


def fsub(a, b):
    return fadd(a, fneg(b))


# jnp.maximum / minimum over rows or python constants; NaN in a row
# propagates, as in JAX (the env's NaN quarantine relies on it)

def _maximum(a, b):
    if _isconst(a) and _isconst(b):
        return max(a, b)
    if _isconst(b):
        return torch.clamp_min(a, b)
    if _isconst(a):
        return torch.clamp_min(b, a)
    return torch.maximum(a, b)


def _minimum(a, b):
    if _isconst(a) and _isconst(b):
        return min(a, b)
    if _isconst(b):
        return torch.clamp_max(a, b)
    if _isconst(a):
        return torch.clamp_max(b, a)
    return torch.minimum(a, b)


def dot3(u, v):
    return fadd(fmul(u[0], v[0]), fmul(u[1], v[1]), fmul(u[2], v[2]))


def cross3(u, v):
    return [
        fsub(fmul(u[1], v[2]), fmul(u[2], v[1])),
        fsub(fmul(u[2], v[0]), fmul(u[0], v[2])),
        fsub(fmul(u[0], v[1]), fmul(u[1], v[0])),
    ]


def v_add(u, v):
    return [fadd(a, b) for a, b in zip(u, v)]


def v_sub(u, v):
    return [fsub(a, b) for a, b in zip(u, v)]


def v_scale(s, u):
    return [fmul(s, a) for a in u]


def m_vec(M, v):
    return [fadd(*[fmul(M[i][j], v[j]) for j in range(len(v))])
            for i in range(len(M))]


def m_mul(A, B):
    n, k, m = len(A), len(B), len(B[0])
    return [[fadd(*[fmul(A[i][p], B[p][j]) for p in range(k)])
             for j in range(m)] for i in range(n)]


def m_add(A, B):
    return [[fadd(a, b) for a, b in zip(ra, rb)] for ra, rb in zip(A, B)]


def m_T(A):
    return [list(r) for r in zip(*A)]


def skew3(v):
    return [[0.0, fneg(v[2]), v[1]],
            [v[2], 0.0, fneg(v[0])],
            [fneg(v[1]), v[0], 0.0]]


# 6-vectors are [angular(3); linear(3)] (Featherstone stacking)

def motion_cross6(v, m):
    w, vl = v[:3], v[3:]
    w2, v2 = m[:3], m[3:]
    return cross3(w, w2) + v_add(cross3(w, v2), cross3(vl, w2))


def force_cross6(v, f):
    w, vl = v[:3], v[3:]
    n, fl = f[:3], f[3:]
    return v_add(cross3(w, n), cross3(vl, fl)) + cross3(w, fl)


def spatial_inertia6(mass, com, inertia_w):
    """[[I + m c̃ c̃ᵀ, m c̃], [m c̃ᵀ, m E]]."""
    cx = skew3(com)
    cxT = m_T(cx)
    tl = m_add(inertia_w, [[fmul(mass, e) for e in row]
                           for row in m_mul(cx, cxT)])
    tr = [[fmul(mass, e) for e in row] for row in cx]
    bl = m_T(tr)
    I6 = [[0.0] * 6 for _ in range(6)]
    for i in range(3):
        for j in range(3):
            I6[i][j] = tl[i][j]
            I6[i][3 + j] = tr[i][j]
            I6[3 + i][j] = bl[i][j]
        I6[3 + i][3 + i] = mass
    return I6


def quat_to_mat(q):
    """xyzw quaternion -> 3x3 rotation matrix."""
    x, y, z, w = q
    xx, yy, zz = fmul(x, x), fmul(y, y), fmul(z, z)
    xy, xz, yz = fmul(x, y), fmul(x, z), fmul(y, z)
    wx, wy, wz = fmul(w, x), fmul(w, y), fmul(w, z)
    return [
        [fadd(1.0, fmul(-2.0, fadd(yy, zz))), fmul(2.0, fsub(xy, wz)),
         fmul(2.0, fadd(xz, wy))],
        [fmul(2.0, fadd(xy, wz)), fadd(1.0, fmul(-2.0, fadd(xx, zz))),
         fmul(2.0, fsub(yz, wx))],
        [fmul(2.0, fsub(xz, wy)), fmul(2.0, fadd(yz, wx)),
         fadd(1.0, fmul(-2.0, fadd(xx, yy)))],
    ]


def quat_mul(a, b):
    ax, ay, az, aw = a
    bx, by, bz, bw = b
    return [
        fadd(fmul(aw, bx), fmul(ax, bw), fmul(ay, bz), fneg(fmul(az, by))),
        fadd(fmul(aw, by), fneg(fmul(ax, bz)), fmul(ay, bw), fmul(az, bx)),
        fadd(fmul(aw, bz), fmul(ax, by), fneg(fmul(ay, bx)), fmul(az, bw)),
        fadd(fmul(aw, bw), fneg(fmul(ax, bx)), fneg(fmul(ay, by)),
             fneg(fmul(az, bz))),
    ]


def rodrigues_const_axis(axis: Sequence[float], q):
    """R = I + sin(q) K + (1-cos(q)) K² for a constant unit axis."""
    K = [[0.0, -axis[2], axis[1]],
         [axis[2], 0.0, -axis[0]],
         [-axis[1], axis[0], 0.0]]
    KK = [[sum(K[i][p] * K[p][j] for p in range(3)) for j in range(3)]
          for i in range(3)]
    s, c = torch.sin(q), torch.cos(q)
    one_c = 1.0 - c
    R = [[0.0] * 3 for _ in range(3)]
    for i in range(3):
        for j in range(3):
            R[i][j] = fadd(1.0 if i == j else 0.0,
                           fmul(s, K[i][j]), fmul(one_c, KK[i][j]))
    return R


def chol_solve_rows(A: List[List], b: List) -> List:
    """Unrolled Cholesky factor + forward and back substitution."""
    n = len(b)
    L: Dict[Tuple[int, int], object] = {}
    for j in range(n):
        s = A[j][j]
        for k in range(j):
            s = fsub(s, fmul(L[(j, k)], L[(j, k)]))
        d = torch.sqrt(_maximum(s, 1e-12))
        L[(j, j)] = d
        inv_d = 1.0 / d
        for i in range(j + 1, n):
            s = A[i][j]
            for k in range(j):
                s = fsub(s, fmul(L[(i, k)], L[(j, k)]))
            L[(i, j)] = fmul(s, inv_d)
    y = {}
    for i in range(n):
        s = b[i]
        for k in range(i):
            s = fsub(s, fmul(L[(i, k)], y[k]))
        y[i] = s / L[(i, i)]
    x = {}
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = fsub(s, fmul(L[(k, i)], x[k]))
        x[i] = s / L[(i, i)]
    return [x[i] for i in range(n)]


# ------------------------------------------------------------ model snapshot

class ModelConsts:
    """Plain-python snapshot of a RobotModel: the folded constants.

    Values are the model's float32 numbers widened to float64, as in the
    JAX module, so both fold the same constants.
    """

    def __init__(self, model):
        def lst(t):
            return np.asarray(t.detach().cpu().numpy(), np.float64).tolist()

        self.nb = int(model.nb)
        self.nj = int(model.nj)
        self.nv = int(model.nv)
        self.parent = tuple(int(p) for p in model.parent)
        self.joint_pos = lst(model.joint_pos)
        self.joint_rot_mat = []
        for x, y, z, w in lst(model.joint_rot):
            self.joint_rot_mat.append([
                [1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                 2 * (x * z + w * y)],
                [2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                 2 * (y * z - w * x)],
                [2 * (x * z - w * y), 2 * (y * z + w * x),
                 1 - 2 * (x * x + y * y)],
            ])
        self.joint_axis = lst(model.joint_axis)
        self.q_lower = lst(model.q_lower)
        self.q_upper = lst(model.q_upper)
        self.velocity_limit = lst(model.velocity_limit)
        self.effort_limit = lst(model.effort_limit)
        self.joint_damping = lst(model.joint_damping)
        self.mass = lst(model.mass)
        self.com = lst(model.com)
        self.inertia = lst(model.inertia)
        self.collision_body = tuple(int(b) for b in model.collision_body)
        self.collision_offset = lst(model.collision_offset)
        self.collision_radius = lst(model.collision_radius)
        self.nc = len(self.collision_body)
        # static ancestor-joint chain of every collision sphere
        self.ancestors = []
        for b in self.collision_body:
            chain = []
            while b > 0:
                chain.append(b - 1)
                b = self.parent[b]
            self.ancestors.append(tuple(reversed(chain)))


# ----------------------------------------------------------------- substep

def _fk(mc: ModelConsts, st: Dict):
    """Origin-relative body rotations, positions and world joint axes."""
    R = [quat_to_mat(st["base_quat"])]
    pos = [[0.0, 0.0, 0.0]]
    axis_w: List = []
    for b in range(1, mc.nb):
        j = b - 1
        p = mc.parent[b]
        anch = v_add(pos[p], m_vec(R[p], mc.joint_pos[j]))
        frame0 = m_mul(R[p], mc.joint_rot_mat[j])
        axis_w.append(m_vec(frame0, mc.joint_axis[j]))
        R.append(m_mul(frame0, rodrigues_const_axis(mc.joint_axis[j],
                                                    st["qpos"][j])))
        pos.append(anch)
    return R, pos, axis_w


def substep_rows(mc: ModelConsts, st: Dict, dt: float, gravity: float,
                 surface=None) -> Dict:
    """One physics substep on rows.  `st` keys (rows / row-lists):

    base_pos[3], base_quat[4], base_lin_vel[3], base_ang_vel[3],
    qpos[nj], qvel[nj], tau[nj], ext_force[3],
    friction[nc], joint_friction[nj], added_mass, com_offset[3],
    k_contact, d_contact.

    `surface`: per-contact (height_row, normal_row3) in world coordinates,
    or None for flat ground at z=0.  Returns the same state keys plus
    contact_force[nc][3].  Everything is computed relative to the base
    origin, so base_pos enters only the contact heights and the final
    position integration.
    """
    nb, nj, nv, nc = mc.nb, mc.nj, mc.nv, mc.nc
    w0 = st["base_ang_vel"]
    v0 = st["base_lin_vel"]
    qvel = st["qvel"]

    # ---- forward kinematics, origin-relative
    R, pos, axis_w = _fk(mc, st)
    anchor = pos[1:]
    com_w = []
    inertia_w = []
    for b in range(nb):
        cb = list(mc.com[b])
        if b == 0:
            cb = v_add(cb, st["com_offset"])
        com_w.append(v_add(pos[b], m_vec(R[b], cb)))
        inertia_w.append(m_mul(m_mul(R[b], mc.inertia[b]), m_T(R[b])))

    # ---- motion subspaces
    S = [axis_w[j] + cross3(anchor[j], axis_w[j]) for j in range(nj)]

    # ---- body spatial velocities
    V = [list(w0) + list(v0)]
    for b in range(1, nb):
        j = b - 1
        V.append(v_add(V[mc.parent[b]], v_scale(qvel[j], S[j])))

    # ---- spatial inertias (effective base mass includes added_mass)
    Isp = []
    for b in range(nb):
        mass_b = (fadd(mc.mass[0], st["added_mass"]) if b == 0
                  else mc.mass[b])
        Isp.append(spatial_inertia6(mass_b, com_w[b], inertia_w[b]))

    # ---- CRBA mass matrix
    Ic = [[row[:] for row in Isp[b]] for b in range(nb)]
    for b in range(nb - 1, 0, -1):
        Ic[mc.parent[b]] = m_add(Ic[mc.parent[b]], Ic[b])
    M = [[0.0] * nv for _ in range(nv)]
    for i in range(6):
        for j in range(6):
            M[i][j] = Ic[0][i][j]
    for j in range(nj):
        b = j + 1
        F = m_vec(Ic[b], S[j])
        M[6 + j][6 + j] = fadd(*[fmul(S[j][r], F[r]) for r in range(6)])
        i = mc.parent[b]
        while i > 0:
            jj = i - 1
            v = fadd(*[fmul(S[jj][r], F[r]) for r in range(6)])
            M[6 + j][6 + jj] = v
            M[6 + jj][6 + j] = v
            i = mc.parent[i]
        for r in range(6):
            M[r][6 + j] = F[r]
            M[6 + j][r] = F[r]

    # ---- RNEA bias forces (udot = 0, gravity pseudo-acceleration)
    a_grav = [0.0, 0.0, 0.0, 0.0, 0.0, float(gravity)]
    accs = [a_grav]
    for b in range(1, nb):
        j = b - 1
        vj = v_scale(qvel[j], S[j])
        accs.append(v_add(accs[mc.parent[b]], motion_cross6(V[b], vj)))
    f_sub = []
    for b in range(nb):
        Iv = m_vec(Isp[b], V[b])
        f_sub.append(v_add(m_vec(Isp[b], accs[b]), force_cross6(V[b], Iv)))
    C = [0.0] * nv
    for b in range(nb - 1, 0, -1):
        j = b - 1
        C[6 + j] = fadd(*[fmul(S[j][r], f_sub[b][r]) for r in range(6)])
        f_sub[mc.parent[b]] = v_add(f_sub[mc.parent[b]], f_sub[b])
    for r in range(6):
        C[r] = f_sub[0][r]

    # ---- applied generalized force
    tau_g = [0.0] * nv
    for r in range(3):
        tau_g[3 + r] = st["ext_force"][r]
    k_lim = 200.0
    for j in range(nj):
        t = st["tau"][j]
        t = fsub(t, fmul(st["joint_friction"][j],
                         torch.tanh(qvel[j] / 0.05)))
        over = _maximum(st["qpos"][j] - mc.q_upper[j], 0.0)
        under = _maximum(mc.q_lower[j] - st["qpos"][j], 0.0)
        t = fadd(t, fmul(-k_lim, over), fmul(k_lim, under))
        tau_g[6 + j] = t

    # ---- contact terms (unilateral damping cap)
    k_c = st["k_contact"]
    d_c = st["d_contact"]
    cJ, cSpring, cD, cN, cActive = [], [], [], [], []
    for c in range(nc):
        b = mc.collision_body[c]
        p_rel = v_add(pos[b], m_vec(R[b], mc.collision_offset[c]))
        r_c = mc.collision_radius[c]
        if surface is None:
            h = 0.0
            n = [0.0, 0.0, 1.0]
        else:
            h, n = surface[c]
        p_z_world = fadd(st["base_pos"][2], p_rel[2])
        gap = fmul(fsub(fsub(p_z_world, r_c), h), n[2])
        # penetration cap: a deep one-substep tunnel gets a bounded kick
        pen = _minimum(_maximum(-gap, 0.0), 0.2)
        active = pen > 0.0

        J = [[0.0] * nv for _ in range(3)]
        sk = skew3(p_rel)
        for r in range(3):
            for col in range(3):
                J[r][col] = fneg(sk[r][col])
            J[r][3 + r] = 1.0
        for j in mc.ancestors[c]:
            colv = v_add(S[j][3:], cross3(S[j][:3], p_rel))
            for r in range(3):
                J[r][6 + j] = colv[r]

        v_p = v_add(V[b][3:], cross3(V[b][:3], p_rel))
        v_n = dot3(n, v_p)
        v_t = v_sub(v_p, v_scale(v_n, n))
        vt_norm = torch.sqrt(_maximum(
            fadd(*[fmul(v_t[r], v_t[r]) for r in range(3)]), 1e-12))

        # depenetration-velocity cap: only the spring of penetration in
        # excess of the static-rest band fades as the point exits at
        # >= MAX_DEPENETRATION_VEL; the band itself always carries load
        s_dep = torch.clamp(1.0 - v_n / MAX_DEPENETRATION_VEL, 0.0, 1.0)
        s_band = torch.clamp(1.0 - 2.0 * (v_n / MAX_DEPENETRATION_VEL - 1.0),
                       0.0, 1.0)
        pen_load = _minimum(pen, PEN_REST)
        f_n_spring = fmul(k_c, fadd(fmul(pen_load, s_band),
                                    fmul(fsub(pen, pen_load), s_dep)))
        f_spring = v_scale(torch.where(active, f_n_spring, 0.0), n)
        d_cap = f_n_spring / _maximum(v_n, 0.05)
        d_n = torch.where(active, _minimum(d_c, d_cap), 0.0)
        f_n_hat = _maximum(
            fsub(f_n_spring, fmul(d_n, _maximum(v_n, 0.0))), 0.0)
        mu = st["friction"][c]
        c_t = torch.where(
            active,
            _minimum(fmul(mu, f_n_hat) / _maximum(vt_norm, 1e-3), 2e3),
            0.0)
        D = [[0.0] * 3 for _ in range(3)]
        for r in range(3):
            for s_ in range(3):
                nn = fmul(n[r], n[s_])
                D[r][s_] = fadd(fmul(d_n, nn),
                                fmul(c_t, fsub(1.0 if r == s_ else 0.0, nn)))
        cJ.append(J)
        cSpring.append(f_spring)
        cD.append(D)
        cN.append(n)
        cActive.append(active)

    # ---- assemble A, rhs
    A = [row[:] for row in M]
    for c in range(nc):
        # dt * Jᵀ D J with J sparse over columns {0..5} ∪ ancestors
        cols = list(range(6)) + [6 + j for j in mc.ancestors[c]]
        DJ = [[fadd(*[fmul(cD[c][r][s_], cJ[c][s_][col]) for s_ in range(3)])
               for col in cols] for r in range(3)]
        for a_i, col_i in enumerate(cols):
            for a_j, col_j in enumerate(cols):
                if col_j < col_i:
                    continue
                val = fadd(*[fmul(cJ[c][r][col_i], DJ[r][a_j])
                             for r in range(3)])
                if is0(val):
                    continue
                A[col_i][col_j] = fadd(A[col_i][col_j], fmul(dt, val))
                if col_j != col_i:
                    A[col_j][col_i] = A[col_i][col_j]
    for j in range(nj):
        A[6 + j][6 + j] = fadd(A[6 + j][6 + j], dt * mc.joint_damping[j])
    for i in range(nv):
        A[i][i] = fadd(A[i][i], 1e-6)

    u = list(w0) + list(v0) + list(qvel)
    rhs = m_vec(M, u)
    Jt_f0 = [0.0] * nv
    for c in range(nc):
        cols = list(range(6)) + [6 + j for j in mc.ancestors[c]]
        for col in cols:
            Jt_f0[col] = fadd(Jt_f0[col],
                              *[fmul(cJ[c][r][col], cSpring[c][r])
                                for r in range(3)])
    for i in range(nv):
        rhs[i] = fadd(rhs[i], fmul(dt, fadd(tau_g[i], Jt_f0[i],
                                            fneg(C[i]))))
    # joint limits are enforced after the solve (velocity clamp + qpos clip)
    u_new = chol_solve_rows(A, rhs)

    # ---- finish: contact sensors + integration
    contact_force = []
    for c in range(nc):
        cols = list(range(6)) + [6 + j for j in mc.ancestors[c]]
        v_p_new = [fadd(*[fmul(cJ[c][r][col], u_new[col]) for col in cols])
                   for r in range(3)]
        f = v_sub(cSpring[c],
                  [fadd(*[fmul(cD[c][r][s_], v_p_new[s_])
                          for s_ in range(3)]) for r in range(3)])
        f_n = dot3(f, cN[c])
        f_t = v_sub(f, v_scale(f_n, cN[c]))
        f_n = _maximum(f_n, 0.0)
        fc = v_add(v_scale(f_n, cN[c]), f_t)
        contact_force.append([torch.where(cActive[c], fc[r], 0.0)
                              for r in range(3)])

    ang = u_new[:3]
    lin = u_new[3:6]
    ang_m = v_scale(0.5, v_add(w0, ang))
    lin_m = v_scale(0.5, v_add(v0, lin))
    lin = v_add(lin, v_scale(dt, cross3(ang_m, lin_m)))
    # Isaac Gym velocity clamps
    ang = [torch.clamp(a, -64.0, 64.0) for a in ang]
    lin = [torch.clamp(a, -50.0, 50.0) for a in lin]
    qvel_new = []
    for j in range(nj):
        vl = mc.velocity_limit[j]
        qvel_new.append(torch.clamp(u_new[6 + j], -vl, vl))
    new_pos = v_add(st["base_pos"], v_scale(dt, lin))
    # q' = normalize(q + dt/2 [w,0] ⊗ q)
    dq = quat_mul([ang[0], ang[1], ang[2], 0.0], st["base_quat"])
    q_new = [fadd(st["base_quat"][i], fmul(0.5 * dt, dq[i]))
             for i in range(4)]
    qn = torch.sqrt(_maximum(
        fadd(*[fmul(q_new[i], q_new[i]) for i in range(4)]), 1e-18))
    q_new = [q / qn for q in q_new]
    qpos_new = []
    for j in range(nj):
        qp = st["qpos"][j] + dt * qvel_new[j]
        # hard position stop at the soft-band edge
        qpos_new.append(torch.clamp(qp, mc.q_lower[j] - 0.2,
                                    mc.q_upper[j] + 0.2))

    return {
        "base_pos": new_pos,
        "base_quat": q_new,
        "base_lin_vel": lin,
        "base_ang_vel": ang,
        "qpos": qpos_new,
        "qvel": qvel_new,
        "contact_force": contact_force,
    }


def fk_contact_pos(mc: ModelConsts, st: Dict) -> List:
    """World [x, y, z] of every collision sphere (positions-only FK).
    `st` needs base_pos, base_quat and qpos only."""
    R, pos, _ = _fk(mc, st)
    out = []
    for c in range(mc.nc):
        b = mc.collision_body[c]
        p_rel = v_add(pos[b], m_vec(R[b], mc.collision_offset[c]))
        out.append([fadd(st["base_pos"][i], p_rel[i]) for i in range(3)])
    return out


def fk_contact_xy(mc: ModelConsts, st: Dict) -> List:
    """World [x, y] of every collision sphere, the terrain-query positions
    of the substep kernel's surface rows.  `st` needs base_pos, base_quat
    and qpos only."""
    return [p[:2] for p in fk_contact_pos(mc, st)]


def pd_torque_rows(mc: ModelConsts, st: Dict, default_qpos, action_scale,
                   control_type: str, sim_dt: float) -> List:
    """PD law on rows: tau = clip(kp (a·scale + q_def − q) − kd q̇, ±lim)
    for control type P; V and T as the env's torque law."""
    taus = []
    for j in range(mc.nj):
        scaled = fmul(st["actions"][j], action_scale)
        if control_type == "P":
            err = fadd(scaled, default_qpos[j], fneg(st["qpos"][j]))
            t = fsub(fmul(st["kp"][j], err), fmul(st["kd"][j], st["qvel"][j]))
        elif control_type == "V":
            t = fsub(fmul(st["kp"][j], fsub(scaled, st["qvel"][j])),
                     fmul(st["kd"][j],
                          fsub(st["qvel"][j], st["last_qvel"][j]) / sim_dt))
        elif control_type == "T":
            t = scaled
        else:
            raise NameError(f"Unknown controller type: {control_type}")
        lim = mc.effort_limit[j]
        taus.append(torch.clamp(t, -lim, lim))
    return taus
