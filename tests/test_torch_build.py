"""The CUDA build's generated model header (ops/cuda/build.py), on the CPU:
sizes and table lengths for ANYmal C, one library per robot and one
Cholesky and one Riccati library without a model header, each keyed by its
own hash; and the packaging of the CUDA sources."""

import ast
import fnmatch
import os
import re

import numpy as np
import pytest
import torch

from pointfoot_tpu_torch.ops.cuda import build
from pointfoot_tpu_torch.ops.cuda import substep as sp
from pointfoot_tpu_torch.physics.assets import get_model
from pointfoot_tpu_torch.utils import profiling


@pytest.fixture(scope="module")
def anymal():
    return sp.model_consts(get_model("anymal_c"))


def _table_len(header: str, name: str) -> int:
    """Entries of table pf_<name>: its declared size, checked against the
    count of values in its initializer (C++ would zero-fill a short one)."""
    m = re.search(rf"pf_{name}\([^)]*\) {{\n  constexpr \w+ t((?:\[\d+\])+)"
                  r" = (.*);\n", header)
    assert m, name
    size = int(np.prod([int(d) for d in re.findall(r"\d+", m.group(1))]))
    values = m.group(2).replace("{", "").replace("}", "").split(",")
    assert len(values) == size, name
    return size


def test_model_header_sizes_for_anymal(anymal):
    h = build.model_header(anymal)
    assert "#define PF_NB 13\n" in h
    assert "#define PF_NJ 12\n" in h
    assert "#define PF_NC 13\n" in h
    assert anymal.nv == 18
    nb, nj, nc = 13, 12, 13
    want = {"parent": nb, "coll_body": nc, "is_ancestor": nb * nb,
            "uses_joint": nc * nj, "joint_pos": nj * 3,
            "joint_rot": nj * 9, "joint_axis": nj * 3, "q_lower": nj,
            "q_upper": nj, "q_lower_stop": nj, "q_upper_stop": nj,
            "velocity_limit": nj, "effort_limit": nj, "joint_damping": nj,
            "mass": nb, "com": nb * 3, "inertia": nb * 9,
            "coll_offset": nc * 3, "coll_radius": nc}
    for name, n in want.items():
        assert _table_len(h, name) == n, name


def test_one_library_per_robot_and_one_cholesky(anymal):
    pointfoot = sp.model_consts(get_model("pointfoot"))
    specs = [build.model_spec(pointfoot), build.model_spec(anymal),
             build.CHOLESKY_SPEC]
    keys = [s.key() for s in specs]
    assert len(set(keys)) == 3
    assert build.CHOLESKY_SPEC.header is None
    assert [s.source for s in specs] == ["substep.cu", "substep.cu",
                                         "cholesky.cu"]
    assert build.model_spec(anymal).key() == keys[1]  # stable


def test_riccati_spec_builds_without_a_model_header():
    spec = build.RICCATI_SPEC
    assert spec.header is None
    assert spec.source == "riccati.cu"
    assert os.path.exists(os.path.join(build.CSRC, spec.source))
    assert spec.key() != build.CHOLESKY_SPEC.key()
    assert spec.path().endswith("libpf_riccati.so")
    with open(os.path.join(build.CSRC, spec.source)) as f:
        src = f.read()
    assert "pf_model.h" not in src and "rowdyn.cuh" not in src
    assert "__global__" in src and 'extern "C"' in src
    assert build._LIBRARY_CLASS[spec.source] is build.RiccatiLibrary


def test_every_csrc_file_is_packaged():
    """Each file under csrc/ matches a package_data pattern of setup.py, so
    an installed copy of the package can build its kernels."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(repo, "setup.py")) as f:
        tree = ast.parse(f.read())
    call = next(n for n in ast.walk(tree) if isinstance(n, ast.Call)
                and getattr(n.func, "id", "") == "setup")
    data = ast.literal_eval(next(
        k.value for k in call.keywords if k.arg == "package_data"))
    patterns = data["pointfoot_tpu_torch"]
    files = sorted(os.listdir(build.CSRC))
    assert "rowdyn.cuh" in files and "riccati.cu" in files
    for name in files:
        assert any(fnmatch.fnmatch(f"csrc/{name}", p) for p in patterns), name


# ------------------------------------- run-time tables of the lane groups

def _array(header: str, name: str):
    """Device array pfr_<name> of the header as nested python lists, its
    value count checked against its declared shape."""
    m = re.search(rf"pfr_{name}((?:\[\d+\])+) = (.*);\n", header)
    assert m, name
    dims = [int(d) for d in re.findall(r"\d+", m.group(1))]
    text = m.group(2).replace("{", "[").replace("}", "]")
    values = ast.literal_eval(re.sub(r"(?<=[\d.])f\b", "", text))
    assert np.asarray(values).shape == tuple(dims), name
    return values


@pytest.mark.parametrize("robot, nbr, maxbl, maxd", [
    ("pointfoot", 2, 3, 3), ("anymal_c", 4, 3, 3), ("a1", 4, 3, 3)])
def test_branch_tables_match_the_model(robot, nbr, maxbl, maxd):
    """The branches below the base partition the bodies, each in an order
    that puts parents first; the spheres of a branch are those on its
    bodies; every sphere's ancestor joints lie in its own branch."""
    mc = sp.model_consts(get_model(robot))
    h = build.model_header(mc)
    for name, v in (("NBR", nbr), ("MAXBL", maxbl), ("MAXD", maxd)):
        assert f"#define PF_{name} {v}\n" in h
    lens, bodies = _array(h, "br_len"), _array(h, "br_body")
    nsph, spheres = _array(h, "br_nsph"), _array(h, "br_sphere")
    assert _array(h, "parent") == list(mc.parent)
    assert _array(h, "coll_body") == list(mc.collision_body)
    seen = []
    for br in range(nbr):
        mine = bodies[br][:lens[br]]
        assert mine == sorted(mine) and mc.parent[mine[0]] == 0
        for b in mine[1:]:
            assert mc.parent[b] in mine and mc.parent[b] < b
        seen += mine
        own = spheres[br][:nsph[br]]
        assert own == [c for c, b in enumerate(mc.collision_body)
                       if b in mine]
        for c in own:
            assert all(j + 1 in mine for j in mc.ancestors[c])
    assert sorted(seen) == list(range(1, mc.nb))
    firsts = [bodies[br][0] for br in range(nbr)]
    assert firsts == sorted(firsts)  # the base folds them last body first
    counts, joints = _array(h, "anc_count"), _array(h, "anc_joint")
    for c in range(mc.nc):
        assert tuple(joints[c][:counts[c]]) == mc.ancestors[c]
        assert list(mc.ancestors[c]) == sorted(mc.ancestors[c])


@pytest.mark.parametrize("robot", ["pointfoot", "anymal_c", "a1"])
def test_run_time_arrays_repeat_the_constexpr_tables(robot):
    """pfr_<name> (indexed by the lanes at run time) holds the values of
    pf_<name>(i) (folded into the per-thread FK kernels)."""
    mc = sp.model_consts(get_model(robot))
    h = build.model_header(mc)
    for name in ("joint_pos", "joint_rot", "joint_axis", "q_lower",
                 "q_upper", "q_lower_stop", "q_upper_stop", "velocity_limit",
                 "effort_limit", "joint_damping", "mass", "com", "inertia",
                 "coll_offset", "coll_radius", "br_len", "br_body"):
        m = re.search(rf"pf_{name}\([^)]*\) {{\n  constexpr \w+ t(?:\[\d+\])+"
                      r" = (.*);\n", h)
        table = ast.literal_eval(re.sub(
            r"(?<=[\d.])f\b", "",
            m.group(1).replace("{", "[").replace("}", "]")))
        np.testing.assert_array_equal(
            np.asarray(table, np.float64).ravel(),
            np.asarray(_array(h, name), np.float64).ravel(), err_msg=name)


def test_substep_sources_use_a_lane_group_and_shared_memory():
    with open(os.path.join(build.CSRC, "substep.cu")) as f:
        src = f.read()
    with open(os.path.join(build.CSRC, "rowdyn.cuh")) as f:
        body = f.read()
    assert "extern __shared__ float smem[]" in src
    assert "substep_group(" in src and "__syncwarp()" in body
    assert "cudaOccupancyMaxActiveBlocksPerMultiprocessor" in src


def _kernel_body(src: str, name: str) -> str:
    """The body of `__global__ ... name(...) { ... }` in src, by braces."""
    start = src.index("{", src.index(f" {name}(", src.index("__global__")))
    depth = 0
    for i in range(start, len(src)):
        depth += {"{": 1, "}": -1}.get(src[i], 0)
        if depth == 0:
            return src[start:i + 1]
    raise AssertionError(f"{name}: unbalanced braces")


def test_cholesky_kernel_stages_in_shared_memory_and_never_leaves_early():
    """The Cholesky kernel gives a system a group of lanes and a slab of
    dynamic shared memory, meets once at __syncthreads() and then
    synchronises the group with __syncwarp(), and has no `return` before a
    barrier: the tail block clamps its system index and skips the stores
    instead."""
    with open(os.path.join(build.CSRC, "cholesky.cu")) as f:
        body = _kernel_body(f.read(), "chol_solve_kernel")
    assert "extern __shared__ float smem[]" in body
    assert "__syncthreads()" in body and "__syncwarp()" in body
    assert "min(" in body and "B - 1)" in body and "if (store)" in body
    assert re.search(r"\breturn\b", body) is None
    assert "blockDim" not in body  # the block size is the kernel's own


@pytest.mark.parametrize("n,lanes", [(12, 8), (18, 16)])
def test_cholesky_staging_covers_the_lower_triangle_once(n, lanes):
    """The kernel stages only A's lower triangle, the entries the factor
    reads: its sweep, run here for every offset, loads each entry (i, j),
    j <= i, exactly once and nothing above the diagonal."""
    with open(os.path.join(build.CSRC, "cholesky.cu")) as f:
        body = _kernel_body(f.read(), "chol_solve_kernel")
    assert "for (int r = r0; r < N * N; r += SWEEP)" in body
    assert "if (r % N <= r / N) ss[(r / N) * AST + r % N] = A[r * Bs + es];" \
        in body
    loaded = []
    for r0 in range(lanes):  # SWEEP = lanes: threads a block / systems
        for r in range(r0, n * n, lanes):
            if r % n <= r // n:
                loaded.append((r // n, r % n))
    assert sorted(loaded) == [(i, j) for i in range(n) for j in range(i + 1)]


@pytest.mark.parametrize("kernel, layout, width", [
    ("fk_contact_xy_kernel", "FkInRows", 2),
    ("fk_from_state_kernel", "StateRows", 3)])
def test_fk_xy_kernel_gives_each_warp_one_branch(kernel, layout, width):
    """Both sphere FK kernels run branch w of the tree below the base in
    warp w of their block (the branch is warp-uniform, so lanes never
    diverge) through the one walk, templated on the input rows and the
    output width, on the folded constexpr tables; their blocks are 32 envs
    of PF_NBR warps, and the tail block clamps its env instead of
    returning."""
    with open(os.path.join(build.CSRC, "substep.cu")) as f:
        src = f.read()
    body = _kernel_body(src, kernel)
    assert "threadIdx.x / 32" in body
    assert f"branch_fk_of<{layout}, {width}, 0>(" in body
    assert "min(e, B - 1)" in body and re.search(r"\breturn\b", body) is None
    walk = src[src.index("void branch_fk("):src.index("void branch_fk_of(")]
    assert "pf_br_body(BR, n)" in walk and "pfr_" not in walk
    assert "L::QUAT" in walk and "L::QPOS" in walk
    assert "for (int i = 0; i < W; ++i) base[i] = rows[(L::POS + i)" in walk
    assert "constexpr int FK_THREADS = 32 * PF_NBR;" in src
    launch = src[src.index(f"  {kernel}<<<"):]
    assert launch.startswith(f"  {kernel}<<<fk_blocks_for(B), FK_THREADS, 0,")


@pytest.mark.parametrize("rows, first", [
    ("FkInRows", ("K_POS", "K_QUAT", "K_QPOS")),
    ("StateRows", ("S_POS", "S_QUAT", "S_QPOS"))])
def test_fk_row_layouts_match_the_wrappers(rows, first):
    """The walk's row layouts name the rows that ops/cuda/substep.py packs:
    base_pos, base_quat and the first qpos row of `fk_in_layout` (the xy
    kernel) and of `state_layout` (the xyz kernel); the per-thread FK of
    the parent design (sphere_world, forward_kinematics) is gone, so two
    forms of sphere FK remain."""
    with open(os.path.join(build.CSRC, "substep.cu")) as f:
        src = f.read()
    with open(os.path.join(build.CSRC, "rowdyn.cuh")) as f:
        body = f.read()
    assert f"using {rows} = PoseRows<{', '.join(first)}>;" in src
    layout = sp.fk_in_layout(6) if rows == "FkInRows" else sp.state_layout(6)
    offsets, o = {}, 0
    for name, cnt in layout:
        offsets[name] = o
        o += cnt
    want = [offsets["base_pos"], offsets["base_quat"], offsets["qpos"]]
    got = [int(re.search(rf"\b{name} = (\d+)", src).group(1))
           for name in first]
    assert got == want
    for gone in ("sphere_world(", "forward_kinematics(",
                 "blocks_for(B), THREADS"):
        assert gone not in src + body, gone


def test_typed_entry_points_are_defined_in_the_sources():
    """Every C entry point that build.py types exists in the extern "C"
    block of a csrc/ source (a missing one fails only at load time on the
    card)."""
    with open(build.__file__) as f:
        typed = set(re.findall(r"\b(pf_\w+)\.(?:argtypes|restype)", f.read()))
    with open(build.__file__) as f:
        typed |= set(re.findall(r"lib\.(pf_\w+)", f.read()))
    defined = set()
    for name in os.listdir(build.CSRC):
        with open(os.path.join(build.CSRC, name)) as f:
            src = f.read()
        if 'extern "C" {' in src:
            block = src[src.index('extern "C" {'):]
            defined |= set(re.findall(r"^\w[\w\s\*]*\b(pf_\w+)\(", block,
                                      re.M))
    assert {"pf_chol_solve", "pf_chol_lanes", "pf_chol_smem_bytes",
            "pf_chol_resident_warps", "pf_substep_resident_warps",
            "pf_fk_xy_resident_warps", "pf_fk_xyz_resident_warps",
            "pf_fk_contact_xy", "pf_fk_from_state"} <= typed
    assert typed <= defined, typed - defined


@pytest.mark.parametrize("num", [1, 130])
@pytest.mark.parametrize("n", [12, 18])
def test_cholesky_cpu_route_is_linalg_chol_solve(n, num):
    """On CPU tensors the Cholesky wrapper is the plain version,
    ops/linalg.chol_solve, bit for bit, and launches nothing."""
    import torch

    from pointfoot_tpu_torch.ops import linalg
    from pointfoot_tpu_torch.ops.cuda import cholesky as ch

    rng = np.random.default_rng(100 * n + num)
    M = rng.normal(size=(num, n, n)).astype(np.float32)
    A = torch.tensor(M @ M.transpose(0, 2, 1) + n * np.eye(n, dtype=np.float32))
    b = torch.tensor(rng.normal(size=(num, n)).astype(np.float32))
    want = linalg.chol_solve(A, b)
    before = profiling.counter("kernel.chol_solve")
    x_t = ch.chol_solve_lanes(A.reshape(num, n * n).t().contiguous(),
                              b.t().contiguous())
    assert torch.equal(x_t.t(), want)
    assert torch.equal(ch.chol_solve(A, b), want)
    assert torch.equal(ch.chol_solve_best(A, b), want)
    assert profiling.counter("kernel.chol_solve") == before


def test_float_literals_are_the_float32_torch_rounds_to():
    """A float64 constant halfway between two float32s (Cassie's subtree
    mass of bodies 5 and 6) is written as the float32 that torch makes of
    the python float, exactly; the decimal repr of the float64 would have
    the compiler round to the other neighbour."""
    from fractions import Fraction

    m = sp.model_consts(get_model("cassie"))
    tie = m.mass[5] + m.mass[6]
    want = float(np.float32(tie))
    assert float(torch.tensor([1.0]).mul(tie)[0]) == want
    # the shortest decimal of the float64 lies nearer the other float32
    # neighbour, where a compiler parsing it straight to float would land
    other = float(np.nextafter(np.float32(want), np.float32(0.0)))
    dec = Fraction(repr(tie))
    assert abs(dec - Fraction(other)) < abs(dec - Fraction(want))
    lit = build._f(tie)
    assert lit.endswith("f") and float(lit[:-1]) == want
    # and the literal's decimal lies nearest to the float32 torch uses
    dec = Fraction(lit[:-1])
    for nb in (other, float(np.nextafter(np.float32(want), np.float32(2.0)))):
        assert abs(dec - Fraction(want)) < abs(dec - Fraction(nb))


@pytest.mark.parametrize("robot", ["pointfoot", "anymal_c", "a1", "cassie"])
def test_composite_masses_fold_as_the_plain_version(robot):
    """pfr_cmass holds each subtree's mass summed in float64 in descending
    body order, as physics/rowdyn.py folds the constant masses of its CRBA
    (the base keeps its own mass: its added mass is a row there)."""
    m = sp.model_consts(get_model(robot))
    cm = build.composite_masses(m)
    ic = {b: m.mass[b] for b in range(m.nb)}
    for b in range(m.nb - 1, 0, -1):
        if m.parent[b] > 0:
            ic[m.parent[b]] = ic[m.parent[b]] + ic[b]
    assert cm == [ic[b] for b in range(m.nb)]
    assert cm[0] == m.mass[0]
    h = build.model_header(m)
    assert f"pfr_cmass[{m.nb}] = " in h


def test_kernel_sums_in_the_plain_versions_order():
    """Source checks of the sum orders that make the substep kernels round
    as physics/rowdyn.py does: J'f0 term by term, the PD law's default
    angle last, D v from the D matrix, divisions by constants as products
    with the float32 reciprocal (torch's CUDA division by a python float),
    the composite masses from the header."""
    with open(os.path.join(build.CSRC, "rowdyn.cuh")) as f:
        src = f.read()
    with open(os.path.join(build.CSRC, "substep.cu")) as f:
        sub = f.read()
    assert "f += jac_base(sp + SP_P, 0, ci) * sp[SP_FS];" in src
    assert "sl[JTF + cj] += jc[0] * sp[SP_FS];" in src
    assert "tanhf(qv * (1.0f / 0.05f))" in src
    assert "v_n * (1.0f / PF_MAX_DEPENETRATION_VEL)" in src
    assert "Isp[ISZ * b] = pfr_cmass[b];" in src
    assert "Dv = s == 0 ? D * v_new[0] : Dv + D * v_new[s];" in src
    assert "((scaled - qp) + default_qpos.v[j])" in sub
    assert "* (1.0f / dt)" in sub
    assert not re.search(r"\) / dt\)", sub)
    assert "qv / 0.05f" not in src and "v_n / PF_MAX" not in src
