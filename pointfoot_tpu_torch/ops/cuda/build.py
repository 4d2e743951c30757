"""Build and bind the CUDA kernels of csrc/ (plain C interface, ctypes).

Three kinds of library, each built from one source:

- substep.cu (with rowdyn.cuh) once per robot: the model's constants are
  written into a generated header, pf_model.h, so PointFoot and ANYmal each
  get their own library;
- cholesky.cu once, with no model header;
- riccati.cu once, with no model header.

Sources, the csrc/ headers, the generated header and the flags are hashed;
a library lands in `_build/<hash>/` of the package on first use and is
reused while none of them change.  `build_all` compiles several at once,
one `nvcc` process each.  `nvcc` comes from the PATH or `$CUDA_HOME/bin`
(default /usr/local/cuda).
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np

from pointfoot_tpu_torch.physics.contact import MAX_DEPENETRATION_VEL, PEN_REST
from pointfoot_tpu_torch.physics.rowdyn import ModelConsts

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
# -fmad=false: no contraction of a*b+c into one FMA, so the kernels round
# as their plain PyTorch versions do.  With contraction, a 4-substep rollout
# at 4096 envs on an H100 drifted up to 4.5e-3 rad/s in qvel from the plain
# version (tolerance 2e-3) in stiff-contact envs; without it, 9.5e-4.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def _f(v: float) -> str:
    """A float literal of v rounded to float32 as torch rounds a python
    float, written exactly (python's repr always has a '.' or an 'e'): the
    compiler's own rounding of the decimal can land on the other neighbour
    of a value halfway between two floats."""
    return f"{float(np.float32(v))!r}f"


def _lit(v, ctype: str) -> str:
    if isinstance(v, (list, tuple)):
        return "{" + ", ".join(_lit(x, ctype) for x in v) + "}"
    if ctype == "bool":
        return "true" if v else "false"
    if ctype == "int":
        return str(int(v))
    return _f(v)


def _table(name: str, values, dims, ctype: str = "float") -> str:
    """`constexpr` accessor pf_<name>(i0, ...) over a nested list."""
    args = ", ".join(f"int i{k}" for k in range(len(dims)))
    shape = "".join(f"[{d}]" for d in dims)
    index = "".join(f"[i{k}]" for k in range(len(dims)))
    return (f"__host__ __device__ constexpr {ctype} pf_{name}({args}) {{\n"
            f"  constexpr {ctype} t{shape} = {_lit(values, ctype)};\n"
            f"  return t{index};\n}}\n")


def _array(name: str, values, dims, ctype: str = "float") -> str:
    """`pfr_<name>`, the same data as a device array that a kernel indexes
    at run time (lanes of a group work on different bodies)."""
    shape = "".join(f"[{d}]" for d in dims)
    return (f"static __device__ const {ctype} pfr_{name}{shape} = "
            f"{_lit(values, ctype)};\n")


def _padded(rows, width: int):
    return [list(r) + [0] * (width - len(r)) for r in rows]


def branches(mc: ModelConsts):
    """The subtrees below the base, in the order of their first body: for
    each, its bodies (ascending, so parents come first) and its collision
    spheres (ascending)."""
    root = {}
    for b in range(1, mc.nb):
        p = mc.parent[b]
        root[b] = b if p == 0 else root[p]
    firsts = sorted(set(root.values()))
    bodies = [[b for b in range(1, mc.nb) if root[b] == f] for f in firsts]
    spheres = [[c for c, b in enumerate(mc.collision_body)
                if b > 0 and root[b] == f] for f in firsts]
    return bodies, spheres


def composite_masses(mc: ModelConsts) -> List[float]:
    """Mass of each body's subtree, summed in float64 over the bodies in
    descending order as physics/rowdyn.py folds its constant masses (the
    base's is its own: its added mass makes it a row there)."""
    cm = list(mc.mass)
    for b in range(mc.nb - 1, 0, -1):
        if mc.parent[b] > 0:
            cm[mc.parent[b]] += cm[b]
    return cm


def model_header(mc: ModelConsts) -> str:
    """pf_model.h for the kernels: sizes and constants of one robot, as
    `constexpr` accessors pf_*(i) that fold into unrolled per-thread code
    and as device arrays pfr_* for code whose lanes index them at run time,
    with the tree cut into the branches below the base (both ways)."""
    nb, nj, nc = mc.nb, mc.nj, mc.nc
    br_bodies, br_spheres = branches(mc)
    nbr = len(br_bodies)
    maxbl = max(len(b) for b in br_bodies)
    maxbs = max(1, max(len(s) for s in br_spheres))
    maxd = max(1, max(len(a) for a in mc.ancestors))
    flat9 = lambda mats: [[v for row in m for v in row] for m in mats]
    anc = [[_is_ancestor(mc, a, b) for b in range(nb)] for a in range(nb)]
    uses = [[j in mc.ancestors[c] for j in range(nj)] for c in range(nc)]
    parts = [
        "// Generated from the robot model by ops/cuda/build.py.\n",
        "#pragma once\n",
        f"#define PF_NB {nb}\n#define PF_NJ {nj}\n#define PF_NC {nc}\n",
        f"#define PF_MAX_DEPENETRATION_VEL {_f(MAX_DEPENETRATION_VEL)}\n",
        f"#define PF_PEN_REST {_f(PEN_REST)}\n",
        "struct PfJointVec { float v[PF_NJ]; };\n",
        _table("parent", list(mc.parent), [nb], "int"),
        _table("coll_body", list(mc.collision_body), [nc], "int"),
        _table("is_ancestor", anc, [nb, nb], "bool"),
        _table("uses_joint", uses, [nc, nj], "bool"),
        _table("joint_pos", mc.joint_pos, [nj, 3]),
        _table("joint_rot", mc.joint_rot_mat, [nj, 3, 3]),
        _table("joint_axis", mc.joint_axis, [nj, 3]),
        _table("q_lower", mc.q_lower, [nj]),
        _table("q_upper", mc.q_upper, [nj]),
        # hard position stops 0.2 rad past the limits, rounded once from
        # float64 as the plain version folds them
        _table("q_lower_stop", [q - 0.2 for q in mc.q_lower], [nj]),
        _table("q_upper_stop", [q + 0.2 for q in mc.q_upper], [nj]),
        _table("velocity_limit", mc.velocity_limit, [nj]),
        _table("effort_limit", mc.effort_limit, [nj]),
        _table("joint_damping", mc.joint_damping, [nj]),
        _table("mass", mc.mass, [nb]),
        _table("com", mc.com, [nb, 3]),
        _table("inertia", mc.inertia, [nb, 3, 3]),
        _table("coll_offset", mc.collision_offset, [nc, 3]),
        _table("coll_radius", mc.collision_radius, [nc]),
        f"#define PF_NBR {nbr}\n#define PF_MAXBL {maxbl}\n"
        f"#define PF_MAXBS {maxbs}\n#define PF_MAXD {maxd}\n",
        _table("br_len", [len(b) for b in br_bodies], [nbr], "int"),
        _table("br_body", _padded(br_bodies, maxbl), [nbr, maxbl], "int"),
        _array("parent", list(mc.parent), [nb], "int"),
        _array("br_len", [len(b) for b in br_bodies], [nbr], "int"),
        _array("br_body", _padded(br_bodies, maxbl), [nbr, maxbl], "int"),
        _array("br_nsph", [len(s) for s in br_spheres], [nbr], "int"),
        _array("br_sphere", _padded(br_spheres, maxbs), [nbr, maxbs], "int"),
        _array("coll_body", list(mc.collision_body), [nc], "int"),
        _array("anc_count", [len(a) for a in mc.ancestors], [nc], "int"),
        _array("anc_joint", _padded(mc.ancestors, maxd), [nc, maxd], "int"),
        _array("joint_pos", mc.joint_pos, [nj, 3]),
        _array("joint_rot", flat9(mc.joint_rot_mat), [nj, 9]),
        _array("joint_axis", mc.joint_axis, [nj, 3]),
        _array("q_lower", mc.q_lower, [nj]),
        _array("q_upper", mc.q_upper, [nj]),
        _array("q_lower_stop", [q - 0.2 for q in mc.q_lower], [nj]),
        _array("q_upper_stop", [q + 0.2 for q in mc.q_upper], [nj]),
        _array("velocity_limit", mc.velocity_limit, [nj]),
        _array("effort_limit", mc.effort_limit, [nj]),
        _array("joint_damping", mc.joint_damping, [nj]),
        _array("mass", mc.mass, [nb]),
        _array("cmass", composite_masses(mc), [nb]),
        _array("com", mc.com, [nb, 3]),
        _array("inertia", flat9(mc.inertia), [nb, 9]),
        _array("coll_offset", mc.collision_offset, [nc, 3]),
        _array("coll_radius", mc.collision_radius, [nc]),
    ]
    return "".join(parts)


def _is_ancestor(mc: ModelConsts, a: int, b: int) -> bool:
    """Body a lies on the path from the base to body b (a != base)."""
    while b > 0:
        b = mc.parent[b]
        if b == a and a > 0:
            return True
    return False


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    path = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or under $CUDA_HOME/bin")
    return path


class BuildSpec(NamedTuple):
    """One shared library: a source of csrc/ and its generated header."""

    source: str  # file name under csrc/
    header: Optional[str]  # pf_model.h text, or None
    libname: str

    def key(self) -> str:
        h = hashlib.sha256()
        for path in [os.path.join(CSRC, self.source)] + sorted(
                glob.glob(os.path.join(CSRC, "*.cuh"))):
            with open(path, "rb") as f:
                h.update(f.read())
        h.update((self.header or "").encode())
        h.update(" ".join(NVCC_FLAGS).encode())
        return h.hexdigest()[:16]

    def path(self) -> str:
        return os.path.join(BUILD_DIR, self.key(), f"lib{self.libname}.so")


class KernelLibrary:
    """A built shared library and how long its build took."""

    def __init__(self, path: str, build_seconds: float, log: str):
        self.path = path
        self.build_seconds = build_seconds
        self.log = log
        self.lib = ctypes.CDLL(path)


class ModelLibrary(KernelLibrary):
    """substep.cu for one robot, with its C entry points typed."""

    def __init__(self, path: str, build_seconds: float, log: str):
        super().__init__(path, build_seconds, log)
        lib = self.lib
        lib.pf_layout.argtypes = [_P]
        lib.pf_layout.restype = None
        layout = (ctypes.c_int * 9)()
        lib.pf_layout(layout)
        # nj, nc, rollout state, rollout control, surface, rollout extra,
        # substep input, substep output and FK input rows
        self.layout = tuple(layout)

        class JointVec(ctypes.Structure):  # PfJointVec, passed by value
            _fields_ = [("v", _F * self.layout[0])]

        self.JointVec = JointVec
        lib.pf_rollout_substep.argtypes = [
            _P, _P, _P, _P, _P, _I, _I, _I, JointVec, _F, _F, _F, _P]
        lib.pf_rollout_substep.restype = _I
        lib.pf_substep.argtypes = [_P, _P, _P, _I, _F, _F, _P]
        lib.pf_substep.restype = _I
        lib.pf_fk_from_state.argtypes = [_P, _P, _I, _P]
        lib.pf_fk_from_state.restype = _I
        lib.pf_fk_contact_xy.argtypes = [_P, _P, _I, _P]
        lib.pf_fk_contact_xy.restype = _I
        lib.pf_substep_smem_bytes.argtypes = []
        lib.pf_substep_smem_bytes.restype = _I
        lib.pf_substep_resident_warps.argtypes = [_I]
        lib.pf_substep_resident_warps.restype = _I
        for fn in (lib.pf_fk_xy_resident_warps, lib.pf_fk_xyz_resident_warps):
            fn.argtypes = []
            fn.restype = _I


class CholeskyLibrary(KernelLibrary):
    """cholesky.cu, with its C entry point typed."""

    def __init__(self, path: str, build_seconds: float, log: str):
        super().__init__(path, build_seconds, log)
        self.lib.pf_chol_solve.argtypes = [_P, _P, _P, _I, _I, _P]
        self.lib.pf_chol_solve.restype = _I
        for fn in (self.lib.pf_chol_lanes, self.lib.pf_chol_smem_bytes,
                   self.lib.pf_chol_resident_warps):
            fn.argtypes = [_I]
            fn.restype = _I


class RiccatiLibrary(KernelLibrary):
    """riccati.cu, with its C entry points typed."""

    def __init__(self, path: str, build_seconds: float, log: str):
        super().__init__(path, build_seconds, log)
        self.lib.pf_srb_lqr.argtypes = [_P] * 10 + [_I, _I, _I, _P]
        self.lib.pf_srb_lqr.restype = _I
        for fn in (self.lib.pf_srb_lqr_smem_bytes,
                   self.lib.pf_srb_lqr_resident_warps):
            fn.argtypes = [_I, _I, _I]
            fn.restype = _I


def model_spec(mc: ModelConsts) -> BuildSpec:
    return BuildSpec("substep.cu", model_header(mc), "pf_substep")


CHOLESKY_SPEC = BuildSpec("cholesky.cu", None, "pf_cholesky")
RICCATI_SPEC = BuildSpec("riccati.cu", None, "pf_riccati")
_LIBRARY_CLASS = {"substep.cu": ModelLibrary, "cholesky.cu": CholeskyLibrary,
                  "riccati.cu": RiccatiLibrary}


def _compile(spec: BuildSpec):
    """nvcc for one spec unless its library exists: (path, seconds, log)."""
    so = spec.path()
    if os.path.exists(so):
        return so, 0.0, ""
    out_dir = os.path.dirname(so)
    os.makedirs(out_dir, exist_ok=True)
    if spec.header is not None:
        with open(os.path.join(out_dir, "pf_model.h"), "w") as f:
            f.write(spec.header)
    tmp = f"{so}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-I", out_dir, "-I", CSRC, "-o", tmp,
         os.path.join(CSRC, spec.source)],
        capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc {spec.source} failed ({proc.returncode}):"
                           f"\n{log}")
    os.replace(tmp, so)
    return so, seconds, log


def build_all(specs: Sequence[BuildSpec]) -> List[KernelLibrary]:
    """Compile the missing libraries of `specs` at once (one nvcc each),
    then load them all."""
    with ThreadPoolExecutor(max_workers=max(len(specs), 1)) as pool:
        built = list(pool.map(_compile, specs))
    return [_load(spec, *b) for spec, b in zip(specs, built)]


_LIBS: Dict[str, KernelLibrary] = {}


def _load(spec: BuildSpec, path: str, seconds: float, log: str
          ) -> KernelLibrary:
    """The library at `path`, opened once per process."""
    if path not in _LIBS:
        _LIBS[path] = _LIBRARY_CLASS[spec.source](path, seconds, log)
    return _LIBS[path]


@functools.lru_cache(maxsize=None)
def load(mc: ModelConsts) -> ModelLibrary:
    """Build (once per sources + model + flags) and load substep.cu for mc."""
    spec = model_spec(mc)
    return _load(spec, *_compile(spec))


@functools.lru_cache(maxsize=None)
def load_cholesky() -> CholeskyLibrary:
    """Build (once per source + flags) and load cholesky.cu."""
    return _load(CHOLESKY_SPEC, *_compile(CHOLESKY_SPEC))


@functools.lru_cache(maxsize=None)
def load_riccati() -> RiccatiLibrary:
    """Build (once per source + flags) and load riccati.cu."""
    return _load(RICCATI_SPEC, *_compile(RICCATI_SPEC))
