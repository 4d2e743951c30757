"""The CUDA build's generated model header (ops/cuda/build.py), on the CPU:
sizes and table lengths for ANYmal C, one library per robot and one
Cholesky library without a model header, each keyed by its own hash."""

import re

import numpy as np
import pytest

from pointfoot_tpu_torch.ops.cuda import build
from pointfoot_tpu_torch.ops.cuda import substep as sp
from pointfoot_tpu_torch.physics.assets import get_model


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
