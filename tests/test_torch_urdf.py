"""The port's URDF compiler (pointfoot_tpu_torch/physics/urdf.py) and model
assets against the JAX package's: a URDF written here compiled by both,
`model_to_dict` / `save_model` / `model_from_dict`, every baked asset, the
bake_assets CLI, and the golden-value cases of tests/test_urdf.py on the
port's baked PointFoot."""

import json
import os

import numpy as np
import pytest

from pointfoot_tpu.physics import assets as jax_assets
from pointfoot_tpu.physics.urdf import load_urdf as jax_load_urdf
from pointfoot_tpu_torch import bake_assets
from pointfoot_tpu_torch.physics import assets, load_urdf

ARRAYS = assets._ARRAYS
META = ("nb", "parent", "body_names", "joint_names", "collision_body",
        "collision_names")

# A two-leg tree: a base with a welded IMU link (fixed joint), two legs of
# hip (revolute) -> knee (continuous) -> welded foot; sphere, box,
# cylinder and mesh collisions; a 0/0 limit (unlimited), a pinned joint
# (lower == upper != 0), rotated joint and inertial frames.
URDF = """<?xml version="1.0"?>
<robot name="biped">
  <link name="base_Link">
    <inertial><origin xyz="0.01 0 0.02" rpy="0 0 0"/><mass value="8.5"/>
      <inertia ixx="0.1" ixy="0.001" ixz="0.002" iyy="0.12" iyz="0.0"
               izz="0.08"/></inertial>
    <collision><origin xyz="0 0 0.05"/>
      <geometry><box size="0.3 0.2 0.12"/></geometry></collision>
  </link>
  <link name="imu_Link">
    <inertial><origin xyz="0 0 0"/><mass value="0.01"/>
      <inertia ixx="1e-6" iyy="1e-6" izz="1e-6"/></inertial>
  </link>
  <joint name="imu_Joint" type="fixed">
    <origin xyz="0.05 0 0.1" rpy="0 0 0.3"/>
    <parent link="base_Link"/><child link="imu_Link"/>
  </joint>
LEGS
</robot>
"""

LEG = """  <link name="hip_{s}_Link">
    <inertial><origin xyz="0 {y2} -0.05" rpy="0.1 0 0"/><mass value="1.6"/>
      <inertia ixx="0.004" iyy="0.005" izz="0.002" ixy="1e-4"/></inertial>
    <collision><origin xyz="0 0 -0.1"/>
      <geometry><cylinder radius="0.04" length="0.2"/></geometry></collision>
  </link>
  <joint name="hip_{s}_Joint" type="revolute">
    <origin xyz="0 {y} -0.05" rpy="0 0.2 0"/>
    <parent link="base_Link"/><child link="hip_{s}_Link"/>
    <axis xyz="0 1 0"/>
    <limit lower="{lo}" upper="{hi}" effort="80" velocity="20"/>
    <dynamics damping="0.1" friction="0.2"/>
  </joint>
  <link name="knee_{s}_Link">
    <inertial><origin xyz="0.05 0 -0.1"/><mass value="0.57"/>
      <inertia ixx="0.002" iyy="0.002" izz="0.0005"/></inertial>
    <collision><origin xyz="0 0 -0.15"/>
      <geometry><mesh filename="knee.stl"/></geometry></collision>
  </link>
  <joint name="knee_{s}_Joint" type="continuous">
    <origin xyz="0 0 -0.25" rpy="0 0 0"/>
    <parent link="hip_{s}_Link"/><child link="knee_{s}_Link"/>
    <axis xyz="0 -2 0"/>
    <limit effort="80" velocity="{kv}"/>
  </joint>
  <link name="foot_{s}_Link">
    <inertial><origin xyz="0 0 0"/><mass value="0.157"/>
      <inertia ixx="1e-5" iyy="1e-5" izz="1e-5"/></inertial>
    <collision><origin xyz="0 0 0"/>
      <geometry><sphere radius="0.03"/></geometry></collision>
  </link>
  <joint name="foot_{s}_Joint" type="fixed">
    <origin xyz="0.15 0 -0.25981" rpy="0 0 0"/>
    <parent link="knee_{s}_Link"/><child link="foot_{s}_Link"/>
  </joint>
"""


def _urdf(tmp_path, name="biped.urdf"):
    legs = (LEG.format(s="L", y=0.1, y2=0.01, lo=0.0, hi=0.0, kv=20)
            + LEG.format(s="R", y=-0.1, y2=-0.01, lo=0.3, hi=0.3, kv=50))
    path = tmp_path / name
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(URDF.replace("LEGS", legs))
    return str(path)


def _assert_models_equal(port, ref):
    for k in META:
        assert getattr(port, k) == getattr(ref, k), k
    for k in ARRAYS:
        got = getattr(port, k).numpy()
        want = np.asarray(getattr(ref, k))
        assert got.dtype == want.dtype == np.float32, k
        np.testing.assert_array_equal(got, want, err_msg=k)


@pytest.fixture(scope="module")
def compiled(tmp_path_factory):
    path = _urdf(tmp_path_factory.mktemp("urdf"))
    return load_urdf(path), jax_load_urdf(path)


def test_compiled_like_jax(compiled):
    """Both compilers do the same float64 numpy, then round to float32:
    every field is equal."""
    (port, pmap), (ref, rmap) = compiled
    _assert_models_equal(port, ref)
    assert pmap == rmap == {"hip_L_Joint": 0, "knee_L_Joint": 1,
                            "hip_R_Joint": 2, "knee_R_Joint": 3}


def test_compiled_tree(compiled):
    port = compiled[0][0]
    assert port.nb == 5 and port.nj == 4
    assert port.body_names == ("base_Link", "hip_L_Link", "knee_L_Link",
                               "hip_R_Link", "knee_R_Link")
    assert port.parent == (-1, 0, 1, 0, 3)
    # the welded IMU and feet merge into base and knees
    np.testing.assert_allclose(float(port.mass[0]), 8.51, rtol=1e-6)
    np.testing.assert_allclose(float(port.mass[2]), 0.57 + 0.157, rtol=1e-6)
    # 0/0 is unlimited, 0.3/0.3 a pin; the axis is normalised
    np.testing.assert_array_equal(port.q_lower.numpy()[[0, 2]],
                                  np.float32([-1e9, 0.3]))
    np.testing.assert_array_equal(port.q_upper.numpy()[[0, 2]],
                                  np.float32([1e9, 0.3]))
    np.testing.assert_array_equal(port.joint_axis.numpy()[1], [0, -1, 0])
    # box -> half its smallest side, cylinder -> its radius, mesh -> 0.02
    radii = dict(zip(port.collision_names, port.collision_radius.tolist()))
    assert radii["base_Link"] == pytest.approx(0.06)
    assert radii["hip_L_Link"] == pytest.approx(0.04)
    assert radii["knee_R_Link"] == pytest.approx(0.02)
    assert len(port.collision_indices("foot")) == 2
    foot = port.collision_indices("foot_L")[0]
    np.testing.assert_allclose(port.collision_offset[foot].numpy(),
                               [0.15, 0.0, -0.25981], atol=1e-6)


def test_inverted_limit_raises(tmp_path):
    text = open(_urdf(tmp_path)).read().replace(
        'lower="0.3" upper="0.3"', 'lower="0.5" upper="0.3"')
    bad = tmp_path / "bad.urdf"
    bad.write_text(text)
    with pytest.raises(ValueError, match="inverted"):
        load_urdf(str(bad))


def test_model_dict_and_round_trip(compiled, tmp_path):
    (port, _), (ref, _) = compiled
    d = assets.model_to_dict(port)
    assert d == jax_assets.model_to_dict(ref)
    path = assets.save_model(port, "biped", str(tmp_path))
    assert path == str(tmp_path / "biped.json")
    with open(path) as f:
        back = assets.model_from_dict(json.load(f))
    _assert_models_equal(back, ref)


def test_every_baked_asset_equals_jax_s():
    names = assets.available_models()
    assert names == jax_assets.available_models()
    assert {"pointfoot", "a1", "anymal_b", "anymal_c", "cassie"} <= set(names)
    for n in names:
        _assert_models_equal(assets.get_model(n), jax_assets.get_model(n))


def test_bake_assets_cli(tmp_path, capsys):
    res = tmp_path / "robots"
    src = _urdf(res / "PF_P441A" / "urdf", "PF_P441A.urdf")
    out = tmp_path / "assets"
    baked = bake_assets.main(["--resources", str(res), "--out", str(out)])
    assert baked == {"pointfoot": str(out / "pointfoot.json")}
    text = capsys.readouterr().out
    for name in ("a1", "anymal_b", "anymal_c", "cassie"):
        assert f"skip {name}:" in text
    with open(baked["pointfoot"]) as f:
        _assert_models_equal(assets.model_from_dict(json.load(f)),
                             jax_load_urdf(src)[0])


def test_bake_assets_default_skips_every_robot(tmp_path, capsys,
                                               monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert bake_assets.main(["--out", str(tmp_path / "a")]) == {}
    assert capsys.readouterr().out.count("skip ") == 5
    assert not os.path.exists(tmp_path / "a")


# --- tests/test_urdf.py's golden values of PF_P441A, on the port's asset


@pytest.fixture(scope="module")
def pf():
    return assets.get_model("pointfoot")


def test_tree_structure(pf):
    assert pf.nb == 7 and pf.nj == 6
    assert pf.parent[0] == -1
    assert pf.body_names[0] == "base_Link"
    i_abad = pf.body_names.index("abad_L_Link")
    i_hip = pf.body_names.index("hip_L_Link")
    i_knee = pf.body_names.index("knee_L_Link")
    assert pf.parent[i_abad] == 0
    assert pf.parent[i_hip] == i_abad
    assert pf.parent[i_knee] == i_hip


def test_joint_limits(pf):
    np.testing.assert_allclose(pf.effort_limit.numpy(), 80.0)
    j = dict(zip(pf.joint_names, pf.velocity_limit.tolist()))
    assert j["knee_R_Joint"] == 50.0
    assert j["knee_L_Joint"] == 20.0


def test_mass_budget(pf):
    total = float(pf.mass.sum())
    np.testing.assert_allclose(total, 8.557 + 0.01 + 2 * 4.779, atol=1e-3)
    i_knee = pf.body_names.index("knee_L_Link")
    np.testing.assert_allclose(float(pf.mass[i_knee]), 0.573 + 0.157,
                               atol=1e-4)


def test_foot_collision_sites(pf):
    feet = pf.collision_indices("foot")
    assert len(feet) == 2
    for c in feet:
        np.testing.assert_allclose(float(pf.collision_radius[c]), 0.03)
        np.testing.assert_allclose(pf.collision_offset[c].numpy(),
                                   [0.15, 0.0, -0.25981], atol=1e-5)
    assert len(pf.collision_indices("base")) == 1
    assert len(pf.collision_indices("abad")) == 2


def test_joint_axes(pf):
    ax = dict(zip(pf.joint_names, pf.joint_axis.numpy()))
    np.testing.assert_allclose(ax["abad_L_Joint"], [1, 0, 0])
    np.testing.assert_allclose(ax["hip_L_Joint"], [0, 1, 0])
    np.testing.assert_allclose(ax["knee_L_Joint"], [0, -1, 0])
    np.testing.assert_allclose(ax["hip_R_Joint"], [0, -1, 0])


def test_all_baked_models_load():
    for n in assets.available_models():
        m = assets.get_model(n)
        assert m.nb >= 7
        assert bool((m.mass >= 0).all())
