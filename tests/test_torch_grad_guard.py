"""The CUDA kernels are forward-only, as the TPU kernels are (on the CPU).

Each of the six wrappers refuses, in its CUDA branch, inputs that require
grad while grad mode is on (ops/cuda/_grad.refuse_grad), instead of
returning a result without a `grad_fn`; its CPU branch is the plain
version, which differentiates, with the gradient held to `jax.grad` of the
JAX reference.
"""

import inspect
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointfoot_tpu.physics import rowdyn as jr
from pointfoot_tpu.physics.assets import get_model as jax_model
from pointfoot_tpu_torch.ops.cuda import cholesky as ch
from pointfoot_tpu_torch.ops.cuda import riccati as rk
from pointfoot_tpu_torch.ops.cuda import substep as sp
from pointfoot_tpu_torch.ops.cuda._grad import refuse_grad
from pointfoot_tpu_torch.physics.assets import get_model
from pointfoot_tpu_torch.utils import profiling

WRAPPERS = [(sp.rollout_step, "rollout_substep_kernel"),
            (sp.fk_rows, "fk_from_state_kernel"),
            (sp.step_rows, "substep_kernel"),
            (sp.fk_xy_rows, "fk_contact_xy_kernel"),
            (ch.chol_solve_lanes, "chol_solve_kernel"),
            (rk.srb_lqr_lanes, "srb_lqr_kernel")]
# float32 gradients of a sum over the spheres, entries up to a few metres
GRAD_TOL = 1e-5


def _leaf(*shape):
    return torch.ones(*shape, requires_grad=True)


@pytest.mark.parametrize("tensors", [
    (_leaf(3, 4),),
    (torch.ones(3, 4), None, _leaf(2)),
    (None, torch.ones(3, 4) * _leaf(1)),  # not a leaf, still needs grad
], ids=["leaf", "second-of-three", "non-leaf"])
def test_guard_raises_for_an_input_that_requires_grad(tensors):
    with pytest.raises(RuntimeError) as info:
        refuse_grad("fk_from_state_kernel", "fk_rows_plain", *tensors)
    msg = str(info.value)
    assert "fk_from_state_kernel has no backward pass" in msg
    assert "TPU kernel" in msg and "`fk_rows_plain`" in msg
    assert "CPU" in msg and "torch.no_grad()" in msg


@pytest.mark.parametrize("mode", ["no_grad", "inference_mode", "no input",
                                  "detached"])
def test_guard_passes_without_a_gradient_to_build(mode):
    x = _leaf(3, 4)
    if mode == "no_grad":
        with torch.no_grad():
            refuse_grad("k", "k_plain", x, None)
    elif mode == "inference_mode":
        with torch.inference_mode():
            refuse_grad("k", "k_plain", x, None)
            refuse_grad("k", "k_plain", x * 2.0)
    elif mode == "no input":
        refuse_grad("k", "k_plain", torch.ones(3), None, torch.zeros(2))
    else:
        refuse_grad("k", "k_plain", x.detach())


def test_guard_raises_for_a_forward_tangent():
    """A dual tensor of torch.autograd.forward_ad would lose its tangent in
    the kernel just as a tensor that requires grad loses its graph: the
    guard raises, under no_grad too; the primal and plain tensors pass."""
    import torch.autograd.forward_ad as fwAD

    with fwAD.dual_level():
        dual = fwAD.make_dual(torch.ones(3, 4), torch.ones(3, 4))
        for ctx in (torch.enable_grad, torch.no_grad):
            with ctx(), pytest.raises(RuntimeError) as info:
                refuse_grad("srb_lqr_kernel", "srb_lqr_lanes_plain", None,
                            torch.ones(2), dual * 2.0)
            msg = str(info.value)
            assert "srb_lqr_kernel has no backward pass" in msg
            assert "forward-mode tangent" in msg
            assert "`srb_lqr_lanes_plain`" in msg
        refuse_grad("k", "k_plain", torch.ones(3), None)
        refuse_grad("k", "k_plain", fwAD.unpack_dual(dual).primal)
    refuse_grad("k", "k_plain", torch.ones(3))


def _cuda_branch(fn) -> str:
    """The source of fn after its CPU branch returns the plain version."""
    src = inspect.getsource(fn)
    m = re.search(r'if dev\.type == "cpu":\n\s+return \w+\(.*\)\n', src)
    assert m, fn.__name__
    return src[m.end():]


@pytest.mark.parametrize("fn, kernel", WRAPPERS,
                         ids=[k for _, k in WRAPPERS])
def test_each_wrapper_refuses_grad_before_its_first_allocation(fn, kernel):
    """The guard is called in the CUDA branch, names the wrapper's kernel
    and plain version, and comes before the first torch.empty (and before
    the launch); the branch never calls the plain version."""
    branch = _cuda_branch(fn)
    call = branch.index(f'refuse_grad("{kernel}", "{fn.__name__}_plain"')
    assert call < branch.index("torch.empty")
    assert call < branch.index('profiling.count("kernel.')
    assert f"{fn.__name__}_plain(" not in branch


@pytest.fixture
def as_if_on_the_card(monkeypatch):
    """The substep wrappers take the CUDA branch for CPU tensors, and fail
    loudly if they get as far as loading a kernel library."""
    def library(mc):
        raise LookupError("reached the kernel library")

    monkeypatch.setattr(sp, "_device", lambda name, t: torch.device("cuda"))
    monkeypatch.setattr(sp, "_library", library)


def _substep_calls(mc):
    nj, nc = mc.nj, mc.nc
    B = 3
    state = torch.zeros(sp._rows(sp.state_layout(nj)), B)
    ctrl = torch.zeros(sp._rows(sp.ctrl_layout(nj, nc)), B)
    sub_in = torch.zeros(sp._rows(sp.substep_in_layout(nj, nc)), B)
    fk_in = torch.zeros(sp._rows(sp.fk_in_layout(nj)), B)
    qdef = (0.0,) * nj
    return {
        "rollout_step": lambda g: sp.rollout_step(
            mc, state, ctrl * g, None, True, qdef, 0.5, "P", 0.005, 9.81),
        "fk_rows": lambda g: sp.fk_rows(mc, state * g),
        "step_rows": lambda g: sp.step_rows(mc, sub_in * g, None, 0.005,
                                            9.81),
        "fk_xy_rows": lambda g: sp.fk_xy_rows(mc, fk_in * g),
    }


@pytest.mark.parametrize("name", ["rollout_step", "fk_rows", "step_rows",
                                  "fk_xy_rows"])
def test_substep_wrappers_refuse_on_the_cuda_branch(as_if_on_the_card,
                                                    name):
    """With a grad-carrying input the CUDA branch raises before it loads
    a library, and does not fall back to the plain version; without one,
    or under no_grad, it goes on to the kernel."""
    call = _substep_calls(sp.model_consts(get_model("pointfoot")))[name]
    with pytest.raises(RuntimeError, match="has no backward pass"):
        call(_leaf(1))
    with pytest.raises(LookupError):
        call(torch.ones(1))
    with torch.no_grad(), pytest.raises(LookupError):
        call(_leaf(1))


@pytest.mark.parametrize("name", ["rollout_step", "fk_rows", "step_rows",
                                  "fk_xy_rows"])
def test_substep_wrappers_refuse_a_tangent_on_the_cuda_branch(
        as_if_on_the_card, name):
    """With an input carrying a forward-mode tangent the CUDA branch raises
    before it loads a library; the CPU branch is the plain version, which
    carries the tangent."""
    import torch.autograd.forward_ad as fwAD

    call = _substep_calls(sp.model_consts(get_model("pointfoot")))[name]
    with fwAD.dual_level(), torch.no_grad():
        g = fwAD.make_dual(torch.ones(1), torch.ones(1))
        with pytest.raises(RuntimeError, match="forward-mode tangent"):
            call(g)


def test_plain_branch_carries_a_tangent():
    """On CPU tensors a wrapper is its plain version: the tangent of a
    dual input comes out (the sphere-xyz FK, d/dz of the base height)."""
    import torch.autograd.forward_ad as fwAD

    mc = sp.model_consts(get_model("pointfoot"))
    state = torch.zeros(sp._rows(sp.state_layout(mc.nj)), 3)
    state[6] = 1.0  # unit quaternion w
    tangent = torch.zeros_like(state)
    tangent[2] = 1.0  # the base z of every env
    with fwAD.dual_level():
        out = sp.fk_rows(mc, fwAD.make_dual(state, tangent))
        t = fwAD.unpack_dual(out).tangent
    z = t.view(mc.nc, 3, -1)[:, 2]
    assert torch.equal(z, torch.ones_like(z))


# ------------------------------- the plain route differentiates, as JAX

def _pose(robot: str, B: int, seed: int):
    """base_pos, base_quat (unit) and qpos rows, float32, from a seed."""
    nj = get_model(robot).nj
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((4, B)) * 0.2
    q[3] += 1.0
    q /= np.linalg.norm(q, axis=0)
    return (rng.standard_normal((3, B)).astype(np.float32),
            q.astype(np.float32),
            (0.5 * rng.standard_normal((nj, B))).astype(np.float32))


def _jax_grad(robot: str, pos, quat, qpos):
    mc = jr.ModelConsts(jax_model(robot))

    def z_sum(quat_rows, qpos_rows):
        st = {"base_pos": list(jnp.asarray(pos)),
              "base_quat": list(quat_rows), "qpos": list(qpos_rows)}
        return sum(jnp.sum(p[2]) for p in jr.fk_contact_pos(mc, st))

    g_quat, g_qpos = jax.grad(z_sum, argnums=(0, 1))(jnp.asarray(quat),
                                                     jnp.asarray(qpos))
    return np.asarray(g_quat), np.asarray(g_qpos)


@pytest.mark.parametrize("robot", ["pointfoot", "anymal_c", "a1"])
def test_plain_fk_rows_gradient_matches_jax(robot):
    """d(sum of sphere z)/d(base_quat, qpos) through the port's CPU
    `fk_rows` (the plain version) equals jax.grad through the JAX
    rowdyn.fk_contact_pos, from the same numpy state, within GRAD_TOL."""
    B = 5
    pos, quat, qpos = _pose(robot, B, seed=len(robot))
    mc = sp.model_consts(get_model(robot))
    t_quat = torch.tensor(quat, requires_grad=True)
    t_qpos = torch.tensor(qpos, requires_grad=True)
    nj = mc.nj
    rest = torch.zeros(6 + 2 * nj, B)  # velocities, qvel, last_qvel
    state = torch.cat([torch.tensor(pos), t_quat, rest[:6], t_qpos,
                       rest[6:]])
    before = profiling.counter("kernel.fk_from_state")
    xyz = sp.fk_rows(mc, state)
    assert profiling.counter("kernel.fk_from_state") == before
    assert xyz.grad_fn is not None
    xyz[2::3].sum().backward()
    want_quat, want_qpos = _jax_grad(robot, pos, quat, qpos)
    assert np.abs(want_qpos).max() > 0.05  # the legs move the spheres' z
    np.testing.assert_allclose(t_quat.grad.numpy(), want_quat, rtol=0,
                               atol=GRAD_TOL)
    np.testing.assert_allclose(t_qpos.grad.numpy(), want_qpos, rtol=0,
                               atol=GRAD_TOL)


def test_jax_grad_through_a_pallas_kernel_raises():
    """The behaviour the port copies: the JAX reference's Pallas kernels
    define no backward pass, so jax.grad through one (interpret mode on
    the CPU) raises rather than returning a gradient."""
    from pointfoot_tpu.ops.pallas.cholesky import pallas_chol_solve_lanes

    n, B = 6, 4
    rng = np.random.default_rng(0)
    M = rng.standard_normal((B, n, n)).astype(np.float32)
    A = M @ M.transpose(0, 2, 1) + n * np.eye(n, dtype=np.float32)
    A_t = jnp.asarray(A.reshape(B, n * n).T)
    b_t = jnp.asarray(rng.standard_normal((n, B)).astype(np.float32))

    def loss(b):
        return jnp.sum(pallas_chol_solve_lanes(A_t, b, interpret=True))

    assert np.isfinite(float(loss(b_t)))
    with pytest.raises(ValueError, match="Linearization failed"):
        jax.grad(loss)(b_t)
