"""The CUDA kernels of the port against their plain PyTorch versions.

Needs an NVIDIA GPU with nvcc; skips without one.  On the card (which has no
JAX, so the repo's conftest files are bypassed):

    python -m pytest --noconftest -o addopts="" -m cuda \\
        tests/test_torch_cuda_kernels.py
"""

import numpy as np
import pytest
import torch

from pointfoot_tpu_torch.ops.cuda import substep as sp
from pointfoot_tpu_torch.physics.assets import get_model

pytestmark = pytest.mark.cuda

# not a multiple of the 128-thread block: the last block has idle threads
B = 1000


@pytest.fixture(scope="module")
def rows():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    mc = sp.model_consts(get_model("pointfoot"))
    rng = np.random.default_rng(1)

    def r(n, s, o=0.0):
        return o + s * rng.standard_normal((n, B))

    q = r(4, 0.1)
    q[3] += 1.0
    q /= np.linalg.norm(q, axis=0)
    state = np.concatenate([r(2, 0.5), 0.42 + 0.25 * rng.random((1, B)), q,
                            r(3, 0.5), r(3, 0.8), r(6, 0.4), r(6, 1.5),
                            r(6, 1.5)])
    ctrl = np.concatenate([
        r(6, 0.5), np.full((6, B), 40.0), np.full((6, B), 1.5),
        0.2 + 1.2 * rng.random((9, B)), 0.1 * rng.random((6, B)),
        r(1, 0.5), r(3, 0.03), np.full((1, B), 1.2e4),
        np.full((1, B), 1.2e3), r(3, 20.0)])
    n = r(3, 0.15)
    n[2] = 1.0
    n /= np.linalg.norm(n, axis=0)
    surf = np.concatenate([r(9, 0.03), np.tile(n, (9, 1))])
    dev = torch.device("cuda")
    return mc, tuple(torch.tensor(a, dtype=torch.float32, device=dev)
                     for a in (state, ctrl, surf))


@pytest.mark.parametrize("control_type", ["P", "V", "T"])
@pytest.mark.parametrize("surface", [True, False])
@pytest.mark.parametrize("push", [True, False])
def test_rollout_step_kernel_matches_plain(rows, control_type, surface,
                                           push):
    mc, (state, ctrl, surf) = rows
    args = (mc, state, ctrl, surf if surface else None, push,
            (0.1, 0.0, -0.1, 0.0, 0.2, 0.0), 0.5, control_type, 0.005, 9.81)
    before = sp.rollout_step.launches
    ks, ke = sp.rollout_step(*args)
    assert sp.rollout_step.launches == before + 1
    ps, pe = sp.rollout_step_plain(*args)
    torch.cuda.synchronize()
    nj, nc = mc.nj, mc.nc
    torch.testing.assert_close(ks, ps, atol=2e-3, rtol=0)
    torch.testing.assert_close(ke[:nj], pe[:nj], atol=5e-3, rtol=0)
    torch.testing.assert_close(ke[nj:nj + 3 * nc], pe[nj:nj + 3 * nc],
                               atol=0.05, rtol=1e-3)
    torch.testing.assert_close(ke[nj + 3 * nc:], pe[nj + 3 * nc:],
                               atol=5e-5, rtol=0)


def test_fk_kernel_matches_plain(rows):
    mc, (state, _, _) = rows
    before = sp.fk_rows.launches
    got = sp.fk_rows(mc, state)
    assert sp.fk_rows.launches == before + 1
    torch.testing.assert_close(got, sp.fk_rows_plain(mc, state), atol=2e-5,
                               rtol=0)


def test_wrapper_rejects_bad_rows(rows):
    mc, (state, ctrl, surf) = rows
    with pytest.raises(ValueError, match="contiguous"):
        sp.fk_rows(mc, state.t().contiguous().t())
    with pytest.raises(ValueError, match="ctrl_rows"):
        sp.rollout_step(mc, state, ctrl[:-1], surf, True, (0.0,) * 6, 0.5,
                        "P", 0.005, 9.81)
