"""The port's batched Cholesky solve (ops/cuda/cholesky.py) on CPU tensors,
where it runs its plain version, vs the JAX Pallas kernel in interpret mode
(tests/test_pallas.py:14-24, :81-91), at the sizes the slice solves:
PointFoot's nv = 12 and ANYmal's nv = 18, with batches that are and are not
a multiple of the TPU kernel's 128-lane block.  Tolerance rtol/atol 3e-3,
as tests/test_pallas.py:24.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointfoot_tpu.ops.pallas.cholesky import pallas_chol_solve
from pointfoot_tpu_torch.ops import linalg
from pointfoot_tpu_torch.ops.cuda import cholesky
from pointfoot_tpu_torch.utils import profiling


def _system(seed: int, B: int, n: int):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(B, n, n)).astype(np.float32)
    A = A @ A.transpose(0, 2, 1) + n * np.eye(n, dtype=np.float32)
    return A, rng.normal(size=(B, n)).astype(np.float32)


@pytest.mark.parametrize("B,n", [(128, 12), (37, 12), (256, 18), (200, 18)])
def test_chol_solve_matches_pallas(B, n):
    A, b = _system(B + n, B, n)
    want = np.asarray(pallas_chol_solve(jnp.asarray(A), jnp.asarray(b),
                                        interpret=True))
    before = profiling.counter("kernel.chol_solve")
    got = cholesky.chol_solve(torch.from_numpy(A), torch.from_numpy(b))
    assert profiling.counter("kernel.chol_solve") == before  # plain on the CPU
    np.testing.assert_allclose(got.numpy(), want, rtol=3e-3, atol=3e-3)
    np.testing.assert_allclose(
        np.einsum("bij,bj->bi", A, got.numpy()), b, rtol=3e-3, atol=3e-3)


def test_lanes_layout_and_best_dispatch():
    A, b = _system(5, 150, 18)
    At, bt = torch.from_numpy(A), torch.from_numpy(b)
    x_t = cholesky.chol_solve_lanes(At.reshape(150, 324).t().contiguous(),
                                    bt.t().contiguous())
    assert x_t.shape == (18, 150)
    ref = linalg.chol_solve(At, bt)
    torch.testing.assert_close(x_t.t(), ref, atol=0, rtol=0)
    torch.testing.assert_close(cholesky.chol_solve_best(At, bt), ref,
                               atol=0, rtol=0)


def test_lanes_rejects_mismatched_shapes_and_devices():
    with pytest.raises(ValueError, match="does not match"):
        cholesky.chol_solve_lanes(torch.zeros(143, 4), torch.zeros(12, 4))
    with pytest.raises(ValueError, match="unsupported device"):
        cholesky.chol_solve_lanes(torch.zeros(144, 4, device="meta"),
                                  torch.zeros(12, 4, device="meta"))
