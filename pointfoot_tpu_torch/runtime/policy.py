"""ctypes bindings for the C++ deployment policy runner
(pointfoot_tpu/runtime/policy.py).

`src/policy_runner.cpp`, a byte copy of the JAX package's source, is the
robot-side inference stack: it decodes the `.onnx` actor that
export/onnx_writer.py writes (the Gemm / activation subset torch emits for
MLPs) and runs the forward pass with no dependency.  Built with g++ on
first use into the package's `_build/` (runtime/native.py), a plain C ABI
like recorder.py.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from pointfoot_tpu_torch.runtime.native import build_library

_SRC = os.path.join(os.path.dirname(__file__), "src", "policy_runner.cpp")

_lib = None


def _load_lib():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build_library(_SRC, "policyrunner"))
        lib.pr_load.restype = ctypes.c_void_p
        lib.pr_load.argtypes = [ctypes.c_char_p]
        lib.pr_obs_dim.restype = ctypes.c_int
        lib.pr_obs_dim.argtypes = [ctypes.c_void_p]
        lib.pr_act_dim.restype = ctypes.c_int
        lib.pr_act_dim.argtypes = [ctypes.c_void_p]
        lib.pr_num_layers.restype = ctypes.c_int
        lib.pr_num_layers.argtypes = [ctypes.c_void_p]
        lib.pr_run.restype = ctypes.c_int
        lib.pr_run.argtypes = [
            ctypes.c_void_p,
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
            ctypes.c_int,
        ]
        lib.pr_free.argtypes = [ctypes.c_void_p]
        _lib = lib
    return _lib


class NativePolicy:
    """A loaded .onnx actor running through the C++ forward pass; takes
    and returns float32 numpy arrays, (obs_dim,) or (N, obs_dim)."""

    def __init__(self, path: str):
        self._lib = _load_lib()
        self._h = self._lib.pr_load(path.encode())
        if not self._h:
            raise ValueError(f"could not parse ONNX policy at {path}")
        self.obs_dim = self._lib.pr_obs_dim(self._h)
        self.act_dim = self._lib.pr_act_dim(self._h)
        self.num_layers = self._lib.pr_num_layers(self._h)

    def __call__(self, obs: np.ndarray) -> np.ndarray:
        obs = np.ascontiguousarray(obs, np.float32)
        squeeze = obs.ndim == 1
        if squeeze:
            obs = obs[None]
        if obs.shape[-1] != self.obs_dim:
            raise ValueError(f"expected obs dim {self.obs_dim}, "
                             f"got {obs.shape[-1]}")
        out = np.empty((obs.shape[0], self.act_dim), np.float32)
        rc = self._lib.pr_run(self._h, obs, out, obs.shape[0])
        if rc != 0:
            raise RuntimeError("pr_run failed")
        return out[0] if squeeze else out

    def close(self):
        if getattr(self, "_h", None):
            self._lib.pr_free(self._h)
            self._h = None

    def __del__(self):  # interpreter teardown
        try:
            self.close()
        except (AttributeError, TypeError, OSError):
            pass
