"""ctypes bindings for the C++ async trajectory recorder
(pointfoot_tpu/runtime/recorder.py).

`src/trajectory_log.cpp` is a byte copy of the JAX package's source,
built with g++ on first use into the package's `_build/` (runtime/native.py)
— no pybind11, a plain C ABI.  See the .cpp header comment for the design;
the Python side adds a numpy-friendly API and a reader of the binary log
format, which both packages share.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import numpy as np

from pointfoot_tpu_torch.runtime.native import build_library

_SRC = os.path.join(os.path.dirname(__file__), "src", "trajectory_log.cpp")

_MAGIC = 0x544C4F47

_lib: Optional[ctypes.CDLL] = None


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build_library(_SRC, "trajlog", ("-pthread",)))
        lib.tlog_open.restype = ctypes.c_void_p
        lib.tlog_open.argtypes = [ctypes.c_char_p, ctypes.c_uint32,
                                  ctypes.c_uint32]
        lib.tlog_push.restype = ctypes.c_int
        lib.tlog_push.argtypes = [ctypes.c_void_p,
                                  ctypes.POINTER(ctypes.c_float)]
        lib.tlog_push_n.restype = ctypes.c_int
        lib.tlog_push_n.argtypes = [ctypes.c_void_p,
                                    ctypes.POINTER(ctypes.c_float),
                                    ctypes.c_uint32]
        lib.tlog_written.restype = ctypes.c_uint64
        lib.tlog_written.argtypes = [ctypes.c_void_p]
        lib.tlog_dropped.restype = ctypes.c_uint64
        lib.tlog_dropped.argtypes = [ctypes.c_void_p]
        lib.tlog_flush.argtypes = [ctypes.c_void_p]
        lib.tlog_close.argtypes = [ctypes.c_void_p]
        _lib = lib
    return _lib


class TrajectoryRecorder:
    """Non-blocking float-record logger backed by the C++ writer thread.

    >>> rec = TrajectoryRecorder("run.tlog", record_size=27)
    >>> rec.push(obs_row)          # (27,) float array; never blocks
    >>> rec.push_batch(obs_block)  # (N, 27)
    >>> rec.close()

    Rows may be numpy arrays or CPU tensors.
    """

    def __init__(self, path: str, record_size: int, capacity: int = 1 << 16):
        self._lib = _load()
        self.record_size = record_size
        self._h = self._lib.tlog_open(path.encode(), record_size, capacity)
        if not self._h:
            raise OSError(f"tlog_open failed for {path}")

    def push(self, row) -> bool:
        row = np.ascontiguousarray(row, np.float32)
        if row.size != self.record_size:
            raise ValueError(f"record of {row.size} floats, expected "
                             f"{self.record_size}")
        ptr = row.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        return bool(self._lib.tlog_push(self._h, ptr))

    def push_batch(self, block) -> int:
        block = np.ascontiguousarray(block, np.float32)
        if block.ndim != 2 or block.shape[1] != self.record_size:
            raise ValueError(f"block of shape {block.shape}, expected "
                             f"(N, {self.record_size})")
        ptr = block.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        return int(self._lib.tlog_push_n(self._h, ptr, block.shape[0]))

    @property
    def written(self) -> int:
        return int(self._lib.tlog_written(self._h))

    @property
    def dropped(self) -> int:
        return int(self._lib.tlog_dropped(self._h))

    def flush(self):
        self._lib.tlog_flush(self._h)

    def close(self):
        if self._h:
            self._lib.tlog_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_log(path: str) -> Tuple[np.ndarray, int]:
    """Read a .tlog file -> ((N, record_size) float32 array, record_size)."""
    with open(path, "rb") as f:
        header = np.fromfile(f, np.uint32, 4)
        if header.size < 4 or header[0] != _MAGIC:
            raise ValueError(f"{path}: not a TLOG file")
        record_size = int(header[2])
        data = np.fromfile(f, np.float32)
    n = data.size // record_size
    return data[: n * record_size].reshape(n, record_size), record_size
