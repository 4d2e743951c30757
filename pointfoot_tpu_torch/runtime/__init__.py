"""Native (C++) host-side runtime (pointfoot_tpu/runtime/): async
trajectory recording and replay, and the dependency-free deployment
policy runner."""

from pointfoot_tpu_torch.runtime.policy import NativePolicy
from pointfoot_tpu_torch.runtime.recorder import TrajectoryRecorder, read_log

__all__ = ["TrajectoryRecorder", "read_log", "NativePolicy"]
