"""Packaging (reference setup.py parity — installable with pip install -e).

Core deps are the JAX stack baked into the TPU image; torch is optional
(policy export only), matplotlib optional (dashboards).
"""

from setuptools import find_packages, setup

setup(
    name="pointfoot_tpu",
    version="0.1.0",
    author="pointfoot-tpu authors",
    license="BSD-3-Clause",
    packages=find_packages(include=["pointfoot_tpu", "pointfoot_tpu.*",
                                    "pointfoot_tpu_torch",
                                    "pointfoot_tpu_torch.*"]),
    package_data={"pointfoot_tpu.physics": ["_assets/*.json"],
                  "pointfoot_tpu.runtime": ["src/*.cpp"],
                  "pointfoot_tpu_torch": ["csrc/*.cu", "csrc/*.cuh", "csrc/*.h",
                                          "_weights/*.npz"],
                  "pointfoot_tpu_torch.physics": ["_assets/*.json"]},
    python_requires=">=3.10",
    install_requires=["jax", "flax", "optax", "orbax-checkpoint", "numpy"],
    extras_require={
        "export": ["torch"],
        "torch": ["torch"],  # the PyTorch/CUDA port, pointfoot_tpu_torch
        "viz": ["matplotlib"],
        "dev": ["pytest"],
    },
    description="TPU-native legged-robot RL / MPC / sys-ID framework "
                "(capabilities of peachvegetable/pointfoot, re-designed "
                "for JAX/XLA/Pallas)",
)
