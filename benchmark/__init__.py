"""The benchmark of the PyTorch/CUDA port (pointfoot_tpu_torch); see
README.md."""
