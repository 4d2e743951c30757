"""System identification (pointfoot_tpu/sysid): the GAN, the WGAN-GP and
the supervised LSTM identifier, with the simulator in-process; the GANs'
generator gradients flow through the simulator itself."""

from pointfoot_tpu_torch.sysid.gan import GANTrainer
from pointfoot_tpu_torch.sysid.identifier import IdentifierTrainer
from pointfoot_tpu_torch.sysid.realdata import (categorize_data_by_cmd,
                                                real_to_tensor)
from pointfoot_tpu_torch.sysid.simulate import (chunk_windows,
                                                simulate_trajectory)
from pointfoot_tpu_torch.sysid.wgan import WGANTrainer

__all__ = ["simulate_trajectory", "chunk_windows", "real_to_tensor",
           "categorize_data_by_cmd", "GANTrainer", "WGANTrainer",
           "IdentifierTrainer"]
