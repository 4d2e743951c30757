"""The sys-ID network zoo (pointfoot_tpu/models), as nn.Modules."""

from pointfoot_tpu_torch.models.nets import (AttentionModel, LSTMIdentifier,
                                             MLPCritic, MLPDiscriminator,
                                             MLPGenerator,
                                             TransformerDiscriminator,
                                             TransformerGenerator)

__all__ = ["MLPGenerator", "MLPDiscriminator", "MLPCritic", "LSTMIdentifier",
           "AttentionModel", "TransformerGenerator", "TransformerDiscriminator"]
