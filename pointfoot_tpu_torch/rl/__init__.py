"""On-policy RL: the actor-critics, PPO and the runner (pointfoot_tpu/rl/).

The JAX package also exports `TrainState`, the flax/optax state its PPO
passes around; the port has no counterpart to export: its PPO holds the
network's parameters, a `torch.optim.Adam` and the learning rate itself
(`PPO.state_dict` gives them as one dict).
"""

from pointfoot_tpu_torch.rl.networks import ActorCritic, ActorCriticRecurrent
from pointfoot_tpu_torch.rl.ppo import PPO
from pointfoot_tpu_torch.rl.runner import OnPolicyRunner

__all__ = ["ActorCritic", "ActorCriticRecurrent", "PPO", "OnPolicyRunner"]
