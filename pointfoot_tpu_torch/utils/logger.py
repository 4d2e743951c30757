"""Episode state and reward logger with a matplotlib dashboard
(pointfoot_tpu/utils/logger.py).

Accumulates per-step state values and episode reward means during play or
evaluation and renders the 3x3 diagnostic dashboard (velocities and
commands, joint state, torques, contact forces) to a file.  Tensors are
logged as numpy arrays after `.cpu()`; matplotlib is imported only when
the dashboard is drawn.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict

import numpy as np
import torch


def _numpy(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


class Logger:
    def __init__(self, dt: float):
        self.dt = dt
        self.state_log: Dict[str, list] = defaultdict(list)
        self.rew_log: Dict[str, list] = defaultdict(list)
        self.num_episodes = 0

    def log_state(self, key: str, value):
        self.state_log[key].append(_numpy(value))

    def log_states(self, d: Dict):
        for k, v in d.items():
            self.log_state(k, v)

    def log_rewards(self, d: Dict, num_episodes: int):
        for k, v in d.items():
            if "rew" in k:
                self.rew_log[k].append(float(_numpy(v)) * num_episodes)
        self.num_episodes += num_episodes

    def reset(self):
        self.state_log.clear()
        self.rew_log.clear()
        self.num_episodes = 0

    def print_rewards(self):
        print("Average rewards per second:")
        for k, values in self.rew_log.items():
            mean = np.sum(np.array(values)) / max(self.num_episodes, 1)
            print(f" - {k}: {mean}")
        print(f"Total number of episodes: {self.num_episodes}")

    def plot_states(self, out_path: str = "play_dashboard.png"):
        """The 3x3 dashboard rendered to a PNG; returns its path."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        log = {k: np.asarray(v) for k, v in self.state_log.items()}
        nb = len(log["base_vel_x"]) if "base_vel_x" in log else 0
        time = np.linspace(0, nb * self.dt, nb)
        fig, axs = plt.subplots(3, 3, figsize=(14, 9))

        def plot(ax, keys, title, ylabel):
            for k, label in keys:
                if k in log and len(log[k]):
                    ax.plot(time[: len(log[k])], log[k], label=label)
            ax.set(title=title, xlabel="time [s]", ylabel=ylabel)
            ax.legend(fontsize=7)

        plot(axs[0, 0], [("base_vel_x", "measured"), ("command_x", "commanded")],
             "Base velocity x", "[m/s]")
        plot(axs[0, 1], [("base_vel_y", "measured"), ("command_y", "commanded")],
             "Base velocity y", "[m/s]")
        plot(axs[0, 2], [("base_vel_yaw", "measured"),
                         ("command_yaw", "commanded")],
             "Base velocity yaw", "[rad/s]")
        plot(axs[1, 0], [("base_vel_z", "measured")], "Base velocity z", "[m/s]")
        plot(axs[1, 1], [("dof_pos", "measured"), ("dof_pos_target", "target")],
             "DOF Position", "[rad]")
        plot(axs[1, 2], [("dof_vel", "measured")], "Joint Velocity", "[rad/s]")
        plot(axs[2, 0], [("dof_torque", "measured")], "Joint Torque", "[Nm]")
        if "contact_forces_z" in log and len(log["contact_forces_z"]):
            forces = np.stack(log["contact_forces_z"])
            for i in range(forces.shape[1]):
                axs[2, 1].plot(time[: forces.shape[0]], forces[:, i],
                               label=f"force {i}")
            axs[2, 1].set(title="Vertical Contact forces", xlabel="time [s]",
                          ylabel="[N]")
            axs[2, 1].legend(fontsize=7)
        plot(axs[2, 2], [("dof_torque", "torque")], "Torque/velocity", "[Nm]")
        fig.tight_layout()
        fig.savefig(out_path, dpi=110)
        plt.close(fig)
        return out_path
