"""Real-robot data (pointfoot_tpu/sysid/realdata.py), numpy only.

`real_to_tensor` loads the npy-of-dicts format a rosbag reader writes (each
entry a dict whose 'obs' holds the 27 proprioceptive observations first);
`categorize_data_by_cmd` buckets observations by their trailing command
triple; `read_rosbag` converts a bag the same way where the `rosbag`
package is installed.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Tuple

import numpy as np


def real_to_tensor(real_data_file: str) -> np.ndarray:
    """npy of dicts -> (N, 1, 27) float32 array."""
    real_data = np.load(real_data_file, allow_pickle=True)
    rows = [np.asarray(entry["obs"][:27], np.float32) for entry in real_data]
    return np.stack(rows)[:, None, :]


def categorize_data_by_cmd(data: np.ndarray
                           ) -> Dict[Tuple[float, ...], np.ndarray]:
    """Bucket (N, 1, D) observations by their last three entries, the
    command, as float64 rounded to 6 places."""
    buckets = defaultdict(list)
    for obs in data:
        cmd = tuple(np.round(np.asarray(obs[0, -3:], np.float64), 6).tolist())
        buckets[cmd].append(obs)
    return {k: np.stack(v) for k, v in buckets.items()}


def read_rosbag(bag_path: str, topic: str = "/obs_topic",
                out_npy: str | None = None) -> np.ndarray:
    """rosbag -> npy-of-dicts, saved to `out_npy` when given."""
    try:
        import rosbag  # type: ignore
    except ImportError as e:
        raise ImportError(
            "rosbag is not installed; convert the bag offline to the "
            "npy-of-dicts format and use real_to_tensor()") from e
    entries = []
    with rosbag.Bag(bag_path) as bag:
        for _topic, msg, _t in bag.read_messages(topics=[topic]):
            entries.append({"obs": np.asarray(msg.data, np.float32)})
    arr = np.asarray(entries, dtype=object)
    if out_npy:
        np.save(out_npy, arr)
    return arr
