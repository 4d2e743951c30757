"""`train_mfu`: the whole iteration's share of the card's float32 peak
(67 TFLOP/s, TF32 off): the policy and value networks' FLOPs an iteration,
counted from the configuration's widths (benchmark/counts.py), over the
traced window's mean iteration time.  Physics and terrain are not
counted.  Percent."""

from benchmark import counts


def read(obs):
    peak = counts.PEAKS.get(obs.get("device_name"), {}).get("fp32_flops")
    t = obs.get("iteration_s")
    if not peak or not t:
        return None
    flops = counts.network_flops_per_iteration(
        obs["config"], obs["envs"] * obs["ranks"])
    return 100.0 * flops / t / (peak * obs["ranks"])
