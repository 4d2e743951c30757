"""The numbers that decide `correct`: the port's recorded iterations against
the reference's, from the same seed.

- `loss`: each recorded iteration's loss, |port - ref| / |ref|, the worst
  iteration.
- `grad_first`: the first gradient as the optimizer got it, by the worst
  leaf: the gap between the port's norm of a leaf and the reference's, not
  the norm of their difference, over the larger of the reference's norm of
  that leaf and of the median leaf.
- `param_change`: the parameters' change over the recorded iterations, by
  the worst leaf as `grad_first`.
- `rollout`: the first iteration's rollout storage (observations,
  privileged observations, actions, rewards, dones, values, log-probs), the
  worst field's sum |port - ref| / sum |ref|.

A driver may compare the first iteration on its own too (`FIRST`), where
rounding that the second iteration amplifies leaves `loss` and
`param_change` loose limits:

- `loss_first`: the first iteration's loss, as `loss`;
- `param_change_first`: the parameters' change over the first iteration,
  as `param_change`.

Leaves whose first gradient in the reference is under a thousandth of the
median leaf's are left out of `grad_first` and `param_change`: Adam moves
them by round-off alone.  A leaf the port leaves unmoved where the
reference moves it reads 1; one it moves double reads 1.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional

import torch

NUMBERS = ("loss", "grad_first", "param_change", "rollout")
FIRST = ("loss_first", "param_change_first")
NEGLIGIBLE_GRAD = 1e-3  # of the median leaf's first-gradient norm


def _norms(leaves: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double()))
            for k, v in leaves.items()}


def _median(values: Iterable[float]) -> float:
    v = sorted(values)
    return v[len(v) // 2] if v else 0.0


def moving_leaves(ref_grad: Dict[str, torch.Tensor]):
    """The leaves whose reference first gradient is not negligible."""
    n = _norms(ref_grad)
    floor = NEGLIGIBLE_GRAD * _median(n.values())
    return sorted(k for k, v in n.items() if v >= floor)


def worst_leaf_gap(prog: Dict[str, torch.Tensor],
                   ref: Dict[str, torch.Tensor], keys) -> float:
    rn = _norms({k: ref[k] for k in keys})
    pn = {k: (float(torch.linalg.vector_norm(prog[k].double()))
              if k in prog else 0.0) for k in keys}
    med = _median(rn.values())
    if not keys:
        return float("inf")
    return max(abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30) for k in keys)


def change(rec, after: str = "params") -> Dict[str, torch.Tensor]:
    params = getattr(rec, after)
    return {k: params[k] - rec.params0[k] for k in params}


def _loss_gap(p: float, r: float) -> float:
    return abs(p - r) / max(abs(r), 1e-30)


def _finite(nums: Dict[str, float]) -> Dict[str, float]:
    return {k: (v if v == v else float("inf")) for k, v in nums.items()}


def numbers(prog, ref) -> Dict[str, float]:
    """The four numbers of `prog` (the port's record) against `ref`."""
    keys = moving_leaves(ref.grad_first)
    out = {}
    out["loss"] = (max(_loss_gap(p, r)
                       for p, r in zip(prog.losses, ref.losses))
                   if prog.losses and len(prog.losses) == len(ref.losses)
                   else float("inf"))
    out["grad_first"] = worst_leaf_gap(prog.grad_first, ref.grad_first, keys)
    out["param_change"] = worst_leaf_gap(change(prog), change(ref), keys)
    gaps = []
    for f, r in ref.rollout.items():
        p = prog.rollout.get(f)
        if p is None or p.shape != r.shape:
            gaps.append(float("inf"))
            continue
        den = float(r.double().abs().sum())
        gaps.append(float((p.double() - r.double()).abs().sum())
                    / max(den, 1e-30))
    out["rollout"] = max(gaps)
    return _finite(out)


def first_numbers(prog, ref) -> Dict[str, float]:
    """The first iteration's numbers (`FIRST`) of `prog` against `ref`."""
    keys = moving_leaves(ref.grad_first)
    return _finite({
        "loss_first": (_loss_gap(prog.losses[0], ref.losses[0])
                       if prog.losses and ref.losses else float("inf")),
        "param_change_first": worst_leaf_gap(
            change(prog, "params_first"), change(ref, "params_first"),
            keys)})


def verdict(nums: Dict[str, float], limits: Optional[Dict[str, float]]
            ) -> bool:
    """Every number within its limit: a NaN, a number without a limit or
    a limit without its number fails."""
    if not limits or set(nums) != set(limits):
        return False
    return all(nums[k] <= limits[k] for k in nums)
