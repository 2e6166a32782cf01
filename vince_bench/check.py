"""The comparison that decides ``correct``: the program's first steps against
the plain reference's, from the same weights, queue, frames and seed.

Both sides hand in readings (``reference/step.py::follow`` describes them);
each number below is a gap that the cell's limits file bounds:

- ``loss``: the mean over the compared steps of the relative gap of a
  step's total loss (the mean, and not the largest, because the program's
  gap grows with each bfloat16 update while a fault's is in every step).
- ``grad``: the worst leaf's gap between the two norms of the first step's
  gradient, over the larger of that leaf's reference norm and the median
  leaf's. The median is over the leaves whose reference gradient is not 0:
  at the start every block's last BatchNorm has the scale 0, so the layers
  before it in the block take no gradient at the first step.
- ``change``: the same of each leaf's change after the last compared step,
  the key encoder's leaves with the query encoder's. A leaf whose largest
  reference gradient over the compared steps is under a thousandth of the
  median leaf's would move by round-off and weight decay alone and is left
  out.
- ``keys``: the largest distance between a key row the program enqueued and
  the reference's (both unit rows).
"""

import math
import statistics
from typing import Dict

import torch

NUMBERS = ("loss", "grad", "change", "keys")
STILL_LEAF = 1e-3  # a leaf's reference gradient under this share of the median's


def _worst(gaps) -> float:
    """The largest gap; NaN if any is (Python's ``max`` may skip a NaN)."""
    gaps = list(gaps)
    return math.nan if any(math.isnan(g) for g in gaps) else max(gaps)


def _norm_gap(prog: Dict[str, float], ref: Dict[str, float], leaves) -> float:
    median = statistics.median(ref[k] for k in leaves if ref[k] > 0)
    return _worst(abs(prog[k] - ref[k]) / max(ref[k], median) for k in leaves)


def numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """The gaps of ``prog``'s readings from ``ref``'s; NaN where the program's
    readings are not finite, which no limit admits."""
    if set(prog["grad"]) != set(ref["grad"]) or set(prog["change"]) != set(ref["change"]):
        raise ValueError("the program and the reference hold different leaves")
    gaps = [abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"])]
    out = {"loss": sum(gaps) / len(gaps) if len(gaps) == len(ref["losses"]) else math.nan}
    out["grad"] = _norm_gap(prog["grad"], ref["grad"], list(ref["grad"]))
    grad_max = ref["grad_max"]
    median = statistics.median(grad_max.values())
    moving = [k for k in ref["change"]
              if grad_max[k.removeprefix("key.")] >= STILL_LEAF * median]
    out["change"] = _norm_gap(prog["change"], ref["change"], moving)
    keys_p, keys_r = prog["keys"].float(), ref["keys"].float()
    out["keys"] = (_worst(torch.linalg.vector_norm(keys_p - keys_r, dim=1).tolist())
                   if keys_p.shape == keys_r.shape else math.nan)
    return {k: (v if math.isfinite(v) else math.nan) for k, v in out.items()}


def verdict(nums: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number within its limit (a NaN is not)."""
    return all(nums[k] <= limits[k] for k in limits)
