"""Learning-rate schedule (counterpart of ``vince_tpu/utils/schedules.py``):
cosine or step decay by epoch, with a linear warmup over the first 500
iterations, as a function of the global step."""

import math
from typing import Sequence

WARMUP_ITERATIONS = 500


def vince_lr_schedule(
    base_lr: float,
    epochs: int,
    iterations_per_epoch: int,
    decay_type: str = "cos",
    step_schedule: Sequence[int] = (120, 160),
    use_warmup: bool = True,
    warmup_iterations: int = WARMUP_ITERATIONS,
):
    step_schedule = tuple(step_schedule)
    if decay_type not in ("cos", "step"):
        raise ValueError(f"unknown lr decay type {decay_type!r}")

    def schedule(step: int) -> float:
        epoch = math.floor(step / iterations_per_epoch)
        if decay_type == "cos":
            lr = base_lr * 0.5 * (1.0 + math.cos(math.pi * epoch / epochs))
        else:
            lr = base_lr * 0.1 ** sum(epoch >= m for m in step_schedule)
        if use_warmup:
            lr *= min(1.0, (step + 1.0) / warmup_iterations)
        return lr

    return schedule
