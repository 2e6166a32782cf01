"""Momentum (EMA) update of the key encoder (counterpart of
``vince_tpu/ops/ema.py``): θ_k ← m·θ_k + (1−m)·θ_q over the tracked subset.

It updates the key tensors in place under ``torch.no_grad()``; the JAX
version returns a new tree.
"""

from typing import Sequence

import torch


@torch.no_grad()
def ema_update(key_tensors: Sequence[torch.Tensor], query_tensors: Sequence[torch.Tensor],
               momentum: float) -> None:
    key_tensors = list(key_tensors)
    query = [q.to(k.dtype) for k, q in zip(key_tensors, query_tensors)]
    torch._foreach_mul_(key_tensors, momentum)
    torch._foreach_add_(key_tensors, query, alpha=1.0 - momentum)
