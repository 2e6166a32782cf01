"""The negative memory bank as a ring buffer on the device (counterpart of
``vince_tpu/ops/queue.py``, unsharded).

Unlike the JAX state, which is immutable, ``enqueue`` writes the new rows
into the bank in place and returns the same state object with the pointers
advanced: the bank is 32 MB at K=65536, D=128, and a copy per step would be
pure traffic. ``tail`` and ``total`` are host integers, so stepping the queue
never waits on the device.
"""

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass
class QueueState:
    """[K, D] bank + ring pointer + fill counter saturated at K."""

    vectors: torch.Tensor  # [K, D] float32, L2-normalised rows
    sources: torch.Tensor  # [K] int32 data-source tags (-1 = random init)
    tail: int = 0  # next insert position
    total: int = 0  # rows inserted so far, saturated at K

    @property
    def maxsize(self) -> int:
        return self.vectors.shape[0]

    @property
    def full(self) -> bool:
        return self.total >= self.maxsize


def init_queue(generator: torch.Generator, maxsize: int, feat_size: int,
               device=None) -> QueueState:
    """Random L2-normalised rows, drawn from ``generator`` (on its device)."""
    v = torch.randn(maxsize, feat_size, generator=generator,
                    device=generator.device, dtype=torch.float32)
    v = v / torch.linalg.norm(v, dim=-1, keepdim=True)
    device = generator.device if device is None else device
    return QueueState(
        vectors=v.to(device),
        sources=torch.full((maxsize,), -1, dtype=torch.int32, device=device),
    )


@torch.no_grad()
def enqueue(state: QueueState, items: torch.Tensor,
            source: Optional[int] = None) -> QueueState:
    """Insert ``items`` [B, D] at the tail with modular wraparound, in place."""
    k = state.maxsize
    b = items.shape[0]
    assert b <= k, f"enqueue batch {b} larger than queue {k}"
    idx = (state.tail + torch.arange(b, device=state.vectors.device)) % k
    state.vectors.index_copy_(0, idx, items.to(state.vectors.dtype))
    state.sources.index_fill_(0, idx, 0 if source is None else int(source))
    state.tail = (state.tail + b) % k
    state.total = min(state.total + b, k)
    return state
