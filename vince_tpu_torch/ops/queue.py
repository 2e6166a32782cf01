"""The negative memory bank as a ring buffer on the device (counterpart of
``vince_tpu/ops/queue.py``, unsharded).

Unlike the JAX state, which is immutable, ``enqueue`` writes the new rows
into the bank in place and returns the same state object with the pointers
advanced: the bank is 32 MB at K=65536, D=128, and a copy per step would be
pure traffic. ``tail`` and ``total`` are int32 0-dim tensors on the bank's
device, as in JAX, so that a CUDA graph of the step replays the insert at the
pointer's current value; ``inserted`` mirrors ``total`` on the host, so that
``full`` never waits on the device.

``HostImageRing`` keeps a thumbnail of each row on the host, for the image
panels.
"""

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass
class QueueState:
    """[K, D] bank + ring pointer + fill counter saturated at K."""

    vectors: torch.Tensor  # [K, D] float32, L2-normalised rows
    sources: torch.Tensor  # [K] int32 data-source tags (-1 = random init)
    tail: Optional[torch.Tensor] = None  # int32 0-dim: next insert position
    total: Optional[torch.Tensor] = None  # int32 0-dim: rows inserted, saturated at K
    inserted: int = 0  # ``total`` on the host

    def __post_init__(self):
        dev = self.vectors.device
        if self.tail is None:
            self.tail = torch.zeros((), dtype=torch.int32, device=dev)
        if self.total is None:
            self.total = torch.zeros((), dtype=torch.int32, device=dev)

    @property
    def maxsize(self) -> int:
        return self.vectors.shape[0]

    @property
    def full(self) -> bool:
        return self.inserted >= self.maxsize

    def count_inserted(self, rows: int) -> None:
        """Advance the host mirror of ``total`` by ``rows`` (the device pointers
        move in ``enqueue``; a replayed graph moves them without Python)."""
        self.inserted = min(self.inserted + rows, self.maxsize)


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
    """Insert ``items`` [B, D] at the tail with modular wraparound, in place,
    with no read of the pointers on the host."""
    k = state.maxsize
    b = items.shape[0]
    assert b <= k, f"enqueue batch {b} larger than queue {k}"
    idx = (state.tail + torch.arange(b, device=state.vectors.device)) % k
    state.vectors.index_copy_(0, idx, items.to(state.vectors.dtype))
    state.sources.index_fill_(0, idx, 0 if source is None else int(source))
    state.tail.add_(b).remainder_(k)
    state.total.add_(b).clamp_(max=k)
    state.count_inserted(b)
    return state


class HostImageRing:
    """Host-side ring of uint8 thumbnails that mirrors the device queue row
    for row: the same capacity and tail arithmetic, written every step in the
    order the step inserts its keys, so that a panel's "queue" neighbours
    show the negatives that were scored. After a restore the device bank is
    back but the images are not: ``clear(tail)`` puts the pointer back and
    leaves the unknown rows None (panels draw them black)."""

    def __init__(self, maxsize: int):
        self.maxsize = maxsize
        self.images = [None] * maxsize
        self.sources = [None] * maxsize
        self.tail = 0

    def enqueue(self, images, source: str):
        for im in images:
            self.images[self.tail] = np.asarray(im)
            self.sources[self.tail] = source
            self.tail = (self.tail + 1) % self.maxsize

    def fill_repeat(self, images, sources):
        """As the queue's prefill: the thumbnails tiled over the whole ring,
        the tail at 0."""
        n = len(images)
        for i in range(self.maxsize):
            self.images[i] = np.asarray(images[i % n])
            self.sources[i] = sources[i % n]
        self.tail = 0

    def clear(self, tail: int = 0):
        self.images = [None] * self.maxsize
        self.sources = [None] * self.maxsize
        self.tail = tail % self.maxsize
