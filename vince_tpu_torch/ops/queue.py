"""The negative memory bank as a ring buffer on the device (counterpart of
``vince_tpu/ops/queue.py``), whole or sharded by rows over a mesh's queue
axis.

Unlike the JAX state, which is immutable, ``enqueue_sharded`` writes the new
rows into the bank in place and returns the same state object with the pointers
advanced: the bank is 32 MB at K=65536, D=128, and a copy per step would be
pure traffic. ``tail`` and ``total`` are int32 0-dim tensors on the bank's
device, as in JAX, so that a CUDA graph of the step replays the insert at the
pointer's current value; ``inserted`` mirrors ``total`` on the host, so that
``full`` never waits on the device.

A sharded state holds rows ``[i·K/n, (i+1)·K/n)`` of a global ring of K rows
(``num_shards`` n, shard ``i``); ``tail``, ``total`` and ``inserted`` count
global rows, and ``maxsize`` is the global K. A whole bank is the state of
one shard (JAX's ``enqueue`` is ``enqueue_sharded`` with n = 1).

``HostImageRing`` keeps a thumbnail of each row on the host, for the image
panels.
"""

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass
class QueueState:
    """[K, D] bank (or its [K/n, D] shard) + ring pointer + fill counter
    saturated at K."""

    vectors: torch.Tensor  # [K/n, D] float32, L2-normalised rows
    sources: torch.Tensor  # [K/n] int32 data-source tags (-1 = random init)
    tail: Optional[torch.Tensor] = None  # int32 0-dim: next global insert position
    total: Optional[torch.Tensor] = None  # int32 0-dim: rows inserted, saturated at K
    inserted: int = 0  # ``total`` on the host
    num_shards: int = 1  # n: the global ring is n times the rows held here

    def __post_init__(self):
        dev = self.vectors.device
        if self.tail is None:
            self.tail = torch.zeros((), dtype=torch.int32, device=dev)
        if self.total is None:
            self.total = torch.zeros((), dtype=torch.int32, device=dev)

    @property
    def maxsize(self) -> int:
        """The global K."""
        return self.vectors.shape[0] * self.num_shards

    @property
    def full(self) -> bool:
        return self.inserted >= self.maxsize

    def count_inserted(self, rows: int) -> None:
        """Advance the host mirror of ``total`` by ``rows`` (the device pointers
        move in ``enqueue_sharded``; a replayed graph moves them without
        Python)."""
        self.inserted = min(self.inserted + rows, self.maxsize)


def init_queue(generator: torch.Generator, maxsize: int, feat_size: int,
               device=None, shard_index: int = 0, num_shards: int = 1) -> QueueState:
    """Random L2-normalised rows, drawn from ``generator`` (on its device) for
    the whole ring, of which the state keeps shard ``shard_index``: every mesh
    starts from the same global bank."""
    v = torch.randn(maxsize, feat_size, generator=generator,
                    device=generator.device, dtype=torch.float32)
    v = v / torch.linalg.norm(v, dim=-1, keepdim=True)
    device = generator.device if device is None else device
    rows = maxsize // num_shards
    return QueueState(
        vectors=v[shard_index * rows:(shard_index + 1) * rows].to(device),
        sources=torch.full((rows,), -1, dtype=torch.int32, device=device),
        num_shards=num_shards,
    )


@torch.no_grad()
def enqueue_sharded(state: QueueState, items: torch.Tensor, source: Optional[int] = None, *,
                    shard_index: int = 0, num_shards: int = 1) -> QueueState:
    """Insert the global rows ``items`` [B, D] into the global ring of which
    ``state`` holds shard ``shard_index`` of ``num_shards``, in place. Every
    rank computes the same global positions; the rows that land outside its
    shard are dropped by masks on the device, with no read of the pointers
    on the host, so that a CUDA graph replays it. With one shard every row
    is kept: the insert with modular wraparound of JAX's ``enqueue``.

    The rows' global positions are consecutive, so when B fits in a shard
    they are distinct modulo the shard's size: each row goes to that
    position, and a dropped row writes back the value it found there. A
    larger B rewrites the shard, each row from the item that lands on it or
    from itself."""
    if state.num_shards != num_shards:
        raise ValueError(f"the state holds 1 of {state.num_shards} shards, not of {num_shards}")
    rows = state.vectors.shape[0]
    k = state.maxsize
    b = items.shape[0]
    assert b <= k, f"enqueue batch {b} larger than queue {k}"
    dev = state.vectors.device
    items = items.to(state.vectors.dtype)
    tag = torch.full((b,), 0 if source is None else int(source), dtype=torch.int32, device=dev)
    if b <= rows:
        glob = (state.tail + torch.arange(b, device=dev)) % k
        pos = glob % rows
        keep = (glob >= shard_index * rows) & (glob < (shard_index + 1) * rows)
        vectors = torch.where(keep[:, None], items, state.vectors[pos])
        sources = torch.where(keep, tag, state.sources[pos])
        state.vectors.index_copy_(0, pos, vectors)
        state.sources.index_copy_(0, pos, sources)
    else:
        item = (shard_index * rows + torch.arange(rows, device=dev) - state.tail) % k
        hit = item < b
        item = item.clamp(max=b - 1)
        state.vectors.copy_(torch.where(hit[:, None], items[item], state.vectors))
        state.sources.copy_(torch.where(hit, tag[item], state.sources))
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
