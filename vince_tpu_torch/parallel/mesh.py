"""The (data, queue) device mesh over ``torch.distributed`` (counterpart of
``vince_tpu/parallel/mesh.py``): one process per GPU, each a point of a
2-axis logical mesh.

- ``data``: the batch axis. Ranks along it hold other rows of the batch;
  gradients are averaged over it.
- ``queue``: the axis the negative queue is sharded over. Ranks along it hold
  the same rows of the batch and other rows of the queue; the softmax over the
  queue is merged across it (``ops/sharded_infonce.py``).

Rank ``r`` sits at ``(d, q) = (r // mq, r % mq)``, the order of JAX's
``reshape(data, queue)`` of the device list. Its **data group** is the ranks
with its ``q`` and its **queue group** the ranks with its ``d``; a group's
ranks are in the order of the other coordinate, so a rank's index in its data
group is ``d`` and in its queue group ``q``.

``mesh=None`` is the single-device code, which calls no collective. A 1×1
``Mesh`` calls every collective over a world of one.

The models name the axis their BatchNorm synchronises over
(``VinceEncoder(bn_axis_name=DATA_AXIS)``), as the JAX modules do; a step
binds its mesh with ``bind`` while it runs them, and ``axis_group`` looks the
name up. Outside a bound mesh every axis has one member, and no collective
runs.
"""

import contextlib
import dataclasses
import threading
from typing import Optional

import torch.distributed as dist

DATA_AXIS = "data"
QUEUE_AXIS = "queue"


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    data_axis_size: int
    queue_axis_size: int = 1

    @property
    def num_devices(self) -> int:
        return self.data_axis_size * self.queue_axis_size


class Mesh:
    """This rank's place in a (data, queue) mesh over the default process
    group, with the groups of its two axes. Every rank must build the mesh,
    and it does: ``dist.new_group`` is called by every rank for every group,
    in one order, as ``torch.distributed`` requires."""

    def __init__(self, spec: MeshSpec):
        if not dist.is_initialized():
            raise RuntimeError("a Mesh needs torch.distributed's process group "
                               "(multihost.initialize, or init_process_group)")
        world = dist.get_world_size()
        if spec.num_devices != world:
            raise ValueError(f"mesh {spec.data_axis_size}x{spec.queue_axis_size} needs "
                             f"{spec.num_devices} processes, the group has {world}")
        self.spec = spec
        md, mq = spec.data_axis_size, spec.queue_axis_size
        self.rank = dist.get_rank()
        self.data_index, self.queue_index = divmod(self.rank, mq)
        self.world_group = dist.group.WORLD
        self.data_group = self.queue_group = None
        for q in range(mq):
            group = dist.new_group([d * mq + q for d in range(md)])
            if q == self.queue_index:
                self.data_group = group
        for d in range(md):
            group = dist.new_group([d * mq + q for q in range(mq)])
            if d == self.data_index:
                self.queue_group = group

    @property
    def data_size(self) -> int:
        return self.spec.data_axis_size

    @property
    def queue_size(self) -> int:
        return self.spec.queue_axis_size

    def group(self, axis: str):
        if axis == DATA_AXIS:
            return self.data_group
        if axis == QUEUE_AXIS:
            return self.queue_group
        raise ValueError(f"unknown mesh axis {axis!r}; choices: {DATA_AXIS}, {QUEUE_AXIS}")

    def queue_source_rank(self) -> int:
        """The global rank of this data row's first queue shard (q = 0)."""
        return self.data_index * self.queue_size

    def __repr__(self):
        return (f"Mesh({self.data_size}x{self.queue_size}, rank {self.rank} at "
                f"(d={self.data_index}, q={self.queue_index}))")


_bound = threading.local()


@contextlib.contextmanager
def bind(mesh: Optional[Mesh]):
    """Make ``mesh`` the one whose axes ``axis_group`` resolves, on this
    thread, for the duration (``None`` binds nothing)."""
    previous = getattr(_bound, "mesh", None)
    _bound.mesh = mesh
    try:
        yield mesh
    finally:
        _bound.mesh = previous


def bound_mesh() -> Optional[Mesh]:
    """The mesh bound on this thread, or None."""
    return getattr(_bound, "mesh", None)


def axis_group(axis_name: Optional[str]):
    """The process group of ``axis_name`` in the bound mesh; None (an axis of
    one member, no collective) without a name or a bound mesh."""
    mesh = bound_mesh()
    if axis_name is None or mesh is None:
        return None
    return mesh.group(axis_name)
