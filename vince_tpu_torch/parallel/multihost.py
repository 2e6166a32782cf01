"""Multi-process runtime (counterpart of ``vince_tpu/parallel/multihost.py``):
one process per GPU over ``torch.distributed``.

- ``initialize``: ``init_process_group`` when ``--distributed`` is set, from
  the three explicit flags (all or none of them) or from the environment that
  ``torchrun`` sets. The backend follows the device: ``nccl`` for CUDA,
  ``gloo`` for the CPU.
- ``local_device``: this process's GPU, ``cuda:{LOCAL_RANK}`` or
  ``process_index % device_count``.
- ``process_count``, ``process_index``, ``is_primary``, ``is_multiprocess``.
- ``broadcast_host``: process 0's host tree to every process.
- ``fetch``: an all-gather to host numpy.
- ``host_allsum`` and ``sync`` (a barrier).

With one process every helper is the plain local computation, as in JAX. JAX's
``stage``, ``global_from_full_host``, ``place`` and ``local_view`` move host
values into and out of global arrays that span processes; here each process
holds only its own tensors, and each of them becomes "take this rank's slice"
(``local_slice``): a batch is loaded by its data index, a queue bank held in
full is cut to the rank's shard. No sharding object is ported.
"""

import os

import numpy as np
import torch
import torch.distributed as dist

from vince_tpu_torch.parallel.collectives import _gather

_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def backend_for(device_type: str) -> str:
    return "nccl" if device_type == "cuda" else "gloo"


def initialize(args) -> bool:
    """Start the process group when ``args.distributed`` is set and none is
    running; True if this call started it.

    A manual cluster gives all three of ``--coordinator-address`` (host:port
    of process 0), ``--num-processes`` and ``--process-id``; ``torchrun``
    gives its environment instead. Anything else raises, as JAX does for
    partial flags: a half-configured run would train alone on a slice of the
    batch.
    """
    if not getattr(args, "distributed", False) or dist.is_initialized():
        return False
    coord = getattr(args, "coordinator_address", "") or None
    nproc = getattr(args, "num_processes", 0) or 0
    pid = getattr(args, "process_id", -1)
    if coord or nproc or pid >= 0 or not all(k in os.environ for k in _TORCHRUN_ENV):
        if not (coord and nproc and pid >= 0):
            raise ValueError(
                "manual clusters need all three of --coordinator-address, "
                f"--num-processes, --process-id (got {coord!r}, {nproc}, {pid}); "
                "or launch with torchrun, which sets " + ", ".join(_TORCHRUN_ENV))
        kwargs = dict(init_method=f"tcp://{coord}", world_size=nproc, rank=pid)
    else:
        kwargs = dict(init_method="env://")
    platform = getattr(args, "platform", "cuda")
    if platform == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass --platform cpu for gloo")
        rank = pid if pid >= 0 else int(os.environ["RANK"])
        torch.cuda.set_device(_local_index(rank))
    dist.init_process_group(backend_for(platform), **kwargs)
    print(f"distributed: process {process_index()}/{process_count()}, backend "
          f"{dist.get_backend()}, device {local_device(platform)}")
    return True


def _local_index(rank: int) -> int:
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return rank % torch.cuda.device_count()


def local_device(platform: str = "cuda") -> torch.device:
    """This process's device: its GPU, or the CPU for ``platform="cpu"``."""
    if platform != "cuda":
        return torch.device(platform)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
    return torch.device("cuda", _local_index(process_index()) if is_multiprocess()
                        else torch.cuda.current_device())


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_primary() -> bool:
    """True on the process that logs, profiles and writes checkpoints."""
    return process_index() == 0


def is_multiprocess() -> bool:
    return process_count() > 1


def _comm_device() -> torch.device:
    """Where a host value crosses the wire: NCCL moves device tensors only."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def broadcast_host(tree):
    """Process 0's host tree (picklable) to every process; the identity with
    one process."""
    if not is_multiprocess():
        return tree
    box = [tree]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def fetch(x: torch.Tensor, group=None) -> np.ndarray:
    """Each member's [b, ...] gathered along rows in rank order, as host numpy
    on every member (over ``group``, default every process)."""
    if group is None:
        if not is_multiprocess():
            return x.detach().cpu().numpy()
        group = dist.group.WORLD
    return _gather(x.detach(), group).cpu().numpy()


def host_allsum(values) -> np.ndarray:
    """A flat list of host floats summed over the processes, in float64."""
    arr = np.asarray(values, np.float64)
    if not is_multiprocess():
        return arr
    t = torch.from_numpy(arr.copy()).to(_comm_device())
    dist.all_reduce(t)
    return t.cpu().numpy()


def sync(name: str = "sync") -> None:
    """A barrier over every process (nothing with one process)."""
    if is_multiprocess():
        dist.barrier()


def local_slice(x, index: int, parts: int):
    """Rows ``[index·n, (index+1)·n)`` of ``x``, n = len(x) / parts: this
    rank's share of a value held in full."""
    n = x.shape[0] // parts
    if n * parts != x.shape[0]:
        raise ValueError(f"{x.shape[0]} rows do not split into {parts} parts")
    return x[index * n:(index + 1) * n]


def shutdown() -> None:
    """Destroy the process group, if one was started."""
    if dist.is_initialized():
        dist.destroy_process_group()

