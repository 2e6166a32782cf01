"""Run a function on each rank of a new process group, one process a rank,
from one Python call: the multi-rank tools' launcher (``torchrun`` is the
CLI's).

- ``run_ranks(fn, world, *args, backend="gloo")`` spawns ``world`` processes
  (the ``spawn`` start method), each joins a group on a ``TCPStore`` at
  127.0.0.1 and calls ``fn(rank, world, *args)``; it returns their results
  by rank, and raises with every failed rank's traceback. ``fn`` must be a
  module-level function (it is pickled by name). With ``backend="nccl"``
  rank r takes GPU r.
- ``start_world_of_one(device)``: a group of this process alone, for a tool
  run in a process that has none.
"""

import os
import socket
import tempfile
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _init(backend: str, world: int, rank: int, port: int) -> None:
    if backend == "nccl":
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                            rank=rank)


def _entry(rank, world, port, out_dir, backend, threads, fn, args):
    if threads:
        torch.set_num_threads(threads)
    _init(backend, world, rank, port)
    try:
        result = fn(rank, world, *args)
        torch.save(result, os.path.join(out_dir, f"{rank}.pt"))
    except Exception:
        with open(os.path.join(out_dir, f"{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world: int, *args, backend: str = "gloo", threads: int = 0):
    """``fn(rank, world, *args)`` on each rank of a new ``world``-process
    group; the list of the results, by rank. ``threads`` > 0 sets each
    process's intra-op threads."""
    if backend == "nccl" and torch.cuda.device_count() < world:
        raise RuntimeError(f"{world} NCCL ranks need {world} GPUs, "
                           f"{torch.cuda.device_count()} present")
    with tempfile.TemporaryDirectory() as out_dir:
        try:
            mp.spawn(_entry, args=(world, free_port(), out_dir, backend, threads, fn, args),
                     nprocs=world)
        except mp.ProcessRaisedException as e:
            errors = [open(os.path.join(out_dir, n)).read() for n in sorted(os.listdir(out_dir))
                      if n.endswith(".err")]
            raise RuntimeError("a rank failed:\n" + "\n".join(errors)) from e
        return [torch.load(os.path.join(out_dir, f"{r}.pt"), weights_only=False)
                for r in range(world)]


def start_world_of_one(device: torch.device) -> None:
    """A process group of this process alone (``nccl`` for a CUDA device,
    ``gloo`` otherwise), on a ``TCPStore`` at 127.0.0.1."""
    backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    store = dist.TCPStore("127.0.0.1", free_port(), 1, is_master=True)
    dist.init_process_group(backend, store=store, rank=0, world_size=1)
