#!/usr/bin/env python
"""One real step of the pretraining step on an N-rank mesh (counterpart of
``__graft_entry__.py``'s ``dryrun_multichip``): augmentation on the device,
the shuffled-BN key forward, the queue-sharded InfoNCE, SGD, the EMA and the
enqueue, at JAX's shapes: a queue axis of 2 when N is even and above 1, the
data axis the rest; a video source (2 videos of 2 frames a data index) and
an ImageNet source with the CE decoders (2 images a data index), self-batch
InfoNCE; ResNet18, 32², embeddings 16, a queue of 64 a queue index.

Under a running group (``torchrun``, or a caller's) it takes that group's
ranks, N of them; else it spawns N ranks: NCCL, one GPU each, or ``gloo``
on the CPU with ``--platform cpu``. Prints, on rank 0,
``dryrun_multichip(N): mesh=(D x Q) total_loss=... OK``.

    python vince_tpu_torch/tools/dryrun_multichip.py 4 --platform cpu
    python vince_tpu_torch/tools/dryrun_multichip.py 4      # four GPUs
    torchrun --nproc-per-node=4 vince_tpu_torch/tools/dryrun_multichip.py 4
"""

import argparse
import math
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))


def mesh_shape(n_devices: int):
    """JAX's choice: (n/2, 2) for an even n above 1, else (n, 1)."""
    mq = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    return n_devices // mq, mq


def dryrun_config(md: int, mq: int):
    from vince_tpu_torch.solvers.vince_step import SourceSpec, VinceConfig

    nf = 2
    return VinceConfig(
        sources=(SourceSpec("YT", batch_size=md * nf * 2, num_frames=nf, source_id=1),
                 SourceSpec("IN", batch_size=md * 2, num_frames=1, use_imagenet_ce=True,
                            transform="BasicImagenetTransform", source_id=0)),
        backbone="ResNet18", embed_size=16, image_size=32, queue_size=64 * mq,
        data_axis_size=md, queue_axis_size=mq, self_batch=True)


def dryrun_rank(rank: int, world: int, device=None) -> str:
    """The step on this rank of the mesh of ``world`` processes; the line."""
    from vince_tpu_torch.parallel.mesh import Mesh, MeshSpec
    from vince_tpu_torch.parallel.multihost import local_device, local_slice
    from vince_tpu_torch.solvers.vince_step import (
        build_vince_optimizer, init_vince_state, make_train_step_fn)

    if device is None:
        device = local_device("cuda" if dist.get_backend() == "nccl" else "cpu")
    md, mq = mesh_shape(world)
    mesh = Mesh(MeshSpec(md, mq))
    cfg = dryrun_config(md, mq)
    opt = build_vince_optimizer(0.03)
    state = init_vince_state(0, cfg, opt, device=device, mesh=mesh)
    step = make_train_step_fn(cfg, opt, mesh=mesh)
    rng = np.random.RandomState(0)
    batch = []
    for src in cfg.sources:
        arrays = {k: rng.randint(0, 256, (src.batch_size, 36, 36, 3), np.uint8)
                  for k in ("data", "queue_data")}
        if src.use_imagenet_ce:
            arrays["labels"] = np.zeros((src.batch_size,), np.int32)
        batch.append({k: torch.from_numpy(local_slice(v, mesh.data_index, md)).to(device)
                      for k, v in arrays.items()})
    _, metrics = step(state, tuple(batch), 1)
    loss = metrics["loss/total_loss"].item()
    if not math.isfinite(loss) or state.step != 1:
        raise RuntimeError(f"dryrun_multichip({world}): step {state.step}, metrics {metrics}")
    return f"dryrun_multichip({world}): mesh=({md}x{mq}) total_loss={loss:.4f} OK"


def dryrun_multichip(n_devices: int, device=None, platform: str = "cuda") -> str:
    """One step on an ``n_devices``-rank mesh: the running group's ranks (its
    size must be ``n_devices``), else ``n_devices`` new ranks, NCCL on the
    GPUs or ``gloo`` on the CPU (``platform="cpu"``). Prints and returns rank
    0's line."""
    if dist.is_initialized():
        if dist.get_world_size() != n_devices:
            raise ValueError(f"the running group has {dist.get_world_size()} ranks, not "
                             f"{n_devices}")
        line = dryrun_rank(dist.get_rank(), n_devices, device)
        if dist.get_rank() != 0:
            return line
    else:
        from vince_tpu_torch.parallel.launch import run_ranks

        cpu = platform == "cpu"
        line = run_ranks(dryrun_rank, n_devices, backend="gloo" if cpu else "nccl",
                         threads=int(cpu))[0]
    print(line)
    return line


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_devices", type=int, nargs="?", default=8)
    ap.add_argument("--platform", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    started = "WORLD_SIZE" in os.environ
    if started:
        # torchrun's environment gives the group
        if args.platform == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group("nccl" if args.platform == "cuda" else "gloo",
                                init_method="env://")
    try:
        dryrun_multichip(args.n_devices, platform=args.platform)
    finally:
        if started:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
