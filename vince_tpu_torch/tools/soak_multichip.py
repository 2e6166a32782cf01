#!/usr/bin/env python
"""Multi-rank soak of the production pretraining step with loss parity across
mesh shapes (counterpart of ``tools/soak_multichip.py``).

Runs the port's pretraining step as the solver runs it (augmentation on the
device, the shuffled-BN key forward, sync-BN, the queue-sharded InfoNCE with
K1 under ``--use-fused-infonce``, SGD, the EMA and the enqueue) for N steps
on each (data x queue) mesh of ``--meshes``, every mesh fed the same data
stream, and holds the loss trajectories to the first mesh's with JAX's
per-step tolerance, ``1e-3 + 5e-3·i/N`` relative, and the queue's tail and
fill count equal. The augmentation draws for the global rows and sync-BN
takes the global batch statistics, so the step does not depend on the mesh's
shape: the claim is parity to float rounding, not a statistical one.

A mesh ``DxQ`` runs D·Q processes, one rank each: ``gloo`` on the CPU
(``--platform cpu``), NCCL with one GPU a rank on the GPU; ``none`` is the
one-device step without a process group. Prints each mesh's trajectory,
ms/step and the parity lines, then ``PARITY OK`` or ``PARITY FAILED`` and
exits 0 or 1.

    python vince_tpu_torch/tools/soak_multichip.py --platform cpu --steps 5 \\
        --image 32 --queue 64 --batch 16 --embed 16 --meshes 1x1,2x1,1x2
    python vince_tpu_torch/tools/soak_multichip.py --meshes none,1x1 --steps 50 \\
        --backbone ResNet50 --image 224 --queue 65536 --batch 128 --num-frames 4 \\
        --embed 128 --compute-dtype bfloat16 --use-fused-infonce --fold-kernel \\
        --shuffle-mode a2a        # one GPU
"""

import argparse
import dataclasses
import json
import os
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

# JAX's soak: SGD at 0.03, the state and the data from seed 0, a line every 20 steps
LR = 0.03
SEED = 0
LOG_EVERY = 20


@dataclasses.dataclass(frozen=True)
class SoakOptions:
    """The step's shape and options (``tools/soak_multichip.py``'s defaults:
    ResNet18, 2-frame videos, 96², queue 8192, embeddings 64, shuffled BN
    and sync-BN)."""

    steps: int = 200
    image: int = 96
    queue: int = 8192
    batch: int = 32
    num_frames: int = 2
    embed: int = 64
    backbone: str = "ResNet18"
    compute_dtype: str = "float32"
    use_fused_infonce: bool = False
    fold_kernel: bool = False
    shuffle_mode: str = "gather"


def soak_config(opts: SoakOptions, md: int = 1, mq: int = 1):
    from vince_tpu_torch.solvers.vince_step import SourceSpec, VinceConfig

    return VinceConfig(
        sources=(SourceSpec("YT", batch_size=opts.batch, num_frames=opts.num_frames,
                            transform="StandardVideoTransform", source_id=1),),
        backbone=opts.backbone, embed_size=opts.embed, image_size=opts.image,
        queue_size=opts.queue, data_axis_size=md, queue_axis_size=mq,
        compute_dtype=torch.bfloat16 if opts.compute_dtype == "bfloat16" else torch.float32,
        shuffle_bn=True, shuffle_mode=opts.shuffle_mode, sync_bn=True, bn_fold="expand",
        stem_kind="s2d", use_fused_infonce=opts.use_fused_infonce, fold_kernel=opts.fold_kernel)


def global_batch(opts: SoakOptions, step: int, device) -> Dict[str, torch.Tensor]:
    """Step ``step``'s global batch of uint8 canvases (image / 0.875 a side),
    the same for every mesh: drawn on ``device`` from the seed and the step."""
    canvas = int(opts.image / 0.875)
    gen = torch.Generator(device=device).manual_seed(SEED * 1_000_003 + step)
    shape = (opts.batch, canvas, canvas, 3)
    return {k: torch.randint(0, 256, shape, generator=gen, device=device, dtype=torch.uint8)
            for k in ("data", "queue_data")}


def run_mesh(opts: SoakOptions, device, mesh=None) -> Dict:
    """``opts.steps`` eager train steps on this rank of ``mesh`` (None: one
    device, no collective); the losses and accuracies (averaged over the data
    axis), the queue's tail and fill count, and the ms/step after the first
    (host clock to a synchronise)."""
    from vince_tpu_torch.parallel.multihost import local_slice
    from vince_tpu_torch.solvers.vince_step import (
        build_vince_optimizer, init_vince_state, make_train_step_fn)

    md, mq = (1, 1) if mesh is None else (mesh.data_size, mesh.queue_size)
    d_idx = 0 if mesh is None else mesh.data_index
    name = "none" if mesh is None else f"{md}x{mq}"
    cfg = soak_config(opts, md, mq)
    opt = build_vince_optimizer(LR)
    state = init_vince_state(SEED, cfg, opt, device=device, mesh=mesh)
    step = make_train_step_fn(cfg, opt, mesh=mesh)
    losses, accs, ms = [], [], []
    for i in range(opts.steps):
        batch = ({k: local_slice(v, d_idx, md) for k, v in global_batch(opts, i, device).items()},)
        _sync(device)
        t0 = time.perf_counter()
        _, metrics = step(state, batch, 1)
        loss = metrics["loss/total_loss"].item()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
        accs.append(metrics["nce_accuracy"].item())
        if not np.isfinite(loss):
            raise FloatingPointError(f"[{name}] non-finite loss at step {i}")
        if (mesh is None or mesh.rank == 0) and (i % LOG_EVERY == 0
                                                  or i == opts.steps - 1):
            print(f"  [{name}] step {i:4d} loss={loss:.5f} acc={accs[-1]:.4f} "
                  f"({ms[-1]:.1f} ms)", flush=True)
    return {"mesh": name, "losses": losses, "accs": accs,
            "queue_tail": int(state.queue.tail), "queue_total": int(state.queue.total),
            "first_ms": ms[0], "ms_per_step": float(np.median(ms[1:])) if len(ms) > 1 else ms[0]}


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _rank(rank: int, world: int, md: int, mq: int, opts: SoakOptions, platform: str):
    from vince_tpu_torch.parallel.mesh import Mesh, MeshSpec
    from vince_tpu_torch.parallel.multihost import local_device

    return run_mesh(opts, local_device(platform), Mesh(MeshSpec(md, mq)))


def parse_mesh(text: str):
    """``none`` → None; ``DxQ`` → (D, Q)."""
    if text == "none":
        return None
    md, mq = (int(x) for x in text.split("x"))
    return md, mq


def run(meshes: List[Optional[tuple]], opts: SoakOptions, platform: str = "cuda") -> List[Dict]:
    """Each mesh's rank-0 result, in order: ``None`` in this process, a mesh
    in new processes (``gloo`` on the CPU, NCCL on the GPUs)."""
    from vince_tpu_torch.device import resolve_device
    from vince_tpu_torch.parallel.launch import run_ranks

    results = []
    for shape in meshes:
        label = "none" if shape is None else f"{shape[0]}x{shape[1]}"
        print(f"=== soak mesh {label}: {opts.backbone} b={opts.batch} @{opts.image}² "
              f"q={opts.queue} × {opts.steps} steps ===", flush=True)
        if shape is None:
            results.append(run_mesh(opts, resolve_device(platform)))
        else:
            md, mq = shape
            # on the CPU one thread a rank: the ranks share the host's cores
            cpu = platform == "cpu"
            results.append(run_ranks(_rank, md * mq, md, mq, opts, platform,
                                     backend="gloo" if cpu else "nccl", threads=int(cpu))[0])
    return results


def parity(results: List[Dict]) -> bool:
    """Every trajectory against the first: per-step relative gap within
    ``1e-3 + 5e-3·i/N`` and the queue's tail and fill count equal; prints a
    line for each."""
    ref, ok = results[0], True
    for r in results[1:]:
        dl = np.abs(np.array(r["losses"]) - np.array(ref["losses"]))
        rel = dl / np.maximum(np.abs(ref["losses"]), 1e-6)
        print(f"parity {r['mesh']} vs {ref['mesh']}: max|Δloss|={dl.max():.2e} "
              f"max rel={rel.max():.2e} (final {ref['losses'][-1]:.5f} vs "
              f"{r['losses'][-1]:.5f})")
        same_queue = (r["queue_tail"], r["queue_total"]) == (ref["queue_tail"],
                                                             ref["queue_total"])
        print(f"  queue tail/total match: {same_queue}")
        # float rounding compounds through SGD: the bound grows with the step
        tol = 1e-3 + 5e-3 * np.arange(len(dl)) / len(dl)
        if not (rel <= tol).all():
            bad = int(np.argmax(rel > tol))
            print(f"  !! divergence beyond tolerance at step {bad}: "
                  f"rel={rel[bad]:.2e} > {tol[bad]:.2e}")
            ok = False
        ok = ok and same_queue
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    defaults = SoakOptions()
    for f in dataclasses.fields(SoakOptions):
        flag = "--" + f.name.replace("_", "-")
        if f.type is bool:
            ap.add_argument(flag, action="store_true")
        else:
            ap.add_argument(flag, type=type(getattr(defaults, f.name)),
                            default=getattr(defaults, f.name))
    ap.add_argument("--meshes", default="1x1,2x1,1x2")
    ap.add_argument("--platform", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--json", default="")
    args = ap.parse_args(argv)
    opts = SoakOptions(**{f.name: getattr(args, f.name) for f in dataclasses.fields(SoakOptions)})
    results = run([parse_mesh(m) for m in args.meshes.split(",")], opts, args.platform)
    for r in results:
        print(f"{r['mesh']}: {r['ms_per_step']:.3f} ms/step after a first step of "
              f"{r['first_ms']:.1f} ms")
    ok = parity(results)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"options": dataclasses.asdict(opts), "results": results,
                       "parity_ok": ok}, f, indent=1)
        print(f"wrote {args.json}")
    print(f"PARITY {'OK' if ok else 'FAILED'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
