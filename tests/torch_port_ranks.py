"""Rank functions of the port's multi-process tests, and the spawner that runs
them: each rank is a process of a ``gloo`` group on the CPU.

This module imports neither JAX nor a test's fixtures: a spawned process
imports the module that defines its target, and the ranks run the port
alone. The tests compute the JAX side in their own process and hand the
ranks numpy inputs through files.
"""

import os
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from vince_tpu_torch.parallel.launch import free_port, run_ranks


def spawn(fn, world: int, *args):
    """Run ``fn(rank, world, *args)`` in ``world`` processes of one gloo group,
    one intra-op thread each; the list of their results, by rank."""
    return run_ranks(fn, world, *args, threads=1)


def spawn_processes(fn, world: int, *args):
    """As ``spawn``, for a ``fn`` that starts the group itself (the CLI):
    ``fn(rank, world, port, *args)``."""
    with tempfile.TemporaryDirectory() as out_dir:
        mp.spawn(_entry_no_group, args=(world, free_port(), out_dir, fn, args), nprocs=world)
        return [torch.load(os.path.join(out_dir, f"{r}.pt"), weights_only=False)
                for r in range(world)]


def _entry_no_group(rank, world, port, out_dir, fn, args):
    torch.set_num_threads(1)
    torch.save(fn(rank, world, port, *args), os.path.join(out_dir, f"{rank}.pt"))


def _numpy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy().copy()
    if isinstance(x, dict):
        return {k: _numpy(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_numpy(v) for v in x)
    return x


# ------------------------------------------------------------- collectives
def collectives_rank(rank, world, x_global, perm, sigma, tau, weights):
    """The collectives on this rank's rows of ``x_global`` [B, D]: gather,
    shuffle, unshuffle, the a2a shuffle and its round trip, and the
    gradients of the differentiable psum and all_gather under the loss
    Σ weights·f(x); and the host helpers of ``multihost`` over every
    process: ``fetch``, ``broadcast_host``, ``host_allsum`` and ``sync``."""
    from vince_tpu_torch.parallel import collectives as C
    from vince_tpu_torch.parallel import multihost

    group = dist.group.WORLD
    b = x_global.shape[0] // world
    x = torch.from_numpy(x_global[rank * b:(rank + 1) * b])
    perm, sigma, tau = (torch.from_numpy(a) for a in (perm, sigma, tau))
    out = {
        "gather": C.gather_global_batch(x, group),
        "shuffle": C.cross_device_shuffle(x, perm, group),
        "a2a": C.cross_device_shuffle_a2a(x, sigma, tau, group),
    }
    out["unshuffle"] = C.cross_device_unshuffle(out["a2a"], perm, group)
    xg = x.clone().requires_grad_(True)
    (C.psum(xg, group) * torch.from_numpy(weights[rank * b:(rank + 1) * b])).sum().backward()
    out["psum_grad"] = xg.grad
    xg = x.clone().requires_grad_(True)
    (C.gather_global_batch(xg, group) * torch.from_numpy(weights)).sum().backward()
    out["gather_grad"] = xg.grad
    out["pmax"] = C.pmax(x, group)
    multihost.sync()
    out["fetch"] = multihost.fetch(x)
    out["broadcast"] = multihost.broadcast_host({"rank": rank, "rows": [rank] * 3})
    out["allsum"] = multihost.host_allsum([rank, 1.5])
    return _numpy(out)


# --------------------------------------------------------------------- CLI
def cli_rank(rank, world, port, argv):
    """``solver_runner.main`` as process ``rank`` of a ``world``-process run;
    the solver's step, its queue shard and the query encoder's tensors."""
    from vince_tpu_torch import solver_runner

    solver = solver_runner.main(argv + [
        "--distributed", "--coordinator-address", f"127.0.0.1:{port}",
        "--num-processes", str(world), "--process-id", str(rank)])
    return _numpy({"step": solver.state.step, "queue": solver.state.queue.vectors,
                   "tail": solver.state.queue.tail, "model": solver.state.model.state_dict(),
                   "mesh": (solver.cfg.data_axis_size, solver.cfg.queue_axis_size)})


# ---------------------------------------------------------- sharded InfoNCE
def sharded_infonce_rank(rank, world, q, kb, mask, queue, temperature):
    """The queue-sharded InfoNCE on a 1 x ``world`` mesh, unfused and fused
    (K1's plain version on the CPU): the loss and metrics, and the gradients
    w.r.t. q and the keys of loss / mq summed over the queue axis, as the
    step takes them."""
    from vince_tpu_torch.ops.sharded_infonce import sharded_multi_pair_infonce
    from vince_tpu_torch.parallel.collectives import flat_all_reduce_
    from vince_tpu_torch.parallel.mesh import Mesh, MeshSpec
    from vince_tpu_torch.parallel.multihost import local_slice

    mesh = Mesh(MeshSpec(1, world))
    shard = torch.from_numpy(local_slice(queue, mesh.queue_index, world))
    out = {}
    for fused in (False, True):
        qt = torch.from_numpy(q).requires_grad_(True)
        kt = torch.from_numpy(kb).requires_grad_(True)
        res = sharded_multi_pair_infonce(qt, kt, torch.from_numpy(mask), temperature,
                                         queue_shard=shard, use_fused_queue_kernel=fused,
                                         queue_group=mesh.queue_group)
        (res["dist"] / world).backward()
        grads = [qt.grad, kt.grad]
        flat_all_reduce_(grads, mesh.queue_group)
        out[fused] = _numpy({**res, "dq": grads[0], "dk": grads[1]})
    return out


# ------------------------------------------------------------------ sync-BN
def _grads_sum(module, group):
    from vince_tpu_torch.parallel.collectives import flat_all_reduce_

    grads = {k: p.grad for k, p in module.named_parameters() if p.grad is not None}
    flat_all_reduce_(list(grads.values()), group)
    return grads


def sync_bn_forward(module, x, weights, mesh=None):
    """A train-mode forward of ``module`` on ``x`` under ``mesh``, and the
    backward of Σ weights·out: the output, the running averages, the input's
    gradient and the parameters' (summed over the data axis)."""
    from vince_tpu_torch.parallel.mesh import bind

    x = x.clone().requires_grad_(True)
    with bind(mesh):
        out = module(x)
    out = out["embeddings"] if isinstance(out, dict) else out
    (out.float() * weights).sum().backward()
    stats = {k: v for k, v in module.state_dict().items() if k.endswith(("running_mean",
                                                                           "running_var"))}
    grads = ({k: p.grad for k, p in module.named_parameters() if p.grad is not None}
             if mesh is None else _grads_sum(module, mesh.data_group))
    return _numpy({"out": out, "stats": stats, "dx": x.grad, "grads": grads})


def sync_bn_block(axis_name=None):
    """A ResNet50 stage-2 bottleneck whose bn2 → relu → conv3 → bn3 chain is a
    K2 site (C = 128, F = 512), weights from a fixed seed."""
    from vince_tpu_torch.models.resnet import BatchNorm, Bottleneck

    block = Bottleneck(256, 128, downsample=True, fold=True, fold_kernel=True,
                       norm=lambda *a, **k: BatchNorm(*a, axis_name=axis_name, **k))
    for m in block.modules():
        if m is not block and hasattr(m, "reset_parameters"):
            m.reset_parameters(torch.Generator().manual_seed(0))
    for m in block.modules():  # a nonzero bn3 scale, so that K2's moments reach the loss
        if isinstance(m, BatchNorm):
            with torch.no_grad():
                m.weight.fill_(0.7)
    return block.train()


def sync_bn_rank(rank, world, encoders, images, weights, block_x, block_w):
    """Sync-BN on a ``world`` x 1 mesh: each ``encoders`` entry (bn_fold, its
    state dict) as a ResNet18 ``VinceEncoder`` on the rank's rows of
    ``images``, and the K2 bottleneck on its rows of ``block_x``."""
    from vince_tpu_torch.models.vince_model import VinceEncoder
    from vince_tpu_torch.parallel.mesh import DATA_AXIS, Mesh, MeshSpec
    from vince_tpu_torch.parallel.multihost import local_slice

    mesh = Mesh(MeshSpec(world, 1))

    def mine(a):
        return torch.from_numpy(local_slice(a, mesh.data_index, world))

    out = {}
    for bn_fold, state_dict in encoders.items():
        enc = VinceEncoder("ResNet18", 16, bn_fold=bn_fold, bn_axis_name=DATA_AXIS)
        enc.load_state_dict({k: torch.from_numpy(v) for k, v in state_dict.items()})
        out[bn_fold] = sync_bn_forward(enc.train(), mine(images), mine(weights), mesh)
    out["block"] = sync_bn_forward(sync_bn_block(DATA_AXIS), mine(block_x), mine(block_w), mesh)
    return out


# ---------------------------------------------------------------- mesh step
def mesh_step_rank(rank, world, md, mq, cfg_kwargs, tree, batches, perms, what=("train",)):
    """The port's steps on an ``md`` x ``mq`` mesh from the state ``tree``
    (a ``checkpoint.state_tree`` of the whole state), each batch cut to the
    rank's rows: with "train" a train step per batch (its metrics, then the
    query encoder's tensors and the whole queue after the last), with "eval"
    the eval step's metrics and with "prefill" the key prefill's gathered
    embeddings, on the first batch. The batches hold the images as the
    augmentation would give them, and ``perms`` is (perm, sigma, tau), the
    shuffled-BN permutation: both are put in place of the draws."""
    from vince_tpu_torch.parallel.mesh import Mesh, MeshSpec
    from vince_tpu_torch.parallel.multihost import local_slice
    from vince_tpu_torch.solvers import vince_step as tvs
    from vince_tpu_torch.utils.checkpoint import load_state_tree, state_tree

    perm, sigma, tau = (None if a is None else torch.from_numpy(a) for a in perms)
    tvs._augment_sources = lambda cfg, batch, draws: (batch[0]["data"], batch[0]["queue_data"])
    tvs.apply_augment = lambda images, draws, cfg, dtype=torch.float32: images.to(dtype)
    tvs.make_shuffle_perm = lambda gen, n: perm
    tvs.make_balanced_shuffle_perm = lambda gen, n, d: (perm, sigma, tau)
    mesh = Mesh(MeshSpec(md, mq))
    cfg = tvs.VinceConfig(sources=(tvs.SourceSpec(**cfg_kwargs.pop("source")),),
                          data_axis_size=md, queue_axis_size=mq, **cfg_kwargs)
    opt = tvs.build_vince_optimizer(0.05)
    state = tvs.init_vince_state(0, cfg, opt, device="cpu", mesh=mesh)
    load_state_tree(state, {k: _torch(v) for k, v in tree.items()}, mesh=mesh)

    def mine(batch):
        return ({k: torch.from_numpy(local_slice(v, mesh.data_index, md))
                 for k, v in batch.items()},)

    out = {}
    if "eval" in what:
        out["eval"] = tvs.make_eval_step(cfg, mesh)(state, mine(batches[0]), 0)
    if "prefill" in what:
        out["prefill"] = tvs.make_key_prefill_fn(cfg, 0, mesh)(
            state, mine(batches[0])[0]["queue_data"], 0)
    if "train" in what:
        step = tvs.make_train_step_fn(cfg, opt, mesh=mesh)
        out["metrics"] = [step(state, mine(b), 0)[1] for b in batches]
        final = state_tree(state, mesh)
        out.update(params=final["model"], queue=final["queue"]["vectors"])
    return _numpy(out)


def mesh_jobs_rank(rank, world, jobs):
    """``mesh_step_rank`` for each of ``jobs`` (its arguments after the
    rank's and the world's), one after the other in one process group: the
    meshes of one world's size share the processes' start."""
    return [mesh_step_rank(rank, world, *job) for job in jobs]


def _torch(x):
    if isinstance(x, np.ndarray):
        return torch.from_numpy(x)
    if isinstance(x, dict):
        return {k: _torch(v) for k, v in x.items()}
    return x


# -------------------------------------------------------- end-task mesh step
def _end_task_snapshot(state):
    """The end-task state's tensors and counters as numpy: the encoder and
    the decoder by name, the optimizer's buffers by (name, kind)."""
    return dict(
        step=state.step, count=state.optimizer.count,
        encoder=_numpy(state.encoder.state_dict()), decoder=_numpy(state.decoder.state_dict()),
        optimizer={(n, b): t.numpy().copy() for n, s in state.optimizer.state.items()
                   for b, t in s.items()})


RANK_TIMEOUT_S = 600  # how long a rank waits for a case's file


def _wait_for(folder, name):
    """The case ``name`` from ``folder/<name>.pt`` once the test has written
    it (tensors mapped, not read); raises if the test wrote ``abort``."""
    path, deadline = os.path.join(folder, f"{name}.pt"), time.time() + RANK_TIMEOUT_S
    while not os.path.exists(path):
        if os.path.exists(os.path.join(folder, "abort")) or time.time() > deadline:
            raise RuntimeError(f"no case {name!r} in {folder}")
        time.sleep(0.05)
    return torch.load(path, mmap=True, weights_only=False)


def mesh_end_task_rank(rank, world, folder, names):
    """The end-task steps on a ``world`` x 1 mesh, for each case of
    ``names``, read from ``folder`` as the test writes it (``_wait_for``): a
    train step from each of the case's states (``checkpoint.end_task_state_tree``
    trees) on the rank's rows of its batch, then the per-sample eval step
    from ``eval_tree`` on its rows of ``eval_batch``. The augmentation is the
    identity (the batches hold the augmented images). Returns, by case, each
    step's metrics and the state after it, and the eval's rows."""
    from vince_tpu_torch.parallel.mesh import Mesh, MeshSpec
    from vince_tpu_torch.parallel.multihost import local_slice
    from vince_tpu_torch.solvers import end_task_step as tet
    from vince_tpu_torch.utils.checkpoint import load_end_task_state_tree
    from vince_tpu_torch.utils.schedules import vince_lr_schedule

    tet.augment_batch = lambda gen, images, cfg, dtype=torch.float32, **kw: images.to(dtype)
    mesh = Mesh(MeshSpec(world, 1))

    def mine(batch):
        return {k: local_slice(v, mesh.data_index, world) for k, v in batch.items()}

    out = {}
    for name in names:
        case = _wait_for(folder, name)
        cfg = tet.EndTaskConfig(data_axis_size=world, **case["cfg"])
        spec = tet.build_optimizer(cfg, case["base_lr"], case["kind"],
                                   schedule=vince_lr_schedule(**case["schedule"]))
        state = tet.init_end_task_state(1, cfg, spec, device="cpu")
        step = tet.make_end_task_train_step(cfg, train=True, mesh=mesh)
        steps = []
        for tree, batch in zip(case["trees"], case["batches"]):
            load_end_task_state_tree(state, tree)
            _, metrics = step(state, mine(batch))
            steps.append(dict(metrics=_numpy(metrics), state=_end_task_snapshot(state)))
        load_end_task_state_tree(state, case["eval_tree"])
        per = tet.make_end_task_train_step(cfg, train=False, per_sample=True, mesh=mesh)(
            state, mine(case["eval_batch"]))
        out[name] = dict(steps=steps, eval=_numpy(per))
    return out


# ---------------------------------------------------- end-task solvers (CLI)
VAL_ITEMS = 49  # odd: the shards are 25 and 24 items, so one rank runs a filler batch


def odd_val_solver():
    """``EndTaskSunSceneSolver`` with a val split of ``VAL_ITEMS`` images
    and a train split of 64 (``tests/helpers/multihost_endtask_worker.py``'s)."""
    from vince_tpu_torch.data.synthetic_dataset import SyntheticImageDataset
    from vince_tpu_torch.solvers.end_task_solvers import EndTaskSunSceneSolver

    class OddValSolver(EndTaskSunSceneSolver):
        def _make_dataset(self, subset):
            n = VAL_ITEMS if subset == "val" else 64
            return SyntheticImageDataset(self.args, subset, num_images=n)

    return OddValSolver


def odd_val_pass(argv, tree):
    """The odd val split's pass (``run_eval``) of ``odd_val_solver`` from the
    state ``tree``, in this process (a rank of the running group, if any):
    the results and the counts, and the real items of this process's slice."""
    from vince_tpu_torch import arg_parser
    from vince_tpu_torch.utils.checkpoint import load_end_task_state_tree

    solver = odd_val_solver()(arg_parser.parse_args(argv))
    try:
        load_end_task_state_tree(solver.state, tree)
        _, loader = solver._fresh_val_loader()
        try:
            items = sum(len(hb["labels"]) for hb in loader)
        finally:
            loader.shutdown()
        results = solver.run_eval()
        return dict(results=results, batches=solver.last_val_batches,
                    samples=solver.last_val_samples, items=items,
                    mesh=None if solver.mesh is None else solver.cfg.data_axis_size)
    finally:
        solver.end()


def small_val_splits(set_attr=setattr):
    """The end-task solvers' val splits cut for the CPU: 33 images, 9 clips,
    2 GOT-10k pairs a sequence (16), and the OTB fallback cut to one sequence
    of 3 frames (``set_attr`` puts them in place: a test passes its
    monkeypatch's)."""
    from vince_tpu_torch.data.got10k_dataset import GOT10kDataset
    from vince_tpu_torch.data.synthetic_dataset import SyntheticClipDataset, SyntheticImageDataset
    from vince_tpu_torch.solvers.end_task_solvers import EndTaskBaseSolver
    from vince_tpu_torch.tracking import experiments
    from vince_tpu_torch.tracking.sequences import SyntheticSequences

    class ShortSequences(SyntheticSequences):
        def __init__(self, num_seqs=4, num_frames=20, **kw):
            super().__init__(1, 3, **kw)

    original = EndTaskBaseSolver._make_dataset

    def make_dataset(self, subset):
        if subset != "val":
            return original(self, subset)
        if self.task == "tracking":
            return GOT10kDataset(self.args, "val", pairs_per_seq=2)
        if self.task == "kinetics":
            return SyntheticClipDataset(self.args, "val", num_clips=9,
                                        num_images_to_return=self.args.num_frames)
        return SyntheticImageDataset(self.args, "val", num_images=33)

    set_attr(EndTaskBaseSolver, "_make_dataset", make_dataset)
    set_attr(experiments, "SyntheticSequences", ShortSequences)


def odd_val_rank(rank, world, folder, argv):
    """``odd_val_pass`` on this rank of the running group, from the state
    that the test writes to ``folder`` as the case ``state``."""
    return odd_val_pass(argv, _wait_for(folder, "state"))


def end_task_solvers_rank(rank, world, runs, tracking_eval=None):
    """On this rank of the running group: ``solver_runner.main`` of each of
    ``runs`` (argv lists with ``--distributed``; ``initialize`` leaves the
    group to its caller) on ``small_val_splits``, each run's val pass's
    counts and results, the saved state (numpy) and its mesh; then, given
    ``tracking_eval``'s argv, ``run_eval`` of its tracking solver (the OTB
    results)."""
    from vince_tpu_torch import arg_parser, solver_runner
    from vince_tpu_torch.solvers.end_task_solvers import EndTaskBaseSolver, EndTaskTrackingSolver
    from vince_tpu_torch.utils.checkpoint import end_task_state_tree

    small_val_splits()
    run_val = EndTaskBaseSolver.run_val

    def kept_run_val(self, *args, **kwargs):
        self.val_results = run_val(self, *args, **kwargs)
        return self.val_results

    EndTaskBaseSolver.run_val = kept_run_val
    out = {}
    for name, argv in runs.items():
        solver = solver_runner.main(argv)
        out[name] = dict(batches=solver.last_val_batches, samples=solver.last_val_samples,
                         results=solver.val_results, step=solver.state.step,
                         mesh=None if solver.mesh is None else solver.cfg.data_axis_size,
                         state=_numpy(end_task_state_tree(solver.state)))
    EndTaskBaseSolver.run_val = run_val
    if tracking_eval is not None:
        solver = EndTaskTrackingSolver(arg_parser.parse_args(tracking_eval))
        try:
            out["otb"] = solver.run_eval()
        finally:
            solver.end()
    return out


# ------------------------------------------------------------ multichip tools
def audit_jobs_rank(rank, world, jobs):
    """``tools/audit_collectives.py``'s audit of each of ``jobs`` ((md, mq,
    options) with md·mq = ``world``) on this rank of the running group."""
    from vince_tpu_torch.tools import audit_collectives

    return [audit_collectives.audit_rank(rank, world, md, mq, opts, "cpu")
            for md, mq, opts in jobs]
