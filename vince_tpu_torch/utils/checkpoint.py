"""Checkpoints of the pretraining state (counterpart of
``vince_tpu/utils/checkpoint.py``, in torch's own format), with the
reference's policy:

- rolling checkpoints by global step, the latest ``max_to_keep`` kept;
- every ``long_save_frequency``-th save also goes, for good, into
  ``long_save_checkpoint_dir``;
- restore of the latest step, with the saved/new variable prefixes remapping
  the top-level module names of both encoders.

A checkpoint is a directory named by its step that holds one file, the whole
``VinceState``: both encoders' parameters and BatchNorm statistics, the
optimizer's momentum traces by parameter name, the queue's
``vectors``/``sources``/``tail``/``total``, and ``step``. The state is copied
to the host on the caller's thread (the next step may overwrite it), then
written on a background thread, under a temporary name that is renamed when
the file is whole, as orbax writes. A step at or below the latest one of a
directory is not written there again, as orbax skips it.

Restore copies into the state's own tensors in place: a captured train step
holds their addresses.

On a mesh (``parallel/mesh.py``) the file is the same: the queue shards are
gathered over the queue axis into the whole bank, and only the primary
process writes, while the others wait at a barrier. Every process restores
from that one file and keeps its own shard of the bank, so a checkpoint of
one mesh restores on any other (JAX's elastic restore).

An end task's ``EndTaskState`` is kept the same way, under its own tree
(``end_task_state_tree``: encoder, decoder, the optimizer's buffers and
count, step), and its encoder is read out of a pretraining checkpoint by
``read_pretrain_encoder``: the query encoder's tensors, not the key
encoder's.
"""

import functools
import os
import shutil
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Sequence

import torch

from vince_tpu_torch.parallel import multihost
from vince_tpu_torch.parallel.collectives import gather_global_batch

STATE_FILE = "state.pt"


def state_tree(state, mesh=None) -> Dict:
    """The tensors of a ``VinceState`` by name (they are the state's own,
    but for the bank of a mesh: its shards gathered over the queue axis, a
    collective every rank takes part in)."""
    q = state.queue
    vectors, sources = q.vectors, q.sources
    if mesh is not None:
        vectors = gather_global_batch(vectors, mesh.queue_group)
        sources = gather_global_batch(sources, mesh.queue_group)
    return {
        "model": state.model.state_dict(),
        "key_model": state.key_model.state_dict(),
        "optimizer": {name: state.optimizer.state[p]["momentum_buffer"]
                      for name, p in state.model.named_parameters()},
        "queue": {"vectors": vectors, "sources": sources, "tail": q.tail, "total": q.total},
        "step": int(state.step),
    }


def _to_host(tree):
    """A snapshot of the tree on the host; device tensors go through pinned
    buffers without a wait each, then one synchronisation."""
    devices = set()

    def copy(x):
        if isinstance(x, dict):
            return {k: copy(v) for k, v in x.items()}
        if not isinstance(x, torch.Tensor):
            return x
        if x.is_cuda:
            devices.add(x.device)
            out = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            return out.copy_(x, non_blocking=True)
        return x.detach().clone()

    out = copy(tree)
    for dev in devices:
        torch.cuda.current_stream(dev).synchronize()
    return out


def _rename_modules(tensors: Dict, saved_prefixes: Sequence[str],
                    new_prefixes: Sequence[str]) -> Dict:
    """Strip the first of ``saved_prefixes`` that a name's top-level module
    starts with and put the matching ``new_prefixes`` entry in its place."""
    out = {}
    for name, val in tensors.items():
        top, dot, rest = name.partition(".")
        for sp, np_ in zip(saved_prefixes, new_prefixes):
            if sp and top.startswith(sp):
                top = (np_ or "") + top[len(sp):]
                break
        out[top + dot + rest] = val
    return out


def _copy_into(dst: Dict[str, torch.Tensor], src: Dict[str, torch.Tensor], strict: bool,
               what: str) -> None:
    missing, unexpected = sorted(set(dst) - set(src)), sorted(set(src) - set(dst))
    if strict and (missing or unexpected):
        raise ValueError(f"checkpoint {what}: missing {missing[:5]} ({len(missing)}), "
                         f"unexpected {unexpected[:5]} ({len(unexpected)})")
    for name in sorted(set(dst) & set(src)):
        if dst[name].shape != src[name].shape:
            raise ValueError(f"checkpoint {what}.{name}: shape {tuple(src[name].shape)}, the "
                             f"state holds {tuple(dst[name].shape)}")
        dst[name].copy_(src[name])
    if missing or unexpected:
        print(f"checkpoint {what}: {len(missing)} tensors of the state not in it, "
              f"{len(unexpected)} of it not in the state")


@torch.no_grad()
def load_state_tree(state, tree: Dict, strict: bool = True, mesh=None) -> None:
    """Copy a checkpoint's tree into ``state``'s tensors in place. ``strict``
    asks for every tensor of the state and no other. On a mesh the state
    keeps its shard of the saved bank."""
    _copy_into(state.model.state_dict(), tree["model"], strict, "model")
    _copy_into(state.key_model.state_dict(), tree["key_model"], strict, "key_model")
    traces = {name: state.optimizer.state[p]["momentum_buffer"]
              for name, p in state.model.named_parameters()}
    _copy_into(traces, tree["optimizer"], strict, "optimizer")
    q = state.queue
    for name in ("vectors", "sources", "tail", "total"):
        saved = tree["queue"][name]
        if mesh is not None and name in ("vectors", "sources"):
            saved = multihost.local_slice(saved, mesh.queue_index, mesh.queue_size)
        getattr(q, name).copy_(saved)
    q.inserted = int(tree["queue"]["total"])
    state.step = int(tree["step"])


def end_task_state_tree(state) -> Dict:
    """The tensors of an ``EndTaskState`` by name (they are the state's own;
    on a mesh the state is replicated, so the tree is the same)."""
    return {"encoder": state.encoder.state_dict(), "decoder": state.decoder.state_dict(),
            "optimizer": state.optimizer.state_tree(), "step": int(state.step)}


@torch.no_grad()
def load_end_task_state_tree(state, tree: Dict, strict: bool = True) -> None:
    """Copy an end-task checkpoint's tree into ``state``'s tensors in place
    (on a mesh, the whole replicated state on every rank)."""
    _copy_into(state.encoder.state_dict(), tree["encoder"], strict, "encoder")
    _copy_into(state.decoder.state_dict(), tree["decoder"], strict, "decoder")
    opt, saved = state.optimizer, tree["optimizer"]
    for kind, buffers in opt.state_tree().items():
        if kind != "count":
            _copy_into(buffers, saved[kind], strict, f"optimizer.{kind}")
    opt.count = int(saved["count"])
    state.step = int(tree["step"])


def _steps(directory: Optional[str]) -> List[int]:
    if not directory or not os.path.isdir(directory):
        return []
    return sorted(int(d) for d in os.listdir(directory) if d.isdigit())


def _write(directory: str, step: int, tree: Dict) -> None:
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, f".{step}.tmp-{os.getpid()}")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    with open(os.path.join(tmp, STATE_FILE), "wb") as f:
        torch.save(tree, f)
        f.flush()
        os.fsync(f.fileno())
    os.rename(tmp, os.path.join(directory, str(step)))


def read_pretrain_encoder(directory: str) -> Optional[Dict[str, torch.Tensor]]:
    """The query encoder's parameters and BatchNorm statistics (``model``)
    of the latest pretraining checkpoint in ``directory``, on the CPU; None
    if there is none."""
    steps = _steps(directory)
    if not steps:
        return None
    path = os.path.join(directory, str(steps[-1]), STATE_FILE)
    return torch.load(path, map_location="cpu", weights_only=True)["model"]


@torch.no_grad()
def load_pretrain_encoder(encoder, tensors: Dict[str, torch.Tensor]) -> None:
    """Copy a pretrained encoder's tensors (``read_pretrain_encoder``'s) into
    ``encoder``: every parameter and statistic it has must be there with its
    shape; those of heads it lacks (the jigsaw head, the ImageNet decoders)
    are left out."""
    own = encoder.state_dict()
    _copy_into(own, {k: v for k, v in tensors.items() if k in own}, True, "pretrained encoder")
    unused = len(set(tensors) - set(own))
    if unused:
        print(f"pretrained encoder: {unused} tensors of heads the end task does not build "
              f"left out")


class CheckpointManager:
    """Rolling and long-save checkpoints of a ``VinceState``, or of another
    replicated state through ``tree_fn`` (state → tree of tensors) and
    ``load_fn`` (state, tree, strict → None, in place); the ``VinceState``'s
    functions are given the mesh, for its queue shards. With a ``mesh`` every process
    calls ``save``; the primary writes, and the others wait at a barrier
    until it has its copy of the state."""

    def __init__(self, checkpoint_dir: str, long_save_checkpoint_dir: Optional[str] = None,
                 max_to_keep: int = 5, long_save_frequency: int = 25,
                 tree_fn: Optional[Callable] = None, load_fn: Optional[Callable] = None,
                 mesh=None):
        tree_fn = tree_fn or functools.partial(state_tree, mesh=mesh)
        load_fn = load_fn or functools.partial(load_state_tree, mesh=mesh)
        self.tree_fn, self.load_fn, self.mesh = tree_fn, load_fn, mesh
        self.checkpoint_dir = os.path.abspath(checkpoint_dir)
        self.long_dir = (os.path.abspath(long_save_checkpoint_dir)
                         if long_save_checkpoint_dir else None)
        self.max_to_keep = max_to_keep
        self.long_save_frequency = long_save_frequency
        self._save_count = 0
        self._executor = ThreadPoolExecutor(max_workers=1)
        self._pending: Optional[Future] = None
        # per save: the step, the host copy's seconds on the caller's thread,
        # and the background write's seconds
        self.timings: List[Dict] = []

    def wait_until_finished(self) -> None:
        """Wait for the write in flight; its error, if any, is raised here."""
        pending, self._pending = self._pending, None
        if pending is not None:
            pending.result()

    def save(self, step: int, state, force_long: bool = False) -> None:
        self.wait_until_finished()
        tree = self.tree_fn(state)  # on a mesh a collective, which every rank takes part in
        if self.mesh is None or multihost.is_primary():
            self._save(step, tree, force_long)
        if self.mesh is not None:
            multihost.sync("save")

    def _save(self, step: int, tree, force_long: bool) -> None:
        step = int(step)
        self._save_count += 1
        targets = []
        if not self._steps_above(self.checkpoint_dir, step):
            targets.append(self.checkpoint_dir)
        if self.long_dir and (force_long or self._save_count % self.long_save_frequency == 0) \
                and not self._steps_above(self.long_dir, step):
            targets.append(self.long_dir)
        if not targets:
            return
        t0 = time.perf_counter()
        tree = _to_host(tree)
        timing = {"step": step, "host_copy_s": time.perf_counter() - t0}
        self.timings.append(timing)
        self._pending = self._executor.submit(self._write_all, targets, step, tree, timing)

    @staticmethod
    def _steps_above(directory: str, step: int) -> bool:
        steps = _steps(directory)
        return bool(steps) and steps[-1] >= step

    def _write_all(self, targets, step, tree, timing):
        t0 = time.perf_counter()
        for directory in targets:
            _write(directory, step, tree)
        for old in _steps(self.checkpoint_dir)[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.checkpoint_dir, str(old)))
        timing["write_s"] = time.perf_counter() - t0

    def latest_step(self) -> Optional[int]:
        self.wait_until_finished()
        steps = _steps(self.checkpoint_dir)
        return steps[-1] if steps else None

    def restore_raw(self, step: Optional[int] = None) -> Optional[Dict]:
        """The checkpoint of ``step`` (default the latest) as a tree of CPU
        tensors, or None if there is none."""
        if step is None:
            step = self.latest_step()
        if step is None:
            return None
        path = os.path.join(self.checkpoint_dir, str(step), STATE_FILE)
        return torch.load(path, map_location="cpu", weights_only=True)

    def restore(self, state, step: Optional[int] = None,
                saved_variable_prefix: Sequence[str] = ("",),
                new_variable_prefix: Sequence[str] = ("",)):
        """Copy the checkpoint of ``step`` (default the latest) into ``state``
        in place and return it; None if there is no checkpoint. Without a
        remap every tensor of the state must be in the checkpoint; with one,
        the tensors whose names match are copied and the counts of the rest
        printed."""
        raw = self.restore_raw(step)
        if raw is None:
            return None
        remap = any(saved_variable_prefix) or any(new_variable_prefix)
        if remap:
            for key in ("model", "key_model"):
                raw[key] = _rename_modules(raw[key], saved_variable_prefix, new_variable_prefix)
        self.load_fn(state, raw, strict=not remap)
        return state

    def close(self) -> None:
        self.wait_until_finished()
        self._executor.shutdown(wait=True)
        if self.mesh is not None:
            multihost.sync("checkpoint written")
