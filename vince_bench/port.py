"""What the benchmark takes from the program under test, ``vince_tpu_torch``:
the training step as its solver builds it from a training script's flags,
and the state that the step updates. Nothing else of the benchmark imports
the program.

The weights and the queue are the benchmark's (made from the seed, handed to
the program and the reference alike); ``load_start`` writes them into the
program's state in place, since a captured step holds the addresses of the
state's tensors.
"""

import argparse
import types
from typing import Dict, List

import torch

# keys of a configuration file that describe it and are not flags of the script
META_KEYS = frozenset({"name", "source", "source_script", "deployment", "published",
                       "reduced", "assumed", "implementation", "reference_model", "flops"})


def script_argv(config: dict) -> List[str]:
    """The training script's command line for a configuration file: its flags
    and the implementation's, each key the ``dest`` of one flag of the
    port's parser."""
    from vince_tpu_torch.arg_parser import build_parser

    actions = {a.dest: a for a in build_parser()._actions if a.option_strings}
    flags = {k: v for k, v in config.items() if k not in META_KEYS}
    flags.update(config.get("implementation", {}))
    argv = []
    for key, value in flags.items():
        if key not in actions:
            raise KeyError(f"configuration key {key!r} is no flag of the training script")
        action = actions[key]
        opt = action.option_strings[-1]
        if isinstance(action, argparse._StoreTrueAction):
            argv += [opt] if value else []
        elif isinstance(action, argparse._StoreFalseAction):
            argv += [] if value else [opt]
        elif isinstance(value, list):
            argv += [opt, *map(str, value)]
        else:
            argv += [opt, str(value)]
    return argv


@torch.no_grad()
def load_start(state, params: Dict[str, torch.Tensor], queue: torch.Tensor) -> None:
    """Both encoders of the program's state at ``params``, the running
    averages at 0 and 1, the momentum at 0, the queue at ``queue`` with its
    tail at 0, the step 0."""
    for encoder in (dict(state.model.named_parameters()),
                    dict(state.key_model.named_parameters())):
        if set(encoder) != set(params) or any(encoder[k].shape != v.shape
                                              for k, v in params.items()):
            raise ValueError("the program's parameters are not the reference's: "
                             f"{sorted(set(encoder) ^ set(params))[:8]}")
        for k, v in params.items():
            encoder[k].copy_(v)
    for model in (state.model, state.key_model):
        for name, buf in model.named_buffers():
            if name.endswith("running_mean"):
                buf.zero_()
            elif name.endswith("running_var"):
                buf.fill_(1.0)
            else:
                raise ValueError(f"unknown buffer {name}")
    for slot in state.optimizer.state.values():
        slot["momentum_buffer"].zero_()
    q = state.queue
    q.vectors.copy_(queue)
    q.sources.fill_(-1)
    q.tail.zero_()
    q.total.zero_()
    q.inserted = 0
    state.step = 0


@torch.no_grad()
def grad_norms(state, params0: Dict[str, torch.Tensor], decay: float) -> Dict[str, float]:
    """Each leaf's gradient of the first step as the optimizer took it: its
    momentum trace after one step, less the weight decay's share."""
    slots = state.optimizer.state
    return {k: float(torch.linalg.vector_norm(slots[p]["momentum_buffer"] - decay * params0[k]))
            for k, p in state.model.named_parameters()}


@torch.no_grad()
def change_norms(state, params0: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Each leaf's change from ``params0``, the key encoder's as ``key.<name>``."""
    out = {k: float(torch.linalg.vector_norm(p - params0[k]))
           for k, p in state.model.named_parameters()}
    out.update({f"key.{k}": float(torch.linalg.vector_norm(p - params0[k]))
                for k, p in state.key_model.named_parameters()})
    return out


def queue_rows(state, rows: int) -> torch.Tensor:
    """The queue's first ``rows`` rows, copied to the host."""
    return state.queue.vectors[:rows].detach().to("cpu", copy=True)


def _args(argv: List[str]):
    from vince_tpu_torch.arg_parser import build_parser, finalize_args

    return finalize_args(build_parser().parse_args(argv))


class Program:
    """The pretraining step of one configuration, built as ``VinceSolver``
    builds it (its ``_config``, its schedule, the captured step on a CUDA
    device and the eager one elsewhere), over a state from
    ``init_vince_state``."""

    def __init__(self, config: dict, device: torch.device):
        from vince_tpu_torch.solvers import vince_step
        from vince_tpu_torch.solvers.vince_solver import VinceSolver, metrics_to_host
        from vince_tpu_torch.utils.schedules import vince_lr_schedule

        args = _args(script_argv(config))
        sources = (vince_step.SourceSpec("YT", batch_size=args.batch_size,
                                         num_frames=max(args.num_frames, 1),
                                         transform=args.transform, source_id=1),)
        self.cfg = VinceSolver._config(types.SimpleNamespace(args=args, sources=sources,
                                                             mesh=None))
        schedule = vince_lr_schedule(args.base_lr, args.epochs, args.iterations_per_epoch,
                                     args.lr_decay_type, args.lr_step_schedule,
                                     use_warmup=args.use_warmup)
        optimizer = vince_step.build_vince_optimizer(schedule, kind=args.optimizer)
        self.state = vince_step.init_vince_state(0, self.cfg, optimizer, device=device)
        make = (vince_step.make_train_step if device.type == "cuda"
                else vince_step.make_train_step_fn)
        self.step_fn = make(self.cfg, optimizer)
        self.metrics_to_host = metrics_to_host

    def step(self, batch, seed: int):
        """One call of the step; the metrics stay on the device."""
        self.state, metrics = self.step_fn(self.state, batch, seed)
        return metrics

    def close(self) -> None:
        """Free the state and the step (a captured graph's pool with it)."""
        self.state = self.step_fn = None


class Solver:
    """The training command's ``VinceSolver`` from a configuration file over
    a data tree, with its loaders, staging thread, queue prefill and step;
    the harness runs its iterations as the command's loop does. The batches
    of the calls made while ``record`` is on are kept (copies on the device)."""

    def __init__(self, config: dict, device: torch.device, data_path: str, logdir: str,
                 seed: int, extra: List[str]):
        from vince_tpu_torch.solvers.vince_solver import VinceSolver

        argv = script_argv(config) + ["--data-path", data_path, "--base-logdir", logdir,
                                      *extra]
        if device.type != "cuda":
            argv += ["--platform", device.type]
        args = _args(argv)
        args.seed = seed  # the solver's draws and the loader's; the parser has no flag
        self.solver = VinceSolver(args)
        self.solver.reset_epoch()
        self.record, self.batches = False, []
        step = self.solver.train_step

        def recording(state, batch, seed_):
            if self.record:
                self.batches.append(tuple({k: v.clone() for k, v in src.items()}
                                          for src in batch))
            return step(state, batch, seed_)

        self.solver.train_step = recording

    @property
    def state(self):
        return self.solver.state

    @property
    def seed(self) -> int:
        return self.solver.seed

    def iteration(self) -> Dict[str, float]:
        """One train iteration of the command's loop; its metrics on the host."""
        return self.solver.run_train_iteration()

    def data_wait_ms(self) -> float:
        """The last iteration's wait for its staged batch."""
        return 1e3 * self.solver.time_meters["data_cache_time"].values[-1]

    def close(self) -> None:
        """End the solver (its prefetch thread and loaders); once."""
        if self.solver is not None:
            self.solver.end()
            self.solver = None
