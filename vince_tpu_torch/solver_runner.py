"""The training entry point (counterpart of ``vince_tpu/solver_runner.py``):

    python -m vince_tpu_torch.solver_runner --solver VinceSolver --dataset ... [--platform cpu]

for pretraining or, with ``--solver EndTaskImagenetSolver``,
``EndTaskSunSceneSolver``, ``EndTaskKinetics400Solver`` or
``EndTaskTrackingSolver``, an end task. It
builds the loggers (none under ``--debug``), the solver by its registry name,
runs an optional first validation (``--test-first``), then the epochs (each
its train iterations, then a validation), and saves in ``finally``, also
after a crash. A failed run exits with code 1.

With ``--distributed`` each process runs this entry point: the process group
starts before the solver (``parallel/multihost.py``), only the primary
process writes logs, a failed process skips the crash save (a collective),
and the group is destroyed at the end (a group that the caller started is
left to it). Launch it with
``torchrun --nproc-per-node=N -m vince_tpu_torch.solver_runner --distributed
...`` or, per process, with ``--coordinator-address``, ``--num-processes``
and ``--process-id``.
"""

import os
import traceback

from vince_tpu_torch import arg_parser
from vince_tpu_torch.parallel import multihost
from vince_tpu_torch.utils.logger import Logger


def get_solver_class(name: str):
    """The solver class of a ``--solver`` name."""
    from vince_tpu_torch.solvers import end_task_solvers
    from vince_tpu_torch.solvers.vince_solver import VinceSolver

    if name == "VinceSolver":
        return VinceSolver
    if name not in arg_parser.SOLVER_NAMES:
        raise KeyError(f"unknown solver {name!r}; choices: {arg_parser.SOLVER_NAMES}")
    return getattr(end_task_solvers, name)


def main(argv=None):
    """Train as the flags say; returns the solver, ended."""
    args = arg_parser.parse_args(argv)
    started = multihost.initialize(args)
    try:
        return _run(args)
    finally:
        if started:
            multihost.shutdown()


def _run(args):
    train_logger = val_logger = None
    if not args.debug and multihost.is_primary():
        train_logger = Logger(os.path.join(args.tensorboard_dir, "train"))
        val_logger = Logger(os.path.join(args.tensorboard_dir, "val"))

    solver = get_solver_class(args.solver or "VinceSolver")(args, train_logger, val_logger)

    failed = True  # KeyboardInterrupt and SystemExit skip the except and else below
    try:
        if args.test_first:
            print("Running initial Val")
            solver.reset_epoch()
            solver.run_val()

        while solver.epoch < args.epochs:
            solver.reset_epoch()
            print("Running Train epoch", solver.epoch)
            for _ in range(solver.iterations_per_epoch):
                solver.run_train_iteration()
            print("Running Val")
            solver.run_val()
            solver.epoch += 1
    except Exception:
        traceback.print_exc()
    else:
        failed = False
    finally:
        # the crash save comes before the shutdown; under --distributed it is
        # a collective that peers stuck in the step's collectives never join,
        # so a failed process skips it
        if args.save and not (failed and multihost.is_multiprocess()):
            print("Saving models")
            solver.save()
        elif args.save:
            print("crash under --distributed: skipping the (collective) crash-save; resume "
                  "from the last periodic checkpoint")
        solver.end()
        for logger in (train_logger, val_logger):
            if logger is not None:
                logger.close()
    if failed:
        raise SystemExit(1)
    return solver


if __name__ == "__main__":
    main()
