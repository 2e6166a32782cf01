"""What stretches the step's host part in the training CLI, on the GPU machine:

    python3 vince_tpu_torch/tools/cli_host_time.py [--iterations 12]

One solver of ``chip_smoke.py``'s phase 9 (``chip_smoke.CLI_ARGV``: ResNet50,
b=128, 224², q=65536, bf16, the texture videos), one captured step, and three
settings in turn, ``--iterations`` iterations each after the capture:

1. as the CLI runs: the loader's threads and the staging thread at work;
2. the same with the interpreter's switch interval at 0.1 ms (5 ms by
   default), so that a thread waiting for the interpreter lock gets it sooner;
3. no loader at work: batches staged beforehand, the loaders and the staging
   thread stopped, each iteration fed from that list.

For each it prints the median and range of the step's host part (from the
step's call to its return: the draws, the copies into the graph's inputs,
the replay's launch), of ``step_time`` (that, then the wait for the device
that the metrics' copy ends) and of ``total_time``. A measurement aid: the
port does not import it.
"""

import argparse
import contextlib
import os
import shutil
import sys
import tempfile

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, HERE)

import chip_smoke as cs  # noqa: E402

LAPS = ("step host", "step_time", "total_time", "data_cache_time")


def compare(argv, iterations):
    """The three settings on one solver built from ``argv``; the laps of each
    setting's iterations, by setting."""
    from vince_tpu_torch import arg_parser
    from vince_tpu_torch.solvers.vince_solver import VinceSolver
    from vince_tpu_torch.solvers.vince_step import WARMUP_STEPS

    runs = {}
    with cs.CliRecord() as rec, contextlib.redirect_stdout(cs.Tee(sys.stdout)):
        solver = VinceSolver(arg_parser.parse_args(argv))
        try:
            solver.reset_epoch()
            for _ in range(WARMUP_STEPS + 1):  # the eager calls and the capture
                solver.run_train_iteration()

            def measure(name):
                start = len(rec.of("run_train_iteration"))
                for _ in range(iterations):
                    solver.run_train_iteration()
                runs[name] = [c["laps"] for c in rec.of("run_train_iteration")[start:]]

            measure("loader threads at work (as the CLI)")
            interval = sys.getswitchinterval()
            sys.setswitchinterval(1e-4)
            try:
                measure("switch interval 0.1 ms")
            finally:
                sys.setswitchinterval(interval)
            staged = [solver.get_batch() for _ in range(iterations)]
            solver.stop_prefetch()
            for _, loader in solver.train_loaders + solver.val_loaders:
                loader.shutdown()
            batches = iter(staged)
            solver.get_batch = lambda: next(batches)
            measure("no loader at work")
        finally:
            solver.end()
    return runs


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--iterations", type=int, default=12)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    from vince_tpu_torch.device import full_f32_products

    full_f32_products()
    card = cs.gpu_name_and_power()
    tmp = tempfile.mkdtemp(prefix="cli_host_time_")
    try:
        runs = compare(cs.CLI_ARGV + ["--title", "t", "--description", "host", "--base-logdir",
                                      tmp, "--epochs", "1", "--no-save", "--no-restore"],
                       args.iterations)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for name, laps in runs.items():
        print(f"{name}: " + ", ".join(
            f"{k} {np.median([x[k] for x in laps]) * 1e3:.3f} ms "
            f"({min(x[k] for x in laps) * 1e3:.3f}-{max(x[k] for x in laps) * 1e3:.3f})"
            for k in LAPS) + f"; {len(laps)} iterations; card {card}", flush=True)


if __name__ == "__main__":
    main()
