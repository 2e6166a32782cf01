"""The runner of the ``files`` traffic: the training command's solver over a
JPEG tree written from the seed (``vince_bench/files.py``), with its
loaders, staging, queue prefill and step. Set-up writes the tree, builds the
solver, runs its first iterations (the captured step's warm-up and
capture), loads the start into its state and runs the compared iterations
through its own loop; the window runs its iterations. After it, the frames
that reached the compared steps are held to the benchmark's own reading of
the tree (``frames``: rows that are none of its frames, or not of their
item's video), and the reference runs over those frames."""

import shutil
import tempfile
import time
from pathlib import Path
from typing import Dict

import torch

from vince_bench import files, harness, port


def canvas_size(config: dict) -> int:
    """The loader's square canvas for the configuration's crop."""
    return int(config["input_width"] / 0.875)


def run(config: dict, traffic: dict, seed: int, seconds: float, trace: bool,
        device: torch.device, cell_limits: Dict[str, float], t0: float) -> harness.Outcome:
    root = Path(tempfile.mkdtemp(prefix="vince_bench_tree_"))
    solver = None
    try:
        files.write_tree(root, traffic, seed)
        solver = port.Solver(config, device, str(root), str(root / "logs"), seed,
                             traffic["flags"])
        params0, queue0 = harness.start_values(config, seed, device)
        for _ in range(harness.warm_calls(device)):
            solver.iteration()
        port.load_start(solver.state, params0, queue0)
        solver.record = True
        prog = harness.readings(solver, lambda i: solver.iteration(), params0,
                                config["batch_size"])
        solver.record = False
        harness.settle(device, trace)
        setup_s = time.perf_counter() - t0
        waits = []

        def iterate(span):
            with span("bench.iteration"):
                metrics = solver.iteration()
            waits.append(solver.data_wait_ms())
            return metrics["loss/total_loss"], None

        win = harness.timed_window(iterate, seconds, trace)
        memory = harness.read_memory(device)
        batches, step_seed = solver.batches, solver.seed
        harness.free(solver, device)
        t = time.perf_counter()
        known = files.read_tree(root / "train", canvas_size(config), traffic["writers"])
        bad = files.frames_not_read(batches, known, config["num_frames"])
        ref = harness.follow(config, params0, queue0,
                             [(b[0]["data"], b[0]["queue_data"]) for b in batches], step_seed,
                             device)
        return harness.outcome(config, prog, ref, win, memory, setup_s, time.perf_counter() - t,
                               cell_limits, {"frames": float(bad)}, {"data_wait_ms": waits})
    finally:
        if solver is not None:
            solver.close()  # its loaders' worker processes, also after a failure
        shutil.rmtree(root, ignore_errors=True)
