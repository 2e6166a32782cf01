"""The runner of the ``step`` traffic: the training step alone, fed from the
device (``traffic.StepFeed``). Set-up builds the program's step and state,
runs the step's first calls, loads the start again and runs the compared
steps; the window runs steps one after another, each followed by the
metrics' copy to the host as the training loop makes it; then the peak
memory is read, the program freed, and the reference run over the compared
steps (``harness``'s docstring)."""

import time
from typing import Dict

import torch

from vince_bench import harness


def run(config: dict, traffic: dict, seed: int, seconds: float, trace: bool,
        device: torch.device, cell_limits: Dict[str, float], t0: float) -> harness.Outcome:
    program, params0, queue0, feed, prog = harness.set_up(config, traffic, seed, device)
    harness.settle(device, trace)
    setup_s = time.perf_counter() - t0

    def iterate(span):
        with span("bench.step"):
            h0 = time.perf_counter()
            metrics = program.step(feed.batch(program.state.step), seed)
            h1 = time.perf_counter()
        with span("bench.metrics_to_host"):
            return program.metrics_to_host(metrics)["loss/total_loss"], (h1 - h0) * 1e3

    win = harness.timed_window(iterate, seconds, trace)
    memory = harness.read_memory(device)
    harness.free(program, device)
    del program
    t = time.perf_counter()
    ref = harness.reference(config, params0, queue0, feed, seed, device)
    return harness.outcome(config, prog, ref, win, memory, setup_s, time.perf_counter() - t,
                           cell_limits)
