"""The benchmark's driver. Everything that belongs to one configuration, one
traffic mix or one metric is a file of its own, found by the name that
``BENCHMARK.json`` or another file gives it:

- a cell's configuration, ``configs/<name>.json``, names its reference
  encoder, ``reference/models/<reference_model>.py``, its counter of
  operations, ``flops/<flops>.py``, and (by the script's ``transform``) the
  reference augmentation's parameters, ``reference/transforms/<name>.json``;
- a cell's traffic mix, ``traffic/<name>.json``, names by its ``kind`` the
  runner that drives it, ``runners/<kind>.py`` (``run`` returns an
  ``Outcome``);
- a per-layer metric is read by ``metrics/<name>.py`` (``read(records)``);
- a cell's limits on the compared numbers are ``limits/<workload>.json``.

This module finds them, holds the pieces the runners share, and assembles
the result line. A run of the ``step`` traffic (``runners/step.py``):

1. set-up: the program's step and state (``port.Program``); the weights,
   the queue and the frames from the seed, on the device; the step's first
   calls (the captured step's eager warm-up and its capture); the start
   loaded again; the first ``COMPARED_STEPS`` steps from it through the
   same call, whose readings the reference is held to;
2. the window: steps one after another, each followed by the metrics'
   copy to the host as the training loop makes it, until ``seconds`` have
   passed; the window ends with the step in flight;
3. with ``trace``, the last stretch of the window under the profiler;
4. the peak memory read, the program's state freed, and the reference run
   over the compared steps.
"""

import dataclasses
import gc
import importlib.util
import json
import math
import statistics
import sys
import time
import types
from pathlib import Path
from typing import Dict, List, Optional

import torch

from vince_bench import check, traffic as traffic_mod
from vince_bench.reference import step as ref_step
from vince_bench.trace import Trace, Tracer, short, top

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
COMPARED_STEPS = 3
STRETCH_S = 4.0  # the traced stretch: at most this long, at the end of the window
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "optax", "orbax", "vince_tpu"})


def forbidden_modules(modules=None) -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (``vince_tpu_torch`` is not ``vince_tpu``)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & FORBIDDEN)


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell(bench: dict, workload: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == workload:
            return w
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def config_file(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return load_json(ROOT / c["file"])
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def limits(workload: str) -> Dict[str, float]:
    """The cell's limits on the compared numbers (``limits/<workload>.json``)."""
    return load_json(BENCH_DIR / "limits" / f"{workload}.json")["limits"]


def find(folder: str, name: str) -> types.ModuleType:
    """The module of the file ``vince_bench/<folder>/<name>.py``, loaded once."""
    key = f"vince_bench.{folder.replace('/', '.')}.{name}"
    if key in sys.modules:
        return sys.modules[key]
    path = BENCH_DIR / folder / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {folder}/{name}.py in {BENCH_DIR}")
    spec = importlib.util.spec_from_file_location(key, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[key] = module
    try:
        spec.loader.exec_module(module)
    except BaseException:
        del sys.modules[key]
        raise
    return module


def reader(name: str) -> types.ModuleType:
    """The per-layer metric's reader, ``metrics/<name>.py``."""
    return find("metrics", name)


def runner(kind: str) -> types.ModuleType:
    """The runner of a traffic kind, ``runners/<kind>.py``."""
    return find("runners", kind)


def reference_model(config: dict) -> types.ModuleType:
    """The configuration's reference encoder, ``reference/models/<name>.py``."""
    return find("reference/models", config["reference_model"])


def cell_metrics(bench: dict, workload: str, section: str) -> List[dict]:
    """The metrics of ``section`` that the cell reports."""
    return [m for m in bench[section] if workload in m.get("workloads", [workload])]


@dataclasses.dataclass
class Records:
    """What a run hands the per-layer readers."""

    config: dict
    frames: int  # per step
    window_s: float  # the whole window
    steps: int
    untraced_s: float  # the window before the traced stretch
    untraced_steps: int
    host_ms: List[float]  # each untraced step's call, to its return
    trace: Optional[Trace] = None
    counters: Dict[str, list] = dataclasses.field(default_factory=dict)
    memory: Dict[str, int] = dataclasses.field(default_factory=dict)  # ``read_memory``'s


@dataclasses.dataclass
class Outcome:
    """A run's result, before it is printed."""

    correct: bool
    attempted: int
    failed: int
    e2e: Dict[str, float]
    records: Records
    compared: Dict[str, dict]
    memory_peak_bytes: int
    phases: Dict[str, float]  # seconds of the run's parts, for its log
    memory: Dict[str, int]  # the allocator's readings, for its log


def start_values(config: dict, seed: int, device) -> tuple:
    """The weights and the queue of a run, from the seed, on the device."""
    params = reference_model(config).make_params(
        config["backbone"], config["vince_embedding_size"],
        traffic_mod.generator(device, seed, "weights"))
    queue = torch.randn(config["vince_queue_size"], config["vince_embedding_size"],
                        generator=traffic_mod.generator(device, seed, "queue"), device=device)
    return params, queue / torch.linalg.vector_norm(queue, dim=1, keepdim=True)


def readings(side, step, params0, frames: int) -> dict:
    """The first ``COMPARED_STEPS`` steps from the start: ``step(i)`` runs
    step i through the program's own call and returns its metrics on the
    host; ``side.state`` is the program's state."""
    from vince_bench import port

    losses, grad = [], None
    for i in range(COMPARED_STEPS):
        losses.append(step(i)["loss/total_loss"])
        if i == 0:
            grad = port.grad_norms(side.state, params0, ref_step.WEIGHT_DECAY)
    return {"losses": losses, "grad": grad, "change": port.change_norms(side.state, params0),
            "keys": port.queue_rows(side.state, COMPARED_STEPS * frames)}


def warm_calls(device) -> int:
    """Calls before a step runs as it will in the window: the captured
    step's eager warm-up and its capture; one eager call elsewhere."""
    if device.type != "cuda":
        return 1
    from vince_tpu_torch.solvers.vince_step import WARMUP_STEPS

    return WARMUP_STEPS + 1


def set_up(config: dict, traffic: dict, seed: int, device: torch.device):
    """The program's step and state, the start (weights, queue) and the
    frames from the seed, the step's first calls, the start loaded again and
    the compared steps: (program, weights, queue, feed, the program's
    readings)."""
    from vince_bench import port

    program = port.Program(config, device)
    params0, queue0 = start_values(config, seed, device)
    feed = traffic_mod.StepFeed(traffic, config["batch_size"], seed, device)
    for i in range(warm_calls(device)):
        program.step(feed.batch(COMPARED_STEPS + i), seed)
    port.load_start(program.state, params0, queue0)
    prog = readings(program, lambda i: program.metrics_to_host(program.step(feed.batch(i), seed)),
                    params0, config["batch_size"])
    return program, params0, queue0, feed, prog


def free(program, device: torch.device) -> None:
    """Close the program's side (its state, step, loaders) and give the
    card's memory back (set-up's objects thawed, so that a collection can
    free what of them is now garbage)."""
    program.close()
    gc.unfreeze()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def reference(config: dict, params0, queue0, feed, seed: int, device: torch.device,
              **planted) -> dict:
    """The reference's readings over the compared steps (blocks recomputed
    in the backward on the card, where the float32 activations of a large
    batch would not fit)."""
    return follow(config, params0, queue0, [feed.frames(i) for i in range(COMPARED_STEPS)],
                  seed, device, **planted)


def follow(config: dict, params0, queue0, batches, seed: int, device: torch.device,
           **planted) -> dict:
    """The reference's step over ``batches`` with the configuration's encoder."""
    return ref_step.follow(ref_step.StepConfig.from_config(config), reference_model(config),
                           params0, queue0, batches, seed, remat=device.type == "cuda",
                           **planted)


@dataclasses.dataclass
class Window:
    """The timed window's account."""

    losses: List[float]
    host_ms: List[float]  # each untraced iteration's host time, where the iteration gives one
    seconds: float
    untraced_s: float
    untraced_steps: int
    stretch: Optional[Trace]
    trace_s: float  # the trace's reduction, after the window
    wall_s: List[float]  # each iteration's wall time, for the run's log


def timed_window(iterate, seconds: float, trace: bool) -> Window:
    """Iterations one after another until ``seconds`` have passed, ending
    with the one in flight; with ``trace`` the last ``STRETCH_S`` (at most
    half the window) of whole iterations under the profiler. ``iterate(spans)``
    runs one and returns (its loss, its host ms or None)."""
    tracer = Tracer()
    losses, host_ms, wall, untraced = [], [], [], None
    start = time.perf_counter()
    now = 0.0
    while True:
        if trace and not tracer.on and time.perf_counter() - start >= seconds - min(
                STRETCH_S, seconds / 2):
            untraced = (time.perf_counter() - start, len(losses))
            tracer.start()
        loss, ms = iterate(tracer.span)
        losses.append(loss)
        if tracer.on:
            tracer.steps += 1
        elif ms is not None:
            host_ms.append(ms)
        before, now = now, time.perf_counter() - start
        wall.append(now - before)
        if now >= seconds:
            break
    t = time.perf_counter()
    stretch = tracer.stop()
    untraced = untraced or (now, len(losses))
    return Window(losses, host_ms, now, untraced[0], untraced[1], stretch,
                  time.perf_counter() - t, wall)


def outcome(config: dict, prog: dict, ref: dict, win: Window, memory: Dict[str, int],
            setup_s: float, ref_s: float, cell_limits: Dict[str, float], more_numbers=None,
            counters=None) -> Outcome:
    """The run's verdict, metrics and records; ``memory`` is ``read_memory``'s
    at the window's close, ``more_numbers`` are compared numbers of the
    traffic's own, ``counters`` what its readers take."""
    peak = memory["reserved_peak"]
    frames = config["batch_size"]
    nums = dict(check.numbers(prog, ref), **(more_numbers or {}))
    failed = sum(not math.isfinite(x) for x in win.losses)
    records = Records(config=config, frames=frames, window_s=win.seconds,
                      steps=len(win.losses), untraced_s=win.untraced_s,
                      untraced_steps=win.untraced_steps, host_ms=win.host_ms,
                      trace=win.stretch, counters=counters or {}, memory=memory)
    return Outcome(correct=check.verdict(nums, cell_limits) and failed == 0,
                   attempted=len(win.losses), failed=failed,
                   e2e={"frames_per_s": len(win.losses) * frames / win.seconds,
                        "peak_mem_gib": peak / 2 ** 30, "setup_s": setup_s},
                   records=records,
                   compared={k: {"value": nums[k], "limit": cell_limits[k]} for k in cell_limits},
                   memory_peak_bytes=peak,
                   phases={"setup_s": setup_s, "window_s": win.seconds,
                           "trace_reduction_s": win.trace_s, "reference_s": ref_s,
                           "iteration_min_s": min(win.wall_s),
                           "iteration_median_s": statistics.median(win.wall_s),
                           "iteration_max_s": max(win.wall_s),
                           "first_iteration_s": win.wall_s[0]},
                   memory=memory)


def settle(device: torch.device, trace: bool) -> None:
    """The end of set-up: the garbage of set-up collected and what is left
    frozen, so that a collection in the window does not walk set-up's
    objects; the profiler's first session (with ``trace``); the device's
    queue drained."""
    gc.collect()
    gc.freeze()
    if device.type == "cuda":
        if trace:
            Tracer.warm()
        torch.cuda.synchronize()


def read_memory(device: torch.device) -> Dict[str, int]:
    """The caching allocator's peaks over set-up and window: what it reserved
    from the card (``peak_mem_gib``) and what tensors held; the times it
    found the card full and gave its cached blocks back to retry; the card's
    size."""
    if device.type != "cuda":
        return {"reserved_peak": 0}
    stats = torch.cuda.memory_stats(device)
    return {"reserved_peak": stats["reserved_bytes.all.peak"],
            "allocated_peak": stats["allocated_bytes.all.peak"],
            "alloc_retries": stats["num_alloc_retries"],
            "card": torch.cuda.get_device_properties(device).total_memory}


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device: torch.device,
             t0: float):
    """One run of a cell: its configuration, traffic mix and limits found by
    name, the runner of the mix's kind; (outcome, result line)."""
    bench = benchmark()
    c = cell(bench, workload)
    config = config_file(bench, c["config"])
    mix = traffic_mod.load(c["traffic"])
    out = runner(mix["kind"]).run(config, mix, seed, seconds, trace, device, limits(workload),
                                  t0)
    return out, result_line(bench, workload, out, trace, device, c["chips"])


def result_line(bench: dict, workload: str, outcome: Outcome, trace: bool, device,
                chips: int = 1) -> dict:
    """The contract's last line: end-to-end metrics without ``trace``, the
    cell's per-layer metrics with it (a reader that finds nothing leaves its
    metric out), and the compared numbers last."""
    metrics = {}
    if not trace:
        for m in cell_metrics(bench, workload, "end_to_end"):
            metrics[m["name"]] = {"value": outcome.e2e[m["name"]], "unit": m["unit"]}
    else:
        for m in cell_metrics(bench, workload, "per_layer"):
            value = reader(m["name"]).read(outcome.records)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    cuda = device.type == "cuda"
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": chips, "memory_peak_bytes": outcome.memory_peak_bytes}
    line = {"correct": outcome.correct, "attempted": outcome.attempted,
            "failed": outcome.failed, "metrics": metrics, "device": dev}
    stretch = outcome.records.trace
    if trace and stretch is not None:
        dev["busy_s"] = stretch.busy_s()
        dev["window_s"] = stretch.window_s
        by_kernel: Dict[str, float] = {}
        for name, secs in stretch.kernel_seconds().items():
            by_kernel[short(name)] = by_kernel.get(short(name), 0.0) + secs
        line["breakdown"] = {"device_ops": top(by_kernel), "idle_gaps": top(stretch.idle_gaps())}
    line["compared"] = outcome.compared
    return line

