"""The benchmark of the PyTorch and CUDA port, ``vince_tpu_torch``: one run of
one cell of ``BENCHMARK.json``, from the root of a checkout:

    python3 -m vince_bench.run --workload r50-large.step --seed 7 --seconds 30 --trace 0

It loads, warms up, checks the program's first steps against the plain
reference's set-up values, measures for ``--seconds`` and prints one JSON
line last on standard output: the end-to-end metrics with ``--trace 0``,
the per-layer metrics with ``--trace 1`` (the end of the window under the
profiler), and under ``compared`` each number of the check beside its limit,
which also end standard error. It exits with another code than 0, and prints
no result, without a CUDA device for each chip the cell asks for, without
the program, or when JAX or the JAX package was loaded.
"""

import time

T0 = time.perf_counter()  # set-up is timed from the process's start

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# caches of compiled code inside the checkout, at fixed paths: the first run
# of a cell fills them, every later one finds them (the port's own kernels
# build into vince_tpu_torch/_build)
CACHE_DIRS = {"TRITON_CACHE_DIR": ROOT / ".bench_cache" / "triton",
              "CUDA_CACHE_PATH": ROOT / ".bench_cache" / "cuda"}


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def card_and_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"


def main(argv=None) -> int:
    args = parse(argv)
    for key, path in CACHE_DIRS.items():
        os.environ.setdefault(key, str(path))
    import torch

    from vince_bench import harness

    bench = harness.benchmark()
    cell = harness.cell(bench, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} present",
              file=sys.stderr)
        return 3
    if not (ROOT / "vince_tpu_torch" / "__init__.py").exists():
        print("the program under test, vince_tpu_torch, is not in this checkout",
              file=sys.stderr)
        return 3
    outcome, line = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                                     torch.device("cuda", 0), T0)
    found = harness.forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)} (JAX or the JAX package)",
              file=sys.stderr)
        return 4
    print(f"card: {card_and_limit()}", file=sys.stderr)
    print("seconds: " + ", ".join(f"{k} {v:.3f}" for k, v in outcome.phases.items()),
          file=sys.stderr)
    print("memory: " + ", ".join(f"{k} {v}" for k, v in outcome.memory.items()),
          file=sys.stderr)
    for name, c in line["compared"].items():
        print(f"compared {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
