"""A later change adds a backbone (a configuration, its reference encoder and
its counter of operations), a traffic kind (its runner and a mix), a
per-layer metric, an end-to-end metric and a cell, each as a new file or a
new entry: the harness, run from a copy of the benchmark in a fresh
process, finds them by name, and no file it had changes."""

import hashlib
import json
import os
import shutil
import subprocess
import sys

from vince_bench import harness

import tiny

CELL = "r34-small.step-rate"

NEW_FILES = {
    "reference/models/resnet34.py": '''"""ResNet34: the reference's ResNet blocks at (3, 4, 6, 3) basic blocks."""

from vince_bench.reference.layers import make_params as from_specs
from vince_bench.reference.models import resnet

ARCH = ((3, 4, 6, 3), "basic")


def make_params(backbone, embed, gen):
    return from_specs(resnet.param_specs(ARCH, embed), gen)


def forward(p, backbone, images, quant=None, remat=False):
    return resnet.forward_arch(ARCH, p, images, quant, remat)
''',
    "flops/resnet34.py": '''"""ResNet34's operations; it has no K2 site."""

from vince_bench.flops import resnet

ARCH = ((3, 4, 6, 3), "basic")


def encoder_flops(backbone, image, embed):
    return resnet.arch_flops(ARCH, image, embed)
''',
    "runners/step_rate.py": '''"""The step traffic with one more end-to-end metric: steps a second."""

from vince_bench.runners import step


def run(config, traffic, *args):
    out = step.run(config, traffic, *args)
    out.e2e["steps_per_s"] = out.records.steps / out.records.window_s
    return out
''',
    "metrics/steps_traced.py": '''LAYER = "step"
MOVES = "frames_per_s"


def read(rec):
    return float(rec.trace.steps) if rec.trace is not None else None
''',
}

RUN = '''
import json, sys, time
from pathlib import Path
import torch
from vince_bench import harness
assert harness.BENCH_DIR == Path.cwd() / "vince_bench", harness.BENCH_DIR
for trace in (False, True):
    # a window of several CPU steps, so that the traced stretch at its end holds one
    out, line = harness.run_cell(sys.argv[1], 4, 2.0, trace, torch.device("cpu"),
                                 time.perf_counter())
    print(json.dumps(line))
'''


def _digests(root):
    return {p.relative_to(root): hashlib.sha1(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_new_files_are_found(tmp_path):
    shutil.copytree(harness.BENCH_DIR, tmp_path / "vince_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    bench_dir = tmp_path / "vince_bench"
    before = _digests(bench_dir)

    for rel, text in NEW_FILES.items():
        assert not (bench_dir / rel).exists(), rel
        (bench_dir / rel).write_text(text)
    config = dict(tiny.config("vince-r18"), name="vince-r34-small", backbone="ResNet34",
                  reference_model="resnet34", flops="resnet34")
    (bench_dir / "configs" / "vince-r34-small.json").write_text(json.dumps(config))
    (bench_dir / "traffic" / "step-rate.json").write_text(
        json.dumps(dict(tiny.step_traffic(), kind="step_rate")))
    (bench_dir / "limits" / f"{CELL}.json").write_text(
        json.dumps({"limits": harness.limits("r18.step")}))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "vince-r34-small", "source": "test",
                             "file": "vince_bench/configs/vince-r34-small.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": CELL, "config": "vince-r34-small",
                               "traffic": "step-rate", "chips": 1, "why": "test"})
    bench["end_to_end"].append({"name": "steps_per_s", "unit": "steps/s", "better": "higher",
                                "bound": 0.05, "source": "host_clock", "workloads": [CELL]})
    bench["per_layer"].append({"name": "steps_traced", "unit": "steps", "better": "higher",
                               "source": "host_clock", "layer": "step", "moves": "frames_per_s",
                               "workloads": [CELL]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    assert {p: d for p, d in _digests(bench_dir).items() if p in before} == before

    env = dict(os.environ, PYTHONPATH=str(harness.ROOT))  # the program, from this checkout
    out = subprocess.run([sys.executable, "-c", RUN, CELL], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    untraced, traced = (json.loads(line) for line in out.stdout.strip().splitlines()[-2:])
    assert untraced["correct"] and traced["correct"], (untraced, traced)
    assert set(untraced["metrics"]) == {"frames_per_s", "peak_mem_gib", "setup_s",
                                        "steps_per_s"}
    assert set(traced["metrics"]) == {"steps_traced"}
    assert traced["metrics"]["steps_traced"]["value"] >= 1
