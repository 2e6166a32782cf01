"""The command's refusals, and the per-layer readers' files."""

import json
import shutil
import subprocess
import sys

import pytest
import torch

from vince_bench import harness, run


def test_no_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert run.main(["--workload", "r18.step", "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


def test_a_checkout_of_the_benchmark_alone_gives_no_result(tmp_path):
    shutil.copytree(harness.BENCH_DIR, tmp_path / "vince_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    out = subprocess.run([sys.executable, "-m", "vince_bench.run", "--workload", "r18.step",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""


def test_every_metric_has_its_reader():
    bench = harness.benchmark()
    for m in bench["per_layer"]:
        module = harness.reader(m["name"])
        assert module.LAYER == m["layer"] and module.MOVES == m["moves"], m["name"]
        for w in m["workloads"]:
            assert m["moves"] in {e["name"] for e in harness.cell_metrics(bench, w, "end_to_end")}
    assert harness.reader("data_wait_ms").LAYER == "loader and staging"
    assert {w["name"] for w in bench["workloads"]} == {
        p.stem for p in (harness.BENCH_DIR / "limits").glob("*.json")}
    json.dumps(bench)
