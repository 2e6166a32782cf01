"""The benchmark loads neither JAX nor the JAX package, compared by whole
top-level names, and its reference loads nothing of the program."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from vince_bench import harness

BENCH = Path(harness.__file__).resolve().parent


@pytest.mark.parametrize("modules, found", [
    ({"vince_tpu_torch", "vince_tpu_torch.ops.augment", "jaxtyping", "flaxen"}, []),
    ({"vince_tpu.models.resnet", "torch"}, ["vince_tpu"]),
    ({"jax", "jaxlib.xla_client", "optax", "orbax.checkpoint", "flax.linen"},
     ["flax", "jax", "jaxlib", "optax", "orbax"]),
])
def test_forbidden_names_compare_whole(modules, found):
    assert harness.forbidden_modules(modules) == found


def _run(code: str) -> str:
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.strip().splitlines()[-1]


def test_a_cpu_run_loads_no_jax():
    """The set-up, a short window, the trace's reduction and the reference,
    at a tiny size on the CPU, in a fresh process."""
    last = _run(
        "import sys, time, torch\n"
        "sys.path.insert(0, 'vince_bench/tests')\n"
        "import tiny\n"
        "from vince_bench import harness\n"
        "cfg = tiny.config('vince-r18')\n"
        "out = harness.runner('step').run(cfg, tiny.step_traffic(), 5, 0.5, True,\n"
        "                                 torch.device('cpu'), harness.limits('r18.step'),\n"
        "                                 time.perf_counter())\n"
        "harness.result_line(harness.benchmark(), 'r18.step', out, True, torch.device('cpu'))\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] == 'vince_tpu_torch')[:1],\n"
        "      harness.forbidden_modules())\n")
    assert last == "['vince_tpu_torch'] []"


def test_the_reference_loads_nothing_of_the_program():
    last = _run(
        "import sys\n"
        "import vince_bench.reference.step, vince_bench.check, vince_bench.counts\n"
        "import vince_bench.reference.models.resnet, vince_bench.flops.resnet\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & {'vince_tpu_torch', 'vince_tpu',"
        " 'jax', 'jaxlib', 'flax'}))\n")
    assert last == "[]"


def test_the_reference_imports_name_no_program():
    for path in sorted((BENCH / "reference").rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                assert name.split(".")[0] in {"torch", "math", "dataclasses", "typing", "types",
                                              "json", "pathlib", "vince_bench"}, (path.name, name)
