"""The port stands alone: importing every ``vince_tpu_torch`` module pulls in
neither JAX nor the JAX package, and no source of the port or of
``chip_smoke.py`` names them."""

import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
SOURCES = sorted((ROOT / "vince_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]

_IMPORT_ALL = """
import importlib, pkgutil, sys
import vince_tpu_torch
for m in pkgutil.walk_packages(vince_tpu_torch.__path__, "vince_tpu_torch."):
    importlib.import_module(m.name)
bad = sorted(k for k in sys.modules if k.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "vince_tpu"))
print(len([k for k in sys.modules if k.startswith("vince_tpu_torch")]), bad)
assert not bad, bad
"""


def test_importing_the_port_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert int(out.stdout.split()[0]) >= 20  # every module was imported


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_source_names_no_jax(path):
    text = path.read_text()
    assert not re.search(r"\bvince_tpu\.", text), path
    assert not re.search(r"^\s*(import|from)\s+(jax|flax|optax)\b", text, re.M), path
