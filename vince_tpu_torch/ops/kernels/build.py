"""Build the CUDA sources under ``vince_tpu_torch/csrc`` with ``nvcc`` into
shared libraries with a plain C interface, and load them with ``ctypes``.

A library is built at first use into ``vince_tpu_torch/_build`` (listed in
``.gitignore``), named by a hash of its source and of the shared headers
(``csrc/*.cuh``), so an edited source is rebuilt and an unchanged one is
loaded as it is. ``build_all`` starts one ``nvcc`` per
source at once and waits for all of them.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-ldl",
]

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine "
                           "with the CUDA toolkit")
    return nvcc


def _target(name: str) -> Path:
    h = hashlib.sha1((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    digest = h.hexdigest()[:12]
    return BUILD_DIR / f"{name}-{digest}.so"


def build_all(names: Iterable[str], verbose: bool = False) -> Dict[str, float]:
    """Compile every named source that is not built yet, all at once; return
    the seconds each build took (0.0 for one found built)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, times = {}, {}
    for name in names:
        target = _target(name)
        if target.exists():
            times[name] = 0.0
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target, time.perf_counter())
    failed = []
    for name, (proc, tmp, target, t0) in procs.items():
        log, _ = proc.communicate()
        times[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        if verbose and log:
            print(log)
        os.replace(tmp, target)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return times


def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu``, building it if needed."""
    if name not in _LIBS:
        build_all([name])
        _LIBS[name] = ctypes.CDLL(str(_target(name)))
    return _LIBS[name]


def check(status: int, what: str):
    """Raise if a C entry point returned a CUDA error."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status}")
