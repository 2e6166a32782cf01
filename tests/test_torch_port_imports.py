"""The port stands alone: importing every ``vince_tpu_torch`` module pulls in
neither JAX nor the JAX package, reaches for the network, or starts a thread
or a process; and no source of the port or of ``chip_smoke.py`` names them.
Every module imports with ``cv2``, ``sklearn``, ``tensorboardX`` and
``orbax`` absent, as on the GPU machine."""

import pathlib
import re
import subprocess
import sys

import pytest

from torch_port_threads import one_intra_op_thread  # noqa: F401  (a module fixture)

ROOT = pathlib.Path(__file__).resolve().parents[1]
SOURCES = sorted((ROOT / "vince_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]

_IMPORT_ALL = """
import importlib, multiprocessing, pkgutil, socket, sys, threading
for absent in ("cv2", "sklearn", "tensorboardX", "orbax"):
    sys.modules[absent] = None  # an import of it raises ImportError
def refuse(*args, **kwargs):
    raise OSError("an import reached for the network")
socket.socket.connect = socket.create_connection = socket.getaddrinfo = refuse
import vince_tpu_torch
for m in pkgutil.walk_packages(vince_tpu_torch.__path__, "vince_tpu_torch."):
    importlib.import_module(m.name)
bad = sorted(k for k in sys.modules if k.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "vince_tpu"))
print(len([k for k in sys.modules if k.startswith("vince_tpu_torch")]), bad)
assert not bad, bad
for name in ("models.efficientnet", "ops.kernels.depthwise_kernel", "ops.kernels.conv_bn_kernel",
             "ops.kernels.folded_dot_kernel", "ops.kernels.infonce_kernel", "solvers.vince_step",
             "solver_runner", "solvers.vince_solver", "utils.checkpoint", "data.loader",
             "data.prefetch", "visualizations.panels", "models.linear_model",
             "models.kinetics_model", "solvers.end_task_step", "solvers.end_task_solvers",
             "run_end_task_eval", "models.tracking_model", "ops.xcorr", "tracking.losses",
             "tracking.ops", "tracking.siamfc_transforms", "tracking.sequences",
             "tracking.tracker", "tracking.experiments", "data.pair_dataset",
             "data.got10k_dataset", "utils.torch_convert", "ops.infonce", "parallel.launch",
             "visualizations.attention", "visualizations.dataset_mosaic",
             "visualizations.view_nearest_neighbors", "utils.video_utils", "utils.youtube_utils",
             "data.video_cacher_dataset", "scrape.drive", "scrape.cache_video_dataset",
             "scrape.recreate_r2v2_dataset", "scrape.download_kinetics", "scrape.download_r2v2",
             "scrape.search_youtube_for_urls", "scrape.download_pretrained_weights"):
    assert "vince_tpu_torch." + name in sys.modules, name
# the tools beside the package (a directory without __init__.py)
for name in ("convert_reference_checkpoint", "export_reference_checkpoint", "eval_retrieval",
             "soak_multichip", "audit_collectives", "dryrun_multichip"):
    importlib.import_module("vince_tpu_torch.tools." + name)
bad = sorted(k for k in sys.modules if k.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "vince_tpu"))
assert not bad, bad
# no import started a thread or a process
assert threading.active_count() == 1, threading.enumerate()
assert not multiprocessing.active_children()
from vince_tpu_torch.utils.logger import Logger
assert Logger("unused").writer is None  # the in-memory history only
"""


def test_importing_the_port_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert int(out.stdout.split()[0]) >= 45  # every module was imported


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_source_names_no_jax(path):
    text = path.read_text()
    assert not re.search(r"\bvince_tpu\.", text), path
    assert not re.search(r"^\s*(import|from)\s+(jax|flax|optax)\b", text, re.M), path
