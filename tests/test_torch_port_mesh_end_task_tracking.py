"""The tracking end task across processes on the CPU, 2 gloo ranks:
``solver_runner.main`` with ``--distributed`` (ResNet18 mapped to its
dilated variant, 120² pairs, one iteration, the val pass over 16 GOT-10k
pairs: the same state and val pass on both ranks), the checkpoint restored
by one process, and ``run_eval`` (the OTB fallback, one sequence of 3
frames) on rank 0 alone while rank 1 waits for its outcome. The runs and
checks are ``test_torch_port_mesh_end_task_solver.py``'s."""

import pytest

from tests.test_torch_port_mesh_end_task_solver import check_cli_run, check_restore, run_solvers
from torch_port_threads import one_intra_op_thread  # noqa: F401  (a module fixture)

NAME = "EndTaskTrackingSolver"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_solvers((NAME,), tmp_path_factory, tracking_eval=True)


def test_cli_run_across_processes(runs):
    check_cli_run(runs, NAME)


def test_distributed_checkpoint_restores_in_one_process(runs, monkeypatch):
    check_restore(runs, NAME, monkeypatch)


def test_tracking_eval_runs_on_rank_0(runs):
    first, second = (r["otb"] for r in runs["ranks"])
    assert second == {}
    assert first["synthetic"] == 1.0 and 0.0 <= first["precision"] <= 1.0
    assert 0.0 <= first["success"] <= 1.0
