"""The port's end-task solvers across processes on the CPU, 2 gloo ranks (the
val pass over a 49-item split with its filler batch, against JAX's:
``test_torch_port_mesh_end_task_val.py``; tracking:
``test_torch_port_mesh_end_task_tracking.py``, with this file's runs and
checks):

- ``solver_runner.main`` with ``--distributed`` for the ImageNet probe, the
  SUN fine-tune and the Kinetics LSTM (ResNet18, 32², embeddings 16) on val
  splits cut for the CPU: the same state and val pass on both ranks, every
  item counted once; the checkpoint, written by rank 0, restored by one
  process, whose val pass gives the same results.
- A failed process under ``--distributed`` skips the crash save."""

import argparse
import contextlib
import io
import json

import numpy as np
import pytest

from torch_port_ranks import end_task_solvers_rank, small_val_splits, spawn
from torch_port_threads import one_intra_op_thread  # noqa: F401  (a module fixture)
from vince_tpu_torch import arg_parser, run_end_task_eval, solver_runner

COMMON = ["--input-width", "32", "--input-height", "32", "--vince-embedding-size", "16",
          "--iterations-per-epoch", "2", "--epochs", "1", "--base-lr", "0.01",
          "--num-workers", "1", "--save-frequency", "100", "--platform", "cpu", "--debug"]
RUNS = {
    "EndTaskImagenetSolver": ["--dataset", "SyntheticImageDataset", "--batch-size", "8",
                              "--end-task-classifier-num-classes", "4",
                              "--freeze-feature-extractor"],
    "EndTaskSunSceneSolver": ["--dataset", "SyntheticImageDataset", "--batch-size", "8",
                              "--end-task-classifier-num-classes", "4"],
    "EndTaskKinetics400Solver": ["--dataset", "SyntheticClipDataset", "--batch-size", "8",
                                 "--num-frames", "2", "--end-task-classifier-num-classes", "4",
                                 "--freeze-feature-extractor"],
    "EndTaskTrackingSolver": ["--dataset", "GOT10kDataset", "--backbone", "ResNet18",
                              "--batch-size", "4", "--input-width", "120",
                              "--input-height", "120", "--freeze-feature-extractor",
                              "--iterations-per-epoch", "1"],
}
VAL_LEN = {"EndTaskImagenetSolver": 33, "EndTaskSunSceneSolver": 33,
           "EndTaskKinetics400Solver": 9, "EndTaskTrackingSolver": 16}


def _tol(v):
    return 5e-5 + 1e-5 * abs(v)


def _argv(tmp, solver):
    # the run's own flags after the common ones: argparse keeps the last
    return ["--title", "cli", "--description", solver, "--solver", solver,
            "--base-logdir", str(tmp), *COMMON, *RUNS[solver]]


NAMES = ("EndTaskImagenetSolver", "EndTaskKinetics400Solver", "EndTaskSunSceneSolver")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_solvers(NAMES, tmp_path_factory)


def run_solvers(names, tmp_path_factory, tracking_eval=False):
    """The CLI runs of ``names`` on 2 ranks (and tracking's ``run_eval``)."""
    tmp = tmp_path_factory.mktemp("mesh_end_task_solvers")
    runs = {name: _argv(tmp, name) + ["--distributed"] for name in names}
    otb = (_argv(tmp, "EndTaskTrackingSolver") + ["--disable-dataloader"]
           if tracking_eval else None)
    return dict(tmp=tmp, ranks=spawn(end_task_solvers_rank, 2, runs, otb))


@pytest.mark.parametrize("name", NAMES)
def test_cli_runs_across_processes(runs, name):
    check_cli_run(runs, name)


@pytest.mark.parametrize("name", NAMES)
def test_distributed_checkpoint_restores_in_one_process(runs, name, monkeypatch):
    check_restore(runs, name, monkeypatch)


def check_cli_run(runs, name):
    """Both ranks: a data axis of 2, the same state, the same val pass over
    every item once (ceil(ceil(N / 2) / (items / 2)) batches each)."""
    got = [r[name] for r in runs["ranks"]]
    frames = 2 if name == "EndTaskKinetics400Solver" else 1
    batch = int(RUNS[name][RUNS[name].index("--batch-size") + 1])
    per_rank = batch // frames // 2
    n = VAL_LEN[name]
    for g in got:
        assert g["mesh"] == 2
        assert g["step"] == (1 if name == "EndTaskTrackingSolver" else 2)
        assert (g["samples"], g["batches"]) == (n, -(-(-(-n // 2)) // per_rank))
        assert g["results"] == got[0]["results"]
        assert all(np.isfinite(v) for v in g["results"].values())
    for part in ("encoder", "decoder"):
        for k, v in got[0]["state"][part].items():
            np.testing.assert_array_equal(got[1]["state"][part][k], v, err_msg=f"{part} {k}")


def check_restore(runs, name, monkeypatch):
    """The checkpoint that rank 0 wrote restores in one process, bit for bit,
    and ``run_end_task_eval`` (one process) gives the distributed val pass's
    results."""
    small_val_splits(monkeypatch.setattr)
    argv = _argv(runs["tmp"], name) + ["--disable-dataloader"]
    rank0 = runs["ranks"][0][name]
    solver = solver_runner.get_solver_class(name)(arg_parser.parse_args(argv))
    try:
        assert solver.mesh is None and solver.state.step == rank0["step"]
        for part in ("encoder", "decoder"):
            for k, v in solver.state.__dict__[part].state_dict().items():
                np.testing.assert_array_equal(v.numpy(), rank0["state"][part][k], err_msg=k)
    finally:
        solver.end()
    if name == "EndTaskTrackingSolver":
        return  # its run_eval is the OTB evaluation: test_tracking_eval_runs_on_rank_0
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        run_end_task_eval.main(argv)
    line = [x for x in out.getvalue().splitlines() if x.startswith("EVAL_RESULT ")]
    assert len(line) == 1, out.getvalue()[-2000:]
    printed = json.loads(line[0][len("EVAL_RESULT "):])
    for k, v in rank0["results"].items():
        assert abs(printed[k] - v) <= _tol(v), (k, printed[k], v)


def test_crash_under_distributed_skips_the_save(monkeypatch, capsys):
    """A failed process of a distributed run does not take the crash save
    (a collective its peers, stuck in the step, never join) and exits 1."""

    class Failing:
        epoch, iterations_per_epoch = 0, 1
        saved = ended = False

        def __init__(self, *args):
            pass

        def reset_epoch(self):
            pass

        def run_train_iteration(self):
            raise RuntimeError("a peer went away")

        def save(self):
            Failing.saved = True

        def end(self):
            Failing.ended = True

    monkeypatch.setattr(solver_runner, "get_solver_class", lambda name: Failing)
    monkeypatch.setattr(solver_runner.multihost, "is_multiprocess", lambda: True)
    with pytest.raises(SystemExit) as exit_info:
        solver_runner.main(["--title", "t", "--description", "d", "--solver",
                            "EndTaskSunSceneSolver", "--debug", "--platform", "cpu"])
    assert exit_info.value.code == 1
    assert not Failing.saved and Failing.ended
    assert "skipping the (collective) crash-save" in capsys.readouterr().out


@pytest.mark.parametrize("asked,processes,expected", [
    (0, 1, 1), (0, 4, 4), (4, 4, 4), (8, 2, 2), (2, 1, 1), (1, 2, None), (2, 4, None)])
def test_data_axis_is_every_process(monkeypatch, asked, processes, expected):
    """The end task's data axis is the process count: a larger
    ``--mesh-data-size`` is clamped to it, as JAX clamps it to the devices,
    and a smaller one, which cannot divide over the processes, raises
    JAX's error."""
    from vince_tpu_torch.solvers import end_task_solvers

    monkeypatch.setattr(end_task_solvers.multihost, "process_count", lambda: processes)
    args = argparse.Namespace(mesh_data_size=asked)
    if expected is None:
        with pytest.raises(ValueError, match=f"--mesh-data-size {asked} must be divisible "
                                             f"by the {processes} processes"):
            end_task_solvers.data_axis_size(args)
    else:
        assert end_task_solvers.data_axis_size(args) == expected
