"""The port's end-task steps on a 2 x 1 mesh of gloo ranks against
``vince_tpu``'s ``shard_map`` end-task step on 2 virtual devices, for the
video tasks: Kinetics-400 (Adam, frozen, 2 clips of 4 frames: a clip a rank)
and tracking (SGD, fine-tuned: the statistics chained through the exemplar
and the search forwards, then averaged over the data axis). The cases, the
runs and the checks are ``test_torch_port_mesh_end_task_step.py``'s."""

import pytest

from tests.test_torch_port_mesh_end_task_step import (
    STEPS, check_eval_rows, check_step_metrics, check_step_state, run_cases)
from torch_port_threads import one_intra_op_thread  # noqa: F401  (a module fixture)

NAMES = ("kinetics", "tracking")


@pytest.fixture(scope="module")
def runs(cpu_devices, tmp_path_factory):
    return run_cases(NAMES, tmp_path_factory)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("step", range(STEPS))
def test_mesh_step_metrics(runs, name, step):
    check_step_metrics(runs, name, step)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("step", range(STEPS))
def test_mesh_step_state(runs, name, step):
    check_step_state(runs, name, step)


@pytest.mark.parametrize("name", NAMES)
def test_mesh_eval_rows_in_rank_order(runs, name):
    check_eval_rows(runs, name)
