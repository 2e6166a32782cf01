"""The port's end-task val pass across processes on the CPU, as
``tests/test_multihost.py::test_two_process_endtask_val_parity_with_filler``
holds JAX's: a 49-item val split over 2 gloo ranks, whose shards are 25 and
24 items, 12 a batch on each rank, so the second rank runs a zero-weight
filler batch; both count 49 samples in 3 batches, and the results equal the
one-process pass's within 5e-5 + 1e-5·|v|, which equals JAX's one-process
pass (on 2 virtual devices) from the same state, carried into the port. The
ranks start beside JAX's pass and read its state from a file when it is
written."""

import concurrent.futures
import os

import jax
import numpy as np
import pytest
import torch

from torch_port_ranks import RANK_TIMEOUT_S, VAL_ITEMS, odd_val_pass, odd_val_rank, spawn
from torch_port_threads import one_intra_op_thread  # noqa: F401  (a module fixture)
from vince_tpu import arg_parser as jax_arg_parser
from vince_tpu.data.synthetic_dataset import SyntheticImageDataset as JaxImages
from vince_tpu.solvers.end_task_solvers import EndTaskSunSceneSolver as JaxSun
from vince_tpu_torch import arg_parser
from vince_tpu_torch.solvers import end_task_solvers
from vince_tpu_torch.utils.checkpoint import end_task_state_tree
from vince_tpu_torch.utils.jax_weights import load_jax_end_task_state

# tests/helpers/multihost_endtask_worker.py's flags
VAL_ARGV = ["--title", "mh_et", "--description", "t", "--solver", "EndTaskSunSceneSolver",
            "--dataset", "SyntheticImageDataset", "--batch-size", "24", "--input-width", "32",
            "--input-height", "32", "--vince-embedding-size", "16",
            "--end-task-classifier-num-classes", "4", "--iterations-per-epoch", "1",
            "--epochs", "1", "--base-lr", "0.05", "--mesh-data-size", "2", "--num-workers", "1",
            "--freeze-feature-extractor", "--no-restore", "--no-save", "--debug"]


def _tol(v):
    return 5e-5 + 1e-5 * abs(v)


def _copied(tree):
    if isinstance(tree, dict):
        return {k: _copied(v) for k, v in tree.items()}
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


class JaxOddVal(JaxSun):
    def _make_dataset(self, subset):
        return JaxImages(self.args, subset, num_images=VAL_ITEMS if subset == "val" else 64)


@pytest.fixture(scope="module")
def runs(cpu_devices, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_end_task_val")
    folder = tmp / "cases"
    folder.mkdir()
    argv = VAL_ARGV + ["--platform", "cpu", "--base-logdir", str(tmp)]
    pool = concurrent.futures.ThreadPoolExecutor(1)
    ranks = pool.submit(spawn, odd_val_rank, 2, str(folder), argv)
    try:
        solver = JaxOddVal(jax_arg_parser.parse_args(
            VAL_ARGV + ["--platform", "cpu", "--base-logdir", str(tmp / "jax")]))
        try:
            solver.reset_epoch()
            jax_val = dict(results=solver.run_eval(), batches=solver.last_val_batches,
                           samples=solver.last_val_samples)
            jax_state = jax.tree_util.tree_map(np.asarray, jax.device_get(solver.state))
        finally:
            solver.end()
        port = end_task_solvers.EndTaskSunSceneSolver(
            arg_parser.parse_args(argv + ["--disable-dataloader"]))
        try:
            load_jax_end_task_state(port.state, jax_state)
            tree = _copied(end_task_state_tree(port.state))
        finally:
            port.end()
        torch.save(tree, folder / "state.tmp")
        os.rename(folder / "state.tmp", folder / "state.pt")
        one = odd_val_pass(argv, tree)
    except BaseException:
        (folder / "abort").touch()
        raise
    finally:
        pool.shutdown(wait=False)
    return dict(jax=jax_val, one=one, ranks=ranks.result(timeout=RANK_TIMEOUT_S))


def test_one_process_val_pass_is_jax(runs):
    one, ref = runs["one"], runs["jax"]
    assert (one["samples"], one["batches"], one["mesh"]) == (49, 3, None)
    assert (ref["samples"], ref["batches"]) == (49, 3)
    assert sorted(one["results"]) == sorted(ref["results"])
    for k, v in ref["results"].items():
        assert abs(one["results"][k] - float(v)) <= _tol(float(v)), (k, one["results"][k], v)


def test_distributed_val_pass_with_filler(runs):
    """25 and 24 items; 3 batches on both ranks (the second's last a filler
    of weight 0); 49 samples; the one-process results, and JAX's."""
    got = runs["ranks"]
    assert [g["items"] for g in got] == [25, 24]
    for g in got:
        assert (g["samples"], g["batches"], g["mesh"]) == (49, 3, 2)
        assert g["results"] == got[0]["results"]
        for ref in (runs["one"]["results"], runs["jax"]["results"]):
            for k, v in ref.items():
                assert abs(g["results"][k] - float(v)) <= _tol(float(v)), (k, g["results"][k], v)
