"""The port's training CLI in 2 processes of a gloo group on the CPU
(``solver_runner.main --distributed --platform cpu`` with the three explicit
flags): a tiny ResNet18 for 2 iterations and a save, on a 2 x 1 mesh (loaders
sharded by data index, sync-BN, the a2a key shuffle) and on a 1 x 2 mesh (the
queue in two shards, the batch broadcast along the queue axis). Then a
single-process restore of each checkpoint, on one device, bit-identical to
the file, whose queue is the ranks' shards put together; and the multi-process
helpers of one process, which are the local computation."""

import os

import numpy as np
import pytest
import torch

from torch_port_ranks import cli_rank, spawn_processes
from torch_port_threads import one_intra_op_thread  # noqa: F401  (a module fixture)
from vince_tpu_torch import arg_parser
from vince_tpu_torch.parallel import multihost
from vince_tpu_torch.solvers.vince_solver import VinceSolver
from vince_tpu_torch.utils.checkpoint import CheckpointManager, state_tree

MESHES = {"2x1": ["--sync-bn", "--shuffle-mode", "a2a"], "1x2": ["--mesh-queue-size", "2"]}


def _argv(tmp, *extra):
    return ["--title", "run", "--description", "cpu", "--solver", "VinceSolver",
            "--backbone", "ResNet18", "--dataset", "SyntheticTextureVideoDataset",
            "--use-videos", "--inter-batch-comparison", "--num-frames", "2",
            "--batch-size", "8", "--input-width", "32", "--input-height", "32",
            "--vince-queue-size", "32", "--vince-embedding-size", "16",
            "--iterations-per-epoch", "2", "--epochs", "1", "--save-frequency", "2",
            "--base-lr", "0.03", "--num-workers", "1", "--synthetic-num-videos", "8",
            "--platform", "cpu", "--debug", "--base-logdir", str(tmp), *extra]


@pytest.fixture(scope="module", params=list(MESHES))
def run(request, tmp_path_factory):
    tmp = tmp_path_factory.mktemp(request.param)
    ranks = spawn_processes(cli_rank, 2, _argv(tmp, *MESHES[request.param]))
    return request.param, tmp, ranks


def test_both_processes_train_the_same_model_and_save(run):
    name, tmp, ranks = run
    assert [r["mesh"] for r in ranks] == [(2, 1) if name == "2x1" else (1, 2)] * 2
    assert [r["step"] for r in ranks] == [2, 2]
    assert [int(r["tail"]) for r in ranks] == [16, 16]
    for k, v in ranks[0]["model"].items():
        np.testing.assert_array_equal(ranks[1]["model"][k], v, err_msg=k)
    assert os.listdir(os.path.join(tmp, "run", "checkpoints_cpu")) == ["2"]


def test_one_process_restores_the_checkpoint_bit_identically(run):
    name, tmp, ranks = run
    saved = CheckpointManager(os.path.join(tmp, "run", "checkpoints_cpu")).restore_raw()
    queue = (ranks[0]["queue"] if name == "2x1"
             else np.concatenate([ranks[0]["queue"], ranks[1]["queue"]]))
    np.testing.assert_array_equal(saved["queue"]["vectors"].numpy(), queue)
    for k, v in ranks[0]["model"].items():
        np.testing.assert_array_equal(saved["model"][k].numpy(), v, err_msg=k)
    solver = VinceSolver(arg_parser.parse_args(_argv(tmp)))
    try:
        assert solver.mesh is None and solver.state.step == 2
        restored = state_tree(solver.state)
        for part in ("model", "key_model", "optimizer", "queue"):
            for k, v in saved[part].items():
                assert torch.equal(restored[part][k], v), f"{part}.{k}"
    finally:
        solver.end()


def test_one_process_helpers_are_the_local_computation():
    assert not torch.distributed.is_initialized()
    assert multihost.process_count() == 1 and multihost.process_index() == 0
    assert multihost.is_primary() and not multihost.is_multiprocess()
    tree = {"a": [1, 2]}
    assert multihost.broadcast_host(tree) is tree
    x = torch.arange(6.0).reshape(3, 2)
    np.testing.assert_array_equal(multihost.fetch(x), x.numpy())
    np.testing.assert_array_equal(multihost.host_allsum([1.5, 2.0]), [1.5, 2.0])
    multihost.sync()
    np.testing.assert_array_equal(multihost.local_slice(np.arange(8), 1, 4), [2, 3])
    assert multihost.local_device("cpu") == torch.device("cpu")
    assert multihost.initialize(arg_parser.parse_args(_argv("/nonexistent"))) is False
