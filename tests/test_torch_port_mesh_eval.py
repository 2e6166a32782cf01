"""The port's eval and key-prefill steps on a 2 x 2 (data x queue) mesh of 4
gloo ranks against ``vince_tpu``'s on a 2 x 2 mesh of virtual devices: a
ResNet18 with BatchNorm (per-rank statistics, the keys shuffled across the
data axis), queue 64 in two shards. The eval step's metrics (averaged over
the data axis; the queue term merged over the queue axis) at rtol 2e-4,
atol 2e-5, and the prefill's embeddings (each rank's rows, gathered over the
data axis) at 1e-3, 1e-5, on every rank. The batch is read as the augmented
images on both sides, with one fixed permutation."""

import numpy as np
import pytest

from torch_port_mesh_common import (
    METRIC_TOL, PARAM_TOL, SOURCE, batches, config, jax_run, patch, perms)
from torch_port_ranks import mesh_step_rank, spawn
from torch_port_threads import one_intra_op_thread  # noqa: F401  (a module fixture)

OPTIONS = {}


@pytest.fixture(scope="module")
def runs(cpu_devices):
    mp = pytest.MonkeyPatch()
    try:
        patch(mp, perms(2))
        ref = jax_run(2, 2, OPTIONS, what=("eval", "prefill"))
    finally:
        mp.undo()
    ranks = spawn(mesh_step_rank, 4, 2, 2, dict(config(**OPTIONS), source=SOURCE), ref["tree"],
                  batches(steps=1), perms(2), ("eval", "prefill"))
    return ref, ranks


def test_eval_step_equals_jax(runs):
    ref, ranks = runs
    for r, got in enumerate(ranks):
        assert got["eval"].keys() == ref["eval"].keys()
        for k, v in ref["eval"].items():
            np.testing.assert_allclose(float(got["eval"][k]), v, **METRIC_TOL,
                                       err_msg=f"rank {r} {k}")


def test_prefill_equals_jax(runs):
    ref, ranks = runs
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got["prefill"], ref["prefill"], **PARAM_TOL,
                                   err_msg=f"rank {r}")
