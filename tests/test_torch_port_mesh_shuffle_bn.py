"""Shuffled BN across ranks in the port's train step, on a 2 x 1 mesh of
gloo ranks against ``vince_tpu``'s ``shard_map`` step on 2 virtual devices: a
ResNet18 with BatchNorm (per-rank statistics, so the key shuffle across the
data axis decides them), the keys moved by the gather or by the balanced
all-to-all (JAX's sigma and tau fed to both). 3 steps; the metrics, the query
encoder's weights and BatchNorm running averages, and the queue's inserted
rows, at JAX's own tolerances (metrics rtol 2e-4, atol 2e-5; weights 1e-3,
1e-5). Sync-BN on the mesh is ``test_torch_port_mesh_sync_bn_step.py``."""

import pytest

from torch_port_mesh_common import assert_run_equal, run_jobs
from torch_port_threads import one_intra_op_thread  # noqa: F401  (a module fixture)

PER_RANK = {"gather": dict(shuffle_mode="gather"), "a2a": dict(shuffle_mode="a2a")}


@pytest.fixture(scope="module")
def per_rank(cpu_devices):
    """Both modes from one initial state, their ranks in one spawn."""
    return run_jobs([(2, 1, options) for options in PER_RANK.values()])[0]


@pytest.mark.parametrize("mode", list(PER_RANK))
def test_shuffled_bn_step_equals_jax(per_rank, mode):
    ref, ranks = per_rank[2, 1, tuple(sorted(PER_RANK[mode].items()))]
    for r, got in enumerate(ranks):
        assert_run_equal(got, ref, what=f"{mode} rank {r}")
