"""Sync-BN in the port's train step on a 2 x 1 mesh of gloo ranks, with the
all-to-all key shuffle: the BatchNorm statistics of both encoders are the
global batch's, so the step is the one-device step. A ResNet18, 3 steps;
the metrics, weights and running averages, and the queue's inserted rows
against the port's and ``vince_tpu``'s one-device steps, at JAX's own
tolerances (metrics rtol 2e-4, atol 2e-5; weights 1e-3, 1e-5)."""

import pytest

from torch_port_mesh_common import assert_run_equal, run_meshes
from torch_port_threads import one_intra_op_thread  # noqa: F401  (a module fixture)

SYNC = dict(shuffle_mode="a2a", sync_bn=True)


@pytest.fixture(scope="module")
def synced(cpu_devices):
    return run_meshes([(2, 1)], SYNC, one_device=("port", "jax"), against_jax=False)


@pytest.mark.parametrize("against", ["port", "jax"])
def test_sync_bn_step_equals_the_one_device_step(synced, against):
    by_mesh, single = synced
    _, ranks = by_mesh[2, 1]
    for r, got in enumerate(ranks):
        assert_run_equal(got, single[against], what=f"rank {r}")
