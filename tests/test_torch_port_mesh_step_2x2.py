"""The port's train step on a 2 x 2 (data x queue) mesh of 4 gloo ranks,
against ``vince_tpu``'s ``shard_map`` step on a 2 x 2 mesh of virtual
devices and against the port's one-device step, as
``test_torch_port_mesh_step.py`` holds the (2,1) and (1,2) meshes: GroupNorm
ResNet18, 3 steps, the metrics, weights and queue rows at JAX's own
tolerances."""

import pytest

from torch_port_mesh_common import assert_run_equal, run_meshes
from torch_port_threads import one_intra_op_thread  # noqa: F401  (a module fixture)

OPTIONS = dict(norm_kind="groupnorm")


@pytest.fixture(scope="module")
def runs(cpu_devices):
    return run_meshes([(2, 2)], OPTIONS, one_device=("port",))


@pytest.mark.parametrize("against", ["jax", "one device"])
def test_mesh_step_2x2(runs, against):
    by_mesh, single = runs
    ref, ranks = by_mesh[2, 2]
    for r, got in enumerate(ranks):
        assert_run_equal(got, ref if against == "jax" else single["port"], what=f"rank {r}")
