"""The port's train step on (data x queue) meshes of 2 gloo ranks — (2,1)
and (1,2) — against ``vince_tpu``'s ``shard_map`` step on the same mesh of
virtual devices, and against the port's one-device step: 3 steps of a
ResNet18 with GroupNorm (no cross-sample statistics, so every mesh computes
the same trajectory), 32² images, queue 64, embeddings 16, float32. The
metrics, the query encoder's weights and the queue's inserted rows, at
``tests/test_multichip_parity.py``'s tolerances (metrics rtol 2e-4, atol
2e-5; weights 1e-3, 1e-5). Both packages read the same numpy batches as the
augmented images and take one fixed shuffled-BN permutation. The (2,2) mesh
is ``test_torch_port_mesh_step_2x2.py``."""

import pytest

from torch_port_mesh_common import assert_run_equal, run_meshes
from torch_port_threads import one_intra_op_thread  # noqa: F401  (a module fixture)

OPTIONS = dict(norm_kind="groupnorm")
MESHES = [(2, 1), (1, 2)]


@pytest.fixture(scope="module")
def runs(cpu_devices):
    return run_meshes(MESHES, OPTIONS, one_device=("port",))


@pytest.mark.parametrize("md,mq", MESHES)
@pytest.mark.parametrize("against", ["jax", "one device"])
def test_mesh_step(runs, md, mq, against):
    by_mesh, single = runs
    ref, ranks = by_mesh[md, mq]
    for r, got in enumerate(ranks):
        assert_run_equal(got, ref if against == "jax" else single["port"], what=f"rank {r}")


def test_draws_are_keyed_by_global_row():
    """A rank's draws are its rows of the one-device draws: the augmentation
    does not depend on the mesh's shape, and the permutation is the global
    batch's on every rank."""
    import dataclasses

    import torch

    from torch_port_mesh_common import port_config, tvs

    one = port_config()
    two = dataclasses.replace(one, data_axis_size=2)
    images = torch.zeros(16, 36, 36, 3, dtype=torch.uint8)
    full = tvs._draw_step(one, ({"data": images, "queue_data": images},), seed=3, step=1)
    for d in (0, 1):
        half = tvs._draw_step(two, ({"data": images[:8], "queue_data": images[:8]},), seed=3,
                              step=1, data_index=d)
        assert torch.equal(half.perm, full.perm)
        for (q, k), (fq, fk) in zip(half.augment, full.augment):
            for f in dataclasses.fields(q):
                for got, ref in ((q, fq), (k, fk)):
                    assert torch.equal(getattr(got, f.name),
                                       getattr(ref, f.name)[d * 8:(d + 1) * 8]), f.name
