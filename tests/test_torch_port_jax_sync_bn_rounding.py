"""Why the port's sync-BN step on a 2 x 1 mesh is held to the one-device
steps and not to ``vince_tpu``'s 2 x 1 step (``test_torch_port_mesh_sync_bn_step.py``).

In float32, JAX's 2 x 1 sync-BN step leaves its one-device step after one
update on some batches, by more than JAX's own tolerances, and by how much
depends on the batch. In float64 the two steps agree: the departure is
float32 rounding on JAX's 2 x 1 path, not a difference of semantics, so the
one-device step is the reference. The tests hold JAX's float64 steps, with
the BatchNorm fold and without it, to JAX's parameter tolerance after one
step of ``torch_port_mesh_common``'s ResNet18.

Run as a script from the repository's root, it prints the gaps:

    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
        PYTHONPATH=tests:. python tests/test_torch_port_jax_sync_bn_rounding.py

the largest parameter gap after one step in float32 and in float64, and the
cosine similarity of three float32 steps on both meshes for three batch
seeds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

import torch_port_mesh_common as common
from vince_tpu.parallel.mesh import MeshSpec, make_mesh
from vince_tpu.solvers import vince_step as jvs
from torch_port_threads import one_intra_op_thread  # noqa: F401  (a module fixture)

SYNC = dict(shuffle_mode="a2a", sync_bn=True)


def jax_params(md, dtype=jnp.float32, bn_fold="expand", seed=7, steps=1):
    """JAX's sync-BN step on an md x 1 mesh from ``PRNGKey(0)``'s state, in
    ``dtype``: the flat parameters after ``steps`` steps and each step's
    cosine_sim."""
    mp = pytest.MonkeyPatch()
    x64 = jax.config.jax_enable_x64
    try:
        common.patch(mp, common.perms(md))
        jax.config.update("jax_enable_x64", dtype == jnp.float64)
        cfg = jvs.VinceConfig(sources=(jvs.SourceSpec(**common.SOURCE),), compute_dtype=dtype,
                              data_axis_size=md, queue_axis_size=1,
                              **common.config(bn_fold=bn_fold, **SYNC))
        opt = jvs.build_vince_optimizer(optax.constant_schedule(0.05))
        mesh = make_mesh(MeshSpec(md, 1))
        state = jax.jit(lambda key: jvs.init_vince_state(key, cfg, opt))(jax.random.PRNGKey(0))
        state = jax.tree_util.tree_map(
            lambda a: a.astype(dtype) if a.dtype == jnp.float32 else a, state)
        state = jvs.shard_state(state, mesh)
        step = jax.jit(jvs.make_train_step_fn(cfg, opt, mesh))
        cosine = []
        for b in common.batches(seed, steps):
            batch = ({k: jnp.asarray(v.astype(dtype)) for k, v in b.items()},)
            state, metrics = step(state, batch, jax.random.PRNGKey(9))
            cosine.append(float(metrics["cosine_sim"]))
        leaves = jax.tree_util.tree_flatten_with_path(jax.device_get(state.params))[0]
        return {jax.tree_util.keystr(k): np.asarray(v, np.float64) for k, v in leaves}, cosine
    finally:
        jax.config.update("jax_enable_x64", x64)
        mp.undo()


def largest_gap(a, b):
    """(the largest |a - b| over the parameters, its parameter)."""
    return max((float(np.max(np.abs(a[k] - b[k]))), k) for k in a)


@pytest.mark.parametrize("bn_fold", ["expand", "none"])
def test_jax_sync_bn_step_on_2x1_equals_its_one_device_step_in_float64(cpu_devices, bn_fold):
    two, _ = jax_params(2, jnp.float64, bn_fold)
    one, _ = jax_params(1, jnp.float64, bn_fold)
    for k, v in one.items():
        np.testing.assert_allclose(two[k], v, **common.PARAM_TOL, err_msg=k)


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    for dtype in (jnp.float32, jnp.float64):
        for bn_fold in ("expand", "none"):
            gap, key = largest_gap(jax_params(2, dtype, bn_fold)[0],
                                   jax_params(1, dtype, bn_fold)[0])
            print(f"{dtype.__name__}, bn_fold {bn_fold}: largest parameter gap 2x1 against 1x1 "
                  f"after one step {gap:.3e} ({key})")
    for seed in (7, 11, 13):
        (p2, c2), (p1, c1) = (jax_params(md, seed=seed, steps=3) for md in (2, 1))
        print(f"float32, batch seed {seed}: cosine_sim 2x1 {c2}, 1x1 {c1}; largest parameter "
              f"gap after 3 steps {largest_gap(p2, p1)[0]:.3e}")
