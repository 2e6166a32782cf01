"""Sync-BN in the port (``VinceEncoder(bn_axis_name=DATA_AXIS)`` under a bound
mesh) on 4 ranks of a gloo group: a ResNet18 encoder with ``bn_fold`` none
and expand, and a ResNet50 bottleneck whose bn2 → relu → conv3 → bn3 chain
runs through K2 (its plain version on the CPU) with s1 and s2 summed over the
data axis. The batch statistics, the outputs and the gradients (w.r.t. the
rank's input rows, and the parameters' summed over the ranks) equal those of
one process on the global batch, and the encoder's equal JAX's sync-BN under
``shard_map`` (``tests/test_multichip_parity.py``), at rtol 1e-3, atol 1e-4.

The ranks run in ``torch_port_ranks.sync_bn_rank``; JAX runs here."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from torch_port_ranks import spawn, sync_bn_block, sync_bn_forward, sync_bn_rank
from vince_tpu.models.vince_model import VinceEncoder as JaxEncoder
from vince_tpu.parallel.mesh import DATA_AXIS, MeshSpec, make_mesh
from vince_tpu_torch.models.vince_model import VinceEncoder
from vince_tpu_torch.ops.kernels.folded_dot_kernel import affine_relu_dot_moments
from vince_tpu_torch.utils.jax_weights import flax_to_state_dict
from torch_port_threads import one_intra_op_thread  # noqa: F401  (a module fixture)

WORLD, N, SIZE, EMBED = 4, 16, 32, 16
FOLDS = ("none", "expand")
RTOL, ATOL = 1e-3, 1e-4


def _jax_variables(images):
    """The encoder's variables from ``PRNGKey(0)``, once for both folds: the
    fold changes the arithmetic, not the variables (flax draws each from its
    module's name)."""
    model = JaxEncoder(backbone_name="ResNet18", embed_size=EMBED)
    return jax.jit(model.init)({"params": jax.random.PRNGKey(0)}, jnp.asarray(images))


def _jax_sync(bn_fold, images, variables):
    """JAX's encoder: the variables, and the sync-BN forward over 4 devices
    (embeddings and the moved batch stats, as port names)."""
    x = jnp.asarray(images)
    model = JaxEncoder(backbone_name="ResNet18", embed_size=EMBED, bn_fold=bn_fold,
                       bn_axis_name=DATA_AXIS)

    def local(params, stats, imgs):
        out, mut = model.apply({"params": params, "batch_stats": stats}, imgs, train=True,
                               mutable=["batch_stats"])
        return out["embeddings"], mut["batch_stats"]

    fn = jax.jit(jax.shard_map(local, mesh=make_mesh(MeshSpec(WORLD, 1)),
                               in_specs=(P(), P(), P(DATA_AXIS)),
                               out_specs=(P(DATA_AXIS), P()), check_vma=False))
    emb, stats = fn(variables["params"], variables["batch_stats"], x)
    tree = jax.tree_util.tree_map(np.asarray, variables)
    moved = flax_to_state_dict(tree["params"], jax.tree_util.tree_map(np.asarray, stats))
    return tree, np.asarray(emb), moved


@pytest.fixture(scope="module")
def sides(cpu_devices):
    rng = np.random.RandomState(3)
    images = rng.randn(N, SIZE, SIZE, 3).astype(np.float32)
    weights = rng.randn(N, EMBED).astype(np.float32)
    block_x = np.maximum(rng.randn(4 * WORLD * 2, 4, 4, 256), 0).astype(np.float32)
    block_w = rng.randn(4 * WORLD * 2, 4, 4, 512).astype(np.float32)
    # no weight on outputs at the block's final ReLU kink: there 1e-6 of another
    # summation order flips the unit, and its weight moves every gradient
    with torch.no_grad():
        block_w *= (sync_bn_block()(torch.from_numpy(block_x)) > 1e-2).numpy()
    jax_out, state_dicts, single = {}, {}, {}
    variables = _jax_variables(images)
    for bn_fold in FOLDS:
        tree, emb, moved = _jax_sync(bn_fold, images, variables)
        jax_out[bn_fold] = (emb, moved)
        state_dicts[bn_fold] = {k: np.array(v) for k, v in
                                flax_to_state_dict(tree["params"], tree["batch_stats"]).items()}
        enc = VinceEncoder("ResNet18", EMBED, bn_fold=bn_fold)
        enc.load_state_dict({k: torch.from_numpy(v) for k, v in state_dicts[bn_fold].items()})
        single[bn_fold] = sync_bn_forward(enc.train(), torch.from_numpy(images),
                                          torch.from_numpy(weights))
    before = affine_relu_dot_moments.plain_calls
    single["block"] = sync_bn_forward(sync_bn_block(), torch.from_numpy(block_x),
                                      torch.from_numpy(block_w))
    assert affine_relu_dot_moments.plain_calls == before + 1  # the block is a K2 site
    ranks = spawn(sync_bn_rank, WORLD, state_dicts, images, weights, block_x, block_w)
    return ranks, single, jax_out


def _rows(a, r):
    n = len(a) // WORLD
    return a[r * n:(r + 1) * n]


@pytest.mark.parametrize("what", FOLDS + ("block",))
def test_statistics_and_outputs_equal_the_global_batch(sides, what):
    ranks, single, _ = sides
    for r, got in enumerate(ranks):
        got = got[what]
        for k, v in single[what]["stats"].items():
            np.testing.assert_allclose(got["stats"][k], v, rtol=RTOL, atol=ATOL,
                                       err_msg=f"rank {r} {k}")
        np.testing.assert_allclose(got["out"], _rows(single[what]["out"], r), rtol=RTOL,
                                   atol=ATOL, err_msg=f"rank {r}")


@pytest.mark.parametrize("what", FOLDS + ("block",))
def test_gradients_equal_the_global_batch(sides, what):
    ranks, single, _ = sides
    for r, got in enumerate(ranks):
        got = got[what]
        np.testing.assert_allclose(got["dx"], _rows(single[what]["dx"], r), rtol=RTOL,
                                   atol=ATOL, err_msg=f"rank {r} dx")
        assert got["grads"].keys() == single[what]["grads"].keys()
        for k, v in single[what]["grads"].items():
            np.testing.assert_allclose(got["grads"][k], v, rtol=RTOL,
                                       atol=ATOL * max(1.0, float(np.abs(v).max())),
                                       err_msg=f"rank {r} {k}")


@pytest.mark.parametrize("bn_fold", FOLDS)
def test_statistics_and_embeddings_equal_jax(sides, bn_fold):
    ranks, _, jax_out = sides
    emb, moved = jax_out[bn_fold]
    for r, got in enumerate(ranks):
        got = got[bn_fold]
        np.testing.assert_allclose(got["out"], _rows(emb, r), rtol=RTOL, atol=ATOL)
        for k, v in got["stats"].items():
            np.testing.assert_allclose(v, moved[k], rtol=RTOL, atol=ATOL, err_msg=k)
