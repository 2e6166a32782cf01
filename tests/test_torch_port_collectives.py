"""The port's collectives (``vince_tpu_torch/parallel/collectives.py``) at 2
and 4 ranks of a gloo group on the CPU, against ``vince_tpu``'s under
``shard_map`` on as many virtual devices: the balanced permutation and its
composite, the a2a shuffle against the gather-permute-slice and its round
trip, gather, shuffle and unshuffle, and the gradients of the differentiable
``psum`` and ``all_gather`` against JAX's transposes (``check_vma=False``);
beside them ``multihost``'s host helpers across the processes.

The ranks run in ``torch_port_ranks.collectives_rank``; JAX runs here."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.sharding import PartitionSpec as P

from torch_port_ranks import collectives_rank, spawn
from vince_tpu.parallel import collectives as jc
from vince_tpu.parallel.mesh import DATA_AXIS, MeshSpec, make_mesh
from vince_tpu_torch.parallel import collectives as tc
from torch_port_threads import one_intra_op_thread  # noqa: F401  (a module fixture)

WORLDS = (2, 4)
B, D = 16, 3


def _inputs(world):
    rng = np.random.RandomState(world)
    x = rng.randn(B, D).astype(np.float32)
    weights = rng.randn(B, D).astype(np.float32)
    perm, sigma, tau = (np.asarray(a) for a in
                        jc.make_balanced_shuffle_perm(jax.random.PRNGKey(world), B, world))
    return x, perm, sigma, tau, weights


def _jax_side(world, x, perm, sigma, tau, weights):
    mesh = make_mesh(MeshSpec(world, 1))
    x, w = jnp.asarray(x), jnp.asarray(weights)

    def local(xl, wl):
        return {
            "gather": jc.gather_global_batch(xl),
            "shuffle": jc.cross_device_shuffle(xl, jnp.asarray(perm)),
            "a2a": jc.cross_device_shuffle_a2a(xl, jnp.asarray(sigma), jnp.asarray(tau)),
            "unshuffle": jc.cross_device_unshuffle(
                jc.cross_device_shuffle_a2a(xl, jnp.asarray(sigma), jnp.asarray(tau)),
                jnp.asarray(perm)),
            "psum_grad": jax.grad(lambda v: jnp.sum(lax.psum(v, DATA_AXIS) * wl))(xl),
            "gather_grad": jax.grad(lambda v: jnp.sum(jc.gather_global_batch(v) * w))(xl),
            "pmax": lax.pmax(xl, DATA_AXIS),
        }

    # per-rank outputs laid side by side: the replicated ones too
    spec = P(DATA_AXIS)
    fn = jax.jit(jax.shard_map(
        lambda xl, wl: {k: v[None] for k, v in local(xl, wl).items()}, mesh=mesh,
        in_specs=(spec, spec), out_specs=spec, check_vma=False))
    return {k: np.asarray(v) for k, v in fn(x, w).items()}


@pytest.fixture(scope="module", params=WORLDS)
def sides(request, cpu_devices):
    world = request.param
    inputs = _inputs(world)
    return world, inputs, spawn(collectives_rank, world, *inputs), _jax_side(world, *inputs)


@pytest.mark.parametrize("world", WORLDS)
def test_balanced_perm_is_a_balanced_permutation_and_its_composite_is_jax(world):
    perm, sigma, tau = tc.make_balanced_shuffle_perm(torch.Generator().manual_seed(world), 64,
                                                     world)
    p = perm.numpy()
    assert sorted(p.tolist()) == list(range(64))
    b, c = 64 // world, 64 // world ** 2
    for i in range(world):  # each destination receives c rows from every source
        counts = np.bincount(p[i * b:(i + 1) * b] // b, minlength=world)
        np.testing.assert_array_equal(counts, np.full(world, c))
    j_perm, j_sigma, j_tau = jc.make_balanced_shuffle_perm(jax.random.PRNGKey(7), 64, world)
    got = tc.balanced_perm(torch.from_numpy(np.array(j_sigma)),
                           torch.from_numpy(np.array(j_tau)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(j_perm))


def test_balanced_perm_of_one_device_is_the_plain_shuffle():
    """With one data index both modes draw the same permutation."""
    perm, sigma, tau = tc.make_balanced_shuffle_perm(torch.Generator().manual_seed(3), 16, 1)
    plain = tc.make_shuffle_perm(torch.Generator().manual_seed(3), 16)
    assert torch.equal(perm, plain) and torch.equal(sigma[0], plain)
    assert torch.equal(tau[0], torch.arange(16))


@pytest.mark.parametrize("what", ["gather", "shuffle", "a2a", "unshuffle", "pmax"])
def test_collective_equals_jax(sides, what):
    world, (x, perm, *_), ranks, ref = sides
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got[what], ref[what][r], err_msg=f"rank {r}")


def test_a2a_equals_the_gather_permute_slice_and_round_trips(sides):
    world, (x, perm, *_), ranks, _ = sides
    b = B // world
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got["a2a"], x[perm][r * b:(r + 1) * b])
        np.testing.assert_array_equal(got["a2a"], got["shuffle"])
        np.testing.assert_array_equal(got["unshuffle"], x)


@pytest.mark.parametrize("what", ["psum_grad", "gather_grad"])
def test_gradients_equal_jax_transposes(sides, what):
    world, _, ranks, ref = sides
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got[what], ref[what][r], rtol=1e-6, atol=1e-6,
                                   err_msg=f"rank {r}")


def test_host_helpers_across_processes(sides):
    """``multihost``'s helpers with more than one process: ``fetch`` (every
    process's rows, in rank order, with the default group), ``broadcast_host``
    (process 0's tree) and ``host_allsum`` (float64 sums), after a ``sync``."""
    world, (x, *_), ranks, _ = sides
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got["fetch"], x, err_msg=f"rank {r}")
        assert got["broadcast"] == {"rank": 0, "rows": [0, 0, 0]}, r
        assert got["allsum"].dtype == np.float64
        np.testing.assert_array_equal(got["allsum"], [sum(range(world)), 1.5 * world])


def test_one_member_axes_run_no_collective():
    """Group None: the local computation, with no process group at all."""
    x = torch.randn(4, 3)
    perm = torch.tensor([2, 0, 3, 1])
    assert tc.psum(x, None) is x and tc.gather_global_batch(x, None) is x
    assert torch.equal(tc.pmax(x, None), x) and torch.equal(tc.pmean(x, None), x)
    assert torch.equal(tc.cross_device_shuffle(x, perm, None), x[perm])
    assert torch.equal(tc.cross_device_unshuffle(x[perm], perm, None), x)
    sigma, tau = perm[None], torch.arange(4)[None]
    assert torch.equal(tc.cross_device_shuffle_a2a(x, sigma, tau, None), x[perm])
