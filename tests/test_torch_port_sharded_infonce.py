"""The queue-sharded InfoNCE of the port (``queue_group``: K1 or the unfused
sweep on each rank's shard, the shards' maxes merged by ``pmax`` and their
sums by ``psum``) at 2 and 4 queue shards in a gloo group, against
``vince_tpu``'s ``sharded_multi_pair_infonce`` under ``shard_map`` on a
1 x mq mesh and against the port's unsharded call: the loss, the metrics,
and the gradients w.r.t. the queries and the keys of loss / mq summed over
the queue axis (the step's recipe), at rtol 1e-5; fused through K1's plain
version on the CPU and unfused. Beside them, ``enqueue_sharded`` against
JAX's ``enqueue`` of the whole bank and JAX's ``enqueue_sharded``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from torch_port_ranks import sharded_infonce_rank, spawn
from vince_tpu.ops import queue as jq
from vince_tpu.ops.sharded_infonce import sharded_multi_pair_infonce as jax_infonce
from vince_tpu.parallel.mesh import MeshSpec, make_mesh
from vince_tpu_torch.ops import queue as tq
from vince_tpu_torch.ops.sharded_infonce import sharded_multi_pair_infonce
from torch_port_threads import one_intra_op_thread  # noqa: F401  (a module fixture)

QUEUE_SHARDS = (2, 4)
BG, D, K, NF, TAU = 16, 128, 64, 2, 0.07  # D = 128: JAX's kernel's lane width
METRICS = ("dist", "softmax_weight", "nce_accuracy", "cosine_sim", "cosine_sim_neg_max")


def _data(seed=0):
    rng = np.random.RandomState(seed)
    norm = lambda x: x / np.linalg.norm(x, axis=-1, keepdims=True)  # noqa: E731
    q = norm(rng.randn(BG, D)).astype(np.float32)
    kb = norm(rng.randn(BG, D)).astype(np.float32)
    queue = norm(rng.randn(K, D)).astype(np.float32)
    groups = np.arange(BG) // NF
    return q, kb, groups[:, None] == groups[None, :], queue


def _jax_sharded(mq, fused, q, kb, mask, queue):
    mesh = make_mesh(MeshSpec(1, mq))

    def inner(q_, k_, mask_, shard):
        def loss(qq, kk):
            out = jax_infonce(qq, kk, mask_, TAU, queue_shard=shard, queue_axis="queue",
                              use_fused_queue_kernel=fused)
            return out["dist"] / mq, out

        (_, out), g = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(q_, k_)
        return out, jax.lax.psum(g, "queue")

    fn = jax.jit(jax.shard_map(inner, mesh=mesh, in_specs=(P(), P(), P(), P("queue")),
                               out_specs=(P(), P()), check_vma=False))
    out, (dq, dk) = fn(*(jnp.asarray(a) for a in (q, kb, mask, queue)))
    return {**{k: float(v) for k, v in out.items()}, "dq": np.asarray(dq), "dk": np.asarray(dk)}


def _port_unsharded(fused, q, kb, mask, queue):
    qt, kt = (torch.from_numpy(a).requires_grad_(True) for a in (q, kb))
    out = sharded_multi_pair_infonce(qt, kt, torch.from_numpy(mask), TAU,
                                     queue_shard=torch.from_numpy(queue),
                                     use_fused_queue_kernel=fused)
    out["dist"].backward()
    return {**{k: float(v.detach()) for k, v in out.items()}, "dq": qt.grad.numpy(),
            "dk": kt.grad.numpy()}


@pytest.fixture(scope="module", params=QUEUE_SHARDS)
def sides(request, cpu_devices):
    mq = request.param
    data = _data(mq)
    ranks = spawn(sharded_infonce_rank, mq, *data, TAU)
    return mq, ranks, {fused: (_jax_sharded(mq, fused, *data), _port_unsharded(fused, *data))
                       for fused in (False, True)}


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("against", ["jax", "unsharded"])
def test_sharded_value_and_gradients(sides, fused, against):
    mq, ranks, refs = sides
    ref = refs[fused][0 if against == "jax" else 1]
    for r, got in enumerate(ranks):
        got = got[fused]
        for k in METRICS:
            np.testing.assert_allclose(float(got[k]), ref[k], rtol=1e-5, atol=1e-7,
                                       err_msg=f"rank {r} {k}")
        for k in ("dq", "dk"):
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, atol=1e-7,
                                       err_msg=f"rank {r} {k}")


def _shards(full, n):
    rows = full.maxsize // n
    return [tq.QueueState(vectors=full.vectors[i * rows:(i + 1) * rows].clone(),
                          sources=full.sources[i * rows:(i + 1) * rows].clone(), num_shards=n)
            for i in range(n)]



@pytest.mark.parametrize("fused", [False, True])
def test_shards_of_one_process_equal_jax_and_unsharded(sides, fused):
    """The queue as mq shards held by one process (a sequence for
    ``queue_shard``, no group): the same merge of the shards' partials, here
    by a local max and sum, against JAX's mq-device call and the unsharded
    one, at rtol 1e-5."""
    mq, _, refs = sides
    q, kb, mask, queue = _data(mq)
    qt, kt = (torch.from_numpy(a).requires_grad_(True) for a in (q, kb))
    out = sharded_multi_pair_infonce(qt, kt, torch.from_numpy(mask), TAU,
                                     queue_shard=list(torch.from_numpy(queue).chunk(mq)),
                                     use_fused_queue_kernel=fused)
    out["dist"].backward()
    got = {**{k: float(v.detach()) for k, v in out.items()}, "dq": qt.grad.numpy(),
           "dk": kt.grad.numpy()}
    for against, ref in zip(("jax", "unsharded"), refs[fused]):
        for k in METRICS + ("dq", "dk"):
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, atol=1e-7,
                                       err_msg=f"{against} {k}")

@pytest.mark.parametrize("rows_per_insert", [7, 12])  # within a shard; more than a shard
def test_enqueue_sharded_equals_enqueue_and_jax(rows_per_insert):
    k, d, n = 32, 8, 4
    full = tq.init_queue(torch.Generator().manual_seed(0), k, d)
    shards = _shards(full, n)
    j_full = jq.init_queue(jax.random.PRNGKey(0), k, d).replace(
        vectors=jnp.asarray(full.vectors.numpy()))
    j_shards = [jq.QueueState(vectors=j_full.vectors[i * 8:(i + 1) * 8],
                              sources=j_full.sources[i * 8:(i + 1) * 8],
                              tail=j_full.tail, total=j_full.total) for i in range(n)]
    rng = np.random.RandomState(1)
    for step in range(6):
        items = rng.randn(rows_per_insert, d).astype(np.float32)
        tq.enqueue_sharded(full, torch.from_numpy(items), source=step)
        j_full = jq.enqueue(j_full, jnp.asarray(items), source=step)
        for i, sh in enumerate(shards):
            tq.enqueue_sharded(sh, torch.from_numpy(items), step, shard_index=i, num_shards=n)
        j_shards = [jq.enqueue_sharded(sh, jnp.asarray(items), step, shard_index=i,
                                       num_shards=n) for i, sh in enumerate(j_shards)]
    for name in ("vectors", "sources"):
        got = torch.cat([getattr(sh, name) for sh in shards]).numpy()
        np.testing.assert_array_equal(got, getattr(full, name).numpy(), err_msg=name)
        np.testing.assert_array_equal(got, np.asarray(getattr(j_full, name)), err_msg=name)
        np.testing.assert_array_equal(
            got, np.concatenate([np.asarray(getattr(sh, name)) for sh in j_shards]),
            err_msg=name)
    for sh in shards:
        assert (int(sh.tail), int(sh.total), sh.inserted) == (
            int(full.tail), int(full.total), full.inserted) == (
            int(j_shards[0].tail), int(j_shards[0].total), full.inserted)


def test_enqueue_sharded_of_one_shard_is_enqueue_bit_for_bit():
    """One shard is the whole bank: JAX's ``enqueue``, wraparound included."""
    b = tq.init_queue(torch.Generator().manual_seed(2), 16, 4)
    a = jq.init_queue(jax.random.PRNGKey(0), 16, 4).replace(
        vectors=jnp.asarray(b.vectors.numpy()))
    rng = np.random.RandomState(3)
    for step in range(5):
        items = rng.randn(6, 4).astype(np.float32)
        a = jq.enqueue(a, jnp.asarray(items), step)
        tq.enqueue_sharded(b, torch.from_numpy(items), step)
    for name in ("vectors", "sources", "tail", "total"):
        np.testing.assert_array_equal(getattr(b, name).numpy(), np.asarray(getattr(a, name)),
                                      err_msg=name)
