"""The port's queue (enqueue with wraparound, source tags, saturating fill
counter) and EMA update against ``vince_tpu.ops.queue`` / ``ops.ema``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vince_tpu.ops import ema as jax_ema
from vince_tpu.ops import queue as jax_queue
from vince_tpu_torch.ops import ema as torch_ema
from vince_tpu_torch.ops import queue as torch_queue


@pytest.mark.parametrize("batch", [3, 4, 10])
def test_enqueue_wraparound_matches_jax(batch):
    k, d = 10, 4
    rng = np.random.RandomState(0)
    init = rng.randn(k, d).astype(np.float32)
    js = jax_queue.QueueState(vectors=jnp.asarray(init), sources=jnp.full((k,), -1, jnp.int32),
                              tail=jnp.zeros((), jnp.int32), total=jnp.zeros((), jnp.int32))
    ts = torch_queue.QueueState(vectors=torch.from_numpy(init.copy()),
                                sources=torch.full((k,), -1, dtype=torch.int32))
    for i in range(5):  # wraps around at least once, and saturates total
        items = rng.randn(batch, d).astype(np.float32)
        js = jax_queue.enqueue(js, jnp.asarray(items), i)
        ts = torch_queue.enqueue(ts, torch.from_numpy(items), i)
        np.testing.assert_array_equal(ts.vectors.numpy(), np.asarray(js.vectors))
        np.testing.assert_array_equal(ts.sources.numpy(), np.asarray(js.sources))
        assert ts.tail == int(js.tail) and ts.total == int(js.total)
    assert ts.total == k and ts.full


def test_init_queue_rows_are_unit_vectors():
    q = torch_queue.init_queue(torch.Generator().manual_seed(0), 64, 16)
    np.testing.assert_allclose(q.vectors.norm(dim=-1).numpy(), 1.0, rtol=1e-6)
    assert (q.sources == -1).all() and q.tail == 0 and q.total == 0


def test_ema_matches_jax():
    rng = np.random.RandomState(0)
    keys = [rng.randn(5, 3).astype(np.float32), rng.randn(7).astype(np.float32)]
    query = [rng.randn(5, 3).astype(np.float32), rng.randn(7).astype(np.float32)]
    ref = jax_ema.ema_update({"a": keys[0], "b": keys[1]}, {"a": query[0], "b": query[1]}, 0.999)
    kt = [torch.from_numpy(x.copy()) for x in keys]
    torch_ema.ema_update(kt, [torch.from_numpy(x) for x in query], 0.999)
    for got, name in zip(kt, "ab"):
        np.testing.assert_allclose(got.numpy(), np.asarray(jax.device_get(ref[name])),
                                   rtol=1e-6, atol=1e-7)


def test_split_and_merge_params_match_jax():
    """The EMA-tracked subset is chosen by top-level module name as in JAX, and
    merging the two halves gives the whole map back."""
    from vince_tpu.models import vince_model as jax_model
    from vince_tpu_torch.models import vince_model as torch_model

    tops = ["backbone", "pool", "embedding", "jigsaw_heads", "attention_pool", "imagenet_head"]
    jax_tracked, _ = jax_model.split_vince_params({t: 0 for t in tops})
    params = {f"{t}.{leaf}": i for i, t in enumerate(tops) for leaf in ("weight", "bias")}
    tracked, rest = torch_model.split_vince_params(params)
    assert {k.split(".")[0] for k in tracked} == set(jax_tracked)
    assert torch_model.merge_params(tracked, rest) == params
