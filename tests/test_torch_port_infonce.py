"""The port's multi-pair InfoNCE against ``vince_tpu.ops.sharded_infonce``
(single device), with and without the fused queue kernel, in the
inter-batch and the MoCo masks: loss, all four metrics and dq."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vince_tpu.ops.sharded_infonce import sharded_multi_pair_infonce as jax_infonce
from vince_tpu_torch.ops.sharded_infonce import sharded_multi_pair_infonce as torch_infonce
from torch_port_threads import one_intra_op_thread  # noqa: F401  (a module fixture)

METRICS = ("softmax_weight", "nce_accuracy", "cosine_sim", "cosine_sim_neg_max")


def _data(b=8, d=128, k=512, nf=2, moco=False, seed=1):
    rng = np.random.RandomState(seed)
    norm = lambda x: x / np.linalg.norm(x, axis=-1, keepdims=True)
    q = norm(rng.randn(b, d).astype(np.float32))
    kb = norm(rng.randn(b, d).astype(np.float32))
    queue = norm(rng.randn(k, d).astype(np.float32))
    if moco:
        mask = np.eye(b, dtype=bool)
        neg = np.zeros_like(mask)
    else:
        groups = np.arange(b) // nf
        mask, neg = groups[:, None] == groups[None, :], None
    return q, kb, queue, mask, neg


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("moco", [False, True])
def test_infonce_matches_jax(fused, moco):
    q, kb, queue, mask, neg = _data(moco=moco)

    def jax_loss(qq):
        res = jax_infonce(qq, jnp.asarray(kb), jnp.asarray(mask), 0.07,
                          queue_shard=jnp.asarray(queue),
                          batch_neg_mask=None if neg is None else jnp.asarray(neg),
                          use_fused_queue_kernel=fused)
        return res["dist"], res

    (_, res_j), g_j = jax.value_and_grad(jax_loss, has_aux=True)(jnp.asarray(q))
    qt = torch.from_numpy(q).requires_grad_(True)
    res_t = torch_infonce(qt, torch.from_numpy(kb), torch.from_numpy(mask), 0.07,
                          queue_shard=torch.from_numpy(queue),
                          batch_neg_mask=None if neg is None else torch.from_numpy(neg),
                          use_fused_queue_kernel=fused)
    res_t["dist"].backward()
    for key in ("dist",) + METRICS:
        np.testing.assert_allclose(float(res_t[key].detach()), float(res_j[key]), rtol=1e-5, err_msg=key)
    np.testing.assert_allclose(qt.grad.numpy(), np.asarray(g_j), rtol=1e-4, atol=1e-6)


def test_infonce_without_queue_matches_jax():
    q, kb, _, mask, _ = _data()
    res_j = jax_infonce(jnp.asarray(q), jnp.asarray(kb), jnp.asarray(mask), 0.07)
    res_t = torch_infonce(torch.from_numpy(q), torch.from_numpy(kb), torch.from_numpy(mask), 0.07)
    for key in ("dist",) + METRICS:
        np.testing.assert_allclose(float(res_t[key].detach()), float(res_j[key]), rtol=1e-5, err_msg=key)
