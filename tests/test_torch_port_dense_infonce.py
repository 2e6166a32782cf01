"""The port's dense reference InfoNCE (``vince_tpu_torch/ops/infonce.py``)
against ``vince_tpu/ops/infonce.py``: the masks, ``multi_pair_infonce``,
``nce_accuracy``, ``cosine_sim_stats`` and ``infonce_from_embeddings`` on
the same numpy inputs, values at rtol 1e-6 and gradients at 1e-5. Then the
port's own step path, ``sharded_multi_pair_infonce`` unfused and through
K1's plain version, held to the dense form: loss, metrics and the
gradients w.r.t. the queries and keys at 1e-5, inter-batch and MoCo."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vince_tpu.ops import infonce as jinf
from vince_tpu_torch.ops import infonce as tinf
from vince_tpu_torch.ops.kernels.infonce_kernel import queue_logsumexp
from vince_tpu_torch.ops.sharded_infonce import sharded_multi_pair_infonce
from torch_port_threads import one_intra_op_thread  # noqa: F401  (a module fixture)

B, D, K, TAU = 8, 128, 48, 0.07  # D = 128: K1's row width


def _unit(rng, *shape):
    x = rng.randn(*shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _embeddings(seed=0):
    rng = np.random.RandomState(seed)
    return _unit(rng, B, D), _unit(rng, B, D), _unit(rng, K, D)


@pytest.mark.parametrize("frames,negatives", [(1, 0), (2, K), (4, 5)])
def test_masks_match_jax(frames, negatives):
    np.testing.assert_array_equal(tinf.multi_frame_mask(B, frames, negatives).numpy(),
                                  np.asarray(jinf.multi_frame_mask(B, frames, negatives)))
    np.testing.assert_array_equal(tinf.moco_mask(B, negatives).numpy(),
                                  np.asarray(jinf.moco_mask(B, negatives)))


def _sims_and_mask(seed=1):
    q, k, queue = _embeddings(seed)
    sims = q @ np.concatenate([k, queue]).T
    return sims.astype(np.float32), np.array(jinf.multi_frame_mask(B, 2, K))


def test_multi_pair_infonce_and_metrics_match_jax():
    sims, mask = _sims_and_mask()
    ref = jinf.multi_pair_infonce(jnp.asarray(sims), jnp.asarray(mask), TAU)
    st = torch.from_numpy(sims).requires_grad_(True)
    got = tinf.multi_pair_infonce(st, torch.from_numpy(mask), TAU)
    for key in ("dists", "dist", "softmax_weights", "softmax_weight"):
        np.testing.assert_allclose(got[key].detach().numpy(), np.asarray(ref[key]), rtol=1e-6,
                                   atol=1e-7, err_msg=key)
    got["dist"].backward()
    ref_grad = jax.grad(lambda s: jinf.multi_pair_infonce(s, jnp.asarray(mask), TAU)["dist"])(
        jnp.asarray(sims))
    np.testing.assert_allclose(st.grad.numpy(), np.asarray(ref_grad), rtol=1e-5, atol=1e-8)
    for per_row in (False, True):
        np.testing.assert_allclose(
            tinf.nce_accuracy(torch.from_numpy(sims), torch.from_numpy(mask), per_row).numpy(),
            np.asarray(jinf.nce_accuracy(jnp.asarray(sims), jnp.asarray(mask), per_row)),
            rtol=1e-6)
    got_cos = tinf.cosine_sim_stats(torch.from_numpy(sims), torch.from_numpy(mask))
    ref_cos = jinf.cosine_sim_stats(jnp.asarray(sims), jnp.asarray(mask))
    for key in ("cosine_sim", "cosine_sim_neg_max"):
        np.testing.assert_allclose(float(got_cos[key]), float(ref_cos[key]), rtol=1e-6,
                                   err_msg=key)


@pytest.mark.parametrize("inter_batch,frames,with_queue", [
    (True, 2, True), (True, 1, True), (True, 2, False), (False, 1, True), (False, 1, False)])
def test_infonce_from_embeddings_matches_jax(inter_batch, frames, with_queue):
    q, k, queue = _embeddings(2)
    queue = queue if with_queue else None

    def jax_loss(qq, kk):
        out = jinf.infonce_from_embeddings(qq, kk, None if queue is None else jnp.asarray(queue),
                                           TAU, frames, inter_batch)
        return out["dist"], out

    (_, ref), (dq, dk) = jax.value_and_grad(jax_loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k))
    qt, kt = (torch.from_numpy(a).requires_grad_(True) for a in (q, k))
    got = tinf.infonce_from_embeddings(qt, kt, None if queue is None else torch.from_numpy(queue),
                                       TAU, frames, inter_batch)
    np.testing.assert_array_equal(got["mask"].numpy(), np.asarray(ref["mask"]))
    for key in ("similarities", "dists", "dist", "softmax_weights", "softmax_weight"):
        np.testing.assert_allclose(got[key].detach().numpy(), np.asarray(ref[key]), rtol=1e-6,
                                   atol=1e-7, err_msg=key)
    got["dist"].backward()
    for g, r in ((qt.grad, dq), (kt.grad, dk)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("inter_batch", [True, False])
def test_sharded_path_equals_the_dense_form(fused, inter_batch):
    """The step's InfoNCE against the batch keys and one queue shard (K1's
    plain version when ``fused``) against the dense loss of the same
    similarities: MoCo mode scores each query against its own key and the
    queue only (``batch_neg_mask`` empty)."""
    q, k, queue = _embeddings(3)
    groups = np.arange(B) // (2 if inter_batch else 1)
    pos = groups[:, None] == groups[None, :]
    neg = None if inter_batch else np.zeros_like(pos)
    qt, kt = (torch.from_numpy(a).requires_grad_(True) for a in (q, k))
    before = queue_logsumexp.plain_calls
    got = sharded_multi_pair_infonce(qt, kt, torch.from_numpy(pos), TAU,
                                     queue_shard=torch.from_numpy(queue),
                                     batch_neg_mask=None if neg is None else torch.from_numpy(neg),
                                     use_fused_queue_kernel=fused)
    assert queue_logsumexp.plain_calls - before == int(fused)
    got["dist"].backward()
    qd, kd = (torch.from_numpy(a).requires_grad_(True) for a in (q, k))
    ref = tinf.infonce_from_embeddings(qd, kd, torch.from_numpy(queue), TAU,
                                       2 if inter_batch else 1, inter_batch)
    ref["dist"].backward()
    sims, mask = ref["similarities"].detach(), ref["mask"]
    metrics = {"dist": ref["dist"].detach(), "softmax_weight": ref["softmax_weight"],
               "nce_accuracy": tinf.nce_accuracy(sims, mask),
               **tinf.cosine_sim_stats(sims, mask)}
    for key, v in metrics.items():
        np.testing.assert_allclose(float(got[key].detach()), float(v), rtol=1e-5, err_msg=key)
    for g, r in ((qt.grad, qd.grad), (kt.grad, kd.grad)):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=1e-5, atol=1e-6)
