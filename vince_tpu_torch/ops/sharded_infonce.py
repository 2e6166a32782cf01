"""Multi-positive InfoNCE against the batch keys and the negative queue
(counterpart of ``vince_tpu/ops/sharded_infonce.py``), with the queue whole
on one device or sharded over the ``queue`` axis of a mesh.

Numerics follow the JAX function exactly: the row max over batch and queue,
detached; ``NEG_INF`` on masked positives; one denominator per positive with
the other positives left out; metrics on the raw similarities. With
``use_fused_queue_kernel`` the queue sweep is ``queue_logsumexp`` (K1): its m
is detached and ``exp(m − M)·S`` carries the gradient through S only, which is
exact because the product does not depend on m.

With ``queue_group`` each rank scores its shard of the queue, and the shards'
partials are merged as a streamed softmax: the row max and the raw-similarity
max through ``pmax``, the queue's ``exp`` sum through ``psum`` over the
group. ``queue_shard`` may also be a sequence of shards held by this
process: their partials go through the same merge, by a local max and sum
before the group's. Gradient contract under the sharding: callers scale the rank's loss by
1/queue_axis_size and sum the gradients over the queue group
(``solvers/vince_step.py``); the psum's backward, a psum of the cotangent,
then adds the shards' cotangents up to exactly one logical gradient.
"""

from typing import Dict, Optional, Sequence, Union

import torch

from vince_tpu_torch.ops.kernels.infonce_kernel import queue_logsumexp
from vince_tpu_torch.parallel.collectives import pmax, psum

NEG_INF = -(2.0 ** 30)


def sharded_multi_pair_infonce(
    q_local: torch.Tensor,  # [b, D] query embeddings
    k_global: torch.Tensor,  # [Bg, D] key embeddings
    pos_mask: torch.Tensor,  # [b, Bg] bool — positives within the key block
    temperature: float,
    # [K/mq, D] this rank's queue shard, or a sequence of shards this process holds
    queue_shard: Union[None, torch.Tensor, Sequence[torch.Tensor]] = None,
    batch_neg_mask: Optional[torch.Tensor] = None,  # [b, Bg] bool; default ~pos_mask
    use_fused_queue_kernel: bool = False,
    queue_group=None,  # the process group the queue is sharded over; None: whole
) -> Dict[str, torch.Tensor]:
    maskf = pos_mask.float()
    inv_maskf = 1.0 - maskf if batch_neg_mask is None else batch_neg_mask.float()

    sims_batch = q_local.float() @ k_global.float().T
    logits_batch = sims_batch / temperature
    rows = q_local.shape[0]

    shards = [queue_shard] if isinstance(queue_shard, torch.Tensor) else queue_shard or []

    def merged(parts, reduce, collective):
        # the shards of this process, then those of the group
        x = parts[0] if len(parts) == 1 else reduce(torch.stack(parts), dim=0)
        return collective(x, queue_group)

    if not shards:
        m_queue = torch.full((rows, 1), NEG_INF, device=q_local.device)
        s_queue_max_raw = m_queue
    else:
        # per shard: its (m, S) from K1, or its logits; the maxes detached
        if use_fused_queue_kernel:
            partials = [tuple(t[:, None] for t in queue_logsumexp(q_local, shard, temperature))
                        for shard in shards]
            m_parts = [m.detach() for m, _ in partials]
            raw_parts = [m * temperature for m in m_parts]
        else:
            sims = [q_local.float() @ shard.float().T for shard in shards]
            partials = [s / temperature for s in sims]
            m_parts = [lg.max(dim=-1, keepdim=True).values.detach() for lg in partials]
            raw_parts = [s.max(dim=-1, keepdim=True).values.detach() for s in sims]
        # the maxes feed only the detached stabiliser and the metrics
        m_queue = merged(m_parts, torch.amax, pmax)
        s_queue_max_raw = merged(raw_parts, torch.amax, pmax)

    # row max over the full row, positives included
    m_batch = logits_batch.max(dim=-1, keepdim=True).values
    row_max = torch.maximum(m_batch, m_queue).detach()

    scaled_batch = logits_batch - row_max
    neg_batch_sum = (torch.exp(scaled_batch) * inv_maskf).sum(dim=-1, keepdim=True)

    if not shards:
        neg_queue_sum = torch.zeros_like(neg_batch_sum)
    else:
        if use_fused_queue_kernel:
            q_exp = [torch.exp(m - row_max) * s for m, s in partials]
        else:
            q_exp = [torch.exp(lg - row_max).sum(dim=-1, keepdim=True) for lg in partials]
        neg_queue_sum = merged(q_exp, torch.sum, psum)

    neg_sum = neg_batch_sum + neg_queue_sum
    pos = torch.where(pos_mask, scaled_batch, NEG_INF)
    log_softmax = pos - torch.log(torch.exp(pos) + neg_sum)

    n_pos = maskf.sum().clamp(min=1.0)
    dist = (-log_softmax * maskf).sum() / n_pos
    softmax_weight = (torch.exp(log_softmax).detach() * maskf).sum() / n_pos

    # metrics on raw (un-scaled) similarities
    with torch.no_grad():
        neg_batch_max_raw = torch.where(inv_maskf > 0, sims_batch, NEG_INF).max(
            dim=-1, keepdim=True).values
        neg_max_raw = torch.maximum(neg_batch_max_raw, s_queue_max_raw)
        correct = (sims_batch > neg_max_raw) & pos_mask
        nce_accuracy = correct.float().sum() / n_pos
        cosine_sim = (sims_batch * maskf).sum() / n_pos
        cosine_sim_neg_max = neg_max_raw.mean()

    return {
        "dist": dist,
        "softmax_weight": softmax_weight,
        "nce_accuracy": nce_accuracy,
        "cosine_sim": cosine_sim,
        "cosine_sim_neg_max": cosine_sim_neg_max,
    }
