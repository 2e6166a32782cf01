"""Multi-positive InfoNCE against the batch keys and the negative queue
(counterpart of ``vince_tpu/ops/sharded_infonce.py``, single-device branch:
the queue is not sharded, so there is no cross-device max or sum).

Numerics follow the JAX function exactly: the row max over batch and queue,
detached; ``NEG_INF`` on masked positives; one denominator per positive with
the other positives left out; metrics on the raw similarities. With
``use_fused_queue_kernel`` the queue sweep is ``queue_logsumexp`` (K1): its m
is detached and ``exp(m − M)·S`` carries the gradient through S only, which is
exact because the product does not depend on m.
"""

from typing import Dict, Optional

import torch

from vince_tpu_torch.ops.kernels.infonce_kernel import queue_logsumexp

NEG_INF = -(2.0 ** 30)


def sharded_multi_pair_infonce(
    q_local: torch.Tensor,  # [b, D] query embeddings
    k_global: torch.Tensor,  # [Bg, D] key embeddings
    pos_mask: torch.Tensor,  # [b, Bg] bool — positives within the key block
    temperature: float,
    queue_shard: Optional[torch.Tensor] = None,  # [K, D] negative queue
    batch_neg_mask: Optional[torch.Tensor] = None,  # [b, Bg] bool; default ~pos_mask
    use_fused_queue_kernel: bool = False,
) -> Dict[str, torch.Tensor]:
    maskf = pos_mask.float()
    inv_maskf = 1.0 - maskf if batch_neg_mask is None else batch_neg_mask.float()

    sims_batch = q_local.float() @ k_global.float().T
    logits_batch = sims_batch / temperature
    rows = q_local.shape[0]

    kernel_partials = None
    if queue_shard is not None and use_fused_queue_kernel:
        m_loc, s_loc = queue_logsumexp(q_local, queue_shard, temperature)
        kernel_partials = (m_loc[:, None], s_loc[:, None])
        m_queue = kernel_partials[0].detach()
        s_queue_max_raw = m_queue * temperature
    elif queue_shard is not None:
        sims_queue = q_local.float() @ queue_shard.float().T
        logits_queue = sims_queue / temperature
        m_queue = logits_queue.max(dim=-1, keepdim=True).values.detach()
        s_queue_max_raw = sims_queue.max(dim=-1, keepdim=True).values.detach()
    else:
        m_queue = torch.full((rows, 1), NEG_INF, device=q_local.device)
        s_queue_max_raw = m_queue

    # row max over the full row, positives included
    m_batch = logits_batch.max(dim=-1, keepdim=True).values
    row_max = torch.maximum(m_batch, m_queue).detach()

    scaled_batch = logits_batch - row_max
    neg_batch_sum = (torch.exp(scaled_batch) * inv_maskf).sum(dim=-1, keepdim=True)

    if kernel_partials is not None:
        m_loc, s_loc = kernel_partials
        neg_queue_sum = torch.exp(m_loc - row_max) * s_loc
    elif queue_shard is not None:
        neg_queue_sum = torch.exp(logits_queue - row_max).sum(dim=-1, keepdim=True)
    else:
        neg_queue_sum = torch.zeros_like(neg_batch_sum)

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
