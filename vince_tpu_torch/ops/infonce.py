"""Multi-positive ("multi-pair") InfoNCE in its dense reference form
(counterpart of ``vince_tpu/ops/infonce.py``): the [B, N] similarities
materialised, every positive scored against its row's negatives only,

    loss(i, j∈pos(i)) = −log( exp(s_ij) / (exp(s_ij) + Σ_{k∈neg(i)} exp(s_ik)) )

with the row max subtracted (detached) and ``MASK_NEG`` in the masked
entries, whose ``exp`` is exactly 0 in float32. No step calls it: the train
step scores through ``ops/sharded_infonce.py`` (unfused, or with K1 over the
queue), and the tests hold those paths to this one.
"""

from typing import Dict, Optional

import torch

MASK_NEG = -(2.0 ** 30)


def multi_frame_mask(batch_size: int, num_frames: int, num_negatives: int,
                     device=None) -> torch.Tensor:
    """[B, B + num_negatives] bool: queries and keys of one video (groups of
    ``num_frames`` rows) are positives; the queue's columns are not."""
    if batch_size % num_frames:
        raise ValueError(f"{batch_size} rows hold no whole number of {num_frames}-frame videos")
    groups = torch.arange(batch_size, device=device) // num_frames
    diag = groups[:, None] == groups[None, :]
    if num_negatives:
        diag = torch.cat([diag, torch.zeros(batch_size, num_negatives, dtype=torch.bool,
                                             device=device)], dim=1)
    return diag


def moco_mask(batch_size: int, num_negatives: int, device=None) -> torch.Tensor:
    """[B, 1 + num_negatives] bool, the positive in column 0 (MoCo's
    [l_pos | l_neg])."""
    m = torch.zeros(batch_size, 1 + num_negatives, dtype=torch.bool, device=device)
    m[:, 0] = True
    return m


def multi_pair_infonce(similarities: torch.Tensor, mask: torch.Tensor,
                       temperature: float) -> Dict[str, torch.Tensor]:
    """The loss of raw similarities [B, N] with positives ``mask`` [B, N]
    (each row one positive and one negative at least) at ``temperature``:
    ``dists`` [B, N] (−log-softmax at the positives, 0 elsewhere), ``dist``
    their mean over the positives (the loss), ``softmax_weights`` (detached,
    at the positives) and their mean ``softmax_weight``."""
    logits = similarities / temperature
    mask = mask.bool()
    row_max = logits.max(dim=-1, keepdim=True).values
    scaled = logits - row_max.detach()

    neg = torch.where(mask, MASK_NEG, scaled)
    pos = torch.where(mask, scaled, MASK_NEG)
    neg_exp_sum = torch.exp(neg).sum(dim=-1, keepdim=True)
    log_softmax = pos - torch.log(torch.exp(pos) + neg_exp_sum)
    dists = -log_softmax

    maskf = mask.to(similarities.dtype)
    n_pos = maskf.sum().clamp(min=1.0)
    dist = (dists * maskf).sum() / n_pos
    softmax_weights = torch.exp(log_softmax).detach() * maskf
    return {
        "dists": dists * maskf,
        "dist": dist,
        "softmax_weights": softmax_weights,
        "softmax_weight": softmax_weights.sum() / n_pos,
    }


def nce_accuracy(similarities: torch.Tensor, mask: torch.Tensor,
                 per_row: bool = False) -> torch.Tensor:
    """The share of positives above the hardest negative of their row (per
    row with ``per_row``)."""
    mask = mask.bool()
    neg_max = torch.where(mask, MASK_NEG, similarities).max(dim=-1, keepdim=True).values
    correct = (similarities > neg_max) & mask
    maskf = mask.float()
    if per_row:
        return correct.sum(dim=-1) / maskf.sum(dim=-1).clamp(min=1.0)
    return correct.float().sum() / maskf.sum().clamp(min=1.0)


def cosine_sim_stats(similarities: torch.Tensor, mask: torch.Tensor) -> Dict[str, torch.Tensor]:
    """``cosine_sim`` (the positives' mean similarity) and
    ``cosine_sim_neg_max`` (the mean over rows of the hardest negative)."""
    mask = mask.bool()
    maskf = mask.float()
    pos_mean = (similarities * maskf).sum() / maskf.sum().clamp(min=1.0)
    neg_max = torch.where(mask, MASK_NEG, similarities).max(dim=-1).values
    return {"cosine_sim": pos_mean, "cosine_sim_neg_max": neg_max.mean()}


def infonce_from_embeddings(query: torch.Tensor, keys: torch.Tensor,
                            queue_vectors: Optional[torch.Tensor], temperature: float,
                            num_frames: int = 1, inter_batch: bool = True
                            ) -> Dict[str, torch.Tensor]:
    """The similarities and mask of the reference's forward, then the loss.

    inter_batch: sims = q · [keys; queue]ᵀ with the multi-frame mask.
    Otherwise: sims = [q·k per row | q · queueᵀ] with the positive in column 0.
    The result holds ``similarities`` and ``mask`` beside the loss's terms."""
    b, dev = query.shape[0], query.device
    nq = 0 if queue_vectors is None else queue_vectors.shape[0]
    if inter_batch:
        negs = keys if queue_vectors is None else torch.cat([keys, queue_vectors], dim=0)
        sims = query @ negs.T
        mask = multi_frame_mask(b, num_frames, nq, dev)
    else:
        l_pos = (query * keys).sum(dim=-1, keepdim=True)
        sims = l_pos if queue_vectors is None else torch.cat([l_pos, query @ queue_vectors.T],
                                                              dim=1)
        mask = moco_mask(b, nq, dev)
    out = multi_pair_infonce(sims, mask, temperature)
    out["similarities"] = sims
    out["mask"] = mask
    return out
