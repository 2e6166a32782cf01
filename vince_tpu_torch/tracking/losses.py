"""SiamFC response-map losses (counterpart of ``vince_tpu/tracking/losses.py``):
the inverse-frequency balanced BCE, the focal loss (the one the tracking end
task trains with), GHM-C with its running bin counts as explicit state, and
online hard-negative mining as a masked rank threshold.
"""

from typing import Optional, Tuple

import torch


def log_sigmoid(x):
    return torch.clamp(x, max=0) - torch.log1p(torch.exp(-torch.abs(x)))


def log_minus_sigmoid(x):
    return torch.clamp(-x, max=0) - torch.log1p(torch.exp(-torch.abs(x)))


def _bce(logits, target):
    return -(target * log_sigmoid(logits) + (1 - target) * log_minus_sigmoid(logits))


def balanced_loss(logits: torch.Tensor, target: torch.Tensor,
                  neg_weight: float = 1.0) -> torch.Tensor:
    """Inverse-frequency weighted BCE. The reference's mask quirk is kept:
    target == 0 counts as the positive bucket and target == 1 as the
    negative one; the weighting it gives is symmetric all the same."""
    target = target.float()
    pos_mask = (target == 0).float()
    neg_mask = (target == 1).float()
    pos_num = torch.clamp(pos_mask.sum(), min=1)
    neg_num = torch.clamp(neg_mask.sum(), min=1)
    weight = pos_mask / pos_num + neg_mask / neg_num * neg_weight
    weight = weight / torch.clamp(weight.sum(), min=1e-12)
    return torch.sum(_bce(logits, target) * weight)


def focal_loss(logits: torch.Tensor, target: torch.Tensor, gamma: float = 2.0,
               reduce: bool = True) -> torch.Tensor:
    """The focal loss, divided by the mean focal weight. ``reduce=False``
    gives a per-sample [B] loss, each renormalised by its own sample's mean
    weight (the exact val pass weighs samples by it)."""
    target = target.float()
    prob = torch.sigmoid(logits)
    pos_weight = (1 - prob) ** gamma
    neg_weight = prob ** gamma
    loss = -(target * pos_weight * log_sigmoid(logits)
             + (1 - target) * neg_weight * log_minus_sigmoid(logits))
    avg_weight = target * pos_weight + (1 - target) * neg_weight
    if reduce:
        return (loss / torch.clamp(avg_weight.mean(), min=1e-12)).mean()
    dims = tuple(range(1, loss.dim()))
    return loss.mean(dims) / torch.clamp(avg_weight.mean(dims), min=1e-12)


def ghmc_loss(logits: torch.Tensor, target: torch.Tensor,
              acc_sum: Optional[torch.Tensor] = None, bins: int = 30,
              momentum: float = 0.5) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gradient-harmonised BCE; the running per-bin counts are explicit state:
    returns (loss, new acc_sum). ``acc_sum=None`` starts them at zero."""
    target = target.float()
    if acc_sum is None:
        acc_sum = torch.zeros(bins, device=logits.device)
    g = torch.abs(torch.sigmoid(logits).detach() - target)
    edges = torch.linspace(0.0, 1.0, bins + 1, device=logits.device)
    edges[-1] += 1e-6
    idx = torch.clamp(torch.searchsorted(edges, g.reshape(-1), right=True) - 1, 0, bins - 1)
    counts = torch.bincount(idx, minlength=bins).float()
    tot = g.numel()
    if momentum > 0:
        new_acc = torch.where(counts > 0, momentum * acc_sum + (1 - momentum) * counts, acc_sum)
        denom = new_acc
    else:
        new_acc, denom = acc_sum, counts
    bin_w = torch.where(counts > 0, tot / torch.clamp(denom, min=1e-12),
                        torch.zeros_like(counts))
    weights = bin_w[idx].reshape(g.shape)
    weights = weights / torch.clamp(weights.mean(), min=1e-12)
    return torch.sum(_bce(logits, target) * weights) / tot, new_acc


def ohnm_loss(logits: torch.Tensor, target: torch.Tensor, neg_ratio: float = 3.0) -> torch.Tensor:
    """Online hard-negative mining: every positive and the int(ratio·P)
    highest-scoring negatives (ties by position), by a rank threshold."""
    target = target.float().reshape(-1)
    logits = logits.reshape(-1)
    pos_mask = target > 0
    neg_num = (pos_mask.sum() * neg_ratio).long()  # truncated, as JAX's astype
    neg_logits = torch.where(target == 0, logits, torch.full_like(logits, -float("inf")))
    order = torch.argsort(-neg_logits, stable=True)  # the hardest negatives first
    ranks = torch.empty_like(order)
    ranks[order] = torch.arange(order.numel(), device=order.device)
    sel = (pos_mask | ((target == 0) & (ranks < neg_num))).float()
    return torch.sum(_bce(logits, target) * sel) / torch.clamp(sel.sum(), min=1.0)
