"""Probe decoders (counterpart of ``vince_tpu/models/linear_model.py``):
``MultiLinearModel`` bundles classifier heads of several depths over the same
features, a linear probe and a 2-layer MLP by default, each with its own CE
loss and accuracy.

The heads are ``MultiLayerLinear``s with float32 parameters that compute in
float32 on bf16 features, as flax promotes a ``Dense`` without a ``dtype``.
"""

from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from vince_tpu_torch.models.heads import MultiLayerLinear


class MultiLinearModel(nn.Module):
    """Head ``classifier_{i}`` has ``depths[i] - 1`` hidden layers as wide as
    the features."""

    def __init__(self, in_features: int, num_classes: int, depths: Sequence[int] = (1, 2)):
        super().__init__()
        self.names = [f"classifier_{i}" for i in range(len(depths))]
        for name, d in zip(self.names, depths):
            self.add_module(name, MultiLayerLinear(in_features, num_classes,
                                                   (in_features,) * (d - 1)))

    def reset_parameters(self, generator=None):
        for name in self.names:
            getattr(self, name).reset_parameters(generator)

    def forward(self, features) -> Tuple[torch.Tensor, ...]:
        return tuple(getattr(self, name)(features) for name in self.names)


def classifier_losses(logits_tuple: Sequence[torch.Tensor], labels: torch.Tensor,
                      reduce: bool = True) -> Dict[str, torch.Tensor]:
    """Per-head CE loss and accuracy; ``reduce=False`` gives per-sample [B]
    tensors instead of batch means."""
    out = {}
    for i, logits in enumerate(logits_tuple):
        logits = logits.float()
        ce = F.cross_entropy(logits, labels.long(), reduction="none")
        acc = (logits.argmax(dim=-1) == labels).float()
        out[f"loss/classifier_loss_{i}"] = ce.mean() if reduce else ce
        out[f"classifier_accuracy_{i}"] = acc.mean() if reduce else acc
    return out
