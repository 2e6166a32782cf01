"""Kinetics-400 action-recognition decoder (counterpart of
``vince_tpu/models/kinetics_model.py``): one LSTM layer (hidden 512) over
per-frame encoder features [B, T, F]; the last hidden state feeds a linear
layer ``fc`` to the classes. CE loss and accuracy.

The LSTM is ``torch.nn.LSTM`` (cuDNN on the GPU), in float32 on bf16
features as flax promotes its ``Dense``s. flax's ``LSTMCell`` has one bias per
gate, on the hidden side (``hi``, ``hf``, ``hg``, ``ho``), and none on the
input side. Two biases would take two updates from an optimizer with weight
decay or Adam's normalisation, where flax takes one, so ``lstm.bias_ih_l0``
is pinned at zero and takes no gradient: ``bias_hh_l0`` is flax's bias. The
gates stack in torch's order i, f, g, o, which is flax's.
"""

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from vince_tpu_torch.models.heads import _reset_linear
from vince_tpu_torch.models.resnet import _lecun_normal_


class Kinetics400Model(nn.Module):
    def __init__(self, in_features: int, num_classes: int = 400, hidden_size: int = 512):
        super().__init__()
        self.hidden_size = hidden_size
        self.lstm = nn.LSTM(in_features, hidden_size, batch_first=True)
        self.lstm.bias_ih_l0.requires_grad_(False)
        self.fc = nn.Linear(hidden_size, num_classes)

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        """flax's initialisers, gate by gate: lecun-normal input kernels,
        orthogonal recurrent kernels, zero biases."""
        h = self.hidden_size
        for g in range(4):
            _lecun_normal_(self.lstm.weight_ih_l0[g * h:(g + 1) * h], self.lstm.input_size,
                           generator)
            nn.init.orthogonal_(self.lstm.weight_hh_l0[g * h:(g + 1) * h], generator=generator)
        self.lstm.bias_ih_l0.zero_()
        self.lstm.bias_hh_l0.zero_()
        _reset_linear(self.fc, generator)

    def forward(self, frame_features: torch.Tensor) -> torch.Tensor:
        """frame_features [B, T, F] → logits [B, num_classes], float32."""
        hidden_seq, _ = self.lstm(frame_features.float())
        return self.fc(hidden_seq[:, -1])


def kinetics_losses(logits: torch.Tensor, labels: torch.Tensor,
                    reduce: bool = True) -> Dict[str, torch.Tensor]:
    logits = logits.float()
    ce = F.cross_entropy(logits, labels.long(), reduction="none")
    acc = (logits.argmax(dim=-1) == labels).float()
    return {"loss/classifier_loss_0": ce.mean() if reduce else ce,
            "classifier_accuracy_0": acc.mean() if reduce else acc}
