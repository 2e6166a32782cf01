"""Pooling and projection heads (counterpart of ``vince_tpu/models/heads.py``).

The parameters are float32 and each head computes in float32 whatever its
input's type, as flax promotes a bf16 input to the f32 parameters of a
``Dense`` or ``Conv`` without a ``dtype``. ``AveragePool`` has no parameters
and keeps its input's type. A pool returns ``(pooled, masks)``, with masks
None for the average.
"""

from typing import Sequence

import torch
from torch import nn

from vince_tpu_torch.models.resnet import Conv1x1, _lecun_normal_


def _reset_linear(fc: nn.Linear, generator=None):
    _lecun_normal_(fc.weight, fc.in_features, generator)
    nn.init.zeros_(fc.bias)


class AveragePool(nn.Module):
    """Global average pool over H, W of an NHWC tensor, accumulated in f32."""

    def forward(self, x):
        return x.float().mean(dim=(1, 2)).to(x.dtype), None


class AttentionPool2D(nn.Module):
    """Softmax spatial attention: a biased 1×1 conv to one logit per pixel, a
    softmax over H·W, the weighted sum of the features. Returns the pooled
    features [N, C] and the masks [N, H, W, 1], both f32."""

    def __init__(self, channels: int):
        super().__init__()
        self.attn_logits = Conv1x1(channels, 1, bias=True)

    def reset_parameters(self, generator=None):
        self.attn_logits.reset_parameters(generator)

    def forward(self, x):
        n, h, w, c = x.shape
        x = x.float()
        weights = torch.softmax(self.attn_logits(x).reshape(n, h * w, 1), dim=1)
        pooled = (x.reshape(n, h * w, c) * weights).sum(dim=1)
        return pooled, weights.reshape(n, h, w, 1)


class ProjectionMLP(nn.Module):
    """Linear→ReLU→Linear projection to the contrastive embedding."""

    def __init__(self, in_features: int, embed_size: int):
        super().__init__()
        self.fc1 = nn.Linear(in_features, in_features)
        self.fc2 = nn.Linear(in_features, embed_size)

    def reset_parameters(self, generator=None):
        for fc in (self.fc1, self.fc2):
            _reset_linear(fc, generator)

    def forward(self, x):
        return self.fc2(torch.relu(self.fc1(x.float())))


class JigsawHeads(nn.Module):
    """PIRL's jigsaw head: a per-patch linear, the 9 patches of each image put
    in the order ``perm``, concatenated, then Linear→ReLU→Linear."""

    def __init__(self, in_features: int, embed_size: int):
        super().__init__()
        self.jigsaw_linear = nn.Linear(in_features, in_features)
        self.fc1 = nn.Linear(9 * in_features, in_features)
        self.fc2 = nn.Linear(in_features, embed_size)

    def reset_parameters(self, generator=None):
        for fc in (self.jigsaw_linear, self.fc1, self.fc2):
            _reset_linear(fc, generator)

    def forward(self, patch_features, perm):
        """patch_features [N, 9, C]; perm [N, 9] integer orders → [N, embed]."""
        n, p, c = patch_features.shape
        x = self.jigsaw_linear(patch_features.float())
        x = torch.gather(x, 1, perm.long()[:, :, None].expand(n, p, c))
        return self.fc2(torch.relu(self.fc1(x.reshape(n, p * c))))


class MultiLayerLinear(nn.Module):
    """An MLP of ``hidden_sizes`` ReLU layers (``fc0``, ``fc1``, …) and a last
    linear layer ``fc_out``: no hidden layer is a linear probe."""

    def __init__(self, in_features: int, out_size: int, hidden_sizes: Sequence[int] = ()):
        super().__init__()
        self.hidden = [f"fc{i}" for i in range(len(hidden_sizes))]
        for name, size in zip(self.hidden, hidden_sizes):
            self.add_module(name, nn.Linear(in_features, size))
            in_features = size
        self.fc_out = nn.Linear(in_features, out_size)

    def reset_parameters(self, generator=None):
        for name in (*self.hidden, "fc_out"):
            _reset_linear(getattr(self, name), generator)

    def forward(self, x):
        x = x.float()
        for name in self.hidden:
            x = torch.relu(getattr(self, name)(x))
        return self.fc_out(x)
