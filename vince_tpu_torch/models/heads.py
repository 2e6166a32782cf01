"""Pooling and projection heads (counterpart of ``vince_tpu/models/heads.py``)."""

import torch
from torch import nn

from vince_tpu_torch.models.resnet import _lecun_normal_


class AveragePool(nn.Module):
    """Global average pool over H, W of an NHWC tensor, accumulated in f32."""

    def forward(self, x):
        return x.float().mean(dim=(1, 2)).to(x.dtype)


class ProjectionMLP(nn.Module):
    """Linear→ReLU→Linear projection to the contrastive embedding, in float32
    (flax promotes the bf16 features to the f32 parameters' type)."""

    def __init__(self, in_features: int, embed_size: int):
        super().__init__()
        self.fc1 = nn.Linear(in_features, in_features)
        self.fc2 = nn.Linear(in_features, embed_size)

    def reset_parameters(self, generator=None):
        for fc in (self.fc1, self.fc2):
            _lecun_normal_(fc.weight, fc.in_features, generator)
            nn.init.zeros_(fc.bias)

    def forward(self, x):
        return self.fc2(torch.relu(self.fc1(x.float())))
