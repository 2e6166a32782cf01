"""VINCE encoder (counterpart of ``vince_tpu/models/vince_model.py``):
backbone → global average pool → projection MLP → L2 normalisation.

The key (momentum) encoder is a second instance of the same module whose
tracked parameters follow the query encoder by EMA (``ops/ema.py``).
"""

from typing import Dict, Tuple

import torch
from torch import nn

from vince_tpu_torch.models import heads
from vince_tpu_torch.models.backbones import get_backbone

# parameter subsets covered by the EMA momentum update
VINCE_PARAM_KEYS = ("backbone", "pool", "embedding", "jigsaw")


class VinceEncoder(nn.Module):
    def __init__(self, backbone_name: str = "ResNet18", embed_size: int = 64,
                 dtype=torch.float32, bn_fold: str = "none", fold_kernel: bool = False):
        super().__init__()
        self.backbone = get_backbone(backbone_name)(
            dtype=dtype, bn_fold=bn_fold, fold_kernel=fold_kernel)
        self.pool = heads.AveragePool()
        self.embedding = heads.ProjectionMLP(self.backbone.output_channels, embed_size)

    def reset_parameters(self, generator=None):
        self.backbone.reset_parameters(generator)
        self.embedding.reset_parameters(generator)

    def forward(self, images) -> Dict[str, torch.Tensor]:
        """images: [N, H, W, C] float → embeddings [N, E] (unit rows) and the
        pooled backbone features."""
        features = self.pool(self.backbone(images))
        prenorm = self.embedding(features)
        norm = torch.linalg.norm(prenorm.float(), dim=-1, keepdim=True)
        return {
            "extracted_features": features,
            "prenorm_features": prenorm,
            "embeddings": (prenorm / norm.clamp(min=1e-12)).to(prenorm.dtype),
        }


def split_vince_params(params: Dict[str, torch.Tensor]) -> Tuple[Dict, Dict]:
    """Split a {name: tensor} map into (EMA-tracked subset, rest) by the
    top-level module name."""
    tracked, rest = {}, {}
    for k, v in params.items():
        top = k.split(".", 1)[0]
        (tracked if any(top.startswith(key) for key in VINCE_PARAM_KEYS) else rest)[k] = v
    return tracked, rest


def merge_params(tracked: Dict, rest: Dict) -> Dict:
    out = dict(tracked)
    out.update(rest)
    return out
