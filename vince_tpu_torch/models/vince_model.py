"""VINCE encoder (counterpart of ``vince_tpu/models/vince_model.py``):
backbone → pool (global average, or attention with its masks) → projection
MLP → L2 normalisation, with PIRL's jigsaw head and the supervised ImageNet
decoders as options.

The key (momentum) encoder is a second instance of the same module whose
tracked parameters (``VINCE_PARAM_KEYS``: the backbone, the pool, the
projection and the jigsaw head) follow the query encoder by EMA
(``ops/ema.py``); the decoders are not tracked.

The modules carry the flax names (``pool``, ``embedding``, ``jigsaw``,
``imagenet_decoder_0``, ``imagenet_decoder_1``), so that the EMA split by
top-level name is JAX's.
"""

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from vince_tpu_torch.models import heads
from vince_tpu_torch.models.backbones import get_backbone

# parameter subsets covered by the EMA momentum update
VINCE_PARAM_KEYS = ("backbone", "pool", "embedding", "jigsaw")


class VinceEncoder(nn.Module):
    def __init__(self, backbone_name: str = "ResNet18", embed_size: int = 64,
                 use_attention: bool = False, jigsaw: bool = False,
                 use_imagenet_decoders: bool = False, num_imagenet_classes: int = 1000,
                 dtype=torch.float32, norm_kind: str = "batchnorm", stem_kind: str = "conv7",
                 bn_fold: str = "none", fold_kernel: bool = False, dw_kind: str = "conv",
                 se_kind: str = "mul", bn_axis_name: Optional[str] = None,
                 remat: bool = False):
        super().__init__()
        # bn_axis_name: the mesh axis that the backbone's train-mode BatchNorm
        # statistics are summed over (sync-BN); None keeps them per device.
        # remat: the backbone's blocks recomputed in the backward
        kwargs = {"axis_name": bn_axis_name, "remat": remat}
        if "ResNet" in backbone_name:
            kwargs.update(fold_kernel=fold_kernel,  # K2 at the bottleneck sites
                          norm_kind=norm_kind, stem_kind=stem_kind)
        if "EfficientNet" in backbone_name:
            kwargs["dw_kind"] = dw_kind  # depthwise emission; "kernel" is K4
            kwargs["se_kind"] = se_kind
        self.backbone = get_backbone(backbone_name)(dtype=dtype, bn_fold=bn_fold, **kwargs)
        channels = self.output_channels = self.backbone.output_channels
        self.pool = heads.AttentionPool2D(channels) if use_attention else heads.AveragePool()
        self.embedding = heads.ProjectionMLP(channels, embed_size)
        self.jigsaw = heads.JigsawHeads(channels, embed_size) if jigsaw else None
        if use_imagenet_decoders:
            # a linear probe and a 2-layer decoder
            self.imagenet_decoder_0 = heads.MultiLayerLinear(channels, num_imagenet_classes)
            self.imagenet_decoder_1 = heads.MultiLayerLinear(channels, num_imagenet_classes,
                                                             (channels,))

    def reset_parameters(self, generator=None):
        for m in self.children():
            if hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)

    def extract_features(self, images) -> Dict[str, torch.Tensor]:
        """images: [N, H, W, C] float → the backbone's ``spatial_features``
        [N, H', W', C'], the pool's ``extracted_features`` [N, C'] and, with
        the attention pool, its ``attention_masks``; no embedding head."""
        spatial = self.backbone(images)
        features, masks = self.pool(spatial)
        out = {"spatial_features": spatial, "extracted_features": features}
        if masks is not None:
            out["attention_masks"] = masks
        return out

    def forward(self, images, jigsaw: bool = False,
                jigsaw_perm: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """images: [N, H, W, C] float → embeddings [N, E] (unit rows), the
        pooled features and, with the attention pool, its masks [N, H', W', 1].

        For ``jigsaw``, ``images`` are the patches [N·9, h, w, C] of
        ``jigsaw_patchify`` and ``jigsaw_perm`` [N, 9] their per-image orders;
        the jigsaw head's output then stands in ``extracted_features`` too."""
        out = self.extract_features(images)
        del out["spatial_features"]
        features = out["extracted_features"]
        if jigsaw:
            if self.jigsaw is None or jigsaw_perm is None:
                raise ValueError("a jigsaw forward needs the jigsaw head and the permutations")
            prenorm = self.jigsaw(features.reshape(-1, 9, features.shape[-1]), jigsaw_perm)
            out["extracted_features"] = prenorm
        else:
            prenorm = self.embedding(features)
        norm = torch.linalg.norm(prenorm.float(), dim=-1, keepdim=True)
        out["prenorm_features"] = prenorm
        out["embeddings"] = (prenorm / norm.clamp(min=1e-12)).to(prenorm.dtype)
        return out

    def imagenet_logits(self, features) -> Tuple[torch.Tensor, torch.Tensor]:
        """The two decoders' logits (the caller detaches the features)."""
        return self.imagenet_decoder_0(features), self.imagenet_decoder_1(features)


def jigsaw_patchify(images: torch.Tensor) -> torch.Tensor:
    """[N, H, W, C] → the 3×3 grid of patches [N·9, ⌈H/3⌉, ⌈W/3⌉, C], row by
    row, after zero padding at the bottom and the right to multiples of 3."""
    n, h, w, c = images.shape
    ph, pw = (3 - h % 3) % 3, (3 - w % 3) % 3
    if ph or pw:
        images = F.pad(images, (0, 0, 0, pw, 0, ph))
        h, w = h + ph, w + pw
    x = images.reshape(n, 3, h // 3, 3, w // 3, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n * 9, h // 3, w // 3, c)


def random_jigsaw_perms(generator: torch.Generator, n: int) -> torch.Tensor:
    """[n, 9] int64: an independent uniform permutation of the 9 patches for
    each image, drawn from ``generator`` on its device."""
    u = torch.rand(n, 9, generator=generator, device=generator.device)
    return torch.argsort(u, dim=1)


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
