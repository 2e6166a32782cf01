"""Backbone registry (counterpart of ``vince_tpu/models/backbones.py``), with
the entries ported so far."""

from typing import Any, Dict

from vince_tpu_torch.models import efficientnet, resnet

__all__ = ["ResNet18", "ResNet50", "EfficientNetB0", "EfficientNetB1", "EfficientNetB2",
           "EfficientNetB3", "EfficientNetB4"]

ResNet18 = resnet.ResNet18
ResNet50 = resnet.ResNet50
EfficientNetB0 = efficientnet.EfficientNetB0
EfficientNetB1 = efficientnet.EfficientNetB1
EfficientNetB2 = efficientnet.EfficientNetB2
EfficientNetB3 = efficientnet.EfficientNetB3
EfficientNetB4 = efficientnet.EfficientNetB4

REGISTRY: Dict[str, Any] = {name: globals()[name] for name in __all__}


def get_backbone(name: str):
    if name not in REGISTRY:
        raise KeyError(f"unknown backbone {name!r}; choices: {sorted(REGISTRY)}")
    return REGISTRY[name]
