"""Backbone registry (counterpart of ``vince_tpu/models/backbones.py``): the
ResNets and EfficientNets that the pretraining step takes, and the dilated
ResNets of the SiamFC tracking end task."""

from typing import Any, Dict

from vince_tpu_torch.models import efficientnet, resnet

__all__ = ["ResNet18", "ResNet34", "ResNet50", "ResNet101", "ResNet152", "ResNet50w2",
           "ResNet50w4", "ResNet18SiamFCDilated", "ResNet50SiamFCDilated", "EfficientNetB0",
           "EfficientNetB1", "EfficientNetB2", "EfficientNetB3", "EfficientNetB4"]

ResNet18 = resnet.ResNet18
ResNet34 = resnet.ResNet34
ResNet50 = resnet.ResNet50
ResNet101 = resnet.ResNet101
ResNet152 = resnet.ResNet152
ResNet50w2 = resnet.ResNet50w2
ResNet50w4 = resnet.ResNet50w4
ResNet18SiamFCDilated = resnet.ResNet18SiamFCDilated
ResNet50SiamFCDilated = resnet.ResNet50SiamFCDilated
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
