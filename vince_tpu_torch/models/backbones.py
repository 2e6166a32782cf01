"""Backbone registry (counterpart of ``vince_tpu/models/backbones.py``), with
the ResNet entries ported so far."""

from typing import Any, Dict

from vince_tpu_torch.models import resnet

__all__ = ["ResNet18", "ResNet50"]

ResNet18 = resnet.ResNet18
ResNet50 = resnet.ResNet50

REGISTRY: Dict[str, Any] = {name: globals()[name] for name in __all__}


def get_backbone(name: str):
    if name not in REGISTRY:
        raise KeyError(f"unknown backbone {name!r}; choices: {sorted(REGISTRY)}")
    return REGISTRY[name]
