"""Named transform pipelines (counterpart of ``vince_tpu/utils/transforms.py``):
each name maps to an ``AugmentConfig`` for ``ops/augment.py``, with the
parameters of the reference's class of the same name.

``RepeatedImagenetTransform`` is ``BasicImagenetTransform``'s config: its
repeated views are rows of the batch, each augmented on its own."""

import dataclasses
from typing import Tuple

from vince_tpu_torch.ops.augment import AugmentConfig

_TV_RATIO = (3.0 / 4.0, 4.0 / 3.0)  # torchvision default


def _cfg(size: Tuple[int, int], **kw) -> AugmentConfig:
    return dataclasses.replace(AugmentConfig(size=size), **kw)


def BasicImagenetTransform(size):
    return _cfg(size, crop_scale=(0.2, 1.0), crop_ratio=(0.7, 1.4))


def StandardVideoTransform(size):
    return _cfg(size, crop_scale=(0.2, 1.0), crop_ratio=_TV_RATIO)


def SimCLRTransform(size):
    return _cfg(size, crop_scale=(0.2, 1.0), crop_ratio=_TV_RATIO,
                brightness=0.8, contrast=0.8, saturation=0.8, hue=0.2, blur_prob=0.5)


def JigsawTransform(size):
    return _cfg(size, crop_scale=(0.7, 1.0), crop_ratio=_TV_RATIO,
                brightness=0.8, contrast=0.8, saturation=0.8, hue=0.2, blur_prob=0.5)


def SunSceneTransform(size):
    return _cfg(size, crop_scale=(0.7, 1.0), crop_ratio=_TV_RATIO)


def Kinetics400Transform(size):
    return _cfg(size, crop_scale=(0.5, 1.0), crop_ratio=_TV_RATIO)


def GOT10KTransform(size):
    """Crop and flip only: no colour jitter, no grayscale."""
    return _cfg(size, crop_scale=(0.2, 1.0), crop_ratio=_TV_RATIO,
                brightness=0.0, contrast=0.0, saturation=0.0, hue=0.0, grayscale_prob=0.0)


def RepeatedImagenetTransform(size):
    return BasicImagenetTransform(size)


def MoCoV1ImagenetTransform(size):
    return _cfg(size, crop_scale=(0.08, 1.0), crop_ratio=_TV_RATIO)


def MoCoV2ImagenetTransform(size):
    return _cfg(size, crop_scale=(0.2, 1.0), crop_ratio=_TV_RATIO,
                brightness=0.4, contrast=0.4, saturation=0.4, hue=0.4, blur_prob=0.5)


_BUILDERS = {f.__name__: f for f in (
    BasicImagenetTransform, StandardVideoTransform, SimCLRTransform, JigsawTransform,
    SunSceneTransform, Kinetics400Transform, GOT10KTransform, RepeatedImagenetTransform,
    MoCoV1ImagenetTransform, MoCoV2ImagenetTransform)}
__all__ = list(_BUILDERS)


def make_config(name: str, size, jitter_order: str = None) -> AugmentConfig:
    if isinstance(size, int):
        size = (size, size)
    if name not in _BUILDERS:
        raise KeyError(f"unknown transform {name!r}; choices: {sorted(_BUILDERS)}")
    cfg = _BUILDERS[name](tuple(size))
    if jitter_order is not None:
        cfg = dataclasses.replace(cfg, jitter_order=jitter_order)
    return cfg
