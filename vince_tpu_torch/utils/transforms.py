"""Named transform pipelines (counterpart of ``vince_tpu/utils/transforms.py``):
each name maps to an ``AugmentConfig`` for ``ops/augment.py``. Ported so far:
the pretraining video transform and SimCLR's (the one with blur)."""

import dataclasses
from typing import Tuple

from vince_tpu_torch.ops.augment import AugmentConfig

_TV_RATIO = (3.0 / 4.0, 4.0 / 3.0)  # torchvision default


def _cfg(size: Tuple[int, int], **kw) -> AugmentConfig:
    return dataclasses.replace(AugmentConfig(size=size), **kw)


def StandardVideoTransform(size):
    return _cfg(size, crop_scale=(0.2, 1.0), crop_ratio=_TV_RATIO)


def SimCLRTransform(size):
    return _cfg(size, crop_scale=(0.2, 1.0), crop_ratio=_TV_RATIO,
                brightness=0.8, contrast=0.8, saturation=0.8, hue=0.2, blur_prob=0.5)


_BUILDERS = {"StandardVideoTransform": StandardVideoTransform,
             "SimCLRTransform": SimCLRTransform}


def make_config(name: str, size, jitter_order: str = None) -> AugmentConfig:
    if isinstance(size, int):
        size = (size, size)
    if name not in _BUILDERS:
        raise KeyError(f"unknown transform {name!r}; ported: {sorted(_BUILDERS)}")
    cfg = _BUILDERS[name](tuple(size))
    if jitter_order is not None:
        cfg = dataclasses.replace(cfg, jitter_order=jitter_order)
    return cfg
