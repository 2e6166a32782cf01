"""Class-name tables and ``to_uint8`` (counterpart of
``vince_tpu/utils/util_functions.py``), from the port's copies of the info
files: the ImageNet, SUN-397, Kinetics-400 and YouTube-8M names, the
76,003-row WordNet table that the YouTube search iterates over, and the
inverse of the ImageNet normalisation for pictures."""

import functools
import os

import numpy as np

from vince_tpu_torch.constants import IMAGENET_MEAN_255, IMAGENET_STD_255

INFO_FILES_DIR = os.path.join(os.path.dirname(__file__), os.pardir, "info_files")


@functools.lru_cache(maxsize=None)
def _load_class_names(filename: str):
    path = os.path.join(INFO_FILES_DIR, filename)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return [line.strip() for line in f if line.strip()]


def imagenet_label_to_class(label: int) -> str:
    names = _load_class_names("imagenet_classes.txt")
    if not names:
        return f"class_{int(label)}"
    # rows are synonym lists ("tench, Tinca tinca,"): the first
    return names[int(label)].rstrip(",").split(",")[0]


def sun_scene_label_to_class(label: int) -> str:
    names = _load_class_names("sun_scene_classes.txt")
    return names[int(label)] if names else f"scene_{int(label)}"


def kinetics_400_label_to_class(label: int) -> str:
    names = _load_class_names("kinetics_400_classes.txt")
    return names[int(label)] if names else f"action_{int(label)}"


def yt8m_label_to_class(label: int) -> str:
    names = _load_class_names("yt8m_classes.txt")
    return names[int(label)] if names else f"yt8m_{int(label)}"


def load_imagenet_categories():
    """The WordNet table's rows (``nXXXXXXXX: names``) as [(wnid, names), ...]."""
    rows = _load_class_names("full_imagenet_categories.txt") or []
    return [tuple(line.split(": ", 1)) for line in rows if ": " in line]


def to_uint8(images: np.ndarray, padding: int = 0) -> np.ndarray:
    """Normalised float images [..., H, W, 3] (unit-scale mean and std) back to
    uint8, with ``padding`` zero pixels around each."""
    images = np.asarray(images, np.float32)
    out = images * (IMAGENET_STD_255 / 255.0) + (IMAGENET_MEAN_255 / 255.0)
    out = np.clip(out * 255.0, 0, 255).astype(np.uint8)
    if padding:
        pad = [(0, 0)] * (out.ndim - 3) + [(padding, padding), (padding, padding), (0, 0)]
        out = np.pad(out, pad, mode="constant")
    return out
