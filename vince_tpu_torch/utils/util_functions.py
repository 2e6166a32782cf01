"""Class names for the panels (counterpart of the part of
``vince_tpu/utils/util_functions.py`` that they use), from the port's copy of
the ImageNet class table."""

import functools
import os

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
