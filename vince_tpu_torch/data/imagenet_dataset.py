"""Labelled image folders (counterpart of ``vince_tpu/data/imagenet_dataset.py``):
ImageNet's class-per-directory tree and SUN-397's official file lists.

The augmentation runs on the device. For VINCE's multi-view pretraining an
ImageNet item repeats its canvas once per frame slot, and the step augments
each copy with its own draws.
"""

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from vince_tpu_torch.data.base_dataset import BaseDataset


class ImagenetDataset(BaseDataset):
    """``<--imagenet-data-path>/<split>/<wnid>/*.JPEG``: classes are the sorted
    directories; ``num_data_points`` keeps that many samples, drawn without
    replacement by ``RandomState(0)``."""

    def __init__(self, args, data_subset: str = "train", num_data_points: Optional[int] = None,
                 num_images_to_return: int = -1):
        super().__init__(args, data_subset)
        self.num_views = (num_images_to_return if num_images_to_return > 0
                          else max(getattr(args, "num_frames", 1), 1))
        root = os.path.join(args.imagenet_data_path, data_subset)
        classes = sorted(d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d)))
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.samples: List[Tuple[str, int]] = []
        for c in classes:
            cdir = os.path.join(root, c)
            for fname in sorted(os.listdir(cdir)):
                if fname.lower().endswith((".jpg", ".jpeg", ".png")):
                    self.samples.append((os.path.join(cdir, fname), self.class_to_idx[c]))
        if num_data_points is not None and num_data_points < len(self.samples):
            keep = np.random.RandomState(0).choice(len(self.samples), num_data_points,
                                                   replace=False)
            self.samples = [self.samples[i] for i in keep]

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx) -> Optional[Dict[str, np.ndarray]]:
        path, label = self.samples[idx]
        img = self.read_image(path)
        if img is None:
            return None
        views = np.repeat(img[None], self.num_views, axis=0)
        labels = np.repeat(np.int32(label), self.num_views)
        return {
            "data": views,  # [num_views, C, C, 3]; the views differ on the device
            "queue_data": views,
            "labels": labels,
            "imagenet_labels": labels.copy(),
            "ind": np.int64(idx),
        }


class SunSceneDataset(BaseDataset):
    """SUN-397 from ``Training_01.txt`` / ``Testing_01.txt`` under
    ``--data-path``; a class is a file's category path (``/a/abbey``)."""

    def __init__(self, args, data_subset: str = "train"):
        super().__init__(args, data_subset)
        root = args.data_path
        list_file = "Training_01.txt" if data_subset == "train" else "Testing_01.txt"
        with open(os.path.join(root, list_file)) as f:
            rel_paths = [line.strip() for line in f if line.strip()]
        class_names = sorted({os.path.dirname(p) for p in rel_paths})
        self.class_to_idx = {c: i for i, c in enumerate(class_names)}
        self.samples = [
            (os.path.join(root, p.lstrip(os.sep)), self.class_to_idx[os.path.dirname(p)])
            for p in rel_paths]

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx) -> Optional[Dict[str, np.ndarray]]:
        path, label = self.samples[idx]
        img = self.read_image(path)
        if img is None:
            return None
        return {
            "data": img[None],
            "classifier_labels": np.int32(label),
            "labels": np.int32(label),
            "ind": np.int64(idx),
        }
