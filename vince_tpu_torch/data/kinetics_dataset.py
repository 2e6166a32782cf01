"""Kinetics-400 frame cache (counterpart of ``vince_tpu/data/kinetics_dataset.py``).

The frames lie in R2V2's layout (``<split>/AA/<vid>_%06d.jpg``, ids from 0
and contiguous per clip). The label map is built once from
``annotations/<split>.json`` (sorted class names) and pickled beside it. An
item is a contiguous window of ``num_frames`` frames; one augmentation per
clip runs on the device.

The window's start is drawn from the dataset's ``RandomState(--seed)``
(val: ``--seed + 1``), where JAX draws it from numpy's global generator.
"""

import json
import os
import pickle
from typing import Dict, Optional

import numpy as np

from vince_tpu_torch.data.base_dataset import BaseDataset, VideoIndex
from vince_tpu_torch.data.r2v2_dataset import R2V2Dataset


class Kinetics400Dataset(BaseDataset):
    parse_path = staticmethod(R2V2Dataset.parse_path)
    frame_path = R2V2Dataset.frame_path

    def __init__(self, args, data_subset: str = "train", num_images_to_return: int = -1,
                 check_for_new_data: bool = False):
        super().__init__(args, data_subset)
        self.num_images_to_return = (
            num_images_to_return if num_images_to_return > 0 else args.num_frames)
        self.rng = np.random.RandomState(getattr(args, "seed", 0) + (data_subset != "train"))
        self.index = VideoIndex(args.data_path, data_subset, "*/*.jpg", self.parse_path,
                                min_frames=self.num_images_to_return,
                                check_for_new_data=check_for_new_data)
        ann_dir = os.path.join(args.data_path, "annotations")
        pickle_path = os.path.join(ann_dir, data_subset + ".pkl")
        if not os.path.exists(pickle_path) or check_for_new_data:
            with open(os.path.join(ann_dir, data_subset + ".json")) as f:
                raw = json.load(f)
            labels = {k: v["annotations"]["label"] for k, v in raw.items()}
            name_to_ind = {n: i for i, n in enumerate(sorted(set(labels.values())))}
            with open(pickle_path, "wb") as f:
                pickle.dump({k: name_to_ind[v] for k, v in labels.items()}, f)
        with open(pickle_path, "rb") as f:
            self.annotations = pickle.load(f)

    def __len__(self):
        return len(self.index)

    def __getitem__(self, idx) -> Optional[Dict[str, np.ndarray]]:
        vid, frame_ids = self.index.path_info[idx]
        t = self.num_images_to_return
        start = self.rng.randint(0, len(frame_ids) - t + 1)
        window = frame_ids[start:start + t]
        images = self.read_images([self.frame_path(vid, int(i)) for i in window])
        if any(img is None for img in images):
            return None
        return {
            "data": np.stack(images),  # [T, C, C, 3]
            "labels": np.int32(self.annotations[vid]),
            "classifier_labels": np.int32(self.annotations[vid]),
            "ind": np.int64(idx),
        }
