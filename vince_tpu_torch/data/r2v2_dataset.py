"""R2V2 video-frame pairs (counterpart of ``vince_tpu/data/r2v2_dataset.py``).

Frames lie as ``<split>/AA/AA2pFq9pFTA_000001.jpg`` (two-character shard
directories). An item draws ``num_frames`` pairs of frames, with
replacement, from one video: the first of each pair goes to ``data`` (the
query), the second to ``queue_data`` (the key). ``--no-multi-frame`` draws
every pair from one frame. The augmentation runs on the device.

An item's draws come from ``RandomState(seed)``: with ``repeatable`` the
seed is the item's index, as in JAX; otherwise it is drawn from the
dataset's own ``RandomState(--seed)`` (val: ``--seed + 1``), in the order in
which JAX draws it from numpy's global generator. So the items follow from
the seed when one thread draws them in order; with several loader threads,
which item gets which seed depends on their scheduling (as with JAX's
global generator).

``GOT10KR2V2Dataset`` reads GOT-10k's ``<vid>/%08d.jpg`` layout.
"""

import os
from typing import Dict, Optional

import numpy as np

from vince_tpu_torch.data.base_dataset import BaseDataset, VideoIndex


class R2V2Dataset(BaseDataset):
    glob_pattern = "*/*.jpg"

    @staticmethod
    def parse_path(path: str):
        stem = os.path.basename(path)[: -len(".jpg")]  # AA2pFq9pFTA_000001
        vid, frame = stem.rsplit("_", 1)
        return vid, int(frame)

    def frame_path(self, vid: str, ind: int) -> str:
        return os.path.join(self.index.data_split_path, vid[:2], f"{vid}_{ind:06d}.jpg")

    def __init__(self, args, data_subset: str = "train", num_images_to_return: int = -1,
                 shared_transform: bool = False, repeatable: bool = False,
                 check_for_new_data: bool = False):
        super().__init__(args, data_subset)
        self.num_images_to_return = (
            num_images_to_return if num_images_to_return > 0 else args.num_frames)
        self.multi_frame = getattr(args, "multi_frame", True)
        self.shared_transform = shared_transform
        self.repeatable = repeatable
        self.rng = np.random.RandomState(getattr(args, "seed", 0) + (data_subset != "train"))
        self.index = VideoIndex(args.data_path, data_subset, self.glob_pattern, self.parse_path,
                                min_frames=self.num_images_to_return,
                                check_for_new_data=check_for_new_data)

    def __len__(self):
        return len(self.index)

    def __getitem__(self, idx) -> Optional[Dict[str, np.ndarray]]:
        vid, frame_ids = self.index.path_info[idx]
        seed = idx if self.repeatable else self.rng.randint(0, 2 ** 31)
        rng = np.random.RandomState(seed)
        if not self.multi_frame:
            frame_ids = rng.choice(frame_ids, 1)
        pairs = [rng.choice(frame_ids, 2, replace=True)
                 for _ in range(self.num_images_to_return)]
        # each frame read once, the item's frames in one batch
        frames = list(dict.fromkeys(int(ind) for pair in pairs for ind in pair))
        images = dict(zip(frames, self.read_images([self.frame_path(vid, i) for i in frames])))
        if any(img is None for img in images.values()):
            return None
        queries = [images[int(q)] for q, _ in pairs]
        keys = [images[int(k)] for _, k in pairs]
        return {
            "data": np.stack(queries),  # [num_frames, C, C, 3] uint8
            "queue_data": np.stack(keys),
            "ind": np.int64(idx),
            "id": vid,
        }


class GOT10KR2V2Dataset(R2V2Dataset):
    @staticmethod
    def parse_path(path: str):
        parts = path.split(os.sep)
        return parts[-2], int(os.path.splitext(parts[-1])[0]) - 1

    def frame_path(self, vid: str, ind: int) -> str:
        return os.path.join(self.index.data_split_path, vid, f"{ind + 1:08d}.jpg")
