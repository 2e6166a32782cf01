"""Host-side dataset bases (counterpart of ``vince_tpu/data/base_dataset.py``).

Datasets only decode and letterbox-resize to a fixed uint8 canvas; the
augmentation runs on the device (``vince_tpu_torch.ops.augment``). The canvas
is ``int(size / 0.875)``, so that the val path (resize by 1/0.875, centre
crop) and the train crop both have room. ``cv2`` is imported where an image
is read or resized, so that the package imports without it. Under
``--native-decode`` the JPEGs are decoded on the run's device
(``vince_tpu_torch.native``).
"""

import abc
import glob
import os
import pickle
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from vince_tpu_torch import native
from vince_tpu_torch.parallel import multihost

def canvas_size(input_size: int) -> int:
    return int(input_size / 0.875)


class BaseDataset(abc.ABC):
    """Items are dicts of numpy arrays; images are uint8 [H, W, 3] RGB."""

    def __init__(self, args, data_subset: str = "train"):
        self.args = args
        self.data_subset = data_subset
        size = getattr(args, "input_width", 224)
        self.canvas = canvas_size(size)
        self._decode_device: Optional[torch.device] = None

    def __len__(self) -> int:
        raise NotImplementedError

    def __getitem__(self, idx) -> Optional[Dict[str, np.ndarray]]:
        raise NotImplementedError

    def read_image(self, path: str) -> Optional[np.ndarray]:
        """A JPEG read into an RGB uint8 square canvas; None on failure (the
        loader draws another item)."""
        return self.read_images([path])[0]

    def read_images(self, paths: List[str]) -> List[Optional[np.ndarray]]:
        """``read_image`` of each path. With ``--native-decode`` (or
        ``VINCE_NATIVE_DECODE=1``) the JPEGs are decoded together on the run's
        device (``vince_tpu_torch.native``: nvJPEG and the JPEG kernels on a
        GPU, the plain version with ``--platform cpu``); a file that path
        refuses (not a JPEG, truncated, CMYK) is read by ``cv2`` and counted."""
        if not native.wanted(self.args):
            return [self._cv2_read(p) for p in paths]
        outs, ok = native.decode_jpeg_files(paths, self.canvas, self.decode_device)
        images = []
        for path, img, good in zip(paths, outs, ok):
            if not good:
                native.count("cv2_reads")
                img = self._cv2_read(path)
            images.append(img)
        return images

    def _cv2_read(self, path: str) -> Optional[np.ndarray]:
        import cv2

        try:
            img = cv2.imread(path, cv2.IMREAD_COLOR)
            if img is None:
                return None
            img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
            return self.resize_canvas(img)
        except Exception:
            return None

    @property
    def decode_device(self) -> torch.device:
        """The device of ``--native-decode``: the run's (``--platform``), on
        the rank's GPU under ``--distributed``. Looked up once, in the process
        that made the dataset: ``PersistentDataLoader`` fixes it before its
        worker processes get their copies, and a worker never looks it up."""
        if getattr(self, "_decode_device", None) is None:
            self._decode_device = multihost.local_device(getattr(self.args, "platform", "cuda"))
        return self._decode_device

    def resize_canvas(self, img: np.ndarray) -> np.ndarray:
        c = self.canvas
        if img.shape[0] != c or img.shape[1] != c:
            import cv2

            img = cv2.resize(img, (c, c), interpolation=cv2.INTER_LINEAR)
        return img


class VideoIndex:
    """video_id → sorted [frame_ids], built once from a glob and pickled as
    ``{split}_names.pkl`` beside the split."""

    def __init__(
        self,
        data_path: str,
        data_subset: str,
        glob_pattern: str,
        parse_fn,  # path -> (video_id, frame_id)
        min_frames: int = 1,
        check_for_new_data: bool = False,
    ):
        self.data_split_path = os.path.join(data_path, data_subset)
        pickle_path = os.path.join(data_path, data_subset + "_names.pkl")
        if not os.path.exists(pickle_path) or check_for_new_data:
            paths = sorted(glob.iglob(os.path.join(self.data_split_path, glob_pattern)))
            grouped: Dict[str, List[int]] = {}
            for vid_id, ind in sorted(parse_fn(p) for p in paths):
                grouped.setdefault(vid_id, []).append(ind)
            path_info = sorted(grouped.items())
            os.makedirs(self.data_split_path, exist_ok=True)
            with open(pickle_path, "wb") as f:
                pickle.dump(path_info, f)
        with open(pickle_path, "rb") as f:
            path_info = pickle.load(f)
        # videos shorter than min_frames are left out
        self.path_info: List[Tuple[str, List[int]]] = [
            (k, v) for k, v in path_info if len(v) >= min_frames
        ]

    def __len__(self):
        return len(self.path_info)
