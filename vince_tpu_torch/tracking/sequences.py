"""Tracking sequence readers (counterpart of ``vince_tpu/tracking/sequences.py``).
An item is ``(frames, anno)``: the frames as image paths or as uint8
[H, W, 3] RGB arrays, and the boxes [T, 4], 1-indexed [x, y, w, h].

- ``GOT10kSequences``: ``<root>/<split>/<seq>/{*.jpg, groundtruth.txt}``,
  ordered by ``list.txt`` where it exists; paths.
- ``OTBSequences``: ``<root>/<seq>/img/*.jpg`` + ``groundtruth_rect.txt``
  (comma- or tab-separated); paths.
- ``SyntheticSequences``: a bright square drifting over noise, and
  ``TextureSequences``: a grating patch drifting over a grating of another
  orientation, through one equalised duotone ramp, so that only texture
  tells the target. Both are the JAX generators, held in memory, where the
  JAX ones write each frame as a JPEG with ``cv2``. The square is drawn inclusive of both corners, as
  ``cv2.rectangle`` draws it.
"""

import glob
import os
from typing import List, Tuple

import numpy as np


class GOT10kSequences:
    def __init__(self, root: str, subset: str = "train"):
        self.root = os.path.join(root, subset)
        list_file = os.path.join(self.root, "list.txt")
        if os.path.exists(list_file):
            with open(list_file) as f:
                names = [line.strip() for line in f if line.strip()]
        else:
            names = sorted(d for d in os.listdir(self.root)
                           if os.path.isdir(os.path.join(self.root, d)))
        self.seq_names = names

    def __len__(self):
        return len(self.seq_names)

    def __getitem__(self, index) -> Tuple[List[str], np.ndarray]:
        seq_dir = os.path.join(self.root, self.seq_names[index])
        img_files = sorted(glob.glob(os.path.join(seq_dir, "*.jpg")))
        anno = np.loadtxt(os.path.join(seq_dir, "groundtruth.txt"), delimiter=",")
        return img_files, np.atleast_2d(anno)


class OTBSequences:
    """The OTB-2015 layout; sequences with one groundtruth file."""

    def __init__(self, root: str):
        self.root = root
        self.seq_names = sorted(
            d for d in os.listdir(root)
            if os.path.isdir(os.path.join(root, d))
            and os.path.exists(os.path.join(root, d, "groundtruth_rect.txt")))

    def __len__(self):
        return len(self.seq_names)

    def __getitem__(self, index) -> Tuple[List[str], np.ndarray]:
        seq_dir = os.path.join(self.root, self.seq_names[index])
        img_files = sorted(glob.glob(os.path.join(seq_dir, "img", "*.jpg")))
        anno_path = os.path.join(seq_dir, "groundtruth_rect.txt")
        try:
            anno = np.loadtxt(anno_path, delimiter=",")
        except ValueError:
            anno = np.loadtxt(anno_path)
        return img_files, np.atleast_2d(anno)


class SyntheticSequences:
    """A bright square drifting over noise; the annotations are exact."""

    prefix = "synth"

    def __init__(self, num_seqs: int = 4, num_frames: int = 20, size: int = 240,
                 target: int = 48, seed: int = 0):
        self.seq_names = [f"{self.prefix}_{i:03d}" for i in range(num_seqs)]
        rng = np.random.RandomState(seed)
        self._frames, self._annos = [], []
        for _ in range(num_seqs):
            background, paint = self._scene(rng, size, target)
            x, y = rng.randint(20, size - target - 20, 2).astype(np.float64)
            vx, vy = rng.uniform(-3, 3, 2)
            frames, boxes = [], []
            for _ in range(num_frames):
                frame = background.copy()
                paint(frame, int(round(x)), int(round(y)))
                frames.append(frame)
                boxes.append([x + 1, y + 1, target, target])  # 1-indexed xywh
                x = np.clip(x + vx, 0, size - target - 1)
                y = np.clip(y + vy, 0, size - target - 1)
            self._frames.append(frames)
            self._annos.append(np.asarray(boxes, np.float64))

    @staticmethod
    def _scene(rng, size, target):
        """(background, paint(frame, x, y)) of one sequence."""
        background = rng.randint(0, 100, (size, size, 3), np.uint8)
        color = rng.randint(180, 256, 3).astype(np.uint8)

        def paint(frame, x, y):  # cv2.rectangle, filled: both corners included
            frame[y: y + target + 1, x: x + target + 1] = color
        return background, paint

    def __len__(self):
        return len(self.seq_names)

    def __getitem__(self, index) -> Tuple[List[np.ndarray], np.ndarray]:
        return self._frames[index], self._annos[index]


class TextureSequences(SyntheticSequences):
    """An oriented grating patch drifting over a grating at least 45° away,
    both rendered through the same equalised duotone ramp: the target's
    intensities equal those of any background patch of its size, so a
    tracker must match texture, not brightness or colour."""

    prefix = "tex"

    @staticmethod
    def _scene(rng, size, target):
        from vince_tpu_torch.data.synthetic_dataset import (
            SyntheticTextureVideoDataset as T,
            _equalized_grating,
        )

        def duotone(inten):
            img = inten[..., None] * T.C1 + (1.0 - inten[..., None]) * T.C2
            return np.clip(img, 0, 255).astype(np.uint8)

        bg_theta = np.pi * rng.randint(0, 4) / 4.0
        tg_theta = bg_theta + np.pi / 2 + rng.uniform(-np.pi / 8, np.pi / 8)
        background = duotone(_equalized_grating(0, size, 0, size, size, bg_theta, 8.0,
                                                rng.uniform(0, 2 * np.pi)))
        patch = duotone(_equalized_grating(0, target, 0, target, target, tg_theta, 3.0,
                                           rng.uniform(0, 2 * np.pi)))

        def paint(frame, x, y):
            frame[y: y + target, x: x + target] = patch
        return background, paint
