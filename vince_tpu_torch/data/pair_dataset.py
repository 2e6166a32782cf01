"""SiamFC training pairs (counterpart of ``vince_tpu/data/pair_dataset.py``):
two frames of one sequence fewer than 100 apart, the sequence's boxes
filtered by visibility, size and aspect (c1-c7), the pair cropped on the host
by ``SiamFCTransforms`` (one warp per image) and, in training, each crop
flipped at random (the search crop with its label). The device step only
normalises.

The JAX dataset draws from numpy's global generator; this one from ``rng``,
in the same order (the split's permutation at construction; per item the
pair, the crops' boxes, the flips); the same items for the same seed only
when one thread draws them in index order. The sequences' frames are paths
or uint8 arrays.
"""

from typing import Dict, Optional

import numpy as np

from vince_tpu_torch.data.base_dataset import BaseDataset
from vince_tpu_torch.tracking.ops import load_frame
from vince_tpu_torch.tracking.siamfc_transforms import SiamFCTransforms


class PairDataset(BaseDataset):
    def __init__(self, args, seqs, data_subset: str = "train",
                 pair_transform: Optional[SiamFCTransforms] = None, pairs_per_seq: int = 25,
                 rng: Optional[np.random.RandomState] = None):
        super().__init__(args, data_subset)
        self.seqs = seqs
        self.rng = rng if rng is not None else np.random.RandomState()
        self.pair_transform = pair_transform
        self.pairs_per_seq = pairs_per_seq
        self.indices = self.rng.permutation(len(seqs))
        self.seq_sizes = {}
        self.invalid_seqs = {}

    def __len__(self):
        return len(self.indices) * self.pairs_per_seq

    def _filter(self, frame0, key, anno):
        """The indices of the frames whose boxes pass c1-c7."""
        if key in self.invalid_seqs:
            return self.invalid_seqs[key]
        if key not in self.seq_sizes:
            img = load_frame(frame0)
            self.seq_sizes[key] = img.shape[:2] if img is not None else (1, 1)
        size = self.seq_sizes[key]
        anno = np.atleast_2d(anno)
        areas = anno[:, 2] * anno[:, 3]
        c1 = areas >= 20
        c2 = np.all(anno[:, 2:] >= 20, axis=1)
        c3 = np.all(anno[:, 2:] <= 500, axis=1)
        # (w, h) over the image's (h, w): the reference's axis mix, kept so
        # that the same pairs are chosen
        c4 = np.all((anno[:, 2:] / size) >= 0.01, axis=1)
        c5 = np.all((anno[:, 2:] / size) <= 0.5, axis=1)
        c6 = (anno[:, 2] / np.maximum(1, anno[:, 3])) >= 0.25
        c7 = (anno[:, 2] / np.maximum(1, anno[:, 3])) <= 4
        val_indices = np.where(np.logical_and.reduce((c1, c2, c3, c4, c5, c6, c7)))[0]
        if len(val_indices) < 2:
            self.invalid_seqs[key] = val_indices
        return val_indices

    def _sample_pair(self, indices):
        n = len(indices)
        if n == 1:
            return indices[0], indices[0]
        if n == 2:
            return indices[0], indices[1]
        for _ in range(100):
            rand_z, rand_x = np.sort(self.rng.choice(indices, 2, replace=False))
            if rand_x - rand_z < 100:
                return rand_z, rand_x
        rand_z = self.rng.choice(indices)
        return rand_z, rand_z

    def __getitem__(self, index) -> Optional[Dict[str, np.ndarray]]:
        index = self.indices[index % len(self.indices)]
        frames, anno = self.seqs[index][:2]
        val_indices = self._filter(frames[0], int(index), anno)
        if len(val_indices) < 2:
            return self.__getitem__(int(self.rng.randint(len(self))))
        rand_z, rand_x = self._sample_pair(val_indices)
        z = load_frame(frames[rand_z])
        x = load_frame(frames[rand_x])
        if z is None or x is None:
            return None
        exemplar_img, (track_img, label) = self.pair_transform(
            (z, x, anno[rand_z], anno[rand_x]))
        if self.data_subset == "train":
            if self.rng.rand() > 0.5:
                exemplar_img = np.fliplr(exemplar_img).copy()
            if self.rng.rand() > 0.5:
                track_img = np.fliplr(track_img).copy()
                label = np.fliplr(label).copy()
        return {"exemplar": exemplar_img.astype(np.uint8), "search": track_img.astype(np.uint8),
                "labels": label.astype(np.float32), "ind": np.int64(index)}
